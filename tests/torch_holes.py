"""The kinds of the select context that change the length, after every
breaker that leaves holes, through the JAX package and the port (shared
by tests/test_torch_holes_*.py, which split the sources between them).

A breaker leaves rows that are not in the frame: the pad past a short
frame's rows (capacity 128 for 40 rows), the rows a filter masked, the
dead slots of a join's or a group-by's output. The kinds that keep the
input's rows and narrow them (`expr.filter` over a numeric and a String
column, `drop_nulls` after `shift`, `drop_nans` with NaN among the live
rows) must mark none of those; `REPAIRED` runs each in a select, and as
the operand of `sum` (`len` for the String one) in a select and in a
`group_by("g").agg()`, after each of `SOURCES`. `GUARDS` runs the kinds
that passed before in a select after the same breakers.

The port runs its lazy plan on the CPU (device="cpu"), the streaming
and distributed sources through `collect(engine="streaming")` and
`collect(engine="distributed")` on a 4-slot CPU mesh. The JAX package
collects each source once in memory, on its CPU path, and runs each
query eagerly over that frame: a lazy query of its own would compile a
program each, and its compiled-chain cache, keyed without the row count,
handed `head(70)` after a filter an earlier query's program and rows
(it is emptied before each of its collects). Its streaming engine
decomposes a group-by's sum of a `shift` batch by batch, a kept
difference held in tests/test_torch_holes_engines.py.

Where the JAX package is wrong, the port is held to numpy over the JAX
package's collect of the same source: `hist` (the JAX package drops a
bin whose row slot is dead in the frame). `unique(maintain_order=True)`
in a select has no evaluation in either package: both must refuse it.

Tolerances: rows, integers, strings and null bits bit for bit; a Float64
sum within 1e-12 of the sum of |x| over the same rows (the JAX package's
`abs().sum()` of the same kind, asked in the same query).
"""

import math
import struct

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
from polaroid_tpu_torch.parallel.mesh import make_mesh

MESH = make_mesh(4, device="cpu")


def _data(n, seed, repeat=0):
    """n rows from `seed`: k (12 keys), g (3 groups), f (Float64, NaN in
    about 10% of rows), i (Int64, null in about 15%), s (String, null in
    about 5%), r (a permutation); the first `repeat` rows appended again
    at the end (whole duplicate rows for `unique`)."""
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 1, n)
    f[rng.random(n) < 0.1] = np.nan
    i = rng.integers(-5, 5, n).astype(object)
    i[rng.random(n) < 0.15] = None
    s = np.array([f"w{x}" for x in rng.integers(0, 7, n)], dtype=object)
    s[rng.random(n) < 0.05] = None
    d = {"k": rng.integers(0, 12, n).tolist(),
         "g": rng.integers(0, 3, n).tolist(), "f": f.tolist(),
         "i": i.tolist(), "s": s.tolist(), "r": rng.permutation(n).tolist()}
    return {c: v + v[:repeat] for c, v in d.items()}


A = _data(150, 1, repeat=40)      # 190 rows
B = _data(90, 2)
SHORT = _data(40, 3)
RIGHT = {"k": list(range(16)) + [3, 5, 7], "rv": list(range(19))}


def lazy(pkg, d):
    return pkg.LazyFrame(d, device="cpu") if pkg is pt else pkg.LazyFrame(d)


def eager(pkg, d):
    return pkg.DataFrame(d, device="cpu") if pkg is pt else pkg.DataFrame(d)


def _firsts(pkg):
    return [pkg.col(c).first() for c in ("f", "i", "s", "g", "r")]


def _filtered_union(pkg):
    return pkg.concat([lazy(pkg, A).filter(pkg.col("k") > 2),
                       lazy(pkg, B).filter(pkg.col("k") < 9)])


# name -> (the frame after the breaker, how the port collects it)
SOURCES = {
    "short": (lambda P: lazy(P, SHORT), None),
    "filter": (lambda P: lazy(P, A).filter(P.col("k") > 2), None),
    "join_inner": (lambda P: lazy(P, A).join(lazy(P, RIGHT), on="k"), None),
    "join_left": (lambda P: lazy(P, A).join(lazy(P, RIGHT), on="k",
                                            how="left"), None),
    "group_by_dense": (lambda P: lazy(P, A).group_by(
        "k", maintain_order=True).agg(_firsts(P)), None),
    "group_by_hash": (lambda P: lazy(P, A).with_columns(
        (P.col("k") * 5000).alias("h")).group_by(
            "h", maintain_order=True).agg(_firsts(P)), None),
    "sort": (lambda P: lazy(P, A).filter(P.col("k") > 2).sort("r"), None),
    "unique": (lambda P: lazy(P, A).unique(maintain_order=True), None),
    "head": (lambda P: lazy(P, A).filter(P.col("k") > 2).head(70), None),
    "concat": (_filtered_union, None),
    "eager": (lambda P: eager(P, A).filter(P.col("k") > 2), "eager"),
    "streaming": (_filtered_union, "streaming"),
    "distributed": (lambda P: lazy(P, A).filter(P.col("k") > 2),
                    "distributed"),
}

KINDS = {
    "filter_num": lambda P: P.col("i").filter(P.col("f") > 0),
    "filter_str": lambda P: P.col("s").filter(P.col("f") > 0),
    "drop_nulls": lambda P: P.col("i").shift(1).drop_nulls(),
    "drop_nans": lambda P: P.col("f").drop_nans(),
    "head": lambda P: P.col("i").head(3),
    "tail": lambda P: P.col("i").tail(3),
    "slice": lambda P: P.col("i").slice(2, 5),
    "gather_every": lambda P: P.col("i").gather_every(3),
    "arg_true": lambda P: (P.col("f") > 0).arg_true(),
    "top_k": lambda P: P.col("r").top_k(3),
    "unique": lambda P: P.col("g").unique(maintain_order=True),
    "mode": lambda P: P.col("g").mode(),
    "implode": lambda P: P.col("i").implode(),
    "hist": lambda P: P.col("f").fill_nan(0.0).hist(bin_count=4),
}
REPAIRED = ("filter_num", "filter_str", "drop_nulls", "drop_nans")
GUARDS = ("head", "tail", "slice", "gather_every", "arg_true", "top_k",
          "unique", "mode", "implode", "hist")
CONTEXTS = ("select", "sum_in_select", "sum_in_group_by")


def repaired_cases(sources):
    return [(s, k, c) for s in sources for k in REPAIRED for c in CONTEXTS]


def guard_cases(sources):
    return [(s, k) for s in sources for k in GUARDS]


def _clear_reference_chains():
    from polaroid_tpu.exec import compiled
    compiled._CACHE.clear()


_REF_FRAMES = {}


def reference_frame(src):
    """The JAX package's frame after the breaker: collected once (in
    memory; the eager source's filter stays a mask)."""
    if src not in _REF_FRAMES:
        build, engine = SOURCES[src]
        _clear_reference_chains()
        f = build(ref)
        _REF_FRAMES[src] = f if engine == "eager" else f.collect()
    return _REF_FRAMES[src]


def run(pkg, src, query):
    """`query` over the source's frame: the port's lazy plan collected as
    the source says; the JAX package's query eagerly over its collected
    frame (each lazy query of its own would compile a program)."""
    if pkg is ref:
        return query(reference_frame(src))
    build, engine = SOURCES[src]
    out = query(build(pkg))
    if engine == "eager":
        return out
    if engine == "streaming":
        return out.collect(engine="streaming")
    if engine == "distributed":
        return out.collect(engine="distributed", mesh=MESH)
    return out.collect()


def source_frame(src) -> dict:
    """The JAX package's rows of the source."""
    return reference_frame(src).to_dict()


def _agg(P, kind):
    e = KINDS[kind](P)
    return e.len() if kind == "filter_str" else e.sum()


def _query(P, kind, ctx, with_abs):
    """The select or group-by of `kind` in `ctx`; `with_abs` adds the sum
    of |x| of a Float64 kind as column "ax"."""
    if ctx == "select":
        return lambda f: f.select(KINDS[kind](P).alias("x"))
    exprs = [_agg(P, kind).alias("x")]
    if with_abs:
        exprs.append(KINDS[kind](P).abs().sum().alias("ax"))
    if ctx == "sum_in_select":
        return lambda f: f.select(exprs)
    return lambda f: f.group_by("g").agg(exprs).sort("g")


def _bits(x):
    return struct.pack("<d", x)


def same(got: dict, want: dict, bounds=None, what=""):
    """Columns, lengths, nulls, integers and strings equal; floats bit for
    bit, or within bounds[column][row] where given."""
    assert list(got) == list(want), (what, list(got), list(want))
    for c in want:
        a, b = got[c], want[c]
        assert len(a) == len(b), (what, c, len(a), len(b), a[:12], b[:12])
        for j, (y, z) in enumerate(zip(a, b)):
            if isinstance(z, float) and isinstance(y, float):
                if bounds and c in bounds:
                    assert abs(y - z) <= bounds[c][j] or (
                        math.isnan(y) and math.isnan(z)), (what, c, j, y, z)
                else:
                    assert _bits(y) == _bits(z) or (
                        math.isnan(y) and math.isnan(z)), (what, c, j, y, z)
            else:
                assert y == z and type(y) is type(z), (what, c, j, y, z)


def check_repaired(src, kind, ctx):
    """The port's answer to `kind` in `ctx` after `src` against the JAX
    package's."""
    floats = kind == "drop_nans" and ctx != "select"
    want = run(ref, src, _query(ref, kind, ctx, floats)).to_dict()
    got = run(pt, src, _query(pt, kind, ctx, False)).to_dict()
    bounds = None
    if floats:
        bounds = {"x": [1e-12 * ax for ax in want.pop("ax")]}
    same(got, want, bounds, (src, kind, ctx))


def hist_oracle(frame: dict) -> list:
    """numpy's `fill_nan(0.0).hist(bin_count=4)` of the frame's f: four
    equal bins over [min, max], right-closed, the first one closed on
    both sides (polars' bins)."""
    x = np.array([0.0 if math.isnan(v) else v for v in frame["f"]
                  if v is not None])
    lo, hi = x.min(), x.max()
    span = hi - lo if hi > lo else 1.0
    edges = lo + span * np.arange(5, dtype=np.float64) / 4
    b = np.searchsorted(edges[1:4], x, "left")
    inb = (x >= edges[0]) & (x <= edges[4])
    return np.bincount(b[inb], minlength=4).tolist()


def check_guard(src, kind):
    """A kind that kept the frame's rows before the repair, in a select
    after `src`: against the JAX package, or numpy where it is wrong
    (hist); `unique`, which neither package evaluates, refused by both."""
    q = _query(pt, kind, "select", False)
    if kind == "unique":
        with pytest.raises(pt.exceptions.ComputeError):
            run(pt, src, q)
        with pytest.raises(ref.exceptions.ComputeError):
            run(ref, src, _query(ref, kind, "select", False))
        return
    got = run(pt, src, q).to_dict()
    if kind == "hist":
        assert got == {"x": hist_oracle(source_frame(src))}, (src, got)
        return
    want = run(ref, src, _query(ref, kind, "select", False)).to_dict()
    if kind == "mode":
        got, want = {"x": sorted(got["x"])}, {"x": sorted(want["x"])}
    same(got, want, None, (src, kind))
