"""The expression catalog (tests/torch_expr_catalog.py) on the CPU.

`test_catalog_covers_every_expr_name` fails when a public name of `Expr`
or of its namespaces `str`, `dt`, `list` (`arr`), `struct`, `cat`, `name`
and `bin`, or a top-level function of `api/functions.py` and
`expr/expr.py`, has neither an entry nor an exclusion with its reason.
`test_every_entry_runs_on_the_cpu` runs each entry (and each variant)
through the port on a small frame with nulls, and after the catalog's
breaker for the entries that phase 22 runs after it; a REFUSED entry
must be refused.

The names that no other test file holds against the JAX package are
held here (`AGAINST_JAX`): each through both packages on the same small
frames, with nulls and after a filter that leaves holes, within the
entry's tolerance (`torch_expr_catalog.TOLERANCE`); a name that neither
package evaluates must be refused by both with the same error. The JAX
side's elementwise names run as one select a frame (a module fixture),
so its compiles stay few; each name is a case of its own.
"""

import inspect
import math
import warnings

import numpy as np
import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pt
import torch_expr_catalog as C

N_ROWS = 200


@pytest.fixture(autouse=True, scope="module")
def _fresh_reference_cache():
    """The JAX package's caches start empty and store nothing while this
    file runs (`tests/test_torch_reference_caches.py`)."""
    from test_torch_reference_caches import fresh_reference_caches
    with fresh_reference_caches():
        yield


NAMESPACES = ("str", "dt", "list", "struct", "cat", "name", "bin")


def _public(obj):
    return {n for n in dir(obj) if not n.startswith("_")}


def public_expr_names():
    """Every public name the catalog must cover, qualified as its
    entries are."""
    names = {f"Expr.{n}" for n in _public(pt.Expr)}
    for ns in NAMESPACES:
        names |= {f"{ns}.{n}" for n in _public(type(getattr(pt.col("a"),
                                                            ns)))}
    modules = {f"polaroid_tpu_torch.{m}" for m in C.TOP_MODULES}
    for n in _public(pt):
        f = getattr(pt, n)
        if inspect.isfunction(f) and f.__module__ in modules:
            names.add(f"top.{n}")
    return names


def test_catalog_covers_every_expr_name():
    names = public_expr_names()
    entries = set(C.ENTRIES)
    also = [a for e in C.ENTRIES.values() for a in e.also]
    covered = entries | set(also) | set(C.EXCLUDED)
    assert sorted(names - covered) == [], "names with no entry"
    assert sorted(covered - names) == [], "entries of names the port lacks"
    # each name is covered once, so that deleting any entry fails above
    assert len(also) == len(set(also))
    assert not entries & set(also) and not entries & set(C.EXCLUDED)
    assert not set(also) & set(C.EXCLUDED)
    assert all(C.EXCLUDED.values())
    assert type(pt.col("a").arr) is type(pt.col("a").list)
    assert {e.family for e in C.ENTRIES.values()} <= set(C.TOLERANCE)


def _frames(pl, device=None):
    kw = {"device": device} if device else {}
    cols, valid = C.num_data(N_ROWS, 5)
    num = pl.DataFrame(C.host_lists(cols, valid), **kw)
    taq = pl.DataFrame(C.host_lists(C.taq_data(N_ROWS, 6)), **kw)
    derived = [e for e in C.taq_derived(pl)
               if pl is pt or e.meta.output_name() != "arr"]
    return {"num": num, "taq": taq.with_columns(derived)}


@pytest.fixture(scope="module")
def port_frames():
    return _frames(pt, "cpu")


@pytest.fixture(scope="module")
def hosts():
    """_frames' columns as numpy's closed forms and the SCAN bounds read
    them."""
    cols, valid = C.num_data(N_ROWS, 5)
    return {"num": C.host_columns("num", cols, valid),
            "taq": C.host_columns("taq", C.taq_data(N_ROWS, 6))}


def _bound(e, hosts, hole=False):
    return C.scan_bound(e, hosts[e.source], hole) \
        if e.family == C.SCAN else None


CASES = [(e.name, False) for e in C.ENTRIES.values()] + \
    [(e.name, False) for e in C.VARIANTS] + \
    [(n, True) for n in C.HOLE_ENTRIES]
_ALL = {**C.ENTRIES, **{e.name: e for e in C.VARIANTS}}


@pytest.mark.parametrize("name,hole", CASES,
                         ids=[f"{n}{'-hole' if h else ''}" for n, h in CASES])
def test_every_entry_runs_on_the_cpu(port_frames, hosts, name, hole):
    e = _ALL[name]
    frame = port_frames[e.source]
    if e.family == C.REFUSED:
        C.refusal(pt, e, frame, hole)
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        out = C.query(pt, e, frame, hole).collect()
    got = C.leaves(out)
    assert out.width >= 1
    if e.family == C.SAMPLE:
        src = C.leaves(C.query(pt, C.Entry(
            e.name, e.source, C.EXACT,
            lambda pl: pl.col(e.cols(pl)[0])), frame, hole).collect())
        C.check_sample(e, got, src)
        return
    # the same query again gives the same result (no state leaks between
    # collects)
    again = C.leaves(C.query(pt, e, frame, hole).collect())
    C.compare(e, again, got, _bound(e, hosts, hole))


# --- against the JAX package ---------------------------------------------

# the names no other test file holds against the JAX package, with the
# operator aliases
AGAINST_JAX = ("Expr.top_k_by", "Expr.bottom_k_by", "Expr.unique_counts",
               "Expr.index_of", "Expr.is_close", "Expr.arg_unique",
               "Expr.eq_missing", "Expr.ne_missing", "dt.offset_by",
               "dt.to_string", "dt.combine", "list.to_array",
               "cat.set_ordering", "cat.to_local", "name.map_fields",
               "Expr.serialize", "Expr.flatten", "Expr.and_", "Expr.or_",
               "Expr.not_", "Expr.mul", "Expr.ne", "Expr.add", "Expr.sub",
               "Expr.truediv", "Expr.floordiv", "Expr.mod", "Expr.pow",
               "Expr.xor", "Expr.neg", "Expr.eq", "Expr.ge", "Expr.gt",
               "Expr.le", "Expr.lt")


def _elementwise(e):
    return e.family not in (C.REFUSED, C.SAMPLE) and e.context == "select" \
        and e.name not in ("Expr.top_k_by", "Expr.bottom_k_by",
                           "Expr.arg_unique", "Expr.flatten",
                           "Expr.serialize", "cat.set_ordering")


def _batched(pl, frames, hole):
    """One select a source over the elementwise AGAINST_JAX names, each
    aliased to its own name: {name: [values]}."""
    out = {}
    for src in ("num", "taq"):
        es = [C.ENTRIES[n] for n in AGAINST_JAX
              if _elementwise(C.ENTRIES[n]) and C.ENTRIES[n].source == src]
        if not es:
            continue
        lf = frames[src].lazy()
        if hole:
            lf = lf.filter(C.HOLE_FILTERS[src](pl))
        res = lf.select([e.build(pl).alias(e.name) for e in es]).collect()
        out.update(res.to_dict())
    return out


@pytest.fixture(scope="module")
def jax_side():
    frames = _frames(ref)
    return frames, {h: _batched(ref, frames, h) for h in (False, True)}


@pytest.fixture(scope="module")
def port_side(port_frames):
    return {h: _batched(pt, port_frames, h) for h in (False, True)}


def _close(a, b, rtol):
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_close(x, y, rtol)
                                        for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(_close(a[k], b[k], rtol)
                                          for k in a)
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or abs(a - b) <= rtol * abs(b)
    return a == b


def _same(name, got, want):
    e = C.ENTRIES[name]
    rtol = 1e-12 if e.family in (C.FLOAT, C.SCAN) else 0.0
    assert len(got) == len(want), (name, len(got), len(want))
    for i, (a, b) in enumerate(zip(got, want)):
        assert _close(a, b, rtol), (name, i, a, b)


@pytest.mark.parametrize("hole", [False, True], ids=["nulls", "holes"])
@pytest.mark.parametrize("name", AGAINST_JAX)
def test_name_matches_jax(name, hole, jax_side, port_side, port_frames):
    e = C.ENTRIES[name]
    frames, batched = jax_side
    if e.family == C.REFUSED:
        got = C.refusal(pt, e, port_frames[e.source], hole)
        want = C.refusal(ref, e, frames[e.source], hole)
        assert got == want
        return
    if _elementwise(e):
        _same(name, port_side[hole][name], batched[hole][name])
        return
    got = C.query(pt, e, port_frames[e.source], hole).collect().to_dict()
    want = C.query(ref, e, frames[e.source], hole).collect().to_dict()
    assert list(got) == list(want)
    for k in want:
        _same(name, got[k], want[k])


# --- regressions of what phase 22 found --------------------------------

def test_strftime_formats_only_the_distinct_valid_values(monkeypatch):
    """`dt.strftime` formats each distinct valid value once on the host
    (it formatted every slot of the capacity: 2^24 Python calls a
    collect at H2O's 10^7 rows), with the JAX package's result."""
    import datetime as dtm

    from polaroid_tpu_torch.expr import dt as port_dt
    seen = []
    real = port_dt.format_values

    def counting(vals, *a):
        seen.append(len(vals))
        return real(vals, *a)
    monkeypatch.setattr(port_dt, "format_values", counting)
    days = [dtm.datetime(2024, 3, 4, 9, 30), dtm.datetime(2024, 3, 10, 2),
            dtm.datetime(1999, 12, 31, 23, 59, 59)]
    ts = [None if i % 7 == 3 else days[i % 3] for i in range(5000)]
    fmt = "%a %d %b %Y %j %H:%M:%S"
    data = {"t": ts, "k": [i % 5 for i in range(5000)]}

    def run(pl, df):
        return df.lazy().filter(pl.col("k") > 0).select(
            pl.col("t").dt.strftime(fmt)).collect()
    got = run(pt, pt.DataFrame(data, device="cpu"))
    want = run(ref, ref.DataFrame(data))
    assert seen == [3]
    assert got.to_dict() == want.to_dict()


NUMPY_CASES = [(e.name, src) for e in list(C.ENTRIES.values()) + C.VARIANTS
               if e.numpy
               for src in (("num", "nulls") if e.source == "num"
                           else ("taq", "taq_ties"))] + \
    [(n, "hole") for n in C.HOLE_ENTRIES if _ALL[n].numpy]


def _taq_ties(n, seed):
    """n trades with their instants cut to the minute: ties of ts, and 5m
    windows of about 10 rows."""
    cols = C.taq_data(n, seed)
    cols["ts"] = cols["ts"].astype("datetime64[m]").astype("datetime64[us]")
    return cols


@pytest.mark.parametrize("name,frame", NUMPY_CASES,
                         ids=[f"{n}-{f}" for n, f in NUMPY_CASES])
def test_numpy_oracles_match_the_port(name, frame):
    """numpy's closed forms that phase 22 uses in place of the port's CPU
    collect give the port's CPU result, within the entry's tolerance (the
    numeric frame in H2O's dtypes as built and with i and x nullable, 2000
    rows: ties in x would break `rank`; the trades, and 8000 trades whose
    instants tie at the minute; the hole entries after the breaker)."""
    e = _ALL[name]
    hole = frame == "hole"
    if hole:
        frame = "nulls" if e.source == "num" else "taq_ties"
    if frame.startswith("taq"):
        cols = C.taq_data(N_ROWS, 6) if frame == "taq" else \
            _taq_ties(8000, 7)
        df = pt.DataFrame(cols, device="cpu").with_columns(
            C.taq_derived(pt))
        host = C.host_columns("taq", cols)
    else:
        cols, valid = C.num_data(2000, 9)
        valid = valid if frame == "nulls" else None
        df = pt.DataFrame(C.host_lists(cols, valid), device="cpu") \
            .with_columns(pt.col("i", "j", "k", "g").cast(pt.Int32))
        host = C.host_columns("num", cols, valid)
    with C.quiet():
        got = C.leaves(C.query(pt, e, df, hole).collect())
    C.compare(e, got, C.numpy_leaves(e, got, C.numpy_form(e, host, hole)),
              C.scan_bound(e, host, hole, numpy=True) if e.family == C.SCAN
              else None)


def test_compare_tells_results_apart(port_frames):
    """Phase 22 holds an EXACT result to its oracle bit for bit: one
    changed value, null or string fails; -0.0 is 0.0 and a NaN any NaN;
    a string column's dictionary order does not count."""
    import torch
    e = C.ENTRIES["Expr.cast"]
    a = C.leaves(C.query(pt, e, port_frames["num"]).collect())
    C.compare(e, a, C.leaves(C.query(pt, e, port_frames["num"]).collect()))
    vals, valid = a["x"]
    at = int(torch.nonzero(valid)[7])
    for change in ("value", "null"):
        v2, m2 = vals.clone(), valid.clone()
        if change == "value":
            v2[at] += 1
        else:
            m2[at] = False
        with pytest.raises(AssertionError):
            C.compare(e, a, {**a, "x": (v2, m2)})
    z = torch.tensor([0.0, float("nan"), 1.0])
    nz = torch.tensor([-0.0, -float("nan"), 1.0])
    C.compare(e, {"z": (z, None)}, {"z": (nz, None)})
    s = C.leaves(C.query(pt, C.ENTRIES["str.to_lowercase"],
                         port_frames["taq"]).collect())
    (k,) = [k for k in s if k != "__schema__"]
    coded, m = s[k]
    shuffled = np.arange(len(coded.values))[::-1]
    remapped = C.Coded(np.argsort(shuffled)[coded.codes.numpy()],
                       coded.values[shuffled])
    e = C.ENTRIES["str.to_lowercase"]
    C.compare(e, {k: (coded, m)}, {k: (remapped, m)})
    other = C.Coded(coded.codes.clone(), coded.values)
    other.codes[0] = (other.codes[0] + 1) % len(coded.values)
    with pytest.raises(AssertionError):
        C.compare(e, {k: (coded, m)}, {k: (other, m)})


F32_CASES = [n for n, e in {**C.ENTRIES, **{v.name: v for v in
                                            C.VARIANTS}}.items()
             if e.family == C.SCAN and e.source == "num"
             and "x" in e.cols(pt)]


def test_every_scan_entry_has_its_bound():
    """Each SCAN entry names its statistic's scale, and each one held to
    numpy's form its worst case."""
    scan = [e for e in _ALL.values() if e.family == C.SCAN]
    assert sorted(e.name for e in scan) == sorted(C.SCAN_SCALE)
    assert sorted(e.name for e in scan if e.numpy) == sorted(C.NUMPY_SCAN)


@pytest.mark.parametrize("name", F32_CASES)
def test_scan_bound_rejects_a_float32_computation(name):
    """Each SCAN entry over the numeric frame's Float64 x, computed from x
    in Float32 with its result in Float32 and widened back, misses its
    bound against the Float64 result (2000 rows with nulls), which meets
    it."""
    import torch
    e = _ALL[name]
    cols, valid = C.num_data(2000, 9)
    df = pt.DataFrame(C.host_lists(cols, valid), device="cpu")
    f32 = df.with_columns(pt.col("x").cast(pt.Float32))
    bound = C.scan_bound(e, C.host_columns("num", cols, valid))
    with C.quiet():
        want = C.leaves(C.query(pt, e, df).collect())
        got = C.leaves(C.query(pt, e, f32).collect())
    C.compare(e, want, want, bound)
    got = {k: (v.float().double() if torch.is_tensor(v) and
               v.is_floating_point() else v, m) for k, (v, m) in got.items()}
    got["__schema__"] = want["__schema__"]
    with pytest.raises(AssertionError, match="beyond its bound"):
        C.compare(e, got, want, bound)
