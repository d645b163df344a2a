"""Nested (List and Struct) column ops.

The port of the JAX package's `ops/nested.py`. A list is a fixed-width
padded (capacity, width) tensor plus a per-row length (`batch.Column`),
so every per-list op is a masked reduction or gather along dim 1 over
all rows at once, with no offsets and no ragged loop.

`explode_table` maps each output row to its (source row, element) pair
by a `torch.repeat_interleave` of the rows by their counts; its one host
sync is the output row count, which picks the result's capacity.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..batch import Column, Table
from ..config import capacity_for
from ..dtypes import Boolean, DataType, Float64, Int64, UInt32, \
    List as ListT, Struct as StructT
from ..errors import InvalidOperationError, ShapeError
from . import compact as C

__all__ = ["explode_table", "implode_all", "list_namespace_op",
           "index_level"]


# ---------------------------------------------------------------------------
# explode
# ---------------------------------------------------------------------------

def explode_table(table: Table, columns: Sequence[str]) -> Table:
    """One row per list element (an empty or null list gives one null
    row, as in polars); the other columns repeat."""
    t = C.compact(table)
    n = t.nrows or 0
    for name in columns:
        c = t.column(name)
        if c.lengths is None:
            raise InvalidOperationError(
                f"explode: column {name!r} is {c.dtype!r}, not a List")
    dev = t.device
    lens = t.cols[columns[0]].lengths[:n]
    for name in columns[1:]:
        if not torch.equal(t.cols[name].lengths[:n], lens):
            raise ShapeError(
                "exploded columns must have matching element counts")
    counts = lens.to(torch.int64).clamp(min=1)
    offs = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    total = int(offs[-1])
    ocap = capacity_for(total)
    j = torch.arange(ocap, dtype=torch.int64, device=dev)
    r = torch.repeat_interleave(torch.arange(n, device=dev), counts,
                                output_size=total)
    r = torch.cat([r, r.new_full((ocap - total,), max(n - 1, 0))])
    e = j - offs[r]
    expl = set(columns)
    cols = {}
    for name in t.names:
        c = t.cols[name]
        if name not in expl:
            cols[name] = c.take(r)
            continue
        validity = e < c.lengths[r]     # an empty or null list: a null row
        if c.elem_valid is not None:
            validity = validity & c.elem_valid[
                r, e.clamp(0, c.elem_valid.shape[1] - 1)]
        if c.validity is not None:
            validity = validity & c.validity[r]
        if c.fields is not None and isinstance(c.dtype.inner, StructT):
            fcols = {}
            for nm, f in c.fields.items():
                ef = e.clamp(0, f.data.shape[1] - 1)
                fval = validity if f.elem_valid is None \
                    else validity & f.elem_valid[r, ef]
                fcols[nm] = Column(f.dtype.inner, f.data[r, ef], fval, f.sdict)
            cols[name] = Column(c.dtype.inner, None, validity, fields=fcols)
        elif c.fields is not None:
            ch = index_level(c.fields["item"], r, e)
            cols[name] = Column(c.dtype.inner, ch.data, validity, ch.sdict,
                                lengths=ch.lengths, elem_valid=ch.elem_valid,
                                fields=ch.fields)
        else:
            ec = e.clamp(0, c.data.shape[1] - 1)
            cols[name] = Column(c.dtype.inner, c.data[r, ec], validity,
                                c.sdict)
    out = Table(list(t.names), cols, ocap, total, None, device=dev)
    if total < ocap:
        out = out.with_valid(j < total, total)
    return out


# ---------------------------------------------------------------------------
# implode (the whole column into one list row)
# ---------------------------------------------------------------------------

def implode_all(data: torch.Tensor, validity, mask: torch.Tensor,
                inner_dtype: DataType):
    """The live rows (in order, nulls kept) gathered into one list row:
    (data (1, cap), lengths (1,), elem_valid or None, List dtype). The
    live rows move to the front by one compaction (kernel B)."""
    from .cuda_partition import compact_words
    cap = data.shape[0]
    pos = torch.arange(cap, dtype=torch.int32, device=data.device)
    (rows,), count = compact_words(mask.contiguous(), [pos])
    rows = rows.long().clamp(0, cap - 1)
    in_len = pos.unsqueeze(0) < count
    elem_valid = None
    if validity is not None:
        elem_valid = validity.expand(cap)[rows].unsqueeze(0) & in_len
    return (data.expand(cap)[rows].unsqueeze(0),
            count.to(torch.int32).reshape(1), elem_valid, ListT(inner_dtype))


# ---------------------------------------------------------------------------
# the list namespace
# ---------------------------------------------------------------------------

def index_level(col: Column, r: torch.Tensor, e: torch.Tensor) -> Column:
    """Element `e` of row `r` of a lifted nested child column: `[r, e]`
    applied to every (outer_cap, W, ...) tensor, recursing into fields,
    giving a column one list level shallower (`e` is clamped per tensor;
    the caller masks the validity)."""
    return col.map_rows(lambda a: a[r, e.clamp(0, a.shape[1] - 1)])


def _and(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _cols(W: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(W, device=like.device).unsqueeze(0)


def _nested_list_namespace_op(op: str, v, attrs: dict):
    """`.list.<op>` on List(Struct) and List(List): the structural
    subset (len, get, first, last)."""
    from ..expr.eval import Val
    lens = v.lengths
    cap = lens.shape[0]
    inner = v.dtype.inner
    if op in ("len", "n_elements"):
        return dict(dtype=UInt32, data=lens.to(torch.int64),
                    validity=v.validity)
    if op in ("get", "first", "last"):
        if op == "first":
            j = torch.zeros_like(lens)
        elif op == "last":
            j = (lens - 1).clamp(min=0)
        else:
            idx = int(attrs.get("index", 0))
            j = torch.full_like(lens, idx) if idx >= 0 else lens + idx
        rows = torch.arange(cap, device=lens.device)
        jc = j.clamp(min=0).long()
        ok = (j >= 0) & (j < lens)
        if v.elem_valid is not None:
            ok = ok & v.elem_valid[rows, jc.clamp(
                max=v.elem_valid.shape[1] - 1)]
        ok = _and(ok, v.validity)
        if isinstance(inner, StructT):
            fields = {}
            for nm, f in v.fields.items():
                jj = jc.clamp(max=f.data.shape[1] - 1)
                fv = ok if f.elem_valid is None \
                    else ok & f.elem_valid[rows, jj]
                fields[nm] = Val(f.dtype.inner, f.data[rows, jj], fv, f.sdict)
            return dict(dtype=inner, data=None, validity=ok, fields=fields)
        from ..expr.eval import column_to_val
        ch = index_level(_val_col(v.fields["item"]), rows, jc)
        cv = column_to_val(ch)
        return dict(dtype=inner, data=ch.data, validity=ok, sdict=ch.sdict,
                    lengths=ch.lengths, elem_valid=ch.elem_valid,
                    fields=cv.fields)
    raise InvalidOperationError(
        f".list.{op} is not supported on {v.dtype!r} (nested inner types "
        "support len/get/first/last)")


def _val_col(x) -> Column:
    """A Val (or Column) of a nested child as a Column."""
    if isinstance(x, Column):
        return x
    return Column(x.dtype, x.data, x.validity, x.sdict,
                  lengths=x.lengths, elem_valid=x.elem_valid,
                  fields=None if x.fields is None else
                  {k: _val_col(f) for k, f in x.fields.items()})


def elem_mask(v) -> torch.Tensor:
    """(cap, W) mask of the present (inside the length, non-null)
    elements."""
    m = _cols(v.data.shape[1], v.data) < v.lengths.unsqueeze(1)
    if v.elem_valid is not None:
        m = m & v.elem_valid
    return m


def _type_extreme(t: torch.dtype, low: bool):
    if t.is_floating_point:
        return -float("inf") if low else float("inf")
    if t == torch.bool:
        return not low
    info = torch.iinfo(t)
    return info.min if low else info.max


def compact_rows(keep: torch.Tensor, *arrays):
    """Each row's kept elements moved to its front, in order (a stable
    sort of ~keep along dim 1): (the arrays reordered, the kept counts)."""
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    return [torch.gather(a, 1, order) for a in arrays], \
        keep.sum(1).to(torch.int32)


def _sort_rows(data, m, in_len, desc: bool):
    """Each row's present values ascending (descending), nulls after
    them, padding last: (sorted data, the row order)."""
    if data.dtype == torch.bool:
        kv = data.to(torch.int8)
    else:
        kv = data
    zero = torch.zeros((), dtype=kv.dtype, device=kv.device)
    kv = torch.where(m, kv, zero)
    o1 = torch.sort(kv, dim=1, descending=desc, stable=True).indices
    rank = torch.where(~in_len, 2, torch.where(m, 0, 1)).to(torch.int8)
    o2 = torch.sort(torch.gather(rank, 1, o1), dim=1, stable=True).indices
    order = torch.gather(o1, 1, o2)
    return torch.gather(data, 1, order), order


def list_namespace_op(op: str, v, attrs: dict):
    """A `.list.<op>` of a list Val: a dict of the result Val's dtype,
    data, validity, sdict, lengths, elem_valid and fields."""
    if v.lengths is None:
        raise InvalidOperationError(
            f".list.{op} on non-list dtype {v.dtype!r}")
    if v.data is None and v.fields is not None:
        return _nested_list_namespace_op(op, v, attrs)
    inner: DataType = v.dtype.inner
    data, lens = v.data, v.lengths
    cap, W = data.shape
    dev = data.device
    row_valid = v.validity
    jidx = _cols(W, data)
    in_len = jidx < lens.unsqueeze(1)
    m = elem_mask(v)

    def flat(dtype, out, validity=None, sdict=None):
        return dict(dtype=dtype, data=out, validity=_and(validity, row_valid),
                    sdict=sdict)

    def flat_inner(out, validity=None):
        return flat(inner, out, validity, v.sdict)

    def listy(data2, lens2, ev2):
        return dict(dtype=v.dtype, data=data2, validity=row_valid,
                    sdict=v.sdict, lengths=lens2, elem_valid=ev2)

    def take(src):
        return torch.gather(data, 1, src.clamp(0, W - 1).long()
                            .expand(cap, -1))

    def take_m(src):
        return torch.gather(m, 1, src.clamp(0, W - 1).long()
                            .expand(cap, -1))

    if op in ("len", "n_elements"):
        return flat(UInt32, lens.to(torch.int64))
    if op == "sum":
        if inner.is_bool:
            return flat(UInt32, (m & data).sum(1))
        if inner.is_float:
            out = torch.where(m, data.to(torch.float64), 0.0).sum(1)
            return flat(inner, out.to(data.dtype))
        return flat(Int64, torch.where(m, data.to(torch.int64), 0).sum(1))
    if op == "mean":
        cnt = m.sum(1)
        s = torch.where(m, data.to(torch.float64), 0.0).sum(1)
        return flat(Float64, s / cnt.clamp(min=1), cnt > 0)
    if op in ("min", "max"):
        low = op == "max"
        x = data.to(torch.int32) if data.dtype == torch.bool else data
        sent = _type_extreme(x.dtype, low)
        red = torch.where(m, x, torch.full_like(x, sent))
        out = red.max(1).values if op == "max" else red.min(1).values
        has = m.any(1)
        out = torch.where(has, out, torch.zeros_like(out)).to(data.dtype)
        return flat_inner(out, has)
    if op in ("any", "all"):
        if not inner.is_bool:
            raise InvalidOperationError(f".list.{op} requires Boolean inner")
        if op == "any":
            return flat(Boolean, (m & data.bool()).any(1))
        return flat(Boolean, (~m | data.bool()).all(1))
    if op in ("first", "last", "get"):
        if op == "first":
            idx = torch.zeros_like(lens)
        elif op == "last":
            idx = (lens - 1).clamp(min=0)
        else:
            i = int(attrs.get("index", 0))
            idx = torch.full_like(lens, i) if i >= 0 else lens + i
        inb = (idx >= 0) & (idx < lens)
        ic = idx.clamp(0, W - 1).long().unsqueeze(1)
        out = torch.gather(data, 1, ic).squeeze(1)
        validity = inb
        if v.elem_valid is not None:
            validity = validity & torch.gather(v.elem_valid, 1, ic).squeeze(1)
        return flat_inner(out, validity)
    if op == "contains":
        item = attrs["item"]
        if inner.is_string:
            c = v.sdict.find(item) if v.sdict is not None else None
            out = (m & (data == (-2 if c is None else c))).any(1)
        else:
            out = (m & (data == item)).any(1)
        return flat(Boolean, out)
    if op in ("arg_min", "arg_max"):
        x = data.to(torch.int32) if data.dtype == torch.bool else data
        sent = _type_extreme(x.dtype, op == "arg_max")
        red = torch.where(m, x, torch.full_like(x, sent))
        out = red.argmin(1) if op == "arg_min" else red.argmax(1)
        return flat(UInt32, out, m.any(1))
    if op == "reverse":
        src = lens.unsqueeze(1) - 1 - jidx
        ev2 = None
        if v.elem_valid is not None:
            ev2 = torch.gather(v.elem_valid, 1,
                               src.clamp(0, W - 1).long()) & in_len
        return listy(take(src), lens, ev2)
    if op == "sort":
        data2, _ = _sort_rows(data, m, in_len,
                              bool(attrs.get("descending", False)))
        ev2 = None
        if v.elem_valid is not None:
            ev2 = jidx < m.sum(1, keepdim=True)
        return listy(data2, lens, ev2)
    if op in ("head", "slice", "tail"):
        if op == "head":
            off = torch.zeros_like(lens)
            ln = lens.clamp(max=int(attrs["n"]))
        elif op == "tail":
            ln = lens.clamp(max=int(attrs["n"]))
            off = lens - ln
        else:
            o = int(attrs.get("offset", 0))
            length = attrs.get("length")
            off = lens.clamp(max=o) if o >= 0 else (lens + o).clamp(min=0)
            avail = lens - off
            ln = avail if length is None else avail.clamp(max=int(length))
        src = off.unsqueeze(1) + jidx
        ev2 = None
        if v.elem_valid is not None:
            ev2 = torch.gather(v.elem_valid, 1, src.clamp(0, W - 1).long()) \
                & (jidx < ln.unsqueeze(1))
        return listy(take(src), ln.to(torch.int32), ev2)
    if op == "unique":
        # sorted within the row, the first of each run kept (polars'
        # default maintain_order=False); nulls, sorted after the values,
        # count as one value
        sd, _ = _sort_rows(data, m, in_len, False)
        nvalid = m.sum(1, keepdim=True)
        newrun = torch.ones_like(in_len)
        newrun[:, 1:] = sd[:, 1:] != sd[:, :-1]
        has_null = in_len & (jidx >= nvalid)
        keep = (newrun & in_len & ~has_null) | (has_null & (jidx == nvalid))
        (data2,), ln2 = compact_rows(keep, sd)
        ev2 = None
        if v.elem_valid is not None:
            ev2 = jidx < (keep & ~has_null).sum(1, keepdim=True)
        return listy(data2, ln2, ev2)
    if op == "join":
        raise InvalidOperationError(
            ".list.join is evaluated on the host (expr/nested.py)")
    if op in ("std", "var"):
        ddof = attrs.get("ddof", 1)
        cnt = m.sum(1)
        x = torch.where(m, data.to(torch.float64), 0.0)
        n = cnt.clamp(min=1)
        mean = x.sum(1) / n
        d2 = torch.where(m, (x - mean.unsqueeze(1)) ** 2, 0.0).sum(1)
        var = d2 / (n - ddof).clamp(min=1)
        return flat(Float64, var.sqrt() if op == "std" else var, cnt > ddof)
    if op == "median":
        sd, _ = _sort_rows(data, m, in_len, False)
        sd = sd.to(torch.float64)
        cnt = m.sum(1)
        pos = (cnt.to(torch.float64) - 1) * 0.5
        i0 = pos.floor().long().clamp(0, W - 1).unsqueeze(1)
        i1 = pos.ceil().long().clamp(0, W - 1).unsqueeze(1)
        lo = torch.gather(sd, 1, i0).squeeze(1)
        hi = torch.gather(sd, 1, i1).squeeze(1)
        return flat(Float64, (lo + hi) / 2, cnt > 0)
    if op == "n_unique":
        res = list_namespace_op("unique", v, {})
        return flat(UInt32, res["lengths"].to(torch.int64))
    if op == "count_matches":
        elem = attrs["element"]
        if inner.is_string:
            c = v.sdict.find(str(elem)) if v.sdict is not None else None
            tgt = -2 if c is None else c
        else:
            tgt = elem
        return flat(UInt32, (m & (data == tgt)).sum(1))
    if op == "diff":
        n = int(attrs.get("n", 1))
        prev = take(jidx - n)
        out = data - prev
        ev2 = m & (jidx - n >= 0) & take_m(jidx - n)
        if attrs.get("null_behavior", "ignore") == "drop":
            ln2 = (lens - n).clamp(min=0)
            src2 = (jidx + n).clamp(0, W - 1).expand(cap, -1)
            out = torch.gather(out, 1, src2)
            ev2 = torch.gather(ev2, 1, src2) & (jidx < ln2.unsqueeze(1))
            return listy(out, ln2.to(torch.int32), ev2)
        return listy(out, lens, ev2)
    if op == "shift":
        n = int(attrs.get("n", 1))
        inb = (jidx - n >= 0) & (jidx - n < lens.unsqueeze(1))
        return listy(take(jidx - n), lens, inb & take_m(jidx - n) & in_len)
    if op == "drop_nulls":
        (data2,), ln2 = compact_rows(m, data)
        return listy(data2, ln2, jidx < ln2.unsqueeze(1))
    if op == "gather":
        take_i = torch.tensor(list(attrs["indices"]), dtype=torch.int64,
                              device=dev)
        W2 = max(len(attrs["indices"]), 1)
        src = take_i.unsqueeze(0).expand(cap, len(attrs["indices"]))
        src = torch.where(src < 0, lens.unsqueeze(1) + src, src)
        inb = (src >= 0) & (src < lens.unsqueeze(1))
        return listy(take(src), torch.full_like(lens, W2),
                     inb & take_m(src))
    if op == "gather_every":
        n = int(attrs.get("n", 1))
        off = int(attrs.get("offset", 0))
        src = off + jidx * n
        inb = src < lens.unsqueeze(1)
        ln2 = torch.div(lens - off + n - 1, n, rounding_mode="floor") \
            .clamp(min=0)
        return listy(take(src), ln2.to(torch.int32), inb & take_m(src))
    if op == "sample":
        # each row's elements in a random order (uniform keys from a
        # seeded generator on the device, outside the length last), the
        # first n kept
        from ..expr.misc import random_generator
        n = int(attrs.get("n", 1))
        g = random_generator(attrs.get("seed"), dev)
        u = torch.rand((cap, W), generator=g, device=dev,
                       dtype=torch.float64)
        order = torch.sort(torch.where(in_len, u, 2.0), dim=1,
                           stable=True).indices
        ln2 = lens.clamp(max=n).to(torch.int32)
        return listy(torch.gather(data, 1, order), ln2,
                     torch.gather(m, 1, order) & (jidx < ln2.unsqueeze(1)))
    raise InvalidOperationError(f"unsupported .list op {op!r}")
