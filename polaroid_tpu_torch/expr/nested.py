"""The list and struct expression kinds (Slice E2).

The port of the JAX package's nested kinds in `expr/eval.py`: `list`
(the list namespace, whose masked dim-1 ops live in `ops/nested.py`),
`list_eval`, `list_filter`, `list_set`, `concat_list`, `repeat_by`,
`int_ranges`, `reshape` and the struct kinds (`struct`,
`struct_with_fields`, `struct_rename`, `struct_json_encode`,
`struct_unnest`, `struct_field`, `field`).

`list.join` and `struct.json_encode` build strings on the host: they
do so for the distinct rows only (`torch.unique` over the rows on the
device, the inverse maps them back).
"""

from __future__ import annotations

import numpy as np
import torch

from ..batch import Column, Table, storage_torch_dtype, width_for
from ..dtypes import DataType, Int64, String, \
    Array as ArrayT, List as ListT, Struct as StructT, supertype
from ..errors import ComputeError, InvalidOperationError
from ..ops import nested as N
from ..strings import EMPTY_DICT, StringDict
from . import meta
from .eval import Val, _align_strings, _and_valid, _type_bounds, cast_val, \
    column_to_val, eval_expr, val_to_column
from .expr import Expr

__all__ = ["eval_nested", "cast_nested", "eval_list"]


def _bcast(v: Val, cap: int) -> Val:
    """A scalar Val broadcast to `cap` rows (a row-wise one unchanged)."""
    if not v.is_scalar:
        return v
    out = column_to_val(val_to_column(v, cap))
    out.live = None
    return out


def _from_res(res: dict, v: Val) -> Val:
    return Val(res["dtype"], res.get("data"), res.get("validity"),
               res.get("sdict"), v.is_scalar, v.live,
               lengths=res.get("lengths"), elem_valid=res.get("elem_valid"),
               fields=res.get("fields"))


def cast_nested(v: Val, dst: DataType) -> Val:
    """List(A) -> List(B) by the elements, Struct -> Struct by the
    fields, Array <-> List by relabeling."""
    src = v.dtype
    if isinstance(src, ListT) and isinstance(dst, ListT):
        if repr(src.inner) == repr(dst.inner) or v.data is None:
            return Val(dst, v.data, v.validity, v.sdict, v.is_scalar, v.live,
                       v.lengths, v.elem_valid, v.fields)
        flat = cast_val(Val(src.inner, v.data.reshape(-1), None, v.sdict),
                        dst.inner, strict=False)
        return Val(ListT(flat.dtype) if not isinstance(dst, ArrayT) else dst,
                   flat.data.reshape(v.data.shape), v.validity, flat.sdict,
                   v.is_scalar, v.live, v.lengths, v.elem_valid)
    if isinstance(src, StructT) and isinstance(dst, StructT):
        want = dict(dst.fields)
        fields = {n: cast_val(f, want[n]) if n in want else f
                  for n, f in v.fields.items()}
        return Val(StructT([(n, f.dtype) for n, f in fields.items()]), None,
                   v.validity, None, v.is_scalar, v.live, fields=fields)
    raise InvalidOperationError(f"cast {src!r} -> {dst!r}")


def eval_list(e: Expr, v: Val, table: Table) -> Val:
    """`.list.<op>`: the masked dim-1 ops of `ops/nested.py`; `to_list`,
    `item`, `to_struct` and `join` here."""
    op = e.attrs["op"]
    if op == "to_list":
        if isinstance(v.dtype, ArrayT):
            return Val(ListT(v.dtype.inner), v.data, v.validity, v.sdict,
                       v.is_scalar, v.live, v.lengths, v.elem_valid, v.fields)
        return v
    if v.lengths is None:
        raise InvalidOperationError(f".list.{op} on {v.dtype!r}")
    if op == "item":
        live = table.row_mask() if v.live is None else v.live
        lv = live if v.validity is None else live & v.validity
        ln = torch.where(lv, v.lengths, 1)
        if bool((ln > 1).any()):
            raise ComputeError(
                ".list.item: a sublist has more than one element")
        if not e.attrs.get("allow_empty", False) and bool((ln < 1).any()):
            raise ComputeError(".list.item: empty sublist (pass "
                               "allow_empty=True for null)")
        return eval_list(Expr("list", e.children, op="get", index=0), v,
                         table)
    if op == "to_struct":
        names = e.attrs.get("fields")
        W = v.data.shape[1]
        nf = int(v.lengths.max()) if names is None else len(names)
        names = list(names) if names is not None else \
            [f"field_{i}" for i in range(max(nf, 1))]
        m = N.elem_mask(v)
        fields = {nm: Val(v.dtype.inner, v.data[:, min(i, W - 1)],
                          m[:, min(i, W - 1)] & (i < W), v.sdict)
                  for i, nm in enumerate(names)}
        return Val(StructT([(nm, v.dtype.inner) for nm in names]), None,
                   v.validity, None, v.is_scalar, v.live, fields=fields)
    if op == "join":
        return _list_join(v, e.attrs.get("separator", ""))
    return _from_res(N.list_namespace_op(op, v, e.attrs), v)


def _list_join(v: Val, sep: str) -> Val:
    """List(String) rows joined by `sep`; a null element makes the row
    null (polars' default). Only the distinct rows are joined."""
    if not v.dtype.inner.is_string:
        raise InvalidOperationError(".list.join requires List(String)")
    m = N.elem_mask(v)
    in_len = torch.arange(v.data.shape[1], device=v.data.device) \
        .unsqueeze(0) < v.lengths.unsqueeze(1)
    rows = torch.where(in_len, v.data, -2).to(torch.int64)
    has_null = (in_len & ~m).any(1, keepdim=True)
    key = torch.cat([rows, has_null.to(torch.int64)], 1)
    uniq, inv = torch.unique(key, dim=0, return_inverse=True)
    words = (v.sdict or EMPTY_DICT).values
    out = []
    for row in uniq.cpu().numpy():
        if row[-1]:
            out.append(None)
        else:
            out.append(sep.join(str(words[c]) for c in row[:-1] if c >= 0))
    mask = np.array([o is not None for o in out], dtype=bool)
    codes, sd = StringDict.encode(np.array(out, dtype=object), mask)
    data = torch.from_numpy(codes).to(v.data.device)[inv]
    return Val(String, data, _and_valid(v.validity, data >= 0), sd,
               v.is_scalar, v.live)


def _list_eval(e: Expr, v: Val, table: Table, ctx: str) -> Val:
    """`.list.eval(expr)`: an elementwise expression over the flattened
    (capacity * width) elements, reshaped back; `pl.element().filter(p)`
    keeps the elements where p holds, moved to each row's front."""
    if v.lengths is None:
        raise InvalidOperationError(f".list.eval on non-list {v.dtype!r}")
    inner_e = e.children[1]
    while inner_e.kind in ("alias", "name_keep"):
        inner_e = inner_e.children[0]
    cap, W = v.data.shape
    if inner_e.kind == "expr_filter" and \
            meta.is_elementwise(inner_e.children[0]) and \
            meta.is_elementwise(inner_e.children[1]):
        val_l = _list_eval(Expr("list_eval", (e.children[0],
                                              inner_e.children[0])),
                           v, table, ctx)
        pred_l = _list_eval(Expr("list_eval", (e.children[0],
                                               inner_e.children[1])),
                            v, table, ctx)
        keep = N.elem_mask(Val(pred_l.dtype, pred_l.data, None, None,
                               lengths=v.lengths,
                               elem_valid=pred_l.elem_valid)) & \
            pred_l.data.bool()
        ev = val_l.elem_valid if val_l.elem_valid is not None else \
            torch.ones_like(keep)
        (data2, ev2), ln2 = N.compact_rows(keep, val_l.data, ev)
        ev2 = ev2 & (torch.arange(W, device=keep.device).unsqueeze(0)
                     < ln2.unsqueeze(1))
        return Val(val_l.dtype, data2, v.validity, val_l.sdict, v.is_scalar,
                   v.live, lengths=ln2, elem_valid=ev2)
    if not meta.is_elementwise(inner_e):
        raise InvalidOperationError(
            ".list.eval supports elementwise expressions and a top-level "
            "pl.element().filter(...); explode for anything else")
    in_len = torch.arange(W, device=v.data.device).unsqueeze(0) < \
        v.lengths.unsqueeze(1)
    evalid = v.elem_valid if v.elem_valid is not None else in_len
    fcol = Column(v.dtype.inner, v.data.reshape(cap * W),
                  (evalid & in_len).reshape(cap * W), v.sdict)
    ft = Table(["__pt_element__"], {"__pt_element__": fcol}, cap * W, None,
               in_len.reshape(cap * W), device=v.data.device)
    rv = eval_expr(inner_e, ft, "select")
    data2 = rv.data.expand(cap * W).reshape(cap, W)
    ev2 = None
    if rv.validity is not None:
        ev2 = rv.validity.expand(cap * W).reshape(cap, W) & in_len
    return Val(ListT(rv.dtype), data2, v.validity, rv.sdict, v.is_scalar,
               v.live, lengths=v.lengths, elem_valid=ev2)


def _list_filter(e: Expr, table: Table, ctx: str) -> Val:
    v = eval_expr(e.children[0], table, ctx)
    if v.lengths is None:
        raise InvalidOperationError(f".list.filter on {v.dtype!r}")
    pv = _list_eval(e, v, table, ctx)
    keep = N.elem_mask(Val(pv.dtype, pv.data, None, None, lengths=v.lengths,
                           elem_valid=pv.elem_valid)) & pv.data.bool()
    W = v.data.shape[1]
    jidx = torch.arange(W, device=keep.device).unsqueeze(0)
    ev = v.elem_valid if v.elem_valid is not None else torch.ones_like(keep)
    (data2, ev2), ln2 = N.compact_rows(keep, v.data, ev)
    return Val(v.dtype, data2, v.validity, v.sdict, v.is_scalar, v.live,
               lengths=ln2, elem_valid=ev2 & (jidx < ln2.unsqueeze(1)))


def _list_set(e: Expr, table: Table, ctx: str) -> Val:
    """Per-row set algebra of two list columns: dictionaries aligned,
    each element's membership in the other row by a batched
    `torch.searchsorted` over that row sorted, kept elements moved to the
    front and made unique."""
    how = e.attrs["how"]
    a = eval_expr(e.children[0], table, ctx)
    b = eval_expr(e.children[1], table, ctx)
    if a.lengths is None or b.lengths is None:
        raise InvalidOperationError("list.set_* requires two list columns")

    def clean(x):
        if x.elem_valid is None:
            return x
        r = N.list_namespace_op("drop_nulls", x, {})
        return Val(r["dtype"], r["data"], r["validity"], x.sdict,
                   x.is_scalar, x.live, lengths=r["lengths"])
    a, b = clean(a), clean(b)
    if a.dtype.inner.is_string:
        fa, fb = _align_strings(Val(a.dtype.inner, a.data.reshape(-1), None,
                                    a.sdict),
                                Val(b.dtype.inner, b.data.reshape(-1), None,
                                    b.sdict))
        a = Val(a.dtype, fa.data.reshape(a.data.shape), a.validity, fa.sdict,
                a.is_scalar, a.live, lengths=a.lengths)
        b = Val(b.dtype, fb.data.reshape(b.data.shape), b.validity, fa.sdict,
                b.is_scalar, b.live, lengths=b.lengths)
    cap, Wa = a.data.shape
    Wb = b.data.shape[1]
    bd = b.data.to(a.data.dtype)
    dev = a.data.device
    in_a = torch.arange(Wa, device=dev).unsqueeze(0) < a.lengths.unsqueeze(1)
    in_b = torch.arange(Wb, device=dev).unsqueeze(0) < b.lengths.unsqueeze(1)
    hi = _type_bounds(a.data.dtype)[1]

    def member(vals, rows_sorted, W):
        pos = torch.searchsorted(rows_sorted, vals.contiguous())
        return torch.gather(rows_sorted, 1, pos.clamp(0, W - 1)) == vals

    bs = torch.sort(torch.where(in_b, bd, torch.full_like(bd, hi)), 1).values
    a_in_b = member(a.data, bs, Wb)
    if how in ("union", "symmetric_difference"):
        as_ = torch.sort(torch.where(in_a, a.data,
                                     torch.full_like(a.data, hi)), 1).values
        b_in_a = member(bd, as_, Wa)
        data = torch.cat([a.data, bd], 1)
        keep = torch.cat([in_a, in_b & ~b_in_a], 1) if how == "union" else \
            torch.cat([in_a & ~a_in_b, in_b & ~b_in_a], 1)
    elif how == "intersection":
        data, keep = a.data, in_a & a_in_b
    else:  # difference
        data, keep = a.data, in_a & ~a_in_b
    (data2,), ln2 = N.compact_rows(keep, data)
    pre = Val(ListT(a.dtype.inner), data2, _and_valid(a.validity, b.validity),
              a.sdict, a.is_scalar, a.live, lengths=ln2)
    res = N.list_namespace_op("unique", pre, {})
    return Val(res["dtype"], res["data"], res["validity"], a.sdict,
               a.is_scalar, a.live, lengths=res["lengths"],
               elem_valid=res.get("elem_valid"))


def _concat_list(e: Expr, table: Table, ctx: str) -> Val:
    """Flat and list parts joined into one list per row, each row's
    elements moved to its front."""
    cap = table.capacity
    vals = [_bcast(eval_expr(c, table, ctx), cap) for c in e.children]
    inner = None
    for v in vals:
        d = v.dtype.inner if isinstance(v.dtype, ListT) else v.dtype
        inner = d if inner is None else supertype(inner, d)
    if inner.is_string:
        cur = Val(String, torch.zeros(1, dtype=torch.int32,
                                      device=table.device), None,
                  EMPTY_DICT, True)
        for v in vals:
            flatv = Val(String, v.data.reshape(-1), None, v.sdict)
            cur, _ = _align_strings(cur, flatv)
    parts, ins, evs, lens = [], [], [], []
    for v in vals:
        if isinstance(v.dtype, ListT):
            d2 = v.data
            if inner.is_string:
                d2 = _align_strings(cur, Val(String, d2.reshape(-1), None,
                                             v.sdict))[1].data \
                    .reshape(d2.shape)
            elif repr(v.dtype.inner) != repr(inner):
                d2 = cast_val(Val(v.dtype.inner, d2.reshape(-1), None,
                                  v.sdict), inner).data.reshape(d2.shape)
            W = d2.shape[1]
            inl = torch.arange(W, device=d2.device).unsqueeze(0) < \
                v.lengths.unsqueeze(1)
            parts.append(d2)
            ins.append(inl)
            evs.append(inl if v.elem_valid is None else v.elem_valid & inl)
            lens.append(v.lengths)
        else:
            cv = _align_strings(cur, v)[1] if inner.is_string else \
                cast_val(v, inner)
            parts.append(cv.data.expand(cap).unsqueeze(1))
            ins.append(torch.ones(cap, 1, dtype=torch.bool,
                                  device=table.device))
            evs.append(cv.valid_or_true().expand(cap).unsqueeze(1))
            lens.append(torch.ones(cap, dtype=torch.int32,
                                   device=table.device))
    data = torch.cat([p.to(parts[0].dtype) if not inner.is_string else p
                      for p in parts], 1)
    inl = torch.cat(ins, 1)
    ev = torch.cat(evs, 1)
    (data2, ev2), ln2 = N.compact_rows(inl, data, ev & inl)
    row_valid = None
    for v in vals:
        if isinstance(v.dtype, ListT) and v.validity is not None:
            row_valid = _and_valid(row_valid, v.validity)
    stor = storage_torch_dtype(inner)
    any_valid = any(v.validity is not None or isinstance(v.dtype, ListT)
                    for v in vals)
    return Val(ListT(inner), data2.to(stor), row_valid,
               cur.sdict if inner.is_string else None, False, None,
               lengths=ln2, elem_valid=ev2 if any_valid else None)


def _repeat_by(e: Expr, table: Table, ctx: str) -> Val:
    cap = table.capacity
    v = _bcast(eval_expr(e.children[0], table, ctx), cap)
    nv = eval_expr(e.children[1], table, ctx)
    counts = nv.data.expand(cap).to(torch.int32)
    counts = torch.where(table.row_mask(), counts.clamp(min=0), 0)
    W = width_for(int(counts.max()) if cap else 1)
    data2 = v.data.unsqueeze(1).expand(cap, W).contiguous()
    ev = None
    if v.validity is not None:
        ev = v.validity.unsqueeze(1).expand(cap, W) & \
            (torch.arange(W, device=counts.device).unsqueeze(0)
             < counts.unsqueeze(1))
    return Val(ListT(v.dtype), data2, nv.validity, v.sdict, False, v.live,
               lengths=counts, elem_valid=ev)


def _int_ranges(e: Expr, table: Table, ctx: str) -> Val:
    """Per-row integer ranges [start, end) by `step`; `dtype` relabels
    the elements (Date for `date_ranges`)."""
    s = eval_expr(e.children[0], table, ctx)
    en = eval_expr(e.children[1], table, ctx)
    step = int(e.attrs.get("step", 1))
    cap = table.capacity
    lo = s.data.expand(cap).to(torch.int64)
    hi = en.data.expand(cap).to(torch.int64)
    if step > 0:
        counts = -torch.div(lo - hi, step, rounding_mode="floor")
    else:
        counts = -torch.div(hi - lo, -step, rounding_mode="floor")
    counts = torch.where(table.row_mask(), counts.clamp(min=0), 0) \
        .to(torch.int32)
    W = width_for(int(counts.max()) if cap else 1)
    data2 = lo.unsqueeze(1) + torch.arange(
        W, dtype=torch.int64, device=lo.device).unsqueeze(0) * step
    out_dt = e.attrs.get("dtype") or Int64
    return Val(ListT(out_dt), data2.to(storage_torch_dtype(out_dt)),
               _and_valid(s.validity, en.validity), None, False, None,
               lengths=counts)


def _has_field_ref(e: Expr) -> bool:
    return e.kind == "field" or any(_has_field_ref(c) for c in e.children)


def _bind_field_refs(e: Expr) -> Expr:
    if e.kind == "field":
        return Expr("col", name=f"__pt_field_{e.attrs['name']}")
    if not e.children:
        return e
    return Expr(e.kind, tuple(_bind_field_refs(c) for c in e.children),
                **e.attrs)


def _struct_of(v: Val, what: str) -> Val:
    if v.fields is None:
        raise InvalidOperationError(f".struct.{what} on non-struct "
                                    f"{v.dtype!r}")
    return v


def _json_encode(v: Val, cap: int) -> Val:
    """Each row's struct as a JSON object, built for the distinct rows
    of the fields' values."""
    import json as _json
    keys, hosts = [], []
    for f in v.fields.values():
        d = f.data.expand(cap)
        keys.append(d.to(torch.int64) if not d.is_floating_point()
                    else d.to(torch.float64).view(torch.int64))
        keys.append(f.valid_or_true().expand(cap).to(torch.int64))
    uniq, inv = torch.unique(torch.stack(keys, 1), dim=0, return_inverse=True)
    first = torch.full((uniq.shape[0],), cap, dtype=torch.int64,
                       device=inv.device).scatter_reduce_(
        0, inv, torch.arange(cap, device=inv.device), "amin")
    for n, f in v.fields.items():
        col = val_to_column(f, cap).take(first)
        hosts.append((n, col.to_numpy(len(first))))
    txt = np.array([_json.dumps({n: (h[i].item() if isinstance(
        h[i], np.generic) else h[i]) for n, h in hosts})
        for i in range(len(first))], dtype=object)
    codes, sd = StringDict.encode(txt, np.ones(len(txt), bool))
    return Val(String, torch.from_numpy(codes).to(inv.device)[inv],
               v.validity, sd, v.is_scalar, v.live)


def _reshape(e: Expr, table: Table, ctx: str) -> Val:
    """reshape((n | -1, w)): a flat column into fixed-width Array rows;
    (n,) of a flat column is the identity. The element count is one host
    sync."""
    dims = e.attrs["dims"]
    v = eval_expr(e.children[0], table, ctx)
    nested = v.lengths is not None or v.fields is not None
    if len(dims) == 1 and not nested:
        return v
    if len(dims) != 2 or nested:
        raise InvalidOperationError(
            "reshape takes a flat column to (rows, width)")
    if ctx != "select":
        raise InvalidOperationError(
            "reshape changes the frame length; only valid in a select")
    n0, w = dims
    if w <= 0:
        raise InvalidOperationError(
            "only the first reshape dimension may be -1")
    cap = table.capacity
    mask = (v.live if v.live is not None else table.row_mask()).expand(cap)
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    data = v.data.expand(cap)[order]
    n_live = int(mask.sum())
    if n_live % w != 0:
        raise InvalidOperationError(
            f"cannot reshape {n_live} elements into rows of width {w}")
    rows = n_live // w
    if n0 not in (-1, rows):
        raise InvalidOperationError(
            f"cannot reshape {n_live} elements into ({n0}, {w})")
    rcap = cap // w

    def rows_of(x, fill):
        x2 = x[:rcap * w].reshape(rcap, w)
        if rcap < cap:
            x2 = torch.cat([x2, x2.new_full((cap - rcap, w), fill)])
        return x2
    ev = None if v.validity is None else \
        rows_of(v.validity.expand(cap)[order], False)
    return Val(ArrayT(v.dtype, w), rows_of(data, 0), None, v.sdict, False,
               live=torch.arange(cap, device=data.device) < rows,
               lengths=torch.full((cap,), w, dtype=torch.int32,
                                  device=data.device), elem_valid=ev)


def eval_nested(e: Expr, table: Table, ctx: str) -> Val:
    k = e.kind
    cap = table.capacity
    if k == "list":
        return eval_list(e, eval_expr(e.children[0], table, ctx), table)
    if k == "list_eval":
        return _list_eval(e, eval_expr(e.children[0], table, ctx), table, ctx)
    if k == "list_filter":
        return _list_filter(e, table, ctx)
    if k == "list_set":
        return _list_set(e, table, ctx)
    if k == "concat_list":
        return _concat_list(e, table, ctx)
    if k == "repeat_by":
        return _repeat_by(e, table, ctx)
    if k == "int_ranges":
        return _int_ranges(e, table, ctx)
    if k == "reshape":
        return _reshape(e, table, ctx)
    if k == "struct":
        fields = {n: _bcast(eval_expr(c, table, ctx), cap)
                  for n, c in zip(e.attrs["names"], e.children)}
        return Val(StructT([(n, f.dtype) for n, f in fields.items()]), None,
                   None, None, False, fields=fields)
    if k == "struct_with_fields":
        v = _struct_of(eval_expr(e.children[0], table, ctx), "with_fields")
        fields = dict(v.fields)
        t2 = table
        if any(_has_field_ref(c) for c in e.children[1:]):
            # pl.field(...) reads the struct's own fields: they ride along
            # as mangled columns of a widened table
            t2 = table
            for fn, fv in fields.items():
                t2 = t2.with_column(f"__pt_field_{fn}",
                                    val_to_column(_bcast(fv, cap), cap))
        for name, ch in zip(e.attrs["names"], e.children[1:]):
            fields[name] = _bcast(eval_expr(_bind_field_refs(ch), t2, ctx),
                                  cap)
        return Val(StructT([(n, f.dtype) for n, f in fields.items()]), None,
                   v.validity, None, v.is_scalar, v.live, fields=fields)
    if k == "struct_rename":
        v = _struct_of(eval_expr(e.children[0], table, ctx), "rename_fields")
        olds = list(v.fields)
        if e.attrs.get("names") is None:
            fn = e.attrs.get("fn")
            if fn is not None:
                new = [str(fn(n)) for n in olds]
            else:
                pre, suf = e.attrs.get("prefix", ""), e.attrs.get("suffix", "")
                new = [f"{pre}{n}{suf}" for n in olds]
        else:
            new = list(e.attrs["names"])
        if len(new) != len(olds):
            raise ComputeError(f"rename_fields: {len(new)} names for "
                               f"{len(olds)} fields")
        fields = {nn: v.fields[on] for nn, on in zip(new, olds)}
        return Val(StructT([(n, f.dtype) for n, f in fields.items()]), None,
                   v.validity, None, v.is_scalar, v.live, fields=fields)
    if k == "struct_json_encode":
        v = _struct_of(eval_expr(e.children[0], table, ctx), "json_encode")
        return _json_encode(v, cap)
    if k == "struct_unnest":
        # a select expands the fields into columns; evaluated bare, the
        # struct itself
        return eval_expr(e.children[0], table, ctx)
    if k == "struct_field":
        v = _struct_of(eval_expr(e.children[0], table, ctx), "field")
        name = e.attrs["name"]
        if name not in v.fields:
            raise ComputeError(f"struct has no field {name!r}")
        f = v.fields[name]
        return Val(f.dtype, f.data, _and_valid(f.validity, v.validity),
                   f.sdict, v.is_scalar, v.live, f.lengths, f.elem_valid,
                   f.fields)
    if k == "field":
        raise InvalidOperationError(
            "pl.field(...) is only valid inside struct.with_fields")
    raise InvalidOperationError(f"unknown nested kind {k!r}")
