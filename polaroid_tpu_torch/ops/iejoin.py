"""Inequality join (`join_where`): dominance counts over a wavelet tree.

The port of the JAX package's `ops/iejoin.py` (capability analogue of the
reference's IEJoin, `polars-ops/src/frame/join/iejoin/mod.rs:206-382`,
Khayyat et al.). The pairs are enumerated without the cross product:

  predicate 1 (la OP1 ra): the right rows sorted by ra (the live ones
      reversed for lt/le) put each left row's matches in a prefix of
      that order, whose length P_i is one binary search;
  predicate 2 (lb OP2 rb): a wavelet tree (`ops/wavelet.py`) over each
      right row's rank by rb, laid out in ra order, counts each left
      row's matches within its prefix (`wavelet_count_lt`) and selects
      the k-th of them for every output slot (`wavelet_select`).

Predicates past the first two filter the pair table. Both sides' rows
are sorted by (dead, key words) with kernel F (`merge_sort_words`, three
key words: the dead flag and the two halves of the orderable 64-bit
code); one permutation and one gather give the order and the sorted
keys, where the JAX package sorts each key twice, and the inverse of the
rb order is one scatter, not a sort.

The port runs eagerly: the JAX package's cache of jitted programs and
its flattened tables (`iejoin.py:178-265`) are not kept. The count phase
reads the output size back once (the one sync); the assemble phase then
enumerates the pairs and gathers both sides.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..batch import Table
from ..config import capacity_for
from ..dtypes import supertype
from ..errors import ComputeError
from ..expr.eval import Val, cast_val, eval_expr
from .keycode import U32, orderable_i64
from .merge_sort import merge_sort_words
from .search import searchsorted
from .wavelet import build_wavelet, wavelet_count_lt, wavelet_select

__all__ = ["iejoin_tables", "iejoin_pairs"]

_I64_MAX = (1 << 63) - 1
_SIGN64 = -(1 << 63)


def _encode_pair(lv: Val, rv: Val, capL: int, capR: int):
    """Both sides cast to their supertype and encoded as signed int64
    codes with the values' order, with their validity (the caller masks
    the nulls)."""
    if lv.dtype.is_string or rv.dtype.is_string:
        raise ComputeError("join_where inequality on string keys is not "
                           "supported")
    st = supertype(lv.dtype, rv.dtype)
    lv, rv = cast_val(lv, st), cast_val(rv, st)

    def enc(v, cap):
        validity = None if v.validity is None else v.validity.expand(cap)
        return orderable_i64(v.data.expand(cap), st), validity

    (la, lval), (ra, rval) = enc(lv, capL), enc(rv, capR)
    return la, ra, lval, rval


def _prefix_len(rsorted: torch.Tensor, nlive: torch.Tensor,
                lkey: torch.Tensor, op: str) -> torch.Tensor:
    """Each left row's count of live right rows with `la OP ra`, as the
    length of a prefix of the right order (ascending for gt/ge, whose
    matches are the smallest ra; the caller reverses it for lt/le)."""
    if op == "gt":       # ra <  la
        p = searchsorted(rsorted, lkey, "left")
    elif op == "ge":     # ra <= la
        p = searchsorted(rsorted, lkey, "right")
    elif op == "lt":     # ra >  la  (a suffix of ascending order)
        p = nlive - searchsorted(rsorted, lkey, "right")
    elif op == "le":     # ra >= la
        p = nlive - searchsorted(rsorted, lkey, "left")
    else:
        raise ComputeError(f"not an inequality: {op!r}")
    return torch.minimum(p.clamp(min=0), nlive)


def _order(key: torch.Tensor, dead: torch.Tensor, nlive: torch.Tensor):
    """(permutation, sorted key): the rows sorted stably by (dead, key)
    by kernel F, and the key in that order with the dead rows as the
    int64 maximum, so the whole array ascends."""
    u = key ^ _SIGN64
    perm = merge_sort_words([dead, (u >> 32) & U32, u & U32], 3,
                            perm_only=True)[0]
    pos = torch.arange(key.shape[0], device=key.device)
    return perm, torch.where(pos < nlive, key[perm],
                             torch.full_like(key, _I64_MAX))


def _counts(la, lb, lmask, ra, rb, rmask, op1: str, op2: Optional[str]):
    """The count phase: (matches per left row, the state the assemble
    phase enumerates them from)."""
    capR = ra.shape[0]
    dev = ra.device
    nlive = rmask.sum()
    dead = (~rmask).to(torch.int64)
    order_a, ra_sorted = _order(ra, dead, nlive)
    if op1 in ("lt", "le"):
        # matches are the largest ra: reverse the live prefix (dead rows
        # stay at the end)
        pos = torch.arange(capR, device=dev)
        order_a = order_a[torch.where(pos < nlive, nlive - 1 - pos, pos)]
    P = torch.where(lmask, _prefix_len(ra_sorted, nlive, la, op1), 0)
    if op2 is None:
        return P, (order_a, None, None, None, None, P)
    order_b, rb_sorted = _order(rb, dead, nlive)
    # each right row's position in the rb order: one scatter
    rank_b = torch.empty_like(order_b)
    rank_b.scatter_(0, order_b, torch.arange(capR, device=dev))
    tables = build_wavelet(rank_b[order_a])
    # K: the rb rank where the matches of `lb OP2 rb` start or stop
    if op2 in ("gt", "lt"):
        side = "left" if op2 == "gt" else "right"
    elif op2 in ("ge", "le"):
        side = "right" if op2 == "ge" else "left"
    else:
        raise ComputeError(f"not an inequality: {op2!r}")
    low_side = op2 in ("gt", "ge")      # matches are the ranks below K
    K = torch.minimum(searchsorted(rb_sorted, lb, side), nlive)
    C = wavelet_count_lt(tables, torch.zeros_like(P), P, K)
    m = torch.where(lmask, C if low_side else P - C, 0)
    return m, (order_a, order_b, tables, C, low_side, P)


def iejoin_pairs(la, lb, lmask, ra, rb, rmask, op1: str,
                 op2: Optional[str]):
    """(left rows, right rows, pair count) of every matching pair: for
    each left row in order, its matches in the right order of the
    driving predicate (the rb order with two)."""
    from .join import _expand_rows
    capL, capR = la.shape[0], ra.shape[0]
    m, (order_a, order_b, tables, C, low_side, P) = _counts(
        la, lb, lmask, ra, rb, rmask, op1, op2)
    m = m.to(torch.int64)
    moff = torch.cumsum(m, 0)
    total = int(moff[-1]) if capL else 0        # the one readback
    out_cap = capacity_for(max(total, 1))
    li = _expand_rows(m, moff, out_cap).clamp(0, capL - 1)
    k = torch.arange(out_cap, device=la.device)
    j = k - (moff[li] - m[li])
    if op2 is None:
        ridx = order_a[j.clamp(0, capR - 1)]
    else:
        # the j-th match of row li: the (base + j)-th smallest rb rank in
        # its prefix [0, P), base 0 for ranks below K, C for those above
        base = torch.zeros_like(j) if low_side else C[li]
        sel = (base + j).clamp(0, capR - 1)
        rank = wavelet_select(tables, torch.zeros_like(sel),
                              P[li].clamp(min=1), sel)
        ridx = order_b[rank.clamp(0, capR - 1)]
    return li, ridx, total


def iejoin_tables(left: Table, right: Table,
                  preds: Sequence[Tuple], post, suffix: str) -> Table:
    """join_where: `preds` are (left expr, op, right expr) inequalities
    (op lt/le/gt/ge, left OP right), `post` further predicates over the
    joined table. The first two inequalities drive the enumeration; the
    rest filter the pairs with `post`."""
    capL, capR = left.capacity, right.capacity
    lmask, rmask = left.row_mask(), right.row_mask()
    le1, op1, re1 = preds[0]
    la, ra, lval, rval = _encode_pair(eval_expr(le1, left, "select"),
                                      eval_expr(re1, right, "select"),
                                      capL, capR)
    lmask = lmask if lval is None else lmask & lval
    rmask = rmask if rval is None else rmask & rval
    op2 = lb = rb = None
    if len(preds) > 1:
        le2, op2, re2 = preds[1]
        lb, rb, lval, rval = _encode_pair(eval_expr(le2, left, "select"),
                                          eval_expr(re2, right, "select"),
                                          capL, capR)
        lmask = lmask if lval is None else lmask & lval
        rmask = rmask if rval is None else rmask & rval
    li, ridx, total = iejoin_pairs(la, lb, lmask, ra, rb, rmask, op1, op2)
    out_cap = li.shape[0]
    names, cols = [], {}
    for n in left.names:
        names.append(n)
        cols[n] = left.cols[n].take(li)
    for n in right.names:
        out_name = f"{n}{suffix}" if n in cols else n
        names.append(out_name)
        cols[out_name] = right.cols[n].take(ridx)
    out = Table(names, cols, out_cap, total, None, device=left.device)
    # the predicates past the first two, and the others: a filter
    conj = None
    for lex, op, rex in preds[2:]:
        from ..expr.expr import Expr
        p = Expr("binary", (lex, _suffix_expr(rex, set(left.names), suffix)),
                 op=op)
        conj = p if conj is None else conj & p
    for p in post:
        conj = p if conj is None else conj & p
    if conj is not None:
        from ..api.frame import DataFrame
        out = DataFrame._from_table(out).filter(conj)._table
    return out


def _suffix_expr(e, lnames, suffix: str):
    """A right-side expression with its column references renamed to
    their names in the joined table."""
    from ..expr.expr import Expr
    if e.kind == "col":
        n = e.attrs["name"]
        return Expr("col", (), name=f"{n}{suffix}" if n in lnames else n)
    if not e.children:
        return e
    return Expr(e.kind, tuple(_suffix_expr(c, lnames, suffix)
                              for c in e.children), **e.attrs)
