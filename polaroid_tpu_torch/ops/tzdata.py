"""Time-zone offset tables for tz-aware Datetime columns.

The port of the JAX package's `ops/tzdata.py`. A Datetime column stores
UTC epochs; its time zone changes how wall-clock fields are derived.
Each zone's transition table (instant, UTC offset, DST offset) is built
once on the host from `zoneinfo`, by probing every day from 1900 to 2100
and bisecting each change to the second, and cached; a fixed offset
("+05:30", "UTC-04:00") needs no zone database. On the device an
offset is one `torch.searchsorted` into the table (a few hundred
entries), with no per-row host work.
"""

from __future__ import annotations

import functools
import re
from datetime import datetime, timedelta

import numpy as np
import torch

from ..errors import ComputeError
from . import temporal as T

_START = -2208988800          # 1900-01-01T00:00:00Z
_END = 4102444800             # 2100-01-01T00:00:00Z
_DAY = 86400

_FIXED = re.compile(r"(?:UTC)?([+-])(\d{2}):?(\d{2})$")


@functools.lru_cache(maxsize=64)
def offset_table(tz_name: str):
    """(transitions s, utcoffset s, dst s) as numpy arrays; offsets[i]
    applies to the instants in [transitions[i], transitions[i+1])."""
    if tz_name in ("UTC", "utc", "Etc/UTC", "GMT"):
        return (np.array([_START], np.int64), np.array([0], np.int32),
                np.array([0], np.int32))
    m = _FIXED.fullmatch(tz_name)
    if m:
        sign = 1 if m.group(1) == "+" else -1
        off = sign * (int(m.group(2)) * 3600 + int(m.group(3)) * 60)
        return (np.array([_START], np.int64), np.array([off], np.int32),
                np.array([0], np.int32))
    try:
        from zoneinfo import ZoneInfo
        tz = ZoneInfo(tz_name)
    except Exception as exc:
        raise ComputeError(f"unknown time zone {tz_name!r}: {exc}")

    def probe(ts: int):
        d = datetime.fromtimestamp(ts, tz)
        return (int(d.utcoffset().total_seconds()),
                int((d.dst() or timedelta()).total_seconds()))

    trans = [_START]
    cur = probe(_START)
    offs = [cur[0]]
    dsts = [cur[1]]
    t = _START
    while t < _END:
        t2 = t + _DAY
        nxt = probe(t2)
        if nxt != cur:
            lo, hi = t, t2
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if probe(mid) != cur:
                    hi = mid
                else:
                    lo = mid
            trans.append(hi)
            offs.append(nxt[0])
            dsts.append(nxt[1])
            cur = nxt
        t = t2
    return (np.asarray(trans, np.int64), np.asarray(offs, np.int32),
            np.asarray(dsts, np.int32))


_DEVICE_TABLES = {}


def device_table(tz_name: str, device) -> tuple:
    """The zone's table as int64 tensors on `device`: (transitions,
    offsets, dst offsets, base offsets), copied once per device."""
    key = (tz_name, str(device))
    if key not in _DEVICE_TABLES:
        trans, offs, dsts = offset_table(tz_name)
        o = offs.astype(np.int64)
        d = dsts.astype(np.int64)
        _DEVICE_TABLES[key] = tuple(torch.from_numpy(a).to(device)
                                    for a in (trans, o, d, o - d))
    return _DEVICE_TABLES[key]


def _lookup(sec: torch.Tensor, trans: torch.Tensor, vals: torch.Tensor
            ) -> torch.Tensor:
    """vals[i] of the interval holding each instant (seconds)."""
    idx = (torch.searchsorted(trans, sec.contiguous(), right=True) - 1) \
        .clamp(0, trans.shape[0] - 1)
    return vals[idx]


def utc_offset(x: torch.Tensor, time_unit: str, tz_name: str, *,
               dst_only: bool = False, base_only: bool = False
               ) -> torch.Tensor:
    """Each element's UTC offset (in `time_unit` ticks) at the UTC
    instants `x`."""
    trans, offs, dsts, base = device_table(tz_name, x.device)
    per_s = T.UNIT_PER_SECOND[time_unit]
    sec = torch.div(x.to(torch.int64), per_s, rounding_mode="floor")
    vals = dsts if dst_only else base if base_only else offs
    return _lookup(sec, trans, vals).to(x.dtype) * per_s


def localize(x: torch.Tensor, time_unit: str, tz_name: str) -> torch.Tensor:
    """UTC epoch -> local wall-clock 'epoch' (the instant whose UTC civil
    fields equal the local ones)."""
    return x + utc_offset(x, time_unit, tz_name)


def delocalize(wall: torch.Tensor, time_unit: str, tz_name: str
               ) -> torch.Tensor:
    """Local wall-clock 'epoch' -> UTC epoch, in two fixed-point steps:
    at a DST fold the earlier offset wins, in a gap the offset before
    the gap applies (the JAX package's rule, polars' ambiguous=
    'earliest')."""
    e0 = wall - utc_offset(wall, time_unit, tz_name)
    return wall - utc_offset(e0, time_unit, tz_name)
