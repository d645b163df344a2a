"""The `str` namespace (Slice E2).

The port of the JAX package's `_eval_str` (`expr/eval.py`): every op maps
the column's sorted dictionary once on the host, O(distinct strings),
into a lookup table (a code map, a value table, a list table) that the
device gathers by code. The gather is plain tensor indexing, as the JAX
package's `lut_gather` is plain indexing and no Pallas kernel. The ops
that return lists (`split`, `extract_all`, `extract_many`, `find_many`,
`chars`) build a (distinct, width) table of element codes, and those
that return structs (`extract_groups`, `split_exact`, `splitn`) one
code map per field. `str.concat`/`str.join` joins a column's live values
into one string (a scalar).
"""

from __future__ import annotations

import datetime as _pydt
import re as _re

import numpy as np
import torch

from ..batch import Column, storage_torch_dtype, width_for
from ..dtypes import Boolean, Date, Datetime, Float64, Int64, String, \
    Time, UInt32, List as ListT, Struct as StructT
from ..errors import ComputeError, InvalidOperationError
from ..ops import temporal as T
from ..strings import EMPTY_DICT, NULL_CODE, StringDict
from .eval import Val, _and_valid, _live_of, column_to_val, gather_codes

__all__ = ["eval_str", "dollar_refs_to_backrefs", "str_transform"]


def eval_str(e, v: Val, table) -> Val:
    op = e.attrs["op"]
    if v.dtype.is_binary or not v.dtype.is_string:
        raise InvalidOperationError(
            f".str.{op} on {v.dtype!r}"
            + (" (use .bin)" if v.dtype.is_binary else ""))
    sd = v.sdict or EMPTY_DICT
    code = v.data
    dev = code.device
    cidx = code.clamp(0, max(len(sd) - 1, 0)).long()

    def lut_gather(lut: np.ndarray, out_dt, validity=None) -> Val:
        stor = storage_torch_dtype(out_dt)
        if len(lut) == 0:
            data = torch.zeros(code.shape, dtype=stor, device=dev)
        else:
            data = torch.from_numpy(np.ascontiguousarray(lut)).to(dev)[cidx]
        return Val(out_dt, data.to(stor), _and_valid(v.validity, validity),
                   None, v.is_scalar, v.live)

    def mask_gather(ok: np.ndarray) -> torch.Tensor:
        if len(ok) == 0:
            return torch.zeros(code.shape, dtype=torch.bool, device=dev)
        return torch.from_numpy(ok).to(dev)[cidx]

    def remapped(nd: StringDict, remap: np.ndarray) -> Val:
        return Val(String, gather_codes(code, remap), v.validity, nd,
                   v.is_scalar, v.live)

    def opt_strings(fn) -> Val:
        """str -> Optional[str] per entry; None makes the row null."""
        mapped = [fn(s) for s in sd.values]
        keep = sorted({m for m in mapped if m is not None})
        index = {m: i for i, m in enumerate(keep)}
        remap = np.array([NULL_CODE if m is None else index[m]
                          for m in mapped], dtype=np.int32)
        data = gather_codes(code, remap)
        return Val(String, data, _and_valid(v.validity, data != NULL_CODE),
                   StringDict(np.array(keep, dtype=object)), v.is_scalar,
                   v.live)

    def list_of_strings(parts_fn) -> Val:
        """str -> list[str] per entry -> a List(String) column."""
        parts = [parts_fn(str(w)) for w in sd.values]
        W = width_for(max((len(p) for p in parts), default=1))
        flat = [s for p in parts for s in p]
        codes_flat, nd = StringDict.encode(np.array(flat, dtype=object))
        lut = np.zeros((max(len(parts), 1), W), dtype=np.int32)
        lens = np.zeros(max(len(parts), 1), dtype=np.int32)
        pos = 0
        for i, p in enumerate(parts):
            lut[i, :len(p)] = codes_flat[pos:pos + len(p)]
            lens[i] = len(p)
            pos += len(p)
        return Val(ListT(String), torch.from_numpy(lut).to(dev)[cidx],
                   v.validity, nd, v.is_scalar, v.live,
                   lengths=torch.from_numpy(lens).to(dev)[cidx])

    def struct_of_strings(fields_fn, names) -> Val:
        """str -> tuple[Optional[str], ...] -> a Struct of String fields."""
        tuples = {s: fields_fn(s) for s in sd.values}
        fields = {nm: opt_strings(lambda s, gi=gi: tuples[s][gi])
                  for gi, nm in enumerate(names)}
        return Val(StructT([(nm, String) for nm in names]), None,
                   v.validity, None, v.is_scalar, v.live, fields=fields)

    if op == "len_chars":
        return lut_gather(sd.map_to_array(len, np.int64), UInt32)
    if op == "len_bytes":
        return lut_gather(sd.map_to_array(lambda s: len(s.encode()),
                                          np.int64), UInt32)
    if op in ("to_uppercase", "to_lowercase", "to_titlecase", "strip_chars",
              "strip_chars_start", "strip_chars_end", "slice", "replace",
              "zfill", "pad_start", "pad_end", "reverse", "strip_prefix",
              "strip_suffix", "normalize", "escape_regex", "replace_many",
              "encode"):
        nd, remap = sd.map_to_strings(str_transform(op, e.attrs))
        return remapped(nd, remap)
    if op in ("starts_with", "ends_with", "contains", "count_matches"):
        pat = e.attrs["pat"]
        literal = e.attrs.get("literal", False)
        if op == "starts_with":
            f = lambda s: s.startswith(pat)  # noqa: E731
        elif op == "ends_with":
            f = lambda s: s.endswith(pat)  # noqa: E731
        elif op == "contains":
            if literal:
                f = lambda s: pat in s  # noqa: E731
            else:
                rx = _re.compile(pat)
                f = lambda s: rx.search(s) is not None  # noqa: E731
        elif literal:
            f = lambda s: s.count(pat)  # noqa: E731
        else:
            rx = _re.compile(pat)
            f = lambda s: len(rx.findall(s))  # noqa: E731
        if op == "count_matches":
            return lut_gather(sd.map_to_array(f, np.int64), UInt32)
        return lut_gather(sd.map_to_array(f, np.bool_), Boolean)
    if op == "split":
        by = e.attrs["by"]
        return list_of_strings(lambda s: s.split(by))
    if op == "decode":
        enc = e.attrs["encoding"]
        if enc not in ("hex", "base64"):
            raise InvalidOperationError(f"unknown encoding {enc!r}")

        def dec(s):
            import base64
            try:
                return bytes.fromhex(s).decode() if enc == "hex" \
                    else base64.b64decode(s).decode()
            except Exception:
                return None
        return opt_strings(dec)
    if op == "json_path_match":
        return opt_strings(_json_path(e.attrs["path"]))
    if op == "contains_any":
        pats = e.attrs["patterns"]
        if e.attrs.get("nocase"):
            lp = [p.lower() for p in pats]
            f = lambda s: any(p in s.lower() for p in lp)  # noqa: E731
        else:
            f = lambda s: any(p in s for p in pats)  # noqa: E731
        return lut_gather(sd.map_to_array(f, np.bool_), Boolean)
    if op == "find":
        pat = e.attrs["pat"]
        if e.attrs.get("literal"):
            f = lambda s: s.find(pat)  # noqa: E731
        else:
            rx = _re.compile(pat)

            def f(s):
                m = rx.search(s)
                return -1 if m is None else m.start()
        lut = sd.map_to_array(f, np.int64)
        return lut_gather(np.maximum(lut, 0), UInt32, mask_gather(lut >= 0))
    if op == "find_many":
        pats = e.attrs["patterns"]
        hits = {s: sorted(i for p in pats for i in _find_all(s, p))
                for s in sd.values}
        W = width_for(max((len(h) for h in hits.values()), default=1))
        lut = np.zeros((max(len(sd), 1), W), dtype=np.int64)
        lens = np.zeros(max(len(sd), 1), dtype=np.int32)
        for i, s in enumerate(sd.values):
            lut[i, :len(hits[s])] = hits[s]
            lens[i] = len(hits[s])
        return Val(ListT(UInt32), torch.from_numpy(lut).to(dev)[cidx],
                   v.validity, None, v.is_scalar, v.live,
                   lengths=torch.from_numpy(lens).to(dev)[cidx])
    if op == "extract_all":
        rx = _re.compile(e.attrs["pat"])
        return list_of_strings(lambda s: [m if isinstance(m, str) else m[0]
                                          for m in rx.findall(s)])
    if op == "extract_many":
        pats = e.attrs["patterns"]
        return list_of_strings(lambda s: [p for _, p in sorted(
            (i, p) for p in pats for i in _find_all(s, p))])
    if op == "chars":
        return list_of_strings(list)
    if op == "extract_groups":
        rx = _re.compile(e.attrs["pat"])
        by_idx = {i: nm for nm, i in rx.groupindex.items()}
        names = [by_idx.get(gi, str(gi)) for gi in range(1, rx.groups + 1)]

        def groups_of(s):
            m = rx.search(s)
            return (None,) * rx.groups if m is None else m.groups()
        return struct_of_strings(groups_of, names)
    if op in ("split_exact", "splitn"):
        by, n = e.attrs["by"], int(e.attrs["n"])
        nf = n + 1 if op == "split_exact" else n

        def fields_of(s):
            p = s.split(by) if op == "split_exact" else s.split(by, n - 1)
            return tuple(p[i] if i < len(p) else None for i in range(nf))
        return struct_of_strings(fields_of, [f"field_{i}" for i in range(nf)])
    if op == "str_concat":
        return _str_concat(e, v, table)
    if op == "to_time":
        fmt = e.attrs.get("format")

        def parse(s):
            try:
                t = _pydt.datetime.strptime(s, fmt).time() if fmt \
                    else _pydt.time.fromisoformat(s)
            except ValueError:
                return -1
            return ((t.hour * 3600 + t.minute * 60 + t.second)
                    * 1_000_000_000 + t.microsecond * 1000)
        lut = sd.map_to_array(parse, np.int64)
        return lut_gather(lut, Time, mask_gather(lut >= 0))
    if op == "json_decode":
        return _json_decode(v, sd, cidx)
    if op == "extract":
        rx = _re.compile(e.attrs["pat"])
        gi = e.attrs.get("group_index", 1)

        def grp(s):
            m = rx.search(s)
            return m.group(gi) if m else ""
        nd, remap = sd.map_to_strings(grp)
        out = remapped(nd, remap)
        matched = mask_gather(sd.map_to_array(
            lambda s: rx.search(s) is not None, np.bool_)) & (code >= 0)
        out.validity = _and_valid(v.validity, matched)
        return out
    if op == "to_integer":
        base = e.attrs.get("base", 10)

        def to_int(s):
            try:
                return int(s, base)
            except ValueError:
                return None
        parsed = [to_int(s) for s in sd.values]
        lut = np.array([p if p is not None else 0 for p in parsed], np.int64)
        ok = np.array([p is not None for p in parsed], dtype=bool)
        return lut_gather(lut, Int64, mask_gather(ok))
    if op == "to_decimal":
        def to_float(s):
            try:
                return float(s)
            except ValueError:
                return np.nan
        return lut_gather(sd.map_to_array(to_float, np.float64), Float64)
    if op in ("to_datetime", "to_date", "strptime"):
        return _parse_temporal(e, op, sd, lut_gather)
    raise ComputeError(f"unknown str op {op!r}")


def _parse_temporal(e, op: str, sd: StringDict, lut_gather) -> Val:
    """strptime / to_date / to_datetime: each distinct string parsed once
    (a Datetime is read as UTC)."""
    fmt = e.attrs.get("format")
    dtype = e.attrs.get("dtype")
    if isinstance(dtype, type):
        dtype = dtype()

    def parse(s, default_fmt):
        try:
            return _pydt.datetime.strptime(s, fmt or default_fmt)
        except ValueError:
            raise ComputeError(
                f"strptime: {s!r} does not match {fmt or default_fmt!r}") \
                from None
    if op == "to_date" or (op == "strptime" and dtype == Date):
        epoch = _pydt.date(1970, 1, 1)
        return lut_gather(sd.map_to_array(
            lambda s: (parse(s, "%Y-%m-%d").date() - epoch).days, np.int64),
            Date)
    tu = dtype.time_unit if isinstance(dtype, Datetime) else \
        e.attrs.get("time_unit", "us")
    scale = T.UNIT_PER_SECOND[tu]
    epoch = _pydt.datetime(1970, 1, 1)

    def ticks(s):
        d = parse(s, "%Y-%m-%dT%H:%M:%S") - epoch
        us = (d.days * 86_400 + d.seconds) * 1_000_000 + d.microseconds
        return us * (scale // 1_000_000) if scale >= 1_000_000 \
            else us // (1_000_000 // scale)
    return lut_gather(sd.map_to_array(ticks, np.int64), Datetime(tu))


def _find_all(s: str, p: str):
    """Every start of `p` in `s`, overlapping ones included."""
    i = s.find(p)
    while i >= 0:
        yield i
        i = s.find(p, i + 1)


def _json_path(path: str):
    import json as _json
    parts = [p for p in path.lstrip("$").lstrip(".").split(".") if p]

    def fn(s):
        try:
            obj = _json.loads(s)
        except ValueError:
            return None
        for p in parts:
            nm, idxs = p, []
            while nm.endswith("]"):
                nm, _, tail = nm.rpartition("[")
                idxs.insert(0, int(tail[:-1]))
            if nm:
                if not isinstance(obj, dict) or nm not in obj:
                    return None
                obj = obj[nm]
            for ix in idxs:
                if not isinstance(obj, list) or ix >= len(obj):
                    return None
                obj = obj[ix]
        if obj is None:
            return None
        return obj if isinstance(obj, str) else _json.dumps(obj)
    return fn


def _json_decode(v: Val, sd: StringDict, cidx: torch.Tensor) -> Val:
    """Each distinct string parsed once into a host column of the
    decoded values (lists and structs included), gathered by code."""
    import json as _json
    parsed = []
    for s in sd.values:
        try:
            parsed.append(None if s == "" else _json.loads(s))
        except ValueError:
            parsed.append(None)
    if not parsed:
        parsed = [None]
    col = Column.from_host(parsed, device=cidx.device).take(cidx)
    out = column_to_val(col)
    out.validity = _and_valid(_and_valid(col.validity, v.validity),
                              v.data >= 0)
    out.is_scalar, out.live = v.is_scalar, v.live
    return out


def _str_concat(e, v: Val, table) -> Val:
    """The live non-null values joined into one string (a scalar)."""
    delim = e.attrs.get("delimiter", "")
    ignore_nulls = e.attrs.get("ignore_nulls", True)
    mask = _live_of(v, table)
    mask = mask.expand(v.data.shape[0]) if v.data.shape[0] != 1 else mask[:1]
    codes = v.data[mask].cpu().numpy()
    valid = v.valid_or_true()[mask].cpu().numpy()
    dec = (v.sdict or EMPTY_DICT).decode(
        np.where(valid, codes, NULL_CODE).astype(np.int32))
    dev = v.data.device
    if not ignore_nulls and not valid.all():
        return Val(String, torch.full((1,), int(NULL_CODE), dtype=torch.int32,
                                      device=dev),
                   torch.zeros(1, dtype=torch.bool, device=dev), EMPTY_DICT,
                   True)
    joined = delim.join(x for x in dec if x is not None)
    return Val(String, torch.zeros(1, dtype=torch.int32, device=dev), None,
               StringDict(np.array([joined], dtype=object)), True)


def dollar_refs_to_backrefs(val: str) -> str:
    """Polars (Rust regex) replacement syntax ($1, ${name}, $$) as Python
    `re` backreferences (\\g<1>, \\g<name>, $)."""
    def sub(m):
        if m.group(0) == "$$":
            return "$"
        return f"\\g<{m.group(1) or m.group(2)}>"
    return _re.sub(r"\$\$|\$\{(\w+)\}|\$(\w+)", sub, val)


def str_transform(op: str, attrs: dict):
    """The str -> str function of a dictionary-mapping op."""
    if op == "to_uppercase":
        return str.upper
    if op == "to_lowercase":
        return str.lower
    if op == "to_titlecase":
        return str.title
    if op in ("strip_chars", "strip_chars_start", "strip_chars_end"):
        c = attrs.get("characters")
        fn = {"strip_chars": str.strip, "strip_chars_start": str.lstrip,
              "strip_chars_end": str.rstrip}[op]
        return lambda s: fn(s, c)
    if op == "slice":
        off, ln = attrs.get("offset", 0), attrs.get("length")
        if ln is None:
            return lambda s: s[off:]
        return lambda s: s[off:off + ln] if off >= 0 else s[off:][:ln]
    if op == "replace":
        pat, val = attrs["pat"], attrs["value"]
        n = attrs.get("n", 1)
        if attrs.get("literal"):
            return lambda s: s.replace(pat, val, -1 if n < 0 else n)
        rx = _re.compile(pat)
        rep = dollar_refs_to_backrefs(val)
        return lambda s: rx.sub(rep, s, 0 if n < 0 else n)
    if op == "zfill":
        ln = attrs["length"]
        return lambda s: s.zfill(ln)
    if op in ("pad_start", "pad_end"):
        ln, fc = attrs["length"], attrs.get("fill_char", " ")
        if op == "pad_start":
            return lambda s: s.rjust(ln, fc)
        return lambda s: s.ljust(ln, fc)
    if op == "reverse":
        return lambda s: s[::-1]
    if op == "strip_prefix":
        pat = attrs["pat"]
        return lambda s: s[len(pat):] if s.startswith(pat) else s
    if op == "strip_suffix":
        pat = attrs["pat"]
        return lambda s: s[:-len(pat)] if pat and s.endswith(pat) else s
    if op == "normalize":
        import unicodedata
        form = attrs.get("form", "NFC")
        return lambda s: unicodedata.normalize(form, s)
    if op == "escape_regex":
        return _re.escape
    if op == "replace_many":
        pairs = list(zip(attrs["patterns"], attrs["values"]))

        def many(s):
            for p, r in pairs:
                s = s.replace(p, r)
            return s
        return many
    if op == "encode":
        enc = attrs["encoding"]
        if enc == "hex":
            return lambda s: s.encode().hex()
        if enc == "base64":
            import base64
            return lambda s: base64.b64encode(s.encode()).decode()
        raise InvalidOperationError(f"unknown encoding {enc!r}")
    raise ComputeError(f"unknown str op {op!r}")
