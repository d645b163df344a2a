"""Frame pretty-printing (polars-style box table)."""

from __future__ import annotations

from ..config import CONFIG


def _fmt_val(v, max_len: int) -> str:
    if v is None:
        return "null"
    if isinstance(v, float):
        s = f"{v:.6g}"
    elif isinstance(v, bool):
        s = "true" if v else "false"
    else:
        s = str(v)
    if len(s) > max_len:
        s = s[: max_len - 1] + "…"
    return s


def format_frame(df) -> str:
    try:
        h = df.height
    except Exception:
        h = 0
    max_rows = CONFIG.fmt_max_rows
    shown = df.head(max_rows) if h > max_rows else df
    d = shown._table.to_numpy_dict()
    names = list(d.keys())[: CONFIG.fmt_max_cols]
    dtypes = [repr(df.schema[n]) for n in names]
    rows = []
    n = len(d[names[0]]) if names else 0
    for i in range(n):
        rows.append([_fmt_val(d[k][i], CONFIG.fmt_str_len) for k in names])
    widths = []
    for j, nm in enumerate(names):
        w = max(len(nm), len(dtypes[j]),
                max((len(r[j]) for r in rows), default=0))
        widths.append(min(w, CONFIG.fmt_str_len))
    header = f"shape: ({h}, {df.width})\n"
    sep = "┌" + "┬".join("─" * (w + 2) for w in widths) + "┐\n"
    name_row = "│" + "│".join(f" {nm:<{w}} " for nm, w in zip(names, widths)) + "│\n"
    dt_row = "│" + "│".join(f" {dt:<{w}} " for dt, w in zip(dtypes, widths)) + "│\n"
    mid = "╞" + "╪".join("═" * (w + 2) for w in widths) + "╡\n"
    body = ""
    for r in rows:
        body += "│" + "│".join(f" {v:<{w}} " for v, w in zip(r, widths)) + "│\n"
    if h > n:
        body += "│" + "│".join(f" {'…':<{w}} " for w in widths) + "│\n"
    bot = "└" + "┴".join("─" * (w + 2) for w in widths) + "┘"
    return header + sep + name_row + dt_row + mid + body + bot


def glimpse(df) -> str:
    """One line per column: its name, dtype and first values."""
    lines = [f"Rows: {df.height}", f"Columns: {df.width}"]
    d = df.head(CONFIG.fmt_max_rows).to_dict()
    for n in df.columns:
        vals = ", ".join(_fmt_val(v, CONFIG.fmt_str_len) for v in d[n])
        lines.append(f"$ {n} <{df.schema[n]!r}> {vals}")
    return "\n".join(lines)
