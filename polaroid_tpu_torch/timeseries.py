"""Finance time-series operations.

The port of the JAX package's `timeseries.py` (the capability of
`crates/polars-timeseries/`: `vwap.rs`, `twap.rs`, `resample.rs`,
`session.rs`): VWAP, TWAP, OHLCV bars and trading-session labels and
filters, composed of the engine's dynamic windows, group-bys, windows
over partitions and when/then, so every one runs on the device.
"""

from __future__ import annotations

from typing import Optional

from .expr.expr import Expr, col, lit, when

__all__ = ["vwap", "twap", "resample_ohlcv", "session_id",
           "filter_trading_hours"]


def vwap(df, price: str = "price", volume: str = "volume",
         by=None, every: Optional[str] = None,
         time_column: str = "timestamp"):
    """Volume-weighted average price (reference: vwap.rs). With `every`,
    computes per time bucket; with `by`, per group; both combine."""
    expr = ((col(price) * col(volume)).sum() /
            col(volume).sum()).alias("vwap")
    if every is not None:
        gb = df.group_by_dynamic(time_column, every=every, group_by=by)
        return gb.agg(expr, col(volume).sum().alias("total_volume"))
    if by is not None:
        return df.group_by(by).agg(expr,
                                   col(volume).sum().alias("total_volume"))
    return df.select(expr)


def twap(df, price: str = "price", time_column: str = "timestamp",
         by=None, every: Optional[str] = None):
    """Time-weighted average price: sum(p_i * dt_i) / sum(dt_i) with
    dt_i the interval to the next observation (reference: twap.rs).
    Intervals are computed per group/bucket via shift(-1)."""
    over_keys = []
    if by is not None:
        over_keys = [by] if isinstance(by, str) else list(by)
    nxt = col(time_column).shift(-1)
    if over_keys:
        nxt = col(time_column).shift(-1).over(*over_keys)
    dt_expr = (nxt - col(time_column)).dt.total_microseconds() \
        .fill_null(0).alias("__dt_us")
    df2 = df.with_columns(dt_expr)
    expr = ((col(price) * col("__dt_us")).sum() /
            col("__dt_us").sum()).alias("twap")
    if every is not None:
        gb = df2.group_by_dynamic(time_column, every=every, group_by=by)
        return gb.agg(expr)
    if by is not None:
        return df2.group_by(by).agg(expr)
    return df2.select(expr)


def resample_ohlcv(df, every: str, time_column: str = "timestamp",
                   price: str = "price", volume: Optional[str] = "volume",
                   by=None):
    """OHLCV bars at the given frequency (reference: resample.rs
    multi_frequency_resample)."""
    aggs = [
        col(price).first().alias("open"),
        col(price).max().alias("high"),
        col(price).min().alias("low"),
        col(price).last().alias("close"),
    ]
    if volume is not None:
        aggs.append(col(volume).sum().alias("volume"))
    gb = df.group_by_dynamic(time_column, every=every, group_by=by)
    return gb.agg(*aggs)


_SESSIONS = {
    # UTC trading sessions (reference: session.rs)
    "asia": (0, 8),
    "europe": (7, 16),
    "us": (13, 21),
}


def session_id(time_column: str = "timestamp") -> Expr:
    """Label each row with its trading session (UTC hours)."""
    h = col(time_column).dt.hour()
    return (when((h >= 13) & (h < 21)).then(lit("us"))
            .when((h >= 7) & (h < 13)).then(lit("europe"))
            .otherwise(lit("asia"))).alias("session")


def filter_trading_hours(df, session: str, time_column: str = "timestamp"):
    lo, hi = _SESSIONS[session]
    h = col(time_column).dt.hour()
    return df.filter((h >= lo) & (h < hi))
