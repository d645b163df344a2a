"""Civil-calendar arithmetic on epoch counts, on the device.

The port of the JAX package's `ops/temporal.py`: branch-free integer
arithmetic on epoch days and epoch counts (Howard Hinnant's civil
calendar), so the `dt` namespace runs as torch ops over whole columns
with no host round trip. Epochs before 1970 are negative: every
division here floors (`torch.div(..., rounding_mode="floor")`, as the
JAX package's `jnp.floor_divide`), never truncates.

One difference: a week truncation (`truncate("1w")`) starts on Monday
for a Datetime as for a Date. The JAX package truncates a Datetime to
epoch-aligned weeks, which start on Thursdays (its `truncate_epoch` has
no week offset), and a Date to Mondays.
"""

from __future__ import annotations

import re

import torch

SECONDS_PER_DAY = 86_400
UNIT_PER_SECOND = {"ms": 1_000, "us": 1_000_000, "ns": 1_000_000_000}
# epoch day 0 (1970-01-01) is a Thursday; day -3 is a Monday
_MONDAY_SHIFT = 3


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def days_to_civil(z: torch.Tensor):
    """Epoch days -> (year, month, day), each int32."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def civil_to_days(y, m, d) -> torch.Tensor:
    """(year, month, day) -> epoch days (int32)."""
    y = y.to(torch.int64)
    m = m.to(torch.int64)
    d = d.to(torch.int64)
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


def per_day(time_unit: str) -> int:
    return UNIT_PER_SECOND[time_unit] * SECONDS_PER_DAY


def epoch_to_days(value: torch.Tensor, time_unit: str) -> torch.Tensor:
    """Datetime epoch count -> epoch days (floor), int32."""
    return _fdiv(value.to(torch.int64), per_day(time_unit)).to(torch.int32)


def time_of_day(value: torch.Tensor, time_unit: str) -> torch.Tensor:
    """Datetime epoch count -> count within the day (non-negative)."""
    return torch.remainder(value, per_day(time_unit))


def weekday(days: torch.Tensor) -> torch.Tensor:
    """ISO weekday 1..7 (Monday 1) from epoch days."""
    return (torch.remainder(days.to(torch.int64) + 3, 7) + 1).to(torch.int32)


def ordinal_day(days: torch.Tensor) -> torch.Tensor:
    y, _, _ = days_to_civil(days)
    one = torch.ones_like(y)
    return (days.to(torch.int64) - civil_to_days(y, one, one) + 1) \
        .to(torch.int32)


def _weeks_in_iso_year(y: torch.Tensor) -> torch.Tensor:
    """52 or 53: 53 when Jan 1 is a Thursday, or a Wednesday of a leap
    year (the p(y) day-of-week polynomial)."""
    y = y.to(torch.int64)

    def p(v):
        return torch.remainder(v + _fdiv(v, 4) - _fdiv(v, 100)
                               + _fdiv(v, 400), 7)
    return torch.where((p(y) == 4) | (p(y - 1) == 3), 53, 52)


def iso_week(days: torch.Tensor) -> torch.Tensor:
    """ISO-8601 week number."""
    doy = ordinal_day(days).to(torch.int64)
    wd = weekday(days).to(torch.int64)
    raw = _fdiv(doy - wd + 10, 7)
    y, _, _ = days_to_civil(days)
    week = torch.where(raw < 1, _weeks_in_iso_year(y - 1),
                       torch.where(raw > _weeks_in_iso_year(y), 1, raw))
    return week.to(torch.int32)


_EVERY_UNIT_COUNTS = {
    "ns": 1, "us": 1_000, "ms": 1_000_000, "s": 1_000_000_000,
    "m": 60 * 1_000_000_000, "h": 3_600 * 1_000_000_000,
    "d": 86_400 * 1_000_000_000, "w": 7 * 86_400 * 1_000_000_000,
}


def parse_every(every: str):
    """A polars duration string ('1h', '15m', '1mo', '1y', '3i') ->
    ('fixed', nanoseconds) or ('months', n); an 'i' count is returned as
    raw units."""
    total_ns = 0
    months = 0
    for num, unit in re.findall(r"(\d+)(mo|ns|us|ms|s|m|h|d|w|q|y|i)",
                                every):
        n = int(num)
        if unit == "mo":
            months += n
        elif unit == "q":
            months += 3 * n
        elif unit == "y":
            months += 12 * n
        elif unit == "i":
            total_ns += n
        else:
            total_ns += n * _EVERY_UNIT_COUNTS[unit]
    if months and total_ns:
        raise ValueError(f"cannot mix month and sub-month units in {every!r}")
    if months:
        return ("months", months)
    return ("fixed", total_ns)


def _truncate_months(days: torch.Tensor, n: int) -> torch.Tensor:
    """Epoch days -> the first day of their n-month bucket (int32)."""
    y, m, _ = days_to_civil(days)
    total = y.to(torch.int64) * 12 + (m.to(torch.int64) - 1)
    total = _fdiv(total, n) * n
    ny = _fdiv(total, 12)
    nm = total - ny * 12 + 1
    return civil_to_days(ny, nm, torch.ones_like(nm))


def truncate_epoch(value: torch.Tensor, time_unit: str, every: str
                   ) -> torch.Tensor:
    """Datetime epochs truncated to `every` (weeks start on Monday)."""
    kind, n = parse_every(every)
    if kind == "fixed":
        step = n // (1_000_000_000 // UNIT_PER_SECOND[time_unit]) \
            if time_unit != "ns" else n
        step = max(step, 1)
        if every.endswith("w") and step % (7 * per_day(time_unit)) == 0:
            shift = _MONDAY_SHIFT * per_day(time_unit)
            return _fdiv(value + shift, step) * step - shift
        return _fdiv(value, step) * step
    d0 = _truncate_months(epoch_to_days(value, time_unit), n)
    return d0.to(value.dtype) * per_day(time_unit)


def truncate_days(days: torch.Tensor, every: str) -> torch.Tensor:
    """Date epoch days truncated to `every` (weeks start on Monday)."""
    kind, n = parse_every(every)
    if kind == "fixed":
        step = max(n // (86_400 * 1_000_000_000), 1)
        if every.endswith("w") and step % 7 == 0:
            return (_fdiv(days.to(torch.int64) + _MONDAY_SHIFT, step) * step
                    - _MONDAY_SHIFT).to(torch.int32)
        return (_fdiv(days.to(torch.int64), step) * step).to(torch.int32)
    return _truncate_months(days, n)
