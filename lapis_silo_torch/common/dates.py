"""Sortable uint32 date encoding: (year << 16) | (month << 12) | day.

0 encodes NULL. Parity with reference src/silo/common/date.cpp: invalid
dates (bad delimiters, month/day out of range, non-numeric) silently become
NULL rather than raising.
"""

from __future__ import annotations

NULL_DATE = 0


import re

_STOI = re.compile(r"\s*([+-]?\d+)")


def _stoi(text: str) -> int:
    """std::stoi semantics: parse the leading integer, ignore trailing
    junk, raise if none (so '03T00:00:00' parses as 3)."""
    match = _STOI.match(text)
    if not match:
        raise ValueError(text)
    return int(match.group(1))


def string_to_date(value: str) -> int:
    if not value:
        return NULL_DATE
    parts = value.split("-")
    if len(parts) < 3:
        return NULL_DATE
    try:
        year = _stoi(parts[0])
        month = _stoi(parts[1])
        day = _stoi(parts[2])
    except ValueError:
        return NULL_DATE
    if month == 0 or month > 12:
        return NULL_DATE
    if day == 0 or day > 31:
        return NULL_DATE
    return (year << 16) + (month << 12) + day


def date_to_string(date: int) -> str | None:
    if date == 0:
        return None
    year = date >> 16
    month = (date >> 12) & 0xF
    day = date & 0xFFF
    return f"{year:04d}-{month:02d}-{day:02d}"
