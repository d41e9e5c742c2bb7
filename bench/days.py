"""Day numbers of the port's date encoding: day 0 = 1992-01-01."""
from __future__ import annotations

import datetime
from typing import Tuple

EPOCH = datetime.date(1992, 1, 1)


def day(iso: str) -> int:
    """Day number of an ISO date."""
    return (datetime.date.fromisoformat(iso) - EPOCH).days


# Q1's cutoff is 1998-12-01 minus DELTA days (TPC-H clause 2.4.1.3)
Q1_BASE = day("1998-12-01")


def year_range(year: int) -> Tuple[int, int]:
    """[first day, first day of the next year) of ``year``."""
    return day(f"{year}-01-01"), day(f"{year + 1}-01-01")
