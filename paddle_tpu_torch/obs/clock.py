"""The one duration clock: every serving timestamp is read from
:func:`now`, so request times and run walls share one axis."""

from __future__ import annotations

import time

__all__ = ["now"]


def now() -> float:
    """Seconds on the process-wide monotonic clock (arbitrary epoch)."""
    return time.perf_counter()
