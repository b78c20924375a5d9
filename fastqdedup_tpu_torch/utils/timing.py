"""Phase wall-clock timing for the pipeline's INFO log lines.

The log format (a rounded ``datetime.timedelta`` per phase) is part of the
drop-in parity surface (capability of reference ``__init__.py:42-51``).
"""

import datetime
import time


class Timer:
    """Stopwatch that restarts on every read.

    ``get_difference()`` returns the whole-second timedelta since the last
    read (or construction) and begins the next interval.
    """

    __slots__ = ("_last",)

    def __init__(self) -> None:
        self._last = time.monotonic()

    def get_difference(self) -> datetime.timedelta:
        now = time.monotonic()
        elapsed, self._last = now - self._last, now
        return datetime.timedelta(seconds=round(elapsed))
