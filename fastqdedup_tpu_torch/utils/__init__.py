"""Host utilities: ragged batch manipulation, timing, logging."""

from .timing import Timer  # noqa: F401
