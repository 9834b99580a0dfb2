"""Process-wide telemetry on/off switch.

Lives in its own module so every obs submodule (and every instrumented
caller) can import it without touching the package root — no import cycles.
The check is one module-global read; instrumented hot paths test it FIRST
and skip all telemetry work when off, which is what the tier-1 overhead
guard (<5% step-time delta, tests/test_obs.py) measures against.

Default: enabled.  ``LIGHTCTR_TELEMETRY=0`` (or ``false``/``off``) in the
environment starts the process disabled.
"""

from __future__ import annotations

import contextlib
import os

_enabled: bool = os.environ.get("LIGHTCTR_TELEMETRY", "1").lower() not in (
    "0", "false", "off", "no",
)


def enabled() -> bool:
    """True when telemetry collection is on for this process."""
    return _enabled


def set_enabled(on: bool) -> bool:
    """Flip the switch; returns the PREVIOUS state (so callers can restore)."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    return prev


@contextlib.contextmanager
def override(on: bool):
    """Scoped enable/disable (tests, benchmark on/off comparisons)."""
    prev = set_enabled(on)
    try:
        yield
    finally:
        set_enabled(prev)
