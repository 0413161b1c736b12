"""Go-style duration parsing ("10s", "10m", "2h30m") for CLI parity with
the reference's ``flags.Duration`` flags (reference rescheduler.go:63-75)."""

from __future__ import annotations

import re

_UNIT = {
    "ns": 1e-9,
    "us": 1e-6,
    "µs": 1e-6,
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
}
_TOKEN = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")


def parse_duration(s: str | float | int) -> float:
    """Duration string → seconds. Bare numbers are taken as seconds."""
    if isinstance(s, (int, float)):
        return float(s)
    s = s.strip()
    try:
        return float(s)
    except ValueError:
        pass
    pos = 0
    total = 0.0
    for m in _TOKEN.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration {s!r}")
        total += float(m.group(1)) * _UNIT[m.group(2)]
        pos = m.end()
    if pos != len(s) or pos == 0:
        raise ValueError(f"invalid duration {s!r}")
    return total
