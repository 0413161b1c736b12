"""Kubernetes resource-quantity parsing.

The reference reads quantities through k8s ``resource.Quantity`` and plans
on CPU MilliValues (reference nodes/nodes.go:149-165). This module is the
framework's equivalent: parse the canonical k8s quantity grammar
(plain/decimal numbers, binary suffixes Ki..Ei, decimal suffixes k..E, and
the milli suffix ``m``) into exact integers.
"""

from __future__ import annotations

from fractions import Fraction

_BINARY = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
_DECIMAL = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 1000),
    "": Fraction(1),
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
}


def parse_quantity(s: str | int | float) -> Fraction:
    """Parse a k8s quantity string into an exact Fraction of base units."""
    if isinstance(s, (int, float)):
        return Fraction(s)
    s = s.strip()
    if not s:
        raise ValueError("empty quantity")
    for suffix, mult in _BINARY.items():
        if s.endswith(suffix):
            return Fraction(s[: -len(suffix)]) * mult
    # decimal suffixes: longest first not needed (all 1 char); handle exponent
    # forms like 1e3 by letting Fraction parse them via float-free path
    last = s[-1]
    if last in _DECIMAL and not last.isdigit():
        return Fraction(s[:-1]) * _DECIMAL[last]
    if "e" in s or "E" in s:
        mantissa, _, exp = s.replace("E", "e").partition("e")
        return Fraction(mantissa) * Fraction(10) ** int(exp)
    return Fraction(s)


def parse_cpu_millis(s: str | int | float) -> int:
    """CPU quantity → integer millicores (the reference's MilliValue,
    nodes/nodes.go:149-165). Rounds up like k8s ``MilliValue`` does for
    sub-milli values."""
    q = parse_quantity(s) * 1000
    return int(-(-q.numerator // q.denominator))  # ceil


def parse_memory_bytes(s: str | int | float) -> int:
    """Memory quantity → integer bytes (ceil)."""
    q = parse_quantity(s)
    return int(-(-q.numerator // q.denominator))
