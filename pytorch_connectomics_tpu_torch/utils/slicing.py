"""Python-style channel-slice selectors ("0:1", "-1:", ":", "2") used by
activations and ensemble configuration (the port's copy of ``parse_slice``
from ``pytorch_connectomics_tpu/utils/slicing.py``)."""

from __future__ import annotations

from typing import Optional


def parse_slice(spec: Optional[str]) -> slice:
    """'a:b' / ':' / 'a:' / ':b' / 'i' -> slice object (channel axis)."""
    if spec is None or spec == ":" or spec == "":
        return slice(None)
    s = str(spec).strip()
    if ":" not in s:
        i = int(s)
        stop = i + 1 if i != -1 else None
        return slice(i, stop)
    lo, _, hi = s.partition(":")
    return slice(int(lo) if lo else None, int(hi) if hi else None)
