"""Streams derived from the run's ``--seed``: any whole number, negative or
far past 32 bits, gives its own stream for each purpose."""

from __future__ import annotations

import hashlib


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose (``tags``) of the run's ``seed``."""
    text = "/".join([str(int(seed))] + [str(t) for t in tags])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1
