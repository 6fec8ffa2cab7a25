"""The relation engine's error types (docs/DESIGN.md §12).

Only the two types the critical-points path raises are here: the base
:class:`RelationError` and the one data error, :class:`RelationWidthError`.
The fault-recovery taxonomy (launch, sync-timeout, upload, device-loss and
poisoned errors) comes with the port of the engine's recovery ladder.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class RelationError(RuntimeError):
    """Base of the engine's structured error taxonomy.

    Carries optional machine-readable fields identifying the fault point:
    ``relation`` (e.g. ``"VV"``), ``segment`` (int segment id), ``shard``
    (int shard index), ``attempt`` (1-based retry attempt)."""

    def __init__(self, message: str = "", *,
                 relation: Optional[str] = None,
                 segment: Optional[int] = None,
                 shard: Optional[int] = None,
                 attempt: Optional[int] = None):
        super().__init__(message)
        self.relation = relation
        self.segment = segment
        self.shard = shard
        self.attempt = attempt

    @property
    def fields(self) -> Dict[str, Any]:
        """The structured context as a dict (``None`` entries omitted)."""
        out = {"relation": self.relation, "segment": self.segment,
               "shard": self.shard, "attempt": self.attempt}
        return {k: v for k, v in out.items() if v is not None}

    def __str__(self) -> str:  # message first, then the structured tail
        base = super().__str__()
        tail = " ".join(f"{k}={v!r}" for k, v in self.fields.items())
        return f"{base} [{tail}]" if tail else base


class RelationWidthError(RelationError, ValueError):
    """A produced relation row holds more entries than the preallocated
    relation-array width ``deg[relation]`` (paper §4.6): the compacted
    ``M`` row would silently drop neighbours. Raised by
    :meth:`RelationEngine._integrate` with the ``deg=`` override to use.
    Non-retryable: the same mesh reproduces it on every arm."""
