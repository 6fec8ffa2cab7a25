"""Structured exception taxonomy for the relation engine (docs/DESIGN.md
§12).

Every engine-raised failure is a :class:`RelationError` carrying
machine-readable context — which ``relation``, which ``segment``, which
``shard``, and on which ``attempt`` the failure happened — so recovery
code can branch on fields instead of parsing messages. The taxonomy
mirrors the fault points of the producer pipeline:

``LaunchError``
    A device kernel launch failed. ``transient=True`` marks it retryable
    under the engine's bounded-backoff policy; ``transient=False`` is a
    hard device-arm failure that feeds the per-relation circuit breaker.
``SyncTimeoutError``
    The sync watchdog (``sync_timeout_s``) gave up waiting for a
    dispatched launch to become ready. The launch is failed, waiters
    wake, and the segments re-dispatch.
``PoolUploadError``
    Uploading a host block into the device block pool failed (device
    OOM). The pool shard is cleared and the upload retried; a second
    failure serves the read un-pooled.
``DeviceLostError``
    A whole shard's device is gone. Non-transient by definition: the
    shard's segments are re-homed onto a surviving shard's pool.
``RelationPoisonedError``
    A relation exhausted every recovery arm (``degrade=False`` policy) —
    all later consumer calls for it fail fast instead of hanging.
``RelationWidthError``
    The one *non-retryable* data error: a produced row holds more entries
    than the preallocated width ``deg[relation]`` (paper §4.6).

Only these types enter the engine's recovery ladder: those the fault
injector raises, and a ``SyncTimeoutError`` the sync watchdog raises for
any launch whose CUDA event is not ready within ``sync_timeout_s`` (an
injected hang or a real slow launch alike, as in the reference). A CUDA
error, a kernel build failure or any other exception of a kernel wrapper
propagates unchanged.
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


class LaunchError(RelationError):
    """A device kernel launch failed. ``transient`` gates the retry arm."""

    def __init__(self, message: str = "", *, transient: bool = True,
                 **kw: Any):
        super().__init__(message, **kw)
        self.transient = transient


class SyncTimeoutError(RelationError):
    """The sync watchdog timed out waiting for a launch (hung device)."""

    def __init__(self, message: str = "", *,
                 timeout_s: Optional[float] = None, **kw: Any):
        super().__init__(message, **kw)
        self.timeout_s = timeout_s


class PoolUploadError(RelationError):
    """A device block-pool upload failed (device OOM on ``put``)."""


class DeviceLostError(RelationError):
    """A shard's device is gone; its segments must be re-homed."""


class RelationPoisonedError(RelationError):
    """The relation permanently failed earlier (``degrade=False``) and all
    subsequent consumer calls fail fast with the original cause chained."""


class RelationWidthError(RelationError, ValueError):
    """A produced relation row holds more entries than the preallocated
    relation-array width ``deg[relation]`` (paper §4.6): the compacted
    ``M`` row would silently drop neighbours. Raised by
    :meth:`RelationEngine._integrate` with the ``deg=`` override to use.
    Non-retryable: the same mesh reproduces it on every arm, so the retry
    and degrade machinery re-raises it unchanged."""
