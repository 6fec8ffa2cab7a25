"""Deterministic fault injection + recovery policy (docs/DESIGN.md §12),
the port's copy of the reference's ``repro.core.faults`` (same schedules,
same seeded ``random.Random``, same ``REPRO_FAULT_SPEC`` grammar, so a
schedule fires at the same points in both engines).

The engine's recovery machinery (bounded retries, sync watchdog,
per-relation circuit breaker, shard re-homing) is only testable if faults
can be injected *deterministically* at chosen ``(relation, segment,
attempt)`` points. :class:`FaultInjector` is that hook: a seeded schedule
of :class:`FaultSpec` entries consulted at the engine's four fault points
— kernel launch, device sync, block-pool upload, and whole-shard device
loss. It is installed via ``RelationEngine(fault_policy=FaultPolicy(
injector=...))`` or, for CI chaos jobs, via the ``REPRO_FAULT_SPEC``
environment variable.

``REPRO_FAULT_SPEC`` grammar — ``;``-separated entries, each either a
fault spec ``kind:key=value,key=value`` or policy overrides
``policy:key=value,...``::

    REPRO_FAULT_SPEC='launch:relation=VV,count=2,transient=1;
                      sync:hang_s=0.4,count=1;
                      policy:max_attempts=4,sync_timeout_s=0.2'

Fault kinds: ``launch`` (kernel launch raises :class:`LaunchError`),
``device-lost`` (launch raises :class:`DeviceLostError`, triggering shard
re-homing), ``sync`` (the launch's results stay un-ready for ``hang_s``
seconds — ``hang_s=inf``-style long hangs are what the watchdog turns
into :class:`SyncTimeoutError`), ``upload`` (block-pool upload reports
device OOM). All randomness (``p`` < 1 matching) comes from one seeded
``random.Random`` so a schedule replays bit-identically.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..errors import DeviceLostError, LaunchError

_KINDS = ("launch", "sync", "upload", "device-lost")


@dataclasses.dataclass
class FaultSpec:
    """One injectable fault. ``None`` matchers match anything; ``segment``
    matches any launch whose batch *contains* that segment. ``count`` is
    how many times the spec fires before exhausting (so "2 transient
    failures then success" is ``count=2``); ``p`` thins matches randomly
    (seeded). ``hang_s`` (sync faults) is how long the launch stays
    un-ready past its natural completion."""

    kind: str = "launch"
    relation: Optional[str] = None
    segment: Optional[int] = None
    attempt: Optional[int] = None
    shard: Optional[int] = None
    count: int = 1
    transient: bool = True
    hang_s: float = 0.0
    p: float = 1.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {_KINDS}")


class FaultInjector:
    """A seeded, deterministic schedule of :class:`FaultSpec` entries.

    The engine consults it under its lock at each fault point; every hit
    is appended to ``injected`` (kind, relation, segments, attempt, shard)
    so tests and benchmarks can assert exactly which faults fired. Not
    independently thread-safe — the engine serializes access."""

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.specs = list(specs)
        self._rng = random.Random(seed)
        self._remaining = [max(0, int(s.count)) for s in self.specs]
        self.injected: List[Tuple] = []

    def _match(self, spec: FaultSpec, i: int, *, relation: str,
               segments: Sequence[int], attempt: int,
               shard: Optional[int]) -> bool:
        if self._remaining[i] <= 0:
            return False
        if spec.relation is not None and spec.relation != relation:
            return False
        if spec.segment is not None and spec.segment not in segments:
            return False
        if spec.attempt is not None and spec.attempt != attempt:
            return False
        if spec.shard is not None and shard is not None \
                and spec.shard != shard:
            return False
        if spec.p < 1.0 and self._rng.random() >= spec.p:
            return False
        return True

    def _take(self, kind: str, *, relation: str, segments: Sequence[int],
              attempt: int, shard: Optional[int]) -> Optional[FaultSpec]:
        for i, spec in enumerate(self.specs):
            if spec.kind != kind:
                continue
            if self._match(spec, i, relation=relation, segments=segments,
                           attempt=attempt, shard=shard):
                self._remaining[i] -= 1
                self.injected.append(
                    (kind, relation, tuple(segments), attempt, shard))
                return spec
        return None

    # -- engine hooks -----------------------------------------------------

    def launch_fault(self, relation: str, segments: Sequence[int],
                     attempt: int, shard: Optional[int] = None
                     ) -> Optional[Exception]:
        """Exception to raise instead of launching, or ``None``. Covers
        the ``launch`` and ``device-lost`` kinds."""
        spec = self._take("device-lost", relation=relation,
                          segments=segments, attempt=attempt, shard=shard)
        if spec is not None:
            return DeviceLostError(
                f"injected device loss for relation {relation!r}",
                relation=relation,
                segment=segments[0] if len(segments) else None,
                shard=shard, attempt=attempt)
        spec = self._take("launch", relation=relation, segments=segments,
                          attempt=attempt, shard=shard)
        if spec is not None:
            word = "transient" if spec.transient else "permanent"
            return LaunchError(
                f"injected {word} launch failure for relation {relation!r}",
                transient=spec.transient, relation=relation,
                segment=segments[0] if len(segments) else None,
                shard=shard, attempt=attempt)
        return None

    def sync_hang_s(self, relation: str, segments: Sequence[int],
                    attempt: int, shard: Optional[int] = None) -> float:
        """Extra seconds this launch stays un-ready (0.0 = no fault)."""
        spec = self._take("sync", relation=relation, segments=segments,
                          attempt=attempt, shard=shard)
        return float(spec.hang_s) if spec is not None else 0.0

    def upload_fault(self, relation: str, segment: int,
                     shard: Optional[int] = None) -> bool:
        """True if this device block-pool upload should fail (OOM)."""
        spec = self._take("upload", relation=relation, segments=(segment,),
                          attempt=1, shard=shard)
        return spec is not None


@dataclasses.dataclass
class FaultPolicy:
    """Recovery policy knobs + the optional injector (docs/DESIGN.md §12).

    ``max_attempts``: total launch attempts (1 = no retries) for transient
    failures; ``backoff_s`` × ``backoff_factor**(attempt-1)`` is slept
    OUTSIDE the engine lock between attempts. ``sync_timeout_s`` arms the
    sync watchdog (``None`` = wait forever, the pre-fault behaviour);
    ``sync_poll_s`` is the watchdog poll interval. After
    ``breaker_threshold`` *consecutive* device-arm failures a relation's
    circuit breaker opens and production degrades to the host arm; after
    ``breaker_cooldown_s`` the next launch probes the device arm again.
    ``degrade=False`` disables the host fallback — exhausted retries
    poison the relation instead (every later call raises
    :class:`RelationPoisonedError`)."""

    max_attempts: int = 3
    backoff_s: float = 0.005
    backoff_factor: float = 2.0
    sync_timeout_s: Optional[float] = None
    sync_poll_s: float = 0.002
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 0.05
    degrade: bool = True
    injector: Optional[FaultInjector] = None

    @staticmethod
    def from_env() -> "FaultPolicy":
        """Build the policy from ``$REPRO_FAULT_SPEC`` (empty/unset env →
        default policy with no injector)."""
        return parse_fault_spec(os.environ.get("REPRO_FAULT_SPEC", ""))


_SPEC_BOOLS = ("transient",)
_POLICY_FIELDS = {f.name: f.type for f in dataclasses.fields(FaultPolicy)
                  if f.name != "injector"}


def _coerce(key: str, value: str) -> Any:
    if key in _SPEC_BOOLS or key == "degrade":
        return value.lower() not in ("0", "false", "no", "")
    if key in ("relation",):
        return value
    if key in ("hang_s", "p", "backoff_s", "backoff_factor",
               "sync_timeout_s", "breaker_cooldown_s", "sync_poll_s"):
        return float(value)
    return int(value)


def parse_fault_spec(text: str) -> FaultPolicy:
    """Parse the ``REPRO_FAULT_SPEC`` grammar into a :class:`FaultPolicy`
    (with a seeded :class:`FaultInjector` when any fault entries are
    present). Raises ``ValueError`` on malformed entries."""
    specs: List[FaultSpec] = []
    policy_kw: Dict[str, Any] = {}
    seed = 0
    for entry in (e.strip() for e in text.split(";")):
        if not entry:
            continue
        if entry.startswith("seed="):
            seed = int(entry.split("=", 1)[1])
            continue
        if ":" not in entry:
            raise ValueError(f"malformed REPRO_FAULT_SPEC entry {entry!r}"
                             " (expected 'kind:k=v,...')")
        kind, _, body = entry.partition(":")
        kind = kind.strip()
        kw: Dict[str, Any] = {}
        for item in (i.strip() for i in body.split(",") if i.strip()):
            if "=" not in item:
                raise ValueError(
                    f"malformed item {item!r} in entry {entry!r}")
            k, _, v = item.partition("=")
            kw[k.strip()] = _coerce(k.strip(), v.strip())
        if kind == "policy":
            unknown = set(kw) - set(_POLICY_FIELDS)
            if unknown:
                raise ValueError(f"unknown policy field(s) {sorted(unknown)}")
            policy_kw.update(kw)
        else:
            specs.append(FaultSpec(kind=kind, **kw))
    policy = FaultPolicy(**policy_kw)
    if specs:
        policy.injector = FaultInjector(specs, seed=seed)
        if any(s.kind == "sync" for s in specs) \
                and policy.sync_timeout_s is None \
                and "sync_timeout_s" not in policy_kw:
            # injected hangs without a watchdog would deadlock CI: arm a
            # conservative default so chaos jobs always terminate
            policy.sync_timeout_s = 0.25
    return policy
