"""The GALE relation engine: task-parallel localized relation computation
(paper §4.4–4.6) on PyTorch and CUDA.

Roles, mapped from the paper:

  consumer        -> the analysis algorithm calling :meth:`get` /
                     :meth:`get_batch` / :meth:`get_full_dev_many`
  leader producer -> :meth:`_dispatch`: drains the per-relation queue
                     (multi-queue design, §4.5), extends the batch with
                     *lookahead* segments along the traversal order, and
                     launches ONE batched kernel per relation type
  worker producer -> the CUDA grid (``kernels/csrc/segment_relations.cu``,
                     one thread block per segment), or the plain torch arm

Asynchronous consumer contract
------------------------------

With ``async_dispatch=True`` (the default) the producer NEVER blocks: a
kernel launch returns as soon as it is queued on the device's current
stream, and its not-yet-ready output tensors are recorded in an
**in-flight futures table** keyed by ``(relation, segment)``. Right after
the launch the engine queues the outputs' copy to pinned host memory and
records a CUDA event; the event says when both are done.

  - :meth:`prefetch` / :meth:`prefetch_many` enqueue traversal-order hints
    and dispatch launches round-robin across relations, returning
    immediately.
  - :meth:`get` / :meth:`get_batch` block only when they read a block that
    is still computing; the wait is accounted in ``stats.t_sync`` (the
    paper's Fig. 10 "waiting" metric). ``stats.t_kernel`` records only the
    host-side dispatch cost.
  - A segment is never produced twice: requests are de-duplicated against
    the cache, the in-flight table, and the pending queues.

With ``async_dispatch=False`` every launch is synced right after dispatch
(the blocking producer of the ACTOPO/TopoCluster baselines,
``core/explicit.py``); the wait still lands in ``t_sync``, so the two modes
are directly comparable.

Multi-consumer thread safety (docs/DESIGN.md §8)
------------------------------------------------

All shared-state mutation sits behind ONE lock + condition variable
(``self._cond``): every public consumer method acquires it once at entry,
and every internal step (queues, cache, in-flight table, device block pool,
stats) runs with it held. The only waits that release the lock are the
retry backoff (docs/DESIGN.md §12) and the device sync: the first consumer
needing a launch becomes its *syncer* (``launch.syncing``), drops the lock
for the wait on the launch's CUDA event, then re-acquires and integrates
exactly once; other consumers needing the same launch wait on the
condition variable until ``launch.done``. A block is
never produced twice for any thread interleaving, stat updates are never
lost (``merged_worker_stats() == stats``), and results are bit-identical
for any number of consumer threads.

Segment shards (docs/DESIGN.md §9)
----------------------------------

``shards=K`` (or ``shard_plan=``) splits the segments into K contiguous
shards (:class:`~repro_torch.distributed.sharding.ShardPlan`). Shard k
holds its own slice of the stacked tables and its own device pool, and
produces exactly its own segments: a launch never mixes shards, lookahead
stops at the shard's end, and the kernels read the shard's tables at
shard-local segment indices. ``shard_stats`` attributes the producer
counters to shards, and ``merged_shard_stats()`` equals ``stats`` on
them. The engine's own plan puts every shard on the engine's device, so
one card runs K logical shards; a plan whose shards sit on distinct cards
raises, because the cross-card exchange needs a second card to verify.

Fault recovery (docs/DESIGN.md §12)
-----------------------------------

``fault_policy=`` (default: :meth:`FaultPolicy.from_env`, which reads
``$REPRO_FAULT_SPEC``) sets the recovery ladder every launch goes through
(:meth:`_launch`): injected transient launch faults retry with a backoff
slept with the lock released; after ``breaker_threshold`` consecutive
device-arm failures a relation's circuit breaker opens and production
degrades to the numpy host arm (:func:`ops.relation_block_host`) until a
probe after the cooldown succeeds; a lost shard is re-homed onto a
surviving shard's pool; with ``degrade=False`` an exhausted relation is
poisoned. With ``sync_timeout_s`` set, the syncer polls the launch's CUDA
event against a deadline instead of blocking on it, and a launch that
stays un-ready is failed and re-dispatched: a real launch slower than
the window enters the ladder as an injected hang does (as in the
reference), and enough of them open the breaker onto the host arm. Only
the taxonomy errors enter the ladder, those the injector raises and the
watchdog's timeouts: a CUDA error, a kernel build failure or any other
exception of a kernel wrapper propagates unchanged. Any
survivable schedule gives blocks bit-identical to the fault-free run.

Kernel-parameter tuning (docs/DESIGN.md §4)
-------------------------------------------

``tune=`` (default ``"auto"``, as the reference) resolves ``batch_max``
and ``bucket_floor`` in the reference's order: explicit constructor
argument > the entry of the port's tuning table for ``(backend, mesh-size
bucket)`` (:mod:`repro_torch.launch.autotune`: ``$REPRO_TORCH_TUNE_TABLE``
or ``TUNE_torch_kernel_params.json`` in the working directory for
``"auto"``, a path otherwise) > the built-in default; ``bucket_floor``
comes from the table only. ``tune="off"`` skips the table. A missing,
corrupt or stale table gives the defaults. The port's kernels pick no
tiles, so the reference's ``block_x`` / ``block_y`` / ``vv_block`` have
no counterpart: the bitmask kernels size their grids from the launch
itself (``segment_relations.bits_blocks``).

This is the reference engine with the completion API (full-block reads,
device inverse maps, boundary relations), the fault ladder and the tuning
table. With no table, or ``tune="off"``, its built-in defaults
(``batch_max=64``, ``bucket_floor=1``, ``lookahead=8``,
``cache_segments=512``, ``dev_pool_segments=256``, ``inflight_max=8``)
give the reference's ``tune="off"`` launch sequence.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.sharding import ShardPlan
from ..errors import (
    DeviceLostError,
    PoolUploadError,
    RelationError,
    RelationPoisonedError,
    RelationWidthError,
    SyncTimeoutError,
)
from ..kernels import ops
from ..launch import autotune
from .blockstore import BlockStore
from .faults import FaultPolicy
from .mesh import _EDGE_COMBOS, _FACE_COMBOS, edge_lookup, face_lookup
from .segtables import OFFLOADED_RELATIONS, Preconditioned, RELATION_TABLES


@dataclasses.dataclass
class EngineStats:
    """Engine accounting (paper Tables 5/6/7 + Fig. 10). Counter semantics:

    - ``requests``: simplex-block reads issued through :meth:`RelationEngine.
      get` / ``get_batch`` / ``get_full_dev_many`` (one per (relation,
      segment) read).
    - ``cache_hits`` / ``cache_misses``: whether a read found its block
      already produced (or in flight — ``inflight_hits`` is that subset).
    - ``kernel_launches`` / ``segments_produced``: producer-side dispatch
      counts. A segment is never produced twice for the same relation, so
      ``segments_produced`` is also the number of distinct blocks computed.
    - ``completion_*``: cross-segment adjacency completion
      (``core/adjacency.py``): completed queries, fan-out block
      consultations (distinct per plan), and raw vs deduplicated neighbour
      entries (the dedup ratio is how much cross-segment overlap the union
      removed).
    """

    requests: int = 0
    kernel_launches: int = 0
    segments_produced: int = 0
    cache_hits: int = 0
    inflight_hits: int = 0   # subset of cache_hits served from in-flight
    cache_misses: int = 0
    evictions: int = 0
    # Device block pool (get_full_dev_many): reads served from still-
    # device-resident launch results vs host-cache blocks re-uploaded.
    devpool_hits: int = 0
    devpool_uploads: int = 0
    # Fault recovery (docs/DESIGN.md §12). ``retries`` counts launch AND
    # sync re-attempts; ``failed_*`` counts launches abandoned after a
    # fault (their dispatch-time ``kernel_launches``/``segments_produced``
    # bumps are reversed, so "produced == distinct blocks" still holds);
    # ``degraded_*`` counts host-arm production/reads while a relation's
    # circuit breaker is open.
    retries: int = 0
    sync_timeouts: int = 0
    failed_launches: int = 0
    failed_segments: int = 0
    breaker_trips: int = 0
    breaker_recoveries: int = 0
    degraded_launches: int = 0
    degraded_segments: int = 0
    degraded_reads: int = 0
    shards_lost: int = 0
    rehomed_segments: int = 0
    # Cross-segment adjacency completion (core/adjacency.py).
    completion_queries: int = 0        # simplex ids completed
    completion_fanout_blocks: int = 0  # block consultations
    completion_raw_neighbors: int = 0  # gathered entries before dedup/self
    completion_neighbors: int = 0      # entries in the final completed rows
    # Waiting-time breakdown (seconds), paper Fig. 10 phases.
    t_enqueue: float = 0.0
    t_queue: float = 0.0
    t_prepare: float = 0.0
    t_kernel: float = 0.0    # host-side kernel DISPATCH time only
    t_sync: float = 0.0      # time the consumer waited on in-flight results
    t_integrate: float = 0.0

    @property
    def completion_dedup_ratio(self) -> float:
        """Raw gathered entries per surviving completed entry (>= 1.0 once
        any completion ran; 0.0 before)."""
        if self.completion_neighbors == 0:
            return 0.0
        return self.completion_raw_neighbors / self.completion_neighbors

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["completion_dedup_ratio"] = self.completion_dedup_ratio
        return d

    def bump(self, **deltas) -> None:
        """Add counter deltas in place. The engine routes every stat update
        through this (under its lock), so concurrent consumers never lose
        increments."""
        for k, v in deltas.items():
            setattr(self, k, getattr(self, k) + v)

    @staticmethod
    def merged(parts: Iterable["EngineStats"]) -> "EngineStats":
        """Sum every field over ``parts`` into a fresh ``EngineStats``
        (deterministic for a fixed iteration order)."""
        out = EngineStats()
        for p in parts:
            out.bump(**dataclasses.asdict(p))
        return out


class StatsHost:
    """Thread-safe stats accounting: a single lock/condition (``self._cond``)
    guards every counter update, and each update is attributed to the
    calling *worker thread* (:meth:`worker_scope`), so ``worker_stats``
    carries the per-consumer breakdown of docs/DESIGN.md §8 and
    ``merged_worker_stats() == stats`` holds at all times (exactly for int
    counters, up to float-summation order for the ``t_*`` phases).
    The producer-side counters (``kernel_launches``,
    ``segments_produced``, ``devpool_hits``, ``devpool_uploads``,
    ``t_kernel``, and the ``failed_*`` and ``degraded_*`` launch counters
    of docs/DESIGN.md §12) are also attributed to segment shards
    (``shard_stats``, docs/DESIGN.md §9)."""

    def _init_stats(self) -> None:
        self.stats = EngineStats()
        self.worker_stats: Dict[str, EngineStats] = {}
        self.shard_stats: Dict[int, EngineStats] = {}
        self._cond = threading.Condition()
        self._tl = threading.local()

    @contextlib.contextmanager
    def worker_scope(self, name: str):
        """Attribute this thread's stat updates to worker ``name`` (the
        scheduler wraps each worker loop in one; unscoped updates land on
        the ``"main"`` worker)."""
        prev = getattr(self._tl, "worker", None)
        self._tl.worker = str(name)
        try:
            yield
        finally:
            self._tl.worker = prev

    def _bump(self, **deltas) -> None:
        # contract: holds-lock
        """Stat update; the caller must hold ``self._cond``."""
        w = getattr(self._tl, "worker", None) or "main"
        ws = self.worker_stats.get(w)
        if ws is None:
            ws = self.worker_stats[w] = EngineStats()
        self.stats.bump(**deltas)
        ws.bump(**deltas)

    def stat_bump(self, **deltas) -> None:
        """Thread-safe counter update for out-of-engine accounting (the
        completion pipeline in ``core/adjacency.py``)."""
        with self._cond:
            self._bump(**deltas)

    def _bump_shard(self, shard: int, **deltas) -> None:
        # contract: holds-lock
        """Producer-side stat update attributed to segment shard ``shard``
        (besides the global/worker landing the caller does via
        :meth:`_bump`); the caller must hold ``self._cond``."""
        ss = self.shard_stats.get(shard)
        if ss is None:
            ss = self.shard_stats[shard] = EngineStats()
        ss.bump(**deltas)

    def reset_stats(self) -> None:
        """Zero every counter (global, per-worker and per-shard) under the
        lock — the way to separate a warm-up from a timed run. Rebinding
        ``.stats`` directly would bypass the lock and orphan the per-worker
        breakdown (the ``merged_worker_stats() == stats`` invariant)."""
        with self._cond:
            self.stats = EngineStats()
            self.worker_stats = {}
            self.shard_stats = {}

    def merged_worker_stats(self) -> EngineStats:
        """Deterministic merge of the per-worker breakdown (sorted worker
        key order); equals ``stats``."""
        with self._cond:
            return EngineStats.merged(
                self.worker_stats[k] for k in sorted(self.worker_stats))

    def merged_shard_stats(self) -> EngineStats:
        """Deterministic merge of the per-shard producer breakdown (sorted
        shard order); equals ``stats`` on the producer counters: ints
        exactly, ``t_kernel`` up to float summation order. Per-shard ``segments_produced`` shows that no
        segment was produced on more than one shard."""
        with self._cond:
            return EngineStats.merged(
                self.shard_stats[k] for k in sorted(self.shard_stats))


@dataclasses.dataclass
class ConsumerBatch:
    """Device-resident view of one consumer batch (docs/DESIGN.md §6): the
    *internal* relation rows of a batch of segments, stacked across several
    relations that share a subject simplex kind, served straight from the
    producer's device block pool.

    Rows are the segments' internal simplices in traversal order (segment by
    segment, ascending global id within each), padded to a power-of-two row
    bucket (``ops.bucket_rows``). Padding rows carry ``gid == -1`` and
    all-(-1) relation entries; their results are the caller's to discard.
    ``M``/``L`` are fresh gather outputs, not views of the pooled launch
    tensors."""

    kind: str                        # subject simplex kind (V/E/F/T)
    segments: Tuple[int, ...]        # segment ids served, in row order
    n_rows: int                      # real rows (before bucket padding)
    gid: np.ndarray                  # (n_rows,) host global ids for scatter
    gid_dev: torch.Tensor            # (rows_pad,) int32 gids, -1 padding
    M: Dict[str, torch.Tensor]       # relation -> (rows_pad, width)
    L: Dict[str, torch.Tensor]       # relation -> (rows_pad,)

    def width(self, relation: str) -> int:
        return self.M[relation].shape[1]


# contract: device-resident
def _gather_internal(pool_M: torch.Tensor, pool_L: torch.Tensor,
                     flat: torch.Tensor, gid: torch.Tensor, w: int):
    """One device gather per (relation, batch): pick the internal rows
    (``flat`` indexes the flattened slot-rows), trim columns to the width
    ``w``, and mask bucket-padding rows (``gid == -1``) to the documented
    all-(-1) / zero-count padding."""
    Mr = pool_M.reshape(-1, pool_M.shape[-1]).index_select(0, flat)[:, :w]
    Lr = pool_L.reshape(-1).index_select(0, flat)
    return (torch.where(gid[:, None] >= 0, Mr, -1),
            torch.where(gid >= 0, Lr, 0))


class _Launch:
    """One dispatched batched kernel whose results may not be ready yet."""

    __slots__ = ("relation", "segments", "M", "L", "M_host", "L_host",
                 "event", "n_rows", "done", "syncing", "shard", "host",
                 "error", "hang_until", "sync_attempts")

    def __init__(self, relation, segments, M, L, M_host, L_host, event,
                 n_rows, shard=0, host=False):
        self.relation = relation
        self.segments = segments      # real (unpadded) segment ids
        self.M = M                    # (B_padded, R, deg) device tensor
        self.L = L                    # (B_padded, R) device tensor
        # host copies, filled by the stream: fresh pinned buffers of this
        # launch alone, so a launch the watchdog abandons (still running on
        # the stream) writes into nothing a re-dispatch reads
        self.M_host = M_host
        self.L_host = L_host
        self.event = event            # recorded after the copies (or None)
        self.n_rows = n_rows          # per-segment internal row counts
        self.done = False
        self.syncing = False          # a consumer thread owns the sync wait
        self.shard = shard            # owning segment shard (stats, re-home)
        self.host = host              # degraded host-arm launch (not pooled)
        self.error = None             # terminal fault (docs/DESIGN.md §12)
        self.hang_until = 0.0         # injected sync hang deadline (faults)
        self.sync_attempts = 0        # watchdog timeouts consumed so far

    def is_ready(self) -> bool:
        if self.hang_until and time.monotonic() < self.hang_until:
            return False              # injected hang: results stay un-ready
        return self.event is None or self.event.query()


class RelationEngine(StatsHost):
    """GALE: GPU-Aided Localized data structurE.

    Runs on ``device`` (``cuda`` unless the caller asks for another; a
    missing card raises). ``backend=None`` launches the CUDA kernels on a
    card and the plain torch arm on the CPU; ``backend="torch"`` runs the
    plain arm on the card too. ``assembly="dense"`` sends every relation
    through the dense counts fallback (the reference's A/B arm); the
    default assembles sparsely wherever ``ops.sparse_arm_ok`` allows, and
    EE/FF always take the dense arm. ``async_dispatch=False`` syncs every
    launch right after dispatch (the localized baselines'
    blocking producer). ``shards=K`` (or ``shard_plan=``) runs K segment
    shards, ``fault_policy=`` / ``sync_timeout_s=`` set the fault
    recovery ladder, and ``tune=`` / ``batch_max=`` the kernel parameters
    (module docstring). Safe for concurrent use by multiple consumer
    threads: every public consumer method acquires the engine lock exactly
    once; internal ``_``-prefixed steps assume it is held."""

    def __init__(
        self,
        pre: Preconditioned,
        relations: Sequence[str],
        backend: Optional[str] = None,
        device=None,
        lookahead: int = 8,
        batch_max: Optional[int] = None,
        cache_segments: int = 512,
        deg: Optional[Dict[str, int]] = None,
        inflight_max: int = 8,
        dev_pool_segments: int = 256,
        shards: int = 1,
        shard_plan: Optional[ShardPlan] = None,
        fault_policy: Optional[FaultPolicy] = None,
        sync_timeout_s: Optional[float] = None,
        assembly: str = "sparse",
        async_dispatch: bool = True,
        tune: str = "auto",
    ):
        if pre.tables is None:
            raise ValueError("precondition(..., build_tables=True) required")
        # Fault-recovery policy (docs/DESIGN.md §12): defaults come from
        # $REPRO_FAULT_SPEC when no explicit policy is passed;
        # sync_timeout_s= overrides the policy's watchdog knob.
        if fault_policy is None:
            fault_policy = FaultPolicy.from_env()
        if sync_timeout_s is not None:
            fault_policy = dataclasses.replace(
                fault_policy, sync_timeout_s=float(sync_timeout_s))
        self._fault_policy = fault_policy
        self._injector = fault_policy.injector
        # per-relation circuit breaker: consecutive device-arm failures,
        # open-until deadline, and the last fault
        self._breaker: Dict[str, Dict] = {}
        # relations that permanently failed under degrade=False: every
        # later consumer call raises RelationPoisonedError immediately
        self._poisoned: Dict[str, BaseException] = {}
        self._lost_shards: set = set()
        self.device = ops.resolve_device(device)
        self.backend = ops.resolve_backend(backend, self.device)
        if assembly not in ops.ASSEMBLIES:
            raise ValueError(f"assembly must be one of {ops.ASSEMBLIES}, "
                             f"got {assembly!r}")
        self.assembly = assembly
        self.pre = pre
        self.smesh = pre.smesh
        self.tables = pre.tables
        self.lookahead = lookahead
        # Kernel-parameter resolution (docs/DESIGN.md §4): explicit argument
        # > tuned table entry (tune="auto" or a path) > built-in default.
        # tune="off" skips the table so today's defaults are reproduced
        # bit-for-bit; a missing/corrupt table silently falls back, so
        # construction never depends on on-disk tuning state.
        tuned = self._load_tuned_config(tune, self.backend,
                                        pre.smesh.n_segments)
        self.kernel_config = autotune.KernelConfig(
            batch_max=int(batch_max if batch_max is not None
                          else tuned.get("batch_max", 64)),
            bucket_floor=max(1, int(tuned.get("bucket_floor", 1))))
        self.batch_max = self.kernel_config.batch_max
        self.bucket_floor = self.kernel_config.bucket_floor
        batch_max = self.batch_max
        self.async_dispatch = async_dispatch
        self.inflight_max = max(1, inflight_max)
        self.relations = tuple(r for r in relations
                               if r in OFFLOADED_RELATIONS)
        self.deg = dict(ops.DEFAULT_DEG)
        if deg:
            self.deg.update(deg)

        # Segment shards (docs/DESIGN.md §9): shard k owns the contiguous
        # segment range plan.shard_bounds(k), produces exactly those blocks
        # and retains them in its own device pool. shards=1 (the default)
        # is the unsharded engine.
        ns = self.smesh.n_segments
        if shard_plan is None:
            shard_plan = ShardPlan.make(
                ns, shards, devices=None if int(shards) <= 1
                else (self.device,) * int(shards))
        elif shard_plan.n_segments != ns:
            raise ValueError(
                f"shard_plan covers {shard_plan.n_segments} segments but the "
                f"mesh has {ns}")
        if shard_plan.multi_device:
            raise NotImplementedError(
                "a shard plan on distinct cards: the cross-card completion "
                "exchange is not verified, it needs a second card (ROADMAP "
                "queue 3); run the shards on one card")
        self.shard_plan = shard_plan
        self.n_shards = shard_plan.n_shards
        self._seg_shard = shard_plan.shard_of_array(np.arange(ns))

        # Multi-queue: one pending-request queue per offloaded relation
        # (paper §4.5 'Justification of design choices').
        self.queues: Dict[str, List[int]] = {r: [] for r in self.relations}
        # Block storage: one host segment cache + one device block pool per
        # shard. Pool entries reference retained launch tensors (idx row)
        # or one-block uploads (idx None); ``dev_pool_segments`` is a
        # per-shard segment budget converted at launch granularity.
        # Evictions only drop device references; the host cache keeps the
        # data.
        self.store = BlockStore(
            cache_segments, max(1, dev_pool_segments // max(1, batch_max)),
            n_shards=self.n_shards,
            shard_of=lambda s: int(self._seg_shard[s]))
        self.cache = self.store.cache
        self._dev_pool = self.store
        # In-flight futures: (relation, segment) -> _Launch whose device
        # tensors may still be computing.
        self._inflight: Dict[Tuple[str, int], _Launch] = {}
        self._flights: "collections.deque[_Launch]" = collections.deque()
        self._init_stats()   # stats + per-worker breakdown + lock

        # Device-resident stacked tables (copied once, like the paper
        # copying initialized arrays to GPU global memory), sliced per
        # shard: each shard holds only its own segments' rows, indexed by
        # shard-local segment id.
        t = self.tables
        put = (lambda a: torch.from_numpy(np.ascontiguousarray(a))
               .to(self.device))
        self._shard_tables: List[Dict[str, torch.Tensor]] = [
            self._stage_shard_tables(*shard_plan.shard_bounds(k))
            for k in range(self.n_shards)]
        self._dev: Dict[str, torch.Tensor] = {}
        # Device-resident inverse maps (docs/DESIGN.md §5): per-kind sorted
        # (segment, gid) appearance lists mirroring tables.inverse, as int32
        # (seg, gid, row) columns, for the device completion gather
        # (kernels/completion_gather.py). When the combined key
        # ``seg * n_global + gid`` fits int32 it is staged too, as
        # ``inv_key_*``, for the single-key search. ``inv_start_*`` (S + 1
        # int32) holds where each segment's run of the maps starts, so the
        # gather kernel searches one segment's run.
        self._inv_nglob: Dict[str, int] = {}
        n_seg = self.smesh.n_segments
        for kind, (keys, rows, n_glob) in (t.inverse or {}).items():
            if kind == "V":   # completion only spans E/F/T kinds
                continue
            segs = keys // n_glob
            self._dev[f"inv_start_{kind}"] = put(np.searchsorted(
                segs, np.arange(n_seg + 1)).astype(np.int32))
            self._dev[f"inv_seg_{kind}"] = put(segs.astype(np.int32))
            self._dev[f"inv_gid_{kind}"] = put(
                (keys % n_glob).astype(np.int32))
            self._dev[f"inv_row_{kind}"] = put(rows.astype(np.int32))
            self._inv_nglob[kind] = int(n_glob)
            if len(keys) == 0 or int(keys[-1]) < 2 ** 31:
                self._dev[f"inv_key_{kind}"] = put(keys.astype(np.int32))

    @staticmethod
    def _load_tuned_config(tune: str, backend: str, n_segments: int) -> Dict:
        """Resolve the autotuned kernel-parameter dict for this engine.

        ``tune="off"`` returns ``{}`` (built-in defaults); ``"auto"`` looks
        up the default on-disk table (``launch/autotune.py``); any other
        string is a path to an explicit table. Lookup failures of any kind
        (missing file, stale version, corrupt JSON) resolve to ``{}`` so
        construction never fails because of tuning state. Only the table
        read sits in the ``try``: nothing here builds or launches a
        kernel."""
        if tune == "off":
            return {}
        try:
            cfg = autotune.lookup(backend, n_segments,
                                  path=None if tune == "auto" else tune)
            return cfg.to_dict() if cfg is not None else {}
        except Exception:
            return {}

    def _stage_shard_tables(self, lo: int, hi: int) -> Dict[str, torch.Tensor]:
        """One shard's slice ``[lo, hi)`` of the stacked segment tables on
        the engine's device (all of them when the engine has one shard).
        Used at construction for every shard and again by
        :meth:`_rehome_shard` to re-stage a lost shard's slice."""
        t = self.tables
        tabs: Dict[str, torch.Tensor] = {}
        for name in ("T_local", "LT_global", "LV_global", "E_local",
                     "LE_global", "F_local", "LF_global"):
            a = getattr(t, name)
            if a is not None:
                tabs[name] = torch.from_numpy(
                    np.ascontiguousarray(a[lo:hi])).to(self.device)
        return tabs

    # -- consumer-side API --------------------------------------------------

    @contextlib.contextmanager
    def _consumer_entry(self, method: str):
        """Public consumer-method entry: rejects re-entrant entry, then
        acquires the engine lock exactly once. The lock is not re-entrant,
        so a nested public call from a thread already inside one would
        deadlock; the thread-local entry marker turns that into an
        immediate ``RuntimeError`` naming both methods."""
        held = getattr(self._tl, "engine_method", None)
        if held is not None:
            raise RuntimeError(
                f"re-entrant call into RelationEngine.{method}() from "
                f"RelationEngine.{held}() on the same thread: the engine "
                f"lock (docs/DESIGN.md §8) is not re-entrant, so this call "
                f"would deadlock. Finish the {held}() call first.")
        self._tl.engine_method = method
        try:
            with self._cond:
                yield
        finally:
            self._tl.engine_method = None

    def request(self, relation: str, segments: Sequence[int]) -> None:
        """Non-blocking enqueue (consumer -> leader queue): appends traversal
        hints to the relation's pending queue, never launches and never
        waits. A segment already cached, in flight or pending is not
        enqueued again."""
        with self._consumer_entry("request"):
            self._request(relation, segments)

    def _request(self, relation: str, segments: Sequence[int]) -> None:
        # contract: holds-lock
        self._check_poisoned(relation)
        t0 = time.perf_counter()
        q = self.queues[relation]
        qs = set(q)
        for s in segments:
            s = int(s)
            if ((relation, s) not in self.cache
                    and (relation, s) not in self._inflight
                    and s not in qs):
                q.append(s)
                qs.add(s)
        self._bump(t_enqueue=time.perf_counter() - t0)

    def clear_cache(self) -> int:
        """Drop every retained block — the host segment cache and the device
        pool — under the engine lock, to model a cold cache. In-flight
        launches are retired (synced and integrated) first, so a launch
        dispatched before the clear cannot bring dropped blocks back; the
        wait lands in ``stats.t_sync``. Returns the number of entries
        dropped."""
        with self._consumer_entry("clear_cache"):
            while self._flights:
                self._sync(self._flights.popleft())
            return self.store.clear_cache()

    def cache_nbytes(self) -> int:
        """Bytes retained across the host segment cache and the device pool,
        under the engine lock."""
        with self._consumer_entry("cache_nbytes"):
            return self.store.cache_nbytes()

    def get(self, relation: str, segment: int) -> Tuple[np.ndarray, np.ndarray]:
        """Fetch the (M, L) relation block for one segment as host arrays.

        Rows are the segment's *internal* simplices of the relation's subject
        kind, in global-id order starting at ``interval[kind][segment]``.
        Returns at once on a cache hit; on an in-flight hit it blocks until
        that launch is ready; on a miss it queue-jumps the segment,
        dispatches one batched launch, and waits for it."""
        with self._consumer_entry("get"):
            segment = int(segment)
            self._bump(requests=1)
            self._count(relation, segment)
            return self._fetch(relation, segment)

    def get_full(self, relation: str, segment: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Like :meth:`get`, but returns ALL local rows of the block —
        internal simplices first (global-id order), then the segment's
        external simplices, then table padding (rows with ``L == 0``).
        Cross-segment adjacency completion reads external rows through
        this method; misses take the normal dispatch path and are
        counted."""
        with self._consumer_entry("get_full"):
            segment = int(segment)
            self._bump(requests=1)
            self._count(relation, segment)
            return self._fetch(relation, segment, full=True)

    def get_full_dev(self, relation: str, segment: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Like :meth:`get_full`, but the block stays on the device: served
        from the device block pool (``devpool_hits``) or uploaded once from
        the host cache and pooled (``devpool_uploads``)."""
        with self._consumer_entry("get_full_dev"):
            M, L, i = self._dev_entry(relation, int(segment))
        return (M, L) if i is None else (M[i], L[i])

    def get_full_dev_batch(self, relation: str, segments: Sequence[int],
                           pad_to: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stacked full device blocks ``(M (S, R, deg), L (S, R))`` for
        several segments, rows in the given order (optionally padded to
        ``pad_to`` slots by repeating the first block — padding slots are
        the caller's to ignore). Counting is one :meth:`get_full_dev` per
        segment; blocks sharing a retained launch are assembled with one
        device gather per launch plus one permutation — the completion
        gather's pool builder."""
        with self._consumer_entry("get_full_dev_batch"):
            segments = [int(s) for s in segments]
            ents = [self._dev_entry(relation, s) for s in segments]
            return self._stack_entries(ents, pad_to)

    def dev_inverse(self, kind: str, shard: Optional[int] = None):
        """Device inverse-map columns for simplex kind ``E``/``F``/``T``:
        ``(inv_seg, inv_gid, inv_row, inv_key_or_None, n_global)``.
        ``inv_key`` is staged only when the combined ``seg * n_global +
        gid`` key fits int32; the split columns always support the
        lexicographic search. The maps are global — resolving a row in any
        segment is what a shard's half of the completion exchange needs —
        and every shard lies on the engine's device, so ``shard=k`` (a
        shard of the plan) reads the same tensors."""
        if shard is not None and not 0 <= int(shard) < self.n_shards:
            raise ValueError(f"shard {shard} is not in the engine's "
                             f"{self.n_shards}-shard plan")
        if kind not in self._inv_nglob:
            raise KeyError(f"no device inverse map for kind {kind!r}")
        return (self._dev[f"inv_seg_{kind}"], self._dev[f"inv_gid_{kind}"],
                self._dev[f"inv_row_{kind}"],
                self._dev.get(f"inv_key_{kind}"), self._inv_nglob[kind])

    def dev_inverse_starts(self, kind: str) -> torch.Tensor:
        """Device ``(S + 1,)`` int32 start table of :meth:`dev_inverse`'s
        maps for kind ``E``/``F``/``T``: segment ``s``'s appearances are
        rows ``start[s]:start[s + 1]``, and ``start[S]`` is their count."""
        if kind not in self._inv_nglob:
            raise KeyError(f"no device inverse map for kind {kind!r}")
        return self._dev[f"inv_start_{kind}"]

    def local_rows(self, kind: str, segs: np.ndarray,
                   gids: np.ndarray) -> np.ndarray:
        """Vectorized ``(segment, global id) -> local block row`` for simplex
        kind ``V``/``E``/``F``/``T`` (``-1`` where absent) via the inverse
        maps built at table time — the row index to use with
        :meth:`get_full`. Host-side, lock-free."""
        return self.tables.local_rows(kind, segs, gids)

    def _dev_entry(self, relation: str, segment: int):
        # contract: holds-lock
        """Pooled device block entry ``(M, L, idx_or_None)`` for one
        segment, producing/uploading on miss (one request count per call).
        Lock held."""
        self._check_poisoned(relation)
        self._bump(requests=1)
        self._count(relation, segment)
        key = (relation, segment)
        shard = int(self._seg_shard[segment])
        ent = self._dev_pool.get(key)
        if ent is None:
            launch = self._inflight.get(key)
            if launch is not None:
                # integration fills the device pool for the whole launch
                self._sync(launch)
                ent = self._dev_pool.get(key)
        if ent is None:
            Mh, Lh = self._fetch(relation, segment, full=True)
            # a cold miss dispatches a launch whose integration fills the
            # device pool — re-check before paying a host->device upload
            ent = self._dev_pool.get(key)
            if ent is None:
                pooled = True
                if self._injector is not None \
                        and self._injector.upload_fault(relation, segment,
                                                        shard):
                    # injected pool-upload OOM: drop every entry of this
                    # shard's pool (free, then retry once); a second
                    # failure serves the read un-pooled (degraded), or
                    # raises under degrade=False
                    self._dev_pool.clear_shard(shard)
                    if self._injector.upload_fault(relation, segment,
                                                   shard):
                        if not self._fault_policy.degrade:
                            raise PoolUploadError(
                                f"device block-pool upload failed twice "
                                f"for relation {relation!r}",
                                relation=relation, segment=segment,
                                shard=shard)
                        self._bump(degraded_reads=1)
                        pooled = False
                ent = (torch.from_numpy(Mh).to(self.device),
                       torch.from_numpy(Lh).to(self.device), None)
                if pooled:
                    self._dev_pool.put(key, *ent)
                self._bump(devpool_uploads=1)
                self._bump_shard(shard, devpool_uploads=1)
                return ent
        self._bump(devpool_hits=1)
        self._bump_shard(shard, devpool_hits=1)
        return ent

    def _stack_entries(self, ents, pad_to: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stack resolved device-pool entries into ``(S, R, deg)`` /
        ``(S, R)`` tensors, rows in ``ents`` order (padded to ``pad_to``
        slots by repeating the first): one gather per retained launch plus
        one permutation."""
        S = len(ents)
        pad_to = S if pad_to is None else max(pad_to, S)
        groups: Dict[int, Tuple[torch.Tensor, torch.Tensor, list, list]] = {}
        for out_pos, (M, L, i) in enumerate(ents):
            if i is None:      # uploaded full block: make it a 1-batch group
                M, L, i = M[None], L[None], 0
            g = groups.setdefault(id(M), (M, L, [], []))
            g[2].append(i)
            g[3].append(out_pos)
        parts_M, parts_L = [], []
        perm = np.empty(pad_to, dtype=np.int64)
        at = 0
        for M, L, idx, outs in groups.values():
            take = torch.tensor(idx, dtype=torch.int64, device=M.device)
            parts_M.append(M.index_select(0, take))
            parts_L.append(L.index_select(0, take))
            perm[np.asarray(outs)] = at + np.arange(len(idx))
            at += len(idx)
        perm[S:] = perm[0]     # padding repeats the first block
        pool_M = torch.cat(parts_M)
        pool_L = torch.cat(parts_L)
        if (len(groups) > 1 or pad_to != S
                or np.any(perm[:S] != np.arange(S))):
            ix = torch.from_numpy(perm).to(pool_M.device)
            pool_M = pool_M.index_select(0, ix)
            pool_L = pool_L.index_select(0, ix)
        return pool_M, pool_L

    def get_full_dev_many(self, relations: Sequence[str],
                          segments: Sequence[int],
                          cols: Optional[Dict[str, int]] = None
                          ) -> ConsumerBatch:
        """Multi-relation device-batch read: one :class:`ConsumerBatch`
        serving the internal rows of ``segments`` across every relation in
        ``relations`` (all sharing one subject simplex kind) straight from
        the device block pool — the consumer pipeline's read primitive
        (docs/DESIGN.md §6).

        All misses are dispatched first through one round-robin prefetch,
        then each relation's internal rows are compacted into one
        ``(rows_pad, width)`` device tensor with one gather off the retained
        launch tensor (batches mixing several launches or uploaded blocks
        go through :meth:`_stack_entries` first) — no host copy of any
        block. ``cols`` optionally trims a relation's columns to a proven
        degree bound (entries past the true max row count are all ``-1``,
        so trimming is lossless). Counting is one pool read per
        ``(relation, segment)``. Relations whose circuit breaker is OPEN
        (docs/DESIGN.md §12) bypass the device pool: their blocks are read
        from the host cache (``degraded_reads``) and assembled on the host
        in the gather's layout, bit-identical to it."""
        relations = tuple(relations)
        kind = relations[0][0]       # subject kind ("VV" subjects are V)
        for r in relations:
            if r[0] != kind:
                raise ValueError(
                    f"get_full_dev_many needs one subject kind per batch: "
                    f"{relations} mixes {kind!r} and {r[0]!r}")
        segments = [int(s) for s in segments]
        # host-side index assembly reads only immutable per-mesh tables, so
        # it runs OUTSIDE the engine lock
        n_int, _ = self.tables.counts(kind)
        iv = self.pre.interval(kind)
        ns_rows = [int(n_int[s]) for s in segments]
        n_rows = sum(ns_rows)
        rows_pad = ops.bucket_rows(n_rows)
        gid = np.empty(n_rows, dtype=np.int64)
        flat = np.zeros(rows_pad, dtype=np.int64)
        at = 0
        for s, n in zip(segments, ns_rows):
            gid[at:at + n] = np.arange(iv[s], iv[s] + n)
            flat[at:at + n] = np.arange(n)      # + slot * R below
            at += n
        gid_pad = np.full(rows_pad, -1, dtype=np.int32)
        gid_pad[:n_rows] = gid
        gid_dev = torch.from_numpy(gid_pad).to(self.device)

        # producer interaction under the lock: prefetch + pool-entry
        # resolution (which may sync in-flight launches); relations whose
        # breaker is open read host blocks instead
        with self._consumer_entry("get_full_dev_many"):
            live = [r for r in relations if self._device_arm_ok(r)]
            if live:
                self._prefetch_many({r: segments for r in live})
            ents_by_rel = {r: [self._dev_entry(r, s) for s in segments]
                           for r in live}
            host_by_rel: Dict[str, list] = {}
            for r in relations:
                if r in ents_by_rel:
                    continue
                blocks = []
                for s in segments:
                    self._bump(requests=1, degraded_reads=1)
                    self._count(r, s)
                    blocks.append(self._fetch(r, s, full=True))
                host_by_rel[r] = blocks

        # the gathers run on held tensor references — outside the lock
        M: Dict[str, torch.Tensor] = {}
        L: Dict[str, torch.Tensor] = {}
        for r in relations:
            if r in host_by_rel:
                # degraded read: the internal rows assembled on the host in
                # _gather_internal's layout (-1/0 bucket padding, columns
                # trimmed to w) and uploaded once
                w = self.deg[r]
                if cols and r in cols:
                    w = min(w, max(int(cols[r]), 1))
                Mh = np.full((rows_pad, w), -1, dtype=np.int32)
                Lh = np.zeros(rows_pad, dtype=np.int32)
                at = 0
                for (Mb, Lb), n in zip(host_by_rel[r], ns_rows):
                    Mh[at:at + n] = Mb[:n, :w]
                    Lh[at:at + n] = Lb[:n]
                    at += n
                M[r] = torch.from_numpy(Mh).to(self.device)
                L[r] = torch.from_numpy(Lh).to(self.device)
                continue
            ents = ents_by_rel[r]
            aid = id(ents[0][0])
            if (all(e[2] is not None for e in ents)
                    and all(id(e[0]) == aid for e in ents)):
                # steady state: every block lives in ONE retained launch
                pool_M, pool_L = ents[0][0], ents[0][1]
                slots = [i for _, _, i in ents]
            else:        # mixed launches / uploads: stacked gather
                pool_M, pool_L = self._stack_entries(ents)
                slots = range(len(ents))
            R = pool_M.shape[1]
            off = np.zeros(rows_pad, dtype=np.int64)
            at = 0
            for i, n in zip(slots, ns_rows):
                off[at:at + n] = i * R
                at += n
            flat_dev = torch.from_numpy(flat + off).to(self.device)
            w = pool_M.shape[2]
            if cols and r in cols:
                w = min(w, max(int(cols[r]), 1))
            M[r], L[r] = _gather_internal(pool_M, pool_L, flat_dev,
                                          gid_dev, w)
        return ConsumerBatch(kind=kind, segments=tuple(segments),
                             n_rows=n_rows, gid=gid, gid_dev=gid_dev,
                             M=M, L=L)

    def get_batch(self, relation: str, segments: Sequence[int]):
        """Fetch several segments' (M, L) host blocks as a list.

        All misses are enqueued first and dispatched in one drain (one
        batched launch per shard and ``batch_max`` segments, plus
        lookahead), then each block is read in order as in :meth:`get`.
        Duplicate segment ids are served from the same produced block.

        A call naming more segments than the host cache holds reads blocks
        that its own later launches evicted, so those are produced again
        at their read, as in the reference: an 8-segment cache serving a
        16-segment batch produces every block twice."""
        with self._consumer_entry("get_batch"):
            segments = [int(s) for s in segments]
            self._bump(requests=len(segments))
            for s in segments:
                self._count(relation, s)
            missing = [s for s in segments
                       if (relation, s) not in self.cache
                       and (relation, s) not in self._inflight]
            if missing:
                self._request(relation, missing)
                self._drain([relation])
            return [self._fetch(relation, s) for s in segments]

    def prefetch(self, relation: str, segments: Sequence[int]) -> None:
        """Traversal-order hint: enqueue + dispatch without blocking.
        Segments already cached / in flight / pending are skipped."""
        with self._consumer_entry("prefetch"):
            self._request(relation, segments)
            self._drain([relation])

    def prefetch_many(self, requests: Dict[str, Sequence[int]]) -> None:
        """Prefetch several relations at once without blocking; launches are
        dispatched round-robin across relations. Unknown relations are
        ignored."""
        with self._consumer_entry("prefetch_many"):
            self._prefetch_many(requests)

    def _prefetch_many(self, requests: Dict[str, Sequence[int]]) -> None:
        # contract: holds-lock
        for r, segs in requests.items():
            if r in self.queues:
                self._request(r, segs)
        self._drain([r for r in requests if r in self.queues])

    # -- leader-producer side -----------------------------------------------

    def _count(self, relation: str, segment: int) -> None:
        # contract: holds-lock
        key = (relation, segment)
        if key in self.cache:
            self._bump(cache_hits=1)
        elif key in self._inflight:
            self._bump(cache_hits=1, inflight_hits=1)
        else:
            self._bump(cache_misses=1)

    def _fetch(self, relation: str, segment: int, full: bool = False
               ) -> Tuple[np.ndarray, np.ndarray]:
        # contract: holds-lock
        """Stat-free read: serve from cache, else sync the in-flight launch,
        else queue-jump + dispatch + sync. ``full`` keeps external + padding
        rows. Lock held (only :meth:`_sync` may release it while waiting on
        the device)."""
        self._check_poisoned(relation)
        key = (relation, segment)
        while True:
            hit = self.cache.get(key)
            if hit is not None:
                break
            launch = self._inflight.get(key)
            if launch is None:
                t0 = time.perf_counter()
                # a blocking miss jumps the queue; at the queue front it
                # integrates last (MRU), so its own launch can never evict
                # it and the loop terminates
                q = self.queues[relation]
                if segment in q:
                    q.remove(segment)
                q.insert(0, segment)
                self._bump(t_queue=time.perf_counter() - t0)
                launch = self._dispatch(relation)
            if launch is not None:
                self._sync(launch)
            # loop: a prefetched launch's own integration may have
            # LRU-evicted this segment, in which case it is re-dispatched
        M, L, n_rows = hit
        t0 = time.perf_counter()
        out = (M, L) if full else (M[:n_rows], L[:n_rows])
        self._bump(t_integrate=time.perf_counter() - t0)
        return out

    def _drain(self, relations: Optional[Sequence[str]] = None) -> None:
        # contract: holds-lock
        """Round-robin one bounded pass over the pending queues, dispatching
        up to ``batch_max`` segments per relation per turn. The budget is
        fixed at entry: lookahead overflow requeued by a dispatch does not
        extend this pass."""
        rels = [r for r in (relations or self.relations) if self.queues[r]]
        budgets = {r: len(self.queues[r]) for r in rels}
        progress = True
        while progress:
            progress = False
            for r in rels:
                if budgets[r] <= 0 or not self.queues[r]:
                    continue
                before = len(self.queues[r])
                self._dispatch(r)
                budgets[r] -= max(1, before - len(self.queues[r]))
                progress = True
        self._harvest()

    def _harvest(self) -> None:
        # contract: holds-lock
        """Retire completed in-flight launches into the cache without
        blocking. Launches a consumer thread is already syncing are left to
        that thread."""
        for launch in self._flights:
            if not launch.done and not launch.syncing and launch.is_ready():
                self._integrate(launch)
        if any(l.done for l in self._flights):
            self._flights = collections.deque(
                l for l in self._flights if not l.done)

    def _sync(self, launch: _Launch) -> None:
        # contract: holds-lock
        """Block until a dispatched launch is ready and integrate it exactly
        once.

        Lock held exactly once on entry. The first consumer to need the
        launch becomes its *syncer*: it releases the lock for the device
        wait, re-acquires, and integrates. Concurrent consumers needing the
        same launch wait on the condition variable instead; each accounts
        its own wall-clock wait in ``t_sync``. If the syncer fails before
        integrating (a :class:`RelationWidthError`), a waiter takes over and
        surfaces the same error instead of hanging.

        Sync watchdog (docs/DESIGN.md §12): with ``sync_timeout_s`` set,
        the syncer's device wait is a bounded poll of the launch's CUDA
        event; a launch that is not ready within the window costs one
        ``sync_timeouts`` and is re-waited up to ``max_attempts`` times,
        after which it is FAILED (:meth:`_fail_launch`): waiters wake at
        once, the breaker records the failure, and callers re-dispatch the
        segments. The abandoned kernel and copies may still run on the
        stream; they write only into this launch's own tensors, which are
        dropped."""
        if launch.done or launch.error is not None:
            return
        t0 = time.perf_counter()
        if launch.syncing:
            while launch.syncing and not launch.done \
                    and launch.error is None:
                self._cond.wait()   # contract: syncer-handoff
            if launch.error is not None:
                # the syncer failed the launch (watchdog / device loss):
                # account the wait and let the caller re-dispatch
                self._bump(t_sync=time.perf_counter() - t0)
                return
            if not launch.done:       # syncer failed: take over the sync
                return self._sync(launch)
            self._bump(t_sync=time.perf_counter() - t0)
            return
        launch.syncing = True
        try:
            while True:
                self._cond.release()
                try:
                    # the ONE device wait that runs lock-free (released
                    # above, re-acquired below)  # contract: syncer-handoff
                    try:
                        self._device_wait(launch)
                        timed_out = None
                    except SyncTimeoutError as exc:
                        timed_out = exc
                finally:
                    self._cond.acquire()
                if timed_out is None:
                    break
                self._bump(sync_timeouts=1)
                launch.sync_attempts += 1
                if launch.error is not None:
                    break             # failed meanwhile (shard loss)
                if launch.sync_attempts >= self._fault_policy.max_attempts:
                    self._fail_launch(launch, timed_out)
                    self._breaker_failure(launch.relation, timed_out)
                    self._bump(t_sync=time.perf_counter() - t0)
                    return
                self._bump(retries=1)
        finally:
            launch.syncing = False
            self._cond.notify_all()
        self._bump(t_sync=time.perf_counter() - t0)
        if launch.error is None:
            self._integrate(launch)
        self._cond.notify_all()

    def _device_wait(self, launch: _Launch) -> None:
        """Device wait for one launch, called by the syncer with the engine
        lock RELEASED (it touches no shared engine state). With no
        ``sync_timeout_s`` this blocks on the launch's CUDA event (then
        sleeps out an injected hang); with the watchdog armed it polls the
        event and the injected hang every ``sync_poll_s`` and raises
        :class:`SyncTimeoutError` when the window expires."""
        timeout = self._fault_policy.sync_timeout_s
        if timeout is None:
            if launch.event is not None:
                launch.event.synchronize()
            wait = launch.hang_until - time.monotonic()
            if wait > 0:              # injected hang, no watchdog armed
                time.sleep(wait)
            return
        deadline = time.monotonic() + timeout
        poll = max(float(self._fault_policy.sync_poll_s), 1e-4)
        while True:
            if launch.is_ready():     # event.query() and the hang deadline
                return
            if time.monotonic() >= deadline:
                raise SyncTimeoutError(
                    f"launch for relation {launch.relation!r} not ready "
                    f"after {timeout}s (segments {list(launch.segments)!r})",
                    timeout_s=timeout, relation=launch.relation,
                    segment=launch.segments[0] if launch.segments else None,
                    shard=launch.shard,
                    attempt=launch.sync_attempts + 1)
            time.sleep(poll)

    def _fail_launch(self, launch: _Launch, exc: BaseException) -> None:
        # contract: holds-lock
        """Abandon a dispatched launch after a terminal fault: record the
        error (waking condvar waiters), deregister its segments from the
        in-flight table so they can re-dispatch, and reverse the
        dispatch-time production counters — ``segments_produced`` keeps
        meaning "distinct blocks actually produced". Idempotent."""
        if launch.done or launch.error is not None:
            return
        launch.error = exc
        for s in launch.segments:
            if self._inflight.get((launch.relation, s)) is launch:
                self._inflight.pop((launch.relation, s))
        try:
            self._flights.remove(launch)
        except ValueError:
            pass
        n = len(launch.segments)
        self._bump(failed_launches=1, failed_segments=n,
                   kernel_launches=-1, segments_produced=-n)
        self._bump_shard(launch.shard, failed_launches=1, failed_segments=n,
                         kernel_launches=-1, segments_produced=-n)
        self._cond.notify_all()

    # -- per-relation circuit breaker (docs/DESIGN.md §12) -------------------

    def _breaker_failure(self, relation: str, exc: BaseException) -> None:
        # contract: holds-lock
        """Record one device-arm failure; after ``breaker_threshold``
        consecutive failures the breaker OPENS: production and
        ``get_full_dev_many`` reads degrade to the host arm until the
        cooldown expires (then one launch probes the device arm again).
        A failure while open re-arms the cooldown."""
        b = self._breaker.setdefault(
            relation, {"failures": 0, "open": False, "open_until": 0.0,
                       "exc": None})
        b["failures"] += 1
        b["exc"] = exc
        if b["open"]:
            b["open_until"] = (time.monotonic()
                               + self._fault_policy.breaker_cooldown_s)
        elif b["failures"] >= self._fault_policy.breaker_threshold:
            b["open"] = True
            b["open_until"] = (time.monotonic()
                               + self._fault_policy.breaker_cooldown_s)
            self._bump(breaker_trips=1)

    def _breaker_success(self, relation: str) -> None:
        # contract: holds-lock
        """A device-arm launch succeeded: reset the consecutive-failure
        count; if the breaker was open this was the cooldown probe — close
        it (``breaker_recoveries``) and return reads to the device arm."""
        b = self._breaker.get(relation)
        if b is None:
            return
        if b["open"]:
            b["open"] = False
            self._bump(breaker_recoveries=1)
        b["failures"] = 0

    def _device_arm_ok(self, relation: str) -> bool:
        # contract: holds-lock
        """True when the device arm may be tried: breaker closed, or open
        with an expired cooldown (the probe window)."""
        b = self._breaker.get(relation)
        if b is None or not b["open"]:
            return True
        return time.monotonic() >= b["open_until"]

    def _poison(self, relation: str, exc: BaseException) -> None:
        # contract: holds-lock
        if relation not in self._poisoned:
            self._poisoned[relation] = exc

    def _check_poisoned(self, relation: str) -> None:
        # contract: holds-lock
        exc = self._poisoned.get(relation)
        if exc is not None:
            raise RelationPoisonedError(
                f"relation {relation!r} permanently failed earlier "
                f"(fault_policy.degrade is off); the engine cannot serve "
                f"it", relation=relation) from exc

    def _backoff_sleep(self, attempt: int) -> None:
        # contract: holds-lock
        """Exponential backoff between launch retry attempts. The sleep
        runs with the engine lock RELEASED — sleeping under the lock would
        stall every consumer thread; the caller re-filters its batch
        against cache + in-flight after the gap, so the de-dup guarantee
        survives the window."""
        delay = float(self._fault_policy.backoff_s) * (
            float(self._fault_policy.backoff_factor) ** max(attempt - 1, 0))
        if delay <= 0:
            return
        self._cond.release()
        try:
            # lock released above, re-acquired below
            time.sleep(delay)   # contract: backoff-sleep
        finally:
            self._cond.acquire()

    def _rehome_shard(self, lost: int, exc: BaseException) -> bool:
        # contract: holds-lock
        """Whole-shard device loss (docs/DESIGN.md §12): re-home the lost
        shard onto the first surviving shard — fail its un-synced flights
        (their device tensors are gone), drop and re-route its device pool
        through :meth:`BlockStore.rehome`, re-stage its table slice on the
        survivor's device, and point its ``ShardPlan`` slot there. Every
        shard reads the engine's one copy of the inverse maps
        (:meth:`dev_inverse`), so no per-shard replica is left to drop.
        Segment *attribution* (``_seg_shard``, per-shard stats) stays
        logical, so the per-shard production partition is untouched.
        Returns ``False`` when no surviving shard exists (a one-shard
        engine degrades to the host arm instead)."""
        if lost in self._lost_shards:
            return True               # already re-homed; retry proceeds
        survivors = [k for k in range(self.n_shards)
                     if k != lost and k not in self._lost_shards]
        if not survivors:
            return False
        target = survivors[0]
        self._lost_shards.add(lost)
        for launch in list(self._flights):
            if launch.shard == lost and not launch.done:
                self._fail_launch(launch, exc)
        self.store.rehome(lost, target)
        lo, hi = self.shard_plan.shard_bounds(lost)
        self._shard_tables[lost] = self._stage_shard_tables(lo, hi)
        self.shard_plan = self.shard_plan.rehomed(lost, target)
        self._bump(shards_lost=1, rehomed_segments=hi - lo)
        self._cond.notify_all()
        return True

    def _integrate(self, launch: _Launch) -> None:
        # contract: holds-lock
        if launch.done or launch.error is not None:
            return
        t0 = time.perf_counter()
        # The host copies were queued right behind the kernel and are
        # complete once the launch is ready, so these are plain numpy views
        # of pinned memory: no device wait under the lock.
        Mh = launch.M_host.numpy()   # contract: syncer-handoff (ready)
        Lh = launch.L_host.numpy()   # contract: syncer-handoff (ready)
        # Preallocated-width contract (paper §4.6): L is the TRUE row count
        # while M holds at most deg entries, so L > deg means the compaction
        # dropped neighbours. Fail loudly with the fix.
        worst = int(Lh.max()) if Lh.size else 0
        deg = self.deg[launch.relation]
        if worst > deg:
            raise RelationWidthError(
                f"relation {launch.relation!r} produced a row with {worst} "
                f"entries but the preallocated width is "
                f"deg[{launch.relation!r}]={deg}; the compacted M row would "
                f"silently drop neighbours. Construct the engine with "
                f"deg={{{launch.relation!r}: {worst}}} (or larger).",
                relation=launch.relation)
        # Reverse order so the explicitly requested segments (batch front)
        # are most-recently-used and cannot be LRU-evicted by their own
        # lookahead when the cache is small.
        for i, s in reversed(list(enumerate(launch.segments))):
            self._inflight.pop((launch.relation, s), None)
            self.cache.put((launch.relation, s),
                           (Mh[i], Lh[i], launch.n_rows[i]))
            # device pool: keep the still-device-resident rows addressable
            # for get_full_dev_many (holds a reference to the launch).
            # Degraded host-arm launches are never pooled: device reads of
            # their blocks go through the counted upload in _dev_entry.
            if not launch.host:
                self._dev_pool.put((launch.relation, s), launch.M, launch.L,
                                   i)
        launch.done = True
        self._bump(evictions=self.cache.evictions - self.stats.evictions,
                   t_integrate=time.perf_counter() - t0)

    def _lookahead_segments(self, relation: str, batch: List[int]) -> List[int]:
        # contract: holds-lock
        """Extend a drained batch with subsequent segments (paper §4.5
        proactive precomputation), de-duplicated against the cache, the
        in-flight table AND the relation's pending queue. Lookahead never
        crosses the owning shard's end: a shard only produces its own
        segments."""
        hi = self.shard_plan.bounds[int(self._seg_shard[batch[0]]) + 1]
        out: List[int] = []
        seen = set(batch)
        queued = set(self.queues[relation])
        for s in batch:
            for d in range(1, self.lookahead + 1):
                n = s + d
                if (n < hi and n not in seen and n not in queued
                        and (relation, n) not in self.cache
                        and (relation, n) not in self._inflight):
                    seen.add(n)
                    out.append(n)
        return out

    def _dispatch(self, relation: str) -> Optional[_Launch]:
        # contract: holds-lock
        """Drain the queue for ``relation`` (up to ``batch_max``), add
        lookahead, and dispatch one batched kernel. Never blocks: the
        returned launch holds device-tensor futures registered in the
        in-flight table.

        Launches are shard-pure: the first popped segment fixes the shard,
        queued segments of other shards stay queued (front, original
        order) for a later dispatch, and the kernel reads the shard's own
        sliced tables at shard-local indices."""
        t0 = time.perf_counter()
        q = self.queues[relation]
        batch: List[int] = []
        shard = -1
        deferred: List[int] = []
        while q and len(batch) < self.batch_max:
            s = q.pop(0)
            # stale entry: produced since it was queued
            if (relation, s) in self.cache or (relation, s) in self._inflight:
                continue
            if shard < 0:
                shard = int(self._seg_shard[s])
            elif int(self._seg_shard[s]) != shard:
                deferred.append(s)
                continue
            batch.append(s)
        if deferred:
            q[0:0] = deferred
        if not batch:
            self._bump(t_prepare=time.perf_counter() - t0)
            return None
        look = self._lookahead_segments(relation, batch)
        room = self.batch_max - len(batch)
        batch = batch + look[:room]
        if look[room:]:
            # the launch is capped at batch_max; overflow lookahead is
            # requeued so proactive production continues in later launches
            qs = set(q)
            q.extend(s for s in look[room:] if s not in qs)
        self._bump(t_prepare=time.perf_counter() - t0)
        return self._launch(relation, batch, shard)

    def _launch(self, relation: str, batch: List[int], shard: int
                ) -> Optional[_Launch]:
        # contract: holds-lock
        """Produce one drained batch through the §12 recovery ladder:

        1. breaker OPEN (cooldown running) -> host arm at once;
        2. device arm; an injected :class:`RelationError` feeds the
           breaker, and a *transient* one retries up to ``max_attempts``
           with exponential backoff — the backoff sleeps with the lock
           RELEASED, and the batch is re-filtered against cache +
           in-flight afterwards, so a segment is never produced twice
           even if another thread produced it during the gap;
        3. :class:`DeviceLostError` re-homes the shard (a surviving
           shard's pool) and retries there;
        4. exhausted/permanent -> host arm (``degrade=True``, the default)
           or poison the relation and raise (``degrade=False``).

        Only :class:`RelationError` subclasses enter the ladder —
        :class:`RelationWidthError` (a data error, identical on every arm)
        and every other exception (a CUDA error, a kernel build failure)
        propagate unchanged."""
        policy = self._fault_policy
        attempt = 1
        while True:
            if not self._device_arm_ok(relation):
                if policy.degrade:
                    return self._launch_host(relation, batch, shard)
                b = self._breaker.get(relation) or {}
                self._poison(relation, b.get("exc") or RelationError(
                    "circuit breaker open", relation=relation, shard=shard))
                self._check_poisoned(relation)
            try:
                launch = self._launch_device(relation, batch, shard,
                                             attempt)
            except RelationWidthError:
                raise                 # data error: identical on every arm
            except RelationError as exc:
                if isinstance(exc, DeviceLostError) \
                        and attempt < policy.max_attempts \
                        and self._rehome_shard(shard, exc):
                    self._bump(retries=1)
                    attempt += 1
                    continue
                self._breaker_failure(relation, exc)
                transient = (getattr(exc, "transient", False)
                             and not isinstance(exc, DeviceLostError))
                if transient and attempt < policy.max_attempts:
                    self._bump(retries=1)
                    attempt += 1
                    self._backoff_sleep(attempt - 1)
                    # the backoff gap ran with the lock released: another
                    # thread may have produced part of the batch meanwhile
                    batch = self._refilter(relation, batch)
                    if not batch:
                        return None
                    continue
                if policy.degrade:
                    return self._launch_host(relation, batch, shard)
                self._poison(relation, exc)
                raise
            if launch is not None and launch.error is None:
                self._breaker_success(relation)
            return launch

    def _refilter(self, relation: str, batch: List[int]) -> List[int]:
        # contract: holds-lock
        """De-dup a retry batch against cache + in-flight after a window
        in which the lock was released (backoff sleep)."""
        return [s for s in batch
                if (relation, s) not in self.cache
                and (relation, s) not in self._inflight]

    def _launch_device(self, relation: str, batch: List[int], shard: int,
                       attempt: int) -> _Launch:
        # contract: holds-lock
        """One device-arm kernel launch: pad to the power-of-two bucket,
        gather the batch's rows of the shard's tables on the device
        (shard-local indices), launch, queue the host copies, record the
        readiness event, and register the in-flight launch. Injected
        faults surface here as :class:`RelationError` subclasses: a launch
        fault before the kernel call, a sync hang after it."""
        if self._injector is not None:
            exc = self._injector.launch_fault(relation, batch, attempt,
                                              shard)
            if exc is not None:
                raise exc
        t0 = time.perf_counter()
        # pad the launch to a power-of-two bucket (duplicating the last
        # segment): O(log batch_max) launch shapes, as the reference
        b_pad = ops.bucket_rows(len(batch), self.bucket_floor)
        padded = batch + [batch[-1]] * (b_pad - len(batch))
        lo = self.shard_plan.bounds[shard]
        segs = torch.tensor([s - lo for s in padded], dtype=torch.int64,
                            device=self.device)

        kx, ky = RELATION_TABLES[relation]
        deg = self.deg[relation]
        nvl = self.tables.NV
        tabs = self._shard_tables[shard]
        if relation == "VV":
            tabX = tabs["T_local"].index_select(0, segs)
            tabY = tabX
            colg = tabs["LV_global"].index_select(0, segs)
        else:
            tabX = self._table_dev(kx, segs, tabs)
            tabY = self._table_dev(ky, segs, tabs)
            colg = tabs[_GLOBAL_NAME[ky]].index_select(0, segs)
        self._bump(t_prepare=time.perf_counter() - t0)

        t1 = time.perf_counter()
        M, L = ops.relation_block(relation, tabX, tabY, colg, nvl, deg=deg,
                                  backend=self.backend,
                                  assembly=self.assembly)
        if self.device.type == "cuda":
            # queued behind the kernel on the same stream; the event marks
            # kernel + copies done, so integration never waits on a later
            # launch the way a copy issued at read time would
            M_host = torch.empty(M.shape, dtype=M.dtype, pin_memory=True)
            L_host = torch.empty(L.shape, dtype=L.dtype, pin_memory=True)
            M_host.copy_(M, non_blocking=True)
            L_host.copy_(L, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        else:
            M_host, L_host, event = M, L, None
        dt = time.perf_counter() - t1
        self._bump(t_kernel=dt, kernel_launches=1,
                   segments_produced=len(batch))
        self._bump_shard(shard, t_kernel=dt, kernel_launches=1,
                         segments_produced=len(batch))

        n_int, _ = self.tables.counts(kx if relation != "VV" else "V")
        launch = _Launch(relation, batch, M, L, M_host, L_host, event,
                         [int(n_int[s]) for s in batch], shard=shard)
        if self._injector is not None:
            hang = self._injector.sync_hang_s(relation, batch, attempt,
                                              shard)
            if hang > 0:
                launch.hang_until = time.monotonic() + hang
        for s in batch:
            self._inflight[(relation, s)] = launch
        self._flights.append(launch)
        if not self.async_dispatch:
            self._sync(launch)
            return launch
        # backpressure on genuinely unfinished launches only (reads retire
        # launches via _sync without removing them from here)
        if any(l.done for l in self._flights):
            self._flights = collections.deque(
                l for l in self._flights if not l.done)
        if len(self._flights) > self.inflight_max:
            self._sync(self._flights.popleft())
        return launch

    def _launch_host(self, relation: str, batch: List[int], shard: int
                     ) -> _Launch:
        # contract: holds-lock
        """Degraded production on the HOST arm (docs/DESIGN.md §12): the
        numpy :func:`ops.relation_block_host` computes the batch with the
        same ``(M, L)`` as the device arms; results integrate into the host
        cache at once (nothing to sync) and the ``degraded_*`` counters
        record the detour. Host launches are never device-pooled — device
        reads of their blocks go through the counted upload path."""
        t0 = time.perf_counter()
        t = self.tables
        kx, ky = RELATION_TABLES[relation]
        segs = np.asarray(batch, dtype=np.intp)
        if relation == "VV":
            tabX = tabY = t.T_local[segs]
            colg = t.LV_global[segs]
        else:
            tabX = t.table(kx, segs)[0]
            tabY, colg = t.table(ky, segs)
        Mh, Lh = ops.relation_block_host(relation, tabX, tabY, colg,
                                         t.NV, deg=self.deg[relation])
        dt = time.perf_counter() - t0
        n = len(batch)
        self._bump(t_kernel=dt, kernel_launches=1, segments_produced=n,
                   degraded_launches=1, degraded_segments=n)
        self._bump_shard(shard, t_kernel=dt, kernel_launches=1,
                         segments_produced=n, degraded_launches=1,
                         degraded_segments=n)
        n_int, _ = t.counts(kx if relation != "VV" else "V")
        Mt, Lt = torch.from_numpy(Mh), torch.from_numpy(Lh)
        launch = _Launch(relation, batch, Mt, Lt, Mt, Lt, None,
                         [int(n_int[s]) for s in batch], shard=shard,
                         host=True)
        for s in batch:
            self._inflight[(relation, s)] = launch
        self._integrate(launch)
        return launch

    def _table_dev(self, kind: str, segs: torch.Tensor,
                   tabs: Dict[str, torch.Tensor]) -> torch.Tensor:
        # contract: holds-lock
        """Stacked per-segment table for ``kind`` from one shard's sliced
        tables (``segs`` are shard-local indices)."""
        if kind == "V":
            # virtual vertex table: tab[v] = (v,) with -1 past n_loc
            lv = tabs["LV_global"].index_select(0, segs)   # (B, NV)
            iota = torch.arange(self.tables.NV, dtype=torch.int32,
                                device=self.device)
            return torch.where(lv >= 0, iota[None, :], -1)[..., None]
        name = {"E": "E_local", "F": "F_local", "T": "T_local"}[kind]
        return tabs[name].index_select(0, segs)

    # -- boundary relations (consumer-side, no device — paper §4.4) --------

    def boundary_EV(self, edge_ids) -> np.ndarray:
        return self.pre.E[np.asarray(edge_ids)]

    def boundary_FV(self, face_ids) -> np.ndarray:
        return self.pre.F[np.asarray(face_ids)]

    def boundary_TV(self, tet_ids) -> np.ndarray:
        return self.smesh.tets[np.asarray(tet_ids)]

    def boundary_FE(self, face_ids) -> np.ndarray:
        """Edges of each face, via interval-bounded lookups (paper's example
        in §4.4: binary search inside the owner segment's E range)."""
        F = self.pre.F[np.asarray(face_ids)]
        nv = self.smesh.n_vertices
        e0 = edge_lookup(self.pre.E_keys, nv, F[:, 0], F[:, 1])
        e1 = edge_lookup(self.pre.E_keys, nv, F[:, 0], F[:, 2])
        e2 = edge_lookup(self.pre.E_keys, nv, F[:, 1], F[:, 2])
        return np.stack([e0, e1, e2], axis=1)

    def boundary_TE(self, tet_ids) -> np.ndarray:
        T = self.smesh.tets[np.asarray(tet_ids)]
        nv = self.smesh.n_vertices
        cols = [edge_lookup(self.pre.E_keys, nv, T[:, a], T[:, b])
                for a, b in _EDGE_COMBOS]
        return np.stack(cols, axis=1)

    def boundary_TF(self, tet_ids) -> np.ndarray:
        T = self.smesh.tets[np.asarray(tet_ids)]
        nv = self.smesh.n_vertices
        cols = [face_lookup(self.pre.F_keys, nv, T[:, a], T[:, b], T[:, c])
                for a, b, c in _FACE_COMBOS]
        return np.stack(cols, axis=1)


_GLOBAL_NAME = {"V": "LV_global", "E": "LE_global",
                "F": "LF_global", "T": "LT_global"}
