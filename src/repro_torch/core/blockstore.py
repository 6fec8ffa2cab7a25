"""Block storage for the relation engine: one LRU core, three wrappers.

The engine retains produced relation blocks in two places with different
granularities:

  - :class:`SegmentCache` — host-side numpy blocks keyed ``(relation,
    segment)``, evicted one segment at a time (DESIGN.md §3).
  - :class:`DevBlockPool` — device-resident blocks keyed the same way but
    *backed* by whole launch tensors: a batched launch produces one stacked
    ``(B, R, deg)`` tensor holding many segments, and retaining any one of
    them retains the launch. Eviction therefore runs at launch granularity
    (touching any entry pins the whole backing tensor as most-recent),
    which is what bounds device memory by *tensors*, not segments
    (DESIGN.md §6).

:class:`BlockStore` composes the two, and routes device-pool operations to
per-shard pools when the engine runs over a segment
:class:`~repro_torch.distributed.sharding.ShardPlan` (DESIGN.md §9): each
shard's pool retains only its own segments' blocks, so the
``dev_pool_segments`` bound holds per shard.

Thread-safety: none of these classes lock; the engine serialises access
under its single condition lock (DESIGN.md §8). Every mutating surface
(``get`` touches LRU recency too) is annotated ``# contract: holds-lock``
so contractcheck's lock-discipline rule verifies the callers.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple


class _LRUCore:
    """Ordered-map LRU shared by the cache and the pool.

    ``get`` marks the key most-recent; ``put`` inserts (or re-touches) and
    evicts least-recent entries past ``capacity``, returning them so the
    caller can release derived state (the pool drops per-segment entries of
    an evicted backing tensor). ``evictions`` counts evicted entries.
    """

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self._store: "OrderedDict[Any, Any]" = OrderedDict()
        self.evictions = 0

    def get(self, key: Any) -> Any:
        # contract: holds-lock
        val = self._store.get(key)
        if val is not None:
            self._store.move_to_end(key)
        return val

    def put(self, key: Any, value: Any) -> List[Tuple[Any, Any]]:
        # contract: holds-lock
        if key in self._store:
            self._store.move_to_end(key)
        self._store[key] = value
        evicted = []
        while len(self._store) > self.capacity:
            evicted.append(self._store.popitem(last=False))
            self.evictions += 1
        return evicted

    def __contains__(self, key: Any) -> bool:
        return key in self._store

    def __len__(self) -> int:
        return len(self._store)


class SegmentCache:
    """Host LRU over per-segment blocks ``(relation, segment) -> (M, L, n)``.

    External code must not touch the backing ``_store`` directly (the
    ``store-encapsulation`` contractcheck rule enforces this): memory
    accounting goes through :meth:`nbytes` and cold-cache modelling through
    :meth:`clear`, which the engine re-exports under its lock as
    ``RelationEngine.cache_nbytes()`` / ``clear_cache()``.
    """

    def __init__(self, capacity: int):
        self._core = _LRUCore(capacity)
        self._store = self._core._store

    @property
    def capacity(self) -> int:
        return self._core.capacity

    @property
    def evictions(self) -> int:
        return self._core.evictions

    def get(self, key):
        # contract: holds-lock
        return self._core.get(key)

    def put(self, key, value) -> None:
        # contract: holds-lock
        self._core.put(key, value)

    def clear(self) -> int:
        # contract: holds-lock
        """Drop every cached block. Returns the number of entries dropped."""
        n = len(self._store)
        self._store.clear()
        return n

    def nbytes(self) -> int:
        """Total bytes held by cached ``(M, L, n)`` blocks (numpy views of
        the launches' host copies, each counted at its own size)."""
        total = 0
        for (M, L, _) in self._store.values():
            total += int(M.size) * M.dtype.itemsize
            total += int(L.size) * L.dtype.itemsize
        return total

    def __contains__(self, key) -> bool:
        return key in self._core

    def __len__(self) -> int:
        return len(self._core)


class DevBlockPool:
    """Device-side LRU over launch-backed blocks.

    Entries map ``(relation, segment) -> (backing tensor id, row index)``;
    the LRU itself runs over *backing tensors* (``_arrays``: ``id(M) ->
    (M, L, keys)``), so a single eviction frees a whole launch and every
    segment it carried. Touching any entry moves its backing tensor to
    most-recent — the launch-granularity pin. Single-segment uploads are
    tensors of their own with ``idx None``.
    """

    def __init__(self, max_arrays: int):
        self._core = _LRUCore(max_arrays)
        self._arrays = self._core._store  # id(M) -> (M, L, set of keys)
        self._entries: Dict[Tuple[str, int], Tuple[int, Optional[int]]] = {}

    @property
    def max_arrays(self) -> int:
        return self._core.capacity

    @property
    def evictions(self) -> int:
        return self._core.evictions

    def get(self, key):
        # contract: holds-lock
        ent = self._entries.get(key)
        if ent is None:
            return None
        aid, idx = ent
        M, L, _ = self._core.get(aid)  # pins the whole backing launch
        return M, L, idx

    def put(self, key, M, L, idx) -> None:
        # contract: holds-lock
        aid = id(M)
        if aid in self._arrays:
            self._core.get(aid)  # re-touch: most-recent
            evicted = []
        else:
            evicted = self._core.put(aid, (M, L, set()))
        for _, (_, _, keys) in evicted:
            for k in keys:
                self._entries.pop(k, None)
        old = self._entries.get(key)
        if old is not None and old[0] != aid:
            prev = self._arrays.get(old[0])
            if prev is not None:
                prev[2].discard(key)
        self._arrays[aid][2].add(key)
        self._entries[key] = (aid, idx)

    def clear(self) -> int:
        # contract: holds-lock
        """Drop every backing tensor and entry in place. Returns the number
        of entries dropped."""
        n = len(self._entries)
        self._arrays.clear()
        self._entries.clear()
        return n

    def nbytes(self) -> int:
        """Bytes of the retained backing tensors: each launch tensor once,
        however many of its segments are pooled."""
        return sum(M.numel() * M.element_size() + L.numel() * L.element_size()
                   for (M, L, _) in self._arrays.values())

    def __contains__(self, key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)


class BlockStore:
    """The engine's storage layer: one host cache + per-shard device pools.

    Presents the :class:`DevBlockPool` ``get``/``put`` surface (the
    engine's ``_dev_pool`` *is* the store) next to the host ``cache``,
    routing each ``(relation, segment)`` key to the pool of the segment's
    owning shard via ``shard_of``. With one shard this is a single pool.
    A shard's slot can be re-routed onto another shard's pool after a
    device loss (:meth:`rehome`).
    """

    def __init__(self, cache_segments: int, pool_arrays: int,
                 n_shards: int = 1,
                 shard_of: Optional[Callable[[int], int]] = None):
        self.cache = SegmentCache(cache_segments)
        self.pools = [DevBlockPool(pool_arrays)
                      for _ in range(max(1, int(n_shards)))]
        # shard -> pool index; re-homing a lost shard redirects its slot
        # onto a survivor's pool (DESIGN.md §12)
        self._route = list(range(len(self.pools)))
        self._shard_of = shard_of

    def shard_of(self, segment: int) -> int:
        if self._shard_of is None or len(self.pools) == 1:
            return 0
        return int(self._shard_of(segment))

    def pool(self, shard: int) -> DevBlockPool:
        return self.pools[self._route[shard]]

    def rehome(self, lost: int, target: int) -> int:
        # contract: holds-lock
        """Re-home shard ``lost``'s pool slot onto shard ``target``'s pool
        after device loss (DESIGN.md §12): the lost pool's blocks are
        unreachable, so they are dropped in place, and every later
        ``get``/``put`` for the lost shard's segments routes to the
        survivor's pool. Returns the number of entries dropped."""
        dropped = self.pools[self._route[lost]].clear()
        self._route[lost] = self._route[target]
        return dropped

    def clear_shard(self, shard: int) -> int:
        # contract: holds-lock
        """Free one shard's device pool in place (upload-OOM recovery:
        clear, then retry the upload once). Returns entries dropped."""
        return self.pools[self._route[shard]].clear()

    # -- DevBlockPool surface, shard-routed --------------------------------
    def get(self, key):
        # contract: holds-lock
        return self.pool(self.shard_of(key[1])).get(key)

    def put(self, key, M, L, idx) -> None:
        # contract: holds-lock
        self.pool(self.shard_of(key[1])).put(key, M, L, idx)

    def __contains__(self, key) -> bool:
        return key in self.pool(self.shard_of(key[1]))

    def __len__(self) -> int:
        return sum(len(p) for p in self.pools)

    @property
    def evictions(self) -> int:
        return sum(p.evictions for p in self.pools)

    def clear_cache(self) -> int:
        # contract: holds-lock
        """Drop the host cache and every shard's device pool in place.
        Returns the total number of entries dropped (cache + pools)."""
        dropped = self.cache.clear()
        for p in self.pools:
            dropped += p.clear()
        return dropped

    def cache_nbytes(self) -> int:
        """Bytes retained across the host cache and all device pools."""
        return self.cache.nbytes() + sum(
            occ["bytes"] for occ in self.shard_occupancy())

    def shard_occupancy(self) -> List[Dict[str, int]]:
        """Per-shard device-pool occupancy: backing tensors, entries, bytes
        (the ``dev_pool_segments`` bound applies to each shard's pool
        separately)."""
        return [{"arrays": len(p._arrays), "entries": len(p),
                 "bytes": p.nbytes()} for p in self.pools]
