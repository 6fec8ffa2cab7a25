"""Consumer-pipeline helpers shared by the algorithm drivers
(docs/DESIGN.md §6): the consumer-arm selection and the per-mesh degree
bounds that give the device arm its tight static column widths.

The device-resident consumer arm reads relation blocks through
:meth:`RelationEngine.get_full_dev_many` (one :class:`ConsumerBatch` of
device tensors per batch of segments); the host arm assembles the blocks
of :meth:`RelationEngine.get_batch` in numpy. Both are bit-identical.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..kernels import ops


def consumer_mode(ds, consumer: str = "auto") -> str:
    """Resolve the driver's consumer arm: ``"device"`` on data structures
    exposing the multi-relation device-batch API (`get_full_dev_many`),
    ``"host"`` otherwise. An explicit ``consumer="device"`` on a structure
    without the API raises instead of silently falling back."""
    if consumer == "auto":
        return "device" if hasattr(ds, "get_full_dev_many") else "host"
    if consumer not in ("device", "host"):
        raise ValueError(f"consumer must be auto/device/host, got {consumer!r}")
    if consumer == "device" and not hasattr(ds, "get_full_dev_many"):
        raise TypeError(
            f"consumer='device' needs a data structure with the "
            f"get_full_dev_many batch API; {type(ds).__name__} has none")
    return consumer


def shard_plan(ds, shards=None):
    """Resolve a driver's ``shards=`` argument against the data structure.

    Sharding is a property of the engine (its
    :class:`~repro_torch.distributed.sharding.ShardPlan`, fixed at
    construction); the drivers only *follow* it — shard-aligned segment
    batches and a shard-affine worker partition (docs/DESIGN.md §9).
    Returns the plan when the structure is sharded (``n_shards > 1``),
    else None. An explicit ``shards`` count that disagrees with the
    structure raises ``ValueError`` instead of silently running a
    different topology."""
    plan = getattr(ds, "shard_plan", None)
    n = getattr(plan, "n_shards", 1)
    if shards is not None and int(shards) != n:
        raise ValueError(
            f"shards={shards} requested but {type(ds).__name__} has {n} "
            f"shard(s); construct the RelationEngine with shards={shards}")
    return plan if n > 1 else None


def degree_bound(pre, relation: str) -> int:
    """Exact per-mesh maximum row count of a coboundary/adjacency relation,
    from host-side bincounts over the global tables.

    The preallocated engine width ``deg[relation]`` is a generous static
    bound (ops.DEFAULT_DEG); this is the realized one, so the device
    consumer arm can trim its columns to a much smaller — still exact, hence
    lossless — width. Cached on ``pre`` after the first call."""
    cache = getattr(pre, "_consumer_deg_bounds", None)
    if cache is None:
        cache = {}
        pre._consumer_deg_bounds = cache
    if relation not in cache:
        cache[relation] = _degree_bound(pre, relation)
    return cache[relation]


def _degree_bound(pre, relation: str) -> int:
    sm = pre.smesh
    nv = sm.n_vertices
    if relation == "VT":
        c = np.bincount(sm.tets.reshape(-1), minlength=nv)
    elif relation in ("VV", "VE"):
        # VV neighbours are exactly the edge-adjacent vertices, so both
        # relations share the vertex-valence bound
        E = pre.E
        if E is None:   # VV alone does not precondition the edge table
            from ..core.mesh import enumerate_edges
            E, _ = enumerate_edges(sm.tets, nv)
        c = np.bincount(E.reshape(-1), minlength=nv)
    elif relation == "VF":
        c = np.bincount(pre.F.reshape(-1), minlength=nv)
    elif relation == "FT":
        return 2          # a face has at most two cofacet tets
    else:
        raise KeyError(relation)
    return int(c.max()) if c.size else 1


def degree_cols(pre, relations: Sequence[str]) -> Dict[str, int]:
    """Power-of-two-bucketed exact column widths for a consumer batch —
    the ``cols=`` argument of :meth:`RelationEngine.get_full_dev_many`."""
    return {r: ops.bucket_rows(degree_bound(pre, r)) for r in relations}
