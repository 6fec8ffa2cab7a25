"""Self-tuning kernel parameters for the port's relation engine.

The paper's Appendix A parameter study shows that the right launch sizes
depend on the mesh and the backend. As in the reference
(``src/repro/launch/autotune.py``, copied here, never imported), this layer

  1. derives a small ranked set of candidate configurations from the
     H100 roofline model (:func:`candidate_configs`: the work functions of
     :mod:`.roofline` on the engine's real table shapes, plus the grid's
     waves, the extra shares' table walks and the wrappers' host cost),
  2. measures them on the real engine (:func:`measure_engine`, or the
     path itself as ``chip_smoke.py`` phase 8e does), and
  3. persists the winner per ``(backend, mesh-size bucket)`` in a small
     on-disk JSON table that :class:`~repro_torch.core.engine.
     RelationEngine` consults at construction (``tune="auto" | "off" |
     <path>``).

The port's knobs are the reference's ``batch_max`` and ``bucket_floor``.
Its kernels have no Pallas tiles, so the reference's ``block_x`` /
``block_y`` / ``vv_block`` have no counterpart: the bitmask kernels split
a segment's rows over as many blocks as their share rule gives for the
launch's batch (``segment_relations.bits_blocks``), and the model prices
each launch at that split. The table is the port's own too:
``$REPRO_TORCH_TUNE_TABLE`` or ``TUNE_torch_kernel_params.json`` in the
working directory, keyed ``"cuda/<bucket>"`` or ``"torch/<bucket>"``; the
reference's table holds Pallas tiles and is never read.

Config key: the mesh size is bucketed to the next power of two (the
buckets of ``ops.bucket_rows``), so one tuned entry covers a range of
meshes. Lookup order inside the engine: explicit constructor argument >
tuned table entry > built-in default. Tables carry a ``version`` field: a
mismatch invalidates the whole table (treated as missing), so stale
entries from an older kernel generation never configure a new engine.
"""

from __future__ import annotations

import dataclasses
import json
import numbers
import os
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from ..kernels import ops
from ..kernels import segment_relations as sr
from . import roofline

TABLE_VERSION = 1
_DEFAULT_NAME = "TUNE_torch_kernel_params.json"
_ENV = "REPRO_TORCH_TUNE_TABLE"

# host cost of one launch: the eager loop of the VV bitmask wrapper at B=64
# on 96^3 tables, 0.0426 ms, where its kernel takes 0.00758 ms (PERF.md §6
# row 1a, on an NVIDIA H100 80GB HBM3 at 700 W); the wrappers cost
# 0.027-0.066 ms a launch (PERF.md §5). The constant the batch dimension
# exists to hide; only used to RANK candidates before real measurement
_LAUNCH_OVERHEAD_S = 0.0426e-3
# resident blocks of a bitmask kernel on one multiprocessor: the share
# rule's target (``segment_relations.bits_row_blocks``)
_BLOCKS_PER_SM = 2

# the candidate grid
BATCH_MAX = (16, 32, 64, 128)
BUCKET_FLOOR = (1, 4)


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One tuned kernel-parameter point (engine constructor knobs).
    ``KernelConfig()`` is the engine's built-in launch."""

    batch_max: int = 64
    bucket_floor: int = 1

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, bool) or not isinstance(v, numbers.Integral) \
                    or v < 1:
                raise ValueError(f"{f.name}={v!r}: a positive int")
            object.__setattr__(self, f.name, int(v))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KernelConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def default_path() -> str:
    """Table location: ``$REPRO_TORCH_TUNE_TABLE`` or
    ``TUNE_torch_kernel_params.json`` in the current working directory."""
    return os.environ.get(_ENV, os.path.join(os.getcwd(), _DEFAULT_NAME))


def bucket(n_segments: int) -> int:
    """Mesh-size bucket: next power of two >= n_segments (min 1)."""
    n = max(1, int(n_segments))
    return 1 << (n - 1).bit_length()


def table_key(backend: str, n_segments: int) -> str:
    return f"{backend}/{bucket(n_segments)}"


def load_table(path: Optional[str] = None) -> Dict[str, Dict]:
    """Load the tuning table; any failure (missing file, bad JSON, version
    mismatch) returns an empty table, so tuning state can never break an
    engine construction."""
    path = path or default_path()
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict) or data.get("version") != TABLE_VERSION:
            return {}
        configs = data.get("configs")
        return configs if isinstance(configs, dict) else {}
    except (OSError, ValueError):
        return {}


def save_table(configs: Dict[str, Dict], path: Optional[str] = None) -> str:
    path = path or default_path()
    with open(path, "w") as f:
        json.dump({"version": TABLE_VERSION, "configs": configs}, f,
                  indent=2, sort_keys=True)
        f.write("\n")
    return path


def lookup(backend: str, n_segments: int,
           path: Optional[str] = None) -> Optional[KernelConfig]:
    """The engine-side read: tuned config for (backend, mesh bucket), or
    ``None`` when nothing is recorded."""
    entry = load_table(path).get(table_key(backend, n_segments))
    if not isinstance(entry, dict):
        return None
    try:
        return KernelConfig.from_dict(entry)
    except (TypeError, ValueError):
        return None


def record(backend: str, n_segments: int, config: KernelConfig,
           path: Optional[str] = None,
           score_s: Optional[float] = None) -> str:
    """Persist a measured winner for (backend, mesh bucket)."""
    configs = load_table(path)
    entry = config.to_dict()
    if score_s is not None:
        entry["score_s"] = float(score_s)
    configs[table_key(backend, n_segments)] = entry
    return save_table(configs, path)


def _relation_shape(relation: str, shapes: Mapping[str, int]):
    """(nvl, NX, NY) of one relation's launch on tables of ``shapes``
    (``NV``, ``NE``, ``NF``, ``NT``: the rows of the engine's segment
    tables), as :func:`roofline.entry_work` takes them."""
    nvl = int(shapes["NV"])
    if relation in ("VV", "TT"):
        return nvl, int(shapes["NT"]), int(shapes["NT"])
    kx, ky = relation
    return nvl, int(shapes[f"N{kx}"]), int(shapes[f"N{ky}"])


def _blocks(relation: str, B: int, shares: Optional[int],
            shapes: Mapping[str, int], sms: int, smem: int) -> int:
    """Blocks a segment of one launch as the wrapper sizes its grid
    (:func:`segment_relations.bits_blocks`), 1 on the sort route and for
    TT."""
    if roofline.ENTRY_ARM.get(relation) not in ("VV", "member", "sub"):
        return 1
    nvl, NX, NY = _relation_shape(relation, shapes)
    return sr.bits_blocks(relation, B, nvl, NX, NY, smem, sms, shares) or 1


def predicted_kernel_s(relation: str, B: int, shares: Optional[int],
                       shapes: Mapping[str, int], deg: int,
                       sms: int = roofline.SMS,
                       smem: int = roofline.SMEM_OPTIN_BYTES) -> float:
    """Predicted device time of one launch of ``relation`` over B segments
    at ``shares`` blocks a segment (``None``: the share rule): the roofline
    bound of the launch's work (:func:`roofline.entry_work`, full tables),
    stretched by the grid's fill of the card (B * shares blocks over
    ``_BLOCKS_PER_SM`` resident blocks on each of ``sms`` multiprocessors,
    in whole waves), plus one more walk of the tables for each extra
    share, since every block of a segment walks its whole table. The sort
    route and TT run one block a segment; EE and FF, which always take the
    dense arm, are priced at their meet-count launch."""
    nvl, NX, NY = _relation_shape(relation, shapes)
    if relation not in roofline.ENTRY_ARM:
        a = roofline.KIND_ARITY[relation[0]]
        return roofline.meet_work(B, NX, a, NY, a).bound_s()
    work = roofline.entry_work(relation, B, nvl, NX, NY, deg)
    k = _blocks(relation, B, shares, shapes, sms, smem)
    blocks = B * k
    slots = _BLOCKS_PER_SM * sms
    fill = blocks / (-(-blocks // slots) * slots)
    walk = roofline.table_bytes(relation, B, nvl, NX, NY)
    return work.bound_s() / fill + (k - 1) * walk / roofline.HBM_BYTES_PER_S


def _launch_plan(cfg: KernelConfig, n_segments: int, demand: int):
    """The launches of one sweep: (padded batch, count) pairs. Each launch
    carries ``min(batch_max, demand)`` segments, the last the rest, each
    padded to its ``bucket_rows`` bucket at the config's floor."""
    b = max(1, min(cfg.batch_max, demand, n_segments))
    full, tail = divmod(n_segments, b)
    plan = [(ops.bucket_rows(b, cfg.bucket_floor), full)]
    if tail:
        plan.append((ops.bucket_rows(tail, cfg.bucket_floor), 1))
    return plan


def _predicted_launch_s(cfg: KernelConfig, n_segments: int,
                        shapes: Mapping[str, int], relations: Sequence[str],
                        deg: Mapping[str, int], demand: int, sms: int,
                        smem: int) -> float:
    """Analytic time per SEGMENT for one candidate: for each relation, the
    sweep's launches (:func:`_launch_plan`), each priced at
    :func:`predicted_kernel_s` (the share rule's blocks) plus the host cost
    of a launch, amortized over the mesh's segments."""
    total = 0.0
    for relation in relations:
        for b_pad, count in _launch_plan(cfg, n_segments, demand):
            t = predicted_kernel_s(relation, b_pad, None, shapes,
                                   deg[relation], sms, smem)
            total += count * (t + _LAUNCH_OVERHEAD_S)
    return total / max(1, n_segments)


def candidate_configs(n_segments: int, shapes: Mapping[str, int],
                      relations: Sequence[str] = ("VV", "VT"),
                      deg: Optional[Mapping[str, int]] = None,
                      demand: Optional[int] = None,
                      max_candidates: int = 8, sms: int = roofline.SMS,
                      smem: int = roofline.SMEM_OPTIN_BYTES
                      ) -> List[KernelConfig]:
    """Model-ranked candidate configs for an engine over ``relations`` on a
    mesh of ``n_segments`` segments whose tables have ``shapes`` (``NV``,
    ``NE``, ``NF``, ``NT``), ``deg`` the relations' widths (the engine's
    defaults if None). ``demand`` is the segments a launch carries when
    ``batch_max`` does not cap it: the consumer's batch plus the engine's
    lookahead; ``None`` takes the whole mesh, a sweep. ``sms`` and
    ``smem`` are the card's multiprocessors and per-block shared-memory
    limit (an H100's by default).

    The grid: ``KernelConfig()`` first, then ``batch_max`` in
    :data:`BATCH_MAX` and ``bucket_floor`` in :data:`BUCKET_FLOOR`, in
    that order. Candidates that launch the same sequence (the same padded
    batches; the blocks follow from them) keep only their first, so the
    default stands for every candidate that launches as it does. The
    returned list (best predicted first; ties in grid order) is what the
    measurement takes: the model prunes the sweep, the measurement picks
    the winner (:func:`pick_winner`)."""
    widths = dict(ops.DEFAULT_DEG)
    widths.update(deg or {})
    demand = n_segments if demand is None else max(1, int(demand))
    grid = [KernelConfig()] + [KernelConfig(batch_max=bm, bucket_floor=fl)
                               for bm in BATCH_MAX for fl in BUCKET_FLOOR]
    scored = {}
    for cfg in grid:
        plan = tuple(_launch_plan(cfg, n_segments, demand))
        if plan not in scored:
            scored[plan] = (_predicted_launch_s(
                cfg, n_segments, shapes, relations, widths, demand, sms,
                smem), len(scored), cfg)
    ranked = sorted(scored.values(), key=lambda t: t[:2])
    return [cfg for _, _, cfg in ranked[:max_candidates]]


def pick_winner(walls: Mapping[KernelConfig, Sequence[float]]
                ) -> KernelConfig:
    """The configuration to record from measured ``walls`` (seconds of
    each repeat, ``KernelConfig()`` among them): the fastest by its best
    repeat where that beats the default's best by more than the spread
    (slowest minus fastest repeat) of either, else the default. A
    difference within the repeats' own noise selects nothing."""
    default = KernelConfig()
    if default not in walls:
        raise ValueError("the default KernelConfig() was not measured")

    def spread(c):
        return max(walls[c]) - min(walls[c])

    best = min(walls, key=lambda c: (min(walls[c]), c != default))
    margin = min(walls[default]) - min(walls[best])
    return best if margin > max(spread(best), spread(default)) else default


def measure_engine(make_engine: Callable[[KernelConfig], Any],
                   relations: Sequence[str], segments: Sequence[int],
                   config: KernelConfig, repeats: int = 3) -> float:
    """Wall-clock seconds for one cold-cache sweep of ``relations`` over
    ``segments`` on an engine built with ``config`` (best of ``repeats``,
    first warmup sweep excluded: it pays the kernels' build and first
    launches).

    ``make_engine`` builds the engine from the candidate (the caller passes
    the constructor knobs through); cache state is reset between timed
    sweeps with the public :meth:`~repro_torch.core.engine.RelationEngine.
    clear_cache`."""
    eng = make_engine(config)
    for r in relations:                      # warmup: build every kernel
        for s in segments:
            eng.get(r, s)
    best = float("inf")
    for _ in range(max(1, repeats)):
        eng.clear_cache()
        t0 = time.perf_counter()
        for r in relations:
            for s in segments:
                eng.get(r, s)
        best = min(best, time.perf_counter() - t0)
    return best
