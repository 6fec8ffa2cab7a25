"""Segment sharding for the relation engine (docs/DESIGN.md §9): the
:class:`ShardPlan` that splits the segments into contiguous shards, and
the integer sum that joins the shards' halves of the completion exchange.

Shards may repeat a device, as in the reference: one card then runs
several logical shards, each with its own sliced tables, device pool and
stats, and the exchange's sum runs on that card. Shards on distinct cards
would need the sum across cards (the reference's ``psum`` over its
``("data",)`` mesh); :func:`all_sum_shards` raises for that case, which
needs a second card to verify.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _card(d) -> Optional[Tuple[str, int]]:
    """A device's normalised ``(type, index)`` when it is a card, so that
    ``cuda`` and ``cuda:0`` name one card; ``None`` for the CPU and for an
    unplaced shard."""
    if d is None:
        return None
    d = torch.device(d)
    if d.type == "cpu":
        return None
    return d.type, d.index or 0


def _distinct_cards(devices: Sequence[Any]) -> int:
    """How many distinct cards ``devices`` name, or 0 when any entry is
    the CPU or unplaced."""
    cards = [_card(d) for d in devices]
    if any(c is None for c in cards):
        return 0
    return len(set(cards))


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Contiguous segment shards.

    Shard ``k`` owns segments ``[bounds[k], bounds[k+1])`` and produces and
    retains exactly those blocks on ``devices[k]``. Contiguity matters:
    Morton-ordered segments make each shard a spatially compact region, so
    cross-shard completion traffic concentrates on shard-boundary faces.
    ``devices`` may repeat (more shards than cards): the plan is then
    purely logical."""

    n_segments: int
    bounds: Tuple[int, ...]          # len n_shards + 1; [0] == 0, [-1] == ns
    devices: Tuple[Any, ...]         # one torch.device per shard (None = any)

    @property
    def n_shards(self) -> int:
        return len(self.bounds) - 1

    @property
    def multi_device(self) -> bool:
        """True when every shard sits on its own distinct card (the
        cross-card exchange path is only meaningful then); the CPU is
        never a distinct card."""
        return self.n_shards > 1 and \
            _distinct_cards(self.devices) == self.n_shards

    def shard_of(self, segment: int) -> int:
        return int(np.searchsorted(np.asarray(self.bounds[1:]),
                                   int(segment), side="right"))

    def shard_of_array(self, segments) -> np.ndarray:
        return np.searchsorted(np.asarray(self.bounds[1:]),
                               np.asarray(segments), side="right")

    def shard_bounds(self, shard: int) -> Tuple[int, int]:
        return self.bounds[shard], self.bounds[shard + 1]

    def rehomed(self, lost: int, target: int) -> "ShardPlan":
        """The plan after shard ``lost``'s device died and its segments
        were re-homed onto shard ``target``'s device. Segment ownership
        (``bounds``) is unchanged; only the lost slot's device is
        replaced, so the plan then repeats a device."""
        devices = list(self.devices)
        devices[lost] = devices[target]
        return ShardPlan(self.n_segments, self.bounds, tuple(devices))

    def segments(self, shard: int) -> range:
        return range(self.bounds[shard], self.bounds[shard + 1])

    @staticmethod
    def make(n_segments: int, shards: int = 1,
             devices: Optional[Sequence[Any]] = None) -> "ShardPlan":
        """Even contiguous split of ``n_segments`` into ``shards`` shards
        (clamped to the segment count), devices round-robin over the
        visible cards, or the CPU when there is none. ``shards=1`` keeps
        ``devices=(None,)`` and touches no device API."""
        n_segments = int(n_segments)
        shards = max(1, min(int(shards), max(1, n_segments)))
        base, rem = divmod(n_segments, shards)
        bounds = [0]
        for k in range(shards):
            bounds.append(bounds[-1] + base + (1 if k < rem else 0))
        if devices is None:
            if shards == 1:
                devices = (None,)
            else:
                n = torch.cuda.device_count() \
                    if torch.cuda.is_available() else 0
                devs = ([torch.device("cuda", k) for k in range(n)]
                        or [torch.device("cpu")])
                devices = tuple(devs[k % len(devs)] for k in range(shards))
        else:
            devices = tuple(None if d is None else torch.device(d)
                            for d in devices)
        return ShardPlan(n_segments, tuple(bounds), tuple(devices))


def all_sum_shards(parts: List[Tuple[torch.Tensor, torch.Tensor]],
                   devices: Optional[Sequence[Any]] = None):
    """Integer sum of per-shard ``(cand, cand_len)`` contributions.

    Each completion pair has exactly one owning shard; the owner
    contributes the gathered pool rows, every other shard exact zeros, so
    an elementwise integer sum reconstructs the single-pool candidate
    matrix bit for bit (docs/DESIGN.md §9). The sum keeps the parts'
    int32. Shards sharing a card (or the CPU) stack and sum on the first
    part's device; parts on distinct cards raise ``NotImplementedError``:
    the cross-card sum needs a second card to verify."""
    if len(parts) == 1:
        return parts[0]
    n = len(parts)
    if devices is not None and n > 1 and _distinct_cards(devices) == n:
        raise NotImplementedError(
            f"all_sum_shards over {n} distinct cards: the cross-card sum "
            f"is not verified, it needs a second card (ROADMAP queue 3); "
            f"run the shards on one card")
    dev = parts[0][0].device
    cands = torch.stack([c.to(dev) for c, _ in parts])
    lens = torch.stack([cl.to(dev) for _, cl in parts])
    return (torch.sum(cands, dim=0, dtype=cands.dtype),
            torch.sum(lens, dim=0, dtype=lens.dtype))
