"""The one traffic generator: it reads a mix's parameters
(``traffic/<name>.json``) and makes the inputs of a run from its seed.

Training (``kind: train``): step ``i``'s batch is ``batch`` rows of ``seq +
1`` token ids drawn uniformly over the vocabulary on the device from the
seed and the step; ``tokens`` are a row's first ``seq`` ids, ``labels`` its
last ``seq`` (next-token prediction). No two steps share a row.

Prefill (``kind: prefill``): prompt lengths follow a log-normal
distribution (``length_median``, ``length_sigma``) served at the lengths
``buckets``: a bucket takes the distribution's mass between the geometric
midpoints to its neighbours, the first everything below, the last
everything above (prompts past the longest length are cut to it).
:func:`deck` rounds those shares to ``deck_size`` prompts; each run of
``deck_size`` requests holds that multiset in an order the seed shuffles,
so every seed offers the same sizes in its own order. A prompt's ids are
uniform over the vocabulary: a slice of a pool of ``pool_tokens`` ids
drawn once on the device from the seed, at an offset drawn from the seed
and the request, so a request is the same whoever serves it and whenever,
and a batch is assembled on the device without a copy from the host.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np
import torch

from .seeds import derive


def check_keys(mix: dict, keys) -> None:
    """Refuse a mix that names a parameter its job does not read, or lacks
    one it does (``why`` and ``source`` are notes, read by no one)."""
    have = set(mix) - {"why", "source"}
    if have != set(keys):
        raise ValueError(f"traffic of kind {mix.get('kind')!r}: unknown "
                         f"keys {sorted(have - set(keys))}, missing "
                         f"{sorted(set(keys) - have)}")


def train_batch(mix: dict, seed: int, step: int, vocab: int, device
                ) -> Dict[str, torch.Tensor]:
    B, S = int(mix["batch"]), int(mix["seq"])
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(derive(seed, "train", step))
    ids = torch.randint(0, vocab, (B, S + 1), generator=gen,
                        device=device, dtype=torch.int64).to(torch.int32)
    return {"tokens": ids[:, :-1].contiguous(),
            "labels": ids[:, 1:].contiguous()}


def deck(mix: dict) -> List[int]:
    """Prompts of each of ``buckets`` in a deck of ``deck_size``: the
    log-normal's shares (see the module), rounded by largest remainder."""
    b = [int(x) for x in mix["buckets"]]
    n = int(mix["deck_size"])
    z = NormalDist()
    mu, sigma = math.log(float(mix["length_median"])), \
        float(mix["length_sigma"])
    cdf = [0.0] + [z.cdf((0.5 * math.log(lo * hi) - mu) / sigma)
                   for lo, hi in zip(b, b[1:])] + [1.0]
    want = [n * (hi - lo) for lo, hi in zip(cdf, cdf[1:])]
    got = [int(w) for w in want]
    for j in sorted(range(len(b)), key=lambda j: got[j] - want[j])[
            :n - sum(got)]:
        got[j] += 1
    return got


class Requests:
    """The prompts of one prefill run, by request number, on ``device``."""

    def __init__(self, mix: dict, seed: int, vocab: int, device):
        self.buckets = [int(b) for b in mix["buckets"]]
        self.deck = np.repeat(self.buckets, deck(mix))
        self.seed = seed
        self._decks: Dict[int, np.ndarray] = {}
        gen = torch.Generator(device=torch.device(device))
        gen.manual_seed(derive(seed, "pool"))
        self.pool = torch.randint(0, vocab, (int(mix["pool_tokens"]),),
                                  generator=gen, device=device,
                                  dtype=torch.int64).to(torch.int32)

    def length(self, i: int) -> int:
        d, j = divmod(i, len(self.deck))
        if d not in self._decks:
            rng = np.random.default_rng(derive(self.seed, "deck", d))
            self._decks[d] = rng.permutation(self.deck)
        return int(self._decks[d][j])

    def tokens(self, i: int) -> torch.Tensor:
        L = self.length(i)
        at = derive(self.seed, "request", i) % (self.pool.shape[0] - L + 1)
        return self.pool[at:at + L]

    def batch(self, ids) -> torch.Tensor:
        """The prompts ``ids`` (of one length) as a (B, L) batch."""
        return torch.stack([self.tokens(i) for i in ids])
