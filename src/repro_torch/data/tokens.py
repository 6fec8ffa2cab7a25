"""Synthetic token data pipeline with host-side producer/consumer prefetch,
a copy of the reference's ``data/tokens.py`` (numpy only).

The GALE principle applied to the LM stack: a background *producer* thread
generates/stages batches ahead of the device-side *consumer* (the train
step), hiding host data-preparation latency as GALE's producers hide
connectivity computation (docs/DESIGN.md §4). The stream is deterministic
in (seed, step) so restarts resume bit-identically mid-epoch.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class SyntheticTokens:
    """Deterministic pseudo-corpus: Zipfian tokens with local n-gram
    structure so the loss actually decreases during the example runs."""

    def __init__(self, vocab: int, seed: int = 0):
        self.vocab = vocab
        self.seed = seed

    def batch(self, step: int, batch_size: int, seq_len: int
              ) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 32) ^ step)
        # Zipf-ish marginal
        base = rng.zipf(1.3, size=(batch_size, seq_len + 1)) % self.vocab
        # inject learnable bigram structure: even positions predict +1
        fixed = (base[:, :-1] * 31 + 7) % self.vocab
        mask = rng.random((batch_size, seq_len)) < 0.5
        nxt = np.where(mask, fixed, base[:, 1:])
        tokens = base[:, :-1].astype(np.int32)
        labels = nxt.astype(np.int32)
        return {"tokens": tokens, "labels": labels}


class PrefetchingLoader:
    """Producer thread keeps ``depth`` batches staged ahead of the consumer."""

    def __init__(self, source: SyntheticTokens, batch_size: int,
                 seq_len: int, start_step: int = 0, depth: int = 2):
        self.source = source
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.depth = depth
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        step = self._step
        while not self._stop.is_set():
            b = self.source.batch(step, self.batch_size, self.seq_len)
            b["step"] = step
            while not self._stop.is_set():
                try:
                    self._q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
