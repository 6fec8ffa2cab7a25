"""Prefill serving (``kind: prefill``): the program's ``models.lm.prefill_fn``
(the call ``launch.steps.make_prefill_step`` wraps) on batches of prompts,
each request's first token the argmax of its row's last-position logits,
copied to the host.

Traffic, ``loop: closed`` (the only loop this job drives; a mix that asks
for another, or names a parameter the job does not read, is refused):
``clients`` clients each submit a prompt
(:class:`gale_bench.generator.Requests`) and the next one when its first
token returns. The batcher takes the oldest waiting request's length and
every waiting request of that length, oldest first, up to
``max_batch_tokens`` a batch: the rows of a batch have one length, as
``prefill_fn`` takes no per-row lengths. A request's time to first token
runs from its submission to its token on the host. The window closes with
the first batch that ends ``seconds`` after it opened; the requests still
waiting then are served after it (drained), their waits counted, their
tokens not.

The check: the reference recomputes the last-position logits of a sample
of the window's batches, in float32: the first batch of each length (so
the longest prompts are in it) and ``check_batches_extra`` more drawn
from the seed over the window (reservoir sampling). A row's ``logit_err``
is the root-mean-square gap between its served logits and the
reference's, in units of the reference row's standard deviation; a cell's
limits compare the largest (``logit_err``), the median row's
(``logit_err_p50``) or the share of rows above a level (``rows_over_<t>``),
as :meth:`Job.readings` reads them. The served token is the argmax of the
served logits, so their check covers it; ``token_gap``, the largest gap by
which a served token's reference logit lies below the reference's best, is
read beside them.
"""

from __future__ import annotations

import collections
import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import generator, weights
from ..reference import lm as ref_lm
from ..reference.precision import Precision, full_fp32
from ..seeds import derive
from ..trace import span


ROWS_OVER = "rows_over_"
KEYS = ("kind", "loop", "clients", "length_median", "length_sigma",
        "buckets", "deck_size", "max_batch_tokens", "pool_tokens",
        "check_batches_extra")


class Job:
    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.cell.traffic
        generator.check_keys(self.mix, KEYS)
        if self.mix["loop"] != "closed":
            raise ValueError(f"loop {self.mix['loop']!r}: this job drives "
                             f"a closed loop only")
        self.requests = generator.Requests(self.mix, ctx.seed,
                                           ctx.shape.vocab, ctx.device)
        self.clients = int(self.mix["clients"])
        self.max_tokens = int(self.mix["max_batch_tokens"])
        self.kept: Dict[int, Tuple] = {}     # batch number -> check inputs
        self.queue: collections.deque = collections.deque()
        self.ttft: List[float] = []

    def setup(self) -> None:
        from repro_torch.models import lm
        ctx = self.ctx
        arch = ctx.arch()
        ctx.mark("import_port")
        self.model = lm.build(arch, ctx.device)
        ctx.mark("build")
        weights.fill(dict(self.model.named_parameters()), ctx.specs,
                     ctx.seed)
        ctx.mark("weights")

        def serve(tokens):
            logits, _ = lm.prefill_fn(self.model, {"tokens": tokens}, arch,
                                      ctx.backend)
            return logits
        self.serve = serve
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(derive(ctx.seed, "warmup"))
        for L in self.requests.buckets:      # one full batch per length
            B = min(self.clients, self.max_tokens // L)
            tok = torch.randint(0, ctx.shape.vocab, (B, L), generator=gen,
                                device=ctx.device, dtype=torch.int64)
            torch.argmax(self.serve(tok.to(torch.int32))[:, -1], -1).cpu()
        ctx.mark("warmup")

    def _batch(self):
        """Take the next batch off the queue: the oldest request's length
        and every waiting request of it, up to the token cap."""
        L = self.queue[0][1]
        cap = max(1, self.max_tokens // L)
        rows, rest = [], collections.deque()
        for r in self.queue:
            if r[1] == L and len(rows) < cap:
                rows.append(r)
            else:
                rest.append(r)
        self.queue = rest
        return L, rows

    def _serve(self, rows):
        with span("batch"):
            tok = self.requests.batch([i for i, _, _ in rows])
        with span("prefill"):
            logits = self.serve(tok)
        with span("first_token"):
            first = torch.argmax(logits[:, -1], -1).cpu()
        t = time.perf_counter()
        for _, _, t_sub in rows:
            self.ttft.append(t - t_sub)
        return tok, logits, first, t

    def window(self, seconds: float) -> dict:
        rng = np.random.default_rng(derive(self.ctx.seed, "check sample"))
        extra = int(self.mix["check_batches_extra"])
        t0 = time.perf_counter()
        submitted = 0
        for _ in range(self.clients):
            self.queue.append((submitted, self.requests.length(submitted),
                               t0))
            submitted += 1
        batches: List[Tuple[int, int]] = []
        first_of: Dict[int, int] = {}
        sampled: List[int] = []
        while True:
            L, rows = self._batch()
            tok, logits, first, t = self._serve(rows)
            n = len(batches)
            batches.append((len(rows), L))
            keep = False
            if L not in first_of:
                first_of[L] = n
                keep = True
            elif len(sampled) < extra:
                sampled.append(n)
                keep = True
            else:
                j = int(rng.integers(0, n + 1))
                if j < extra:
                    self.kept.pop(sampled[j], None)
                    sampled[j] = n
                    keep = True
            if keep:
                self.kept[n] = (tok, logits[:, -1], first)
            if t - t0 >= seconds:
                break
            for _ in rows:
                self.queue.append((submitted,
                                   self.requests.length(submitted), t))
                submitted += 1
        return {"batches": batches, "tokens": sum(b * s for b, s in batches),
                "window_s": t - t0, "ttft_s": self.ttft,
                "attempted": submitted, "failed": 0}

    def drain(self) -> None:
        """Serve what is still waiting; the waits join ``ttft_s``."""
        while self.queue:
            _, rows = self._batch()
            self._serve(rows)

    def release(self) -> None:
        self.model = self.serve = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, controls=()) -> Dict[str, Dict]:
        """Over the kept batches' rows, against the float32 reference:
        ``"program"``'s numbers as it served them, and for each precision
        of ``controls`` (the reference run in it, :mod:`..reference.
        precision`) those of the token it puts first and of its logits.
        The numbers: ``token_gap`` (the largest), ``logit_err`` (the
        largest), ``logit_err_p50`` (the median row's), ``rows`` (how many
        were compared) and, for each ``rows_over_<t>`` the cell's limits
        name, the share of rows whose ``logit_err`` exceeds ``t``."""
        ctx = self.ctx
        params = weights.make(ctx.specs, ctx.seed, ctx.device,
                              self.model_dtype())
        who = ("program",) + tuple(controls)
        gaps = {p: [] for p in who}
        errs = {p: [] for p in who}
        for n in sorted(self.kept):
            tok, logits, first = self.kept[n]
            with full_fp32():
                ref = ref_lm.last_logits(params, tok, ctx.shape, ctx.block,
                                         Precision("float32"))
                std = ref.std(-1)
                for p in who:
                    if p == "program":
                        served = first.to(ref.device)
                        got = logits.float()
                    else:
                        got = ref_lm.last_logits(params, tok, ctx.shape,
                                                 ctx.block, Precision(p))
                        served = torch.argmax(got, -1)
                    gap = (ref.max(-1).values
                           - ref.gather(1, served[:, None])[:, 0]) / std
                    err = (got - ref).square().mean(-1).sqrt() / std
                    gaps[p].append(gap)
                    errs[p].append(err)
        del params
        over = {k: float(k[len(ROWS_OVER):]) for k in ctx.cell.limits
                if k.startswith(ROWS_OVER)}
        out = {}
        for p in who:
            gap, err = torch.cat(gaps[p]), torch.cat(errs[p])
            out[p] = {"token_gap": float(gap.max()),
                      "logit_err": float(err.max()),
                      "logit_err_p50": float(err.median()),
                      "rows": len(err)}
            for k, t in over.items():
                out[p][k] = float((err > t).float().mean())
        return out

    def model_dtype(self):
        return torch.bfloat16 if self.ctx.shape.dtype == "bfloat16" \
            else torch.float32

    def check(self) -> dict:
        return self.readings()["program"]
