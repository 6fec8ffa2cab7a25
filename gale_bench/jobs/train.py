"""Closed-loop training steps (``kind: train``): the program's
``launch.steps.make_train_step`` (forward and backward in the compute dtype
on float32 masters, AdamW in place), one object built in set-up, driven from
the seed through its first ``check_steps`` steps there, then through the
window, one step after another, each on a batch of its own.

The check: the reference (:mod:`gale_bench.reference`) trains a float32
copy of the same weights on the same first batches. Compared, each against
its limit: ``loss_gap``, the largest gap between the two losses over the
first steps; ``grad_gap``, the worst leaf's gap between the norms of the
first clipped gradient as the optimizer took it (the program's from its
first moment after one step, ``mu / (1 - beta1)``); ``change_gap``, the
worst leaf's gap between the norms of the weights' change over those steps.
A leaf's gap is measured against the larger of the reference's norm of that
leaf and of the median leaf; leaves whose reference gradient is below a
thousandth of the median leaf's are left out (they move by round-off).
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import torch

from .. import generator, weights
from ..reference import lm as ref_lm
from ..reference.adamw import AdamW
from ..reference.precision import Precision, full_fp32
from ..trace import span

QUIET = 1e-3        # a leaf whose reference gradient is below this share
                    # of the median leaf's is not compared


KEYS = ("kind", "batch", "seq", "check_steps", "optimizer")


class Job:
    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.cell.traffic
        generator.check_keys(self.mix, KEYS)
        self.n_check = int(self.mix["check_steps"])
        self.prog: Dict[str, object] = {}

    def batch(self, step: int, device=None):
        return generator.train_batch(self.mix, self.ctx.seed, step,
                                     self.ctx.shape.vocab,
                                     device or self.ctx.device)

    def setup(self) -> None:
        from repro_torch.launch import steps
        from repro_torch.models import lm
        from repro_torch.optim import adamw
        ctx = self.ctx
        ctx.mark("import_port")
        self.model = lm.build(ctx.arch(), ctx.device, torch.float32)
        ctx.mark("build")
        named = dict(self.model.named_parameters())
        weights.fill(named, ctx.specs, ctx.seed)
        ctx.mark("weights")
        opt_cfg = adamw.AdamWConfig(**self.mix["optimizer"])
        self.opt_state = adamw.init_state(named, opt_cfg)
        self.step = steps.make_train_step(ctx.arch(), opt_cfg, ctx.backend)
        losses: List[float] = []
        grad: Dict[str, float] = {}
        b1 = opt_cfg.beta1
        for i in range(1, self.n_check + 1):
            _, self.opt_state, m = self.step(self.model, self.opt_state,
                                             self.batch(i))
            losses.append(float(m["loss"]))
            if i == 1:
                grad = {n: float(t.norm()) / (1 - b1)
                        for n, t in self.opt_state["mu"].items()}
        ctx.mark("first_steps")
        self.prog = {"losses": losses, "grad": grad,
                     "change": _change(named, ctx.specs, ctx.seed)}
        self.next_step = self.n_check + 1

    def window(self, seconds: float) -> dict:
        from ..harness import sync
        dev = self.ctx.device
        steps = 0
        t0 = time.perf_counter()
        while True:
            with span("feed"):
                batch = self.batch(self.next_step)
            with span("train_step"):
                self.step(self.model, self.opt_state, batch)
            with span("sync"):
                sync(dev)
            self.next_step += 1
            steps += 1
            t = time.perf_counter()
            if t - t0 >= seconds:
                break
        B, S = int(self.mix["batch"]), int(self.mix["seq"])
        return {"steps": steps, "tokens": steps * B * S, "window_s": t - t0,
                "batch": B, "seq": S, "attempted": steps, "failed": 0}

    def drain(self) -> None:
        pass

    def release(self) -> None:
        self.model = self.opt_state = self.step = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32", rows=None) -> dict:
        """The reference's losses, first clipped gradients' and change's
        leaf norms over the first steps; ``rows`` trains on those rows of
        each batch only (a fault the check must see)."""
        ctx = self.ctx
        params = weights.make(ctx.specs, ctx.seed, ctx.device, torch.float32)
        for p in params.values():
            p.requires_grad_(True)
        opt = AdamW(params, self.mix["optimizer"])
        prec = Precision(precision)
        names = list(params)
        losses: List[float] = []
        grad: Dict[str, float] = {}
        for i in range(1, self.n_check + 1):
            b = self.batch(i)
            tok, lab = b["tokens"], b["labels"]
            if rows is not None:
                tok, lab = tok[rows], lab[rows]
            with full_fp32():
                loss = ref_lm.loss(params, tok, lab, ctx.shape, ctx.block,
                                   prec)
                grads = torch.autograd.grad(loss, [params[n] for n in names])
            norms = opt.step(dict(zip(names, grads)))
            del grads
            losses.append(float(loss.detach()))
            if i == 1:
                grad = norms
        out = {"losses": losses, "grad": grad,
               "change": _change(params, ctx.specs, ctx.seed)}
        del params, opt
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def check(self) -> dict:
        return compare(self.prog, self.reference())


def _change(named: Dict[str, torch.Tensor], specs, seed: int
            ) -> Dict[str, float]:
    """Each weight's norm of its change since the seed's draw."""
    out = {}

    def visit(name, values):
        with torch.no_grad():
            out[name] = float((named[name].float() - values).norm())
    weights.draw(specs, seed, next(iter(named.values())).device, visit)
    return out


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              counted) -> float:
    med = statistics.median(ref[n] for n in counted)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in counted)


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared: ``loss_gap``, ``grad_gap``, ``change_gap``."""
    med = statistics.median(ref["grad"].values())
    counted = [n for n, g in ref["grad"].items() if g >= QUIET * med]
    return {"loss_gap": max(abs(a - b) for a, b in
                            zip(prog["losses"], ref["losses"])),
            "grad_gap": _leaf_gap(prog["grad"], ref["grad"], counted),
            "change_gap": _leaf_gap(prog["change"], ref["change"], counted)}
