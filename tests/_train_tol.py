"""The tolerances of the train-step card test (``tests/test_torch_cuda.py::
test_train_step_on_the_card_equals_the_torch_arm``), derived on the CPU
from how far each SMOKE model's gradients move when its attention output
moves (``tests/test_torch_train.py`` holds the derivation's checks). It
imports the port only, never JAX, so that the card test can use it.

The card test holds the loss and every gradient of one ``loss_and_grads``
through the flash kernels against the plain arm's, within ``TRAIN_TOL`` of
each entry plus ``TRAIN_TOL`` of the tensor's largest. The hybrid's
recurrence amplifies the attention's rounding into its gradients, so:

- float32: the hybrid's tolerance is the dense family's times the ratio of
  their sensitivities (:func:`sensitivity`: the mean gradient deviation
  under a seeded 1e-6 relative noise on the attention output). It then
  admits the same attention error as the dense family's tolerance does.
- bf16: each arch's tolerance is at least ``BF16_MARGIN`` times the spread
  between two correct arms on the CPU (:func:`spread`: the Function with
  the kernel's plain forward against the plain arm): the margin covers a
  third correct arm, the kernel, rounding as differently again. Below half
  the tolerance the dtype's tolerance stands.
"""

import contextlib
import dataclasses
import functools
from unittest import mock

import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import steps, train
from repro_torch.models import layers, lm

CPU = torch.device("cpu")
TRAIN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DENSE = "deepseek-7b"
NOISE = 1e-6
NOISE_SEEDS = (1, 2, 3, 4)
BF16_MARGIN = 2.0


def _setup(arch, dtype):
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    if arch == "gemma-7b":
        cfg = dataclasses.replace(cfg, head_dim=256)
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), CPU,
                           torch.float32)
    batch = train.train_batch(cfg, train.SyntheticTokens(cfg.vocab).batch(
        0, 2, 128), CPU)
    return cfg, model, batch


def grads_with(arch: str, dtype: str, forward=None):
    """(loss, gradients) of one float32-master ``loss_and_grads`` of
    ``arch``'s SMOKE model (the card test's batch) on the CPU: the plain
    arm, or with ``forward`` as the flash Function's forward."""
    cfg, model, batch = _setup(arch, dtype)
    m = lm.build(cfg, CPU, torch.float32)
    m.load_state_dict(model.state_dict())

    def attend(q, k, v, is_causal, backend, dtype):
        return layers.flash_attention_trainable(q, k, v, causal=is_causal,
                                                forward=forward)
    with mock.patch.object(layers, "_attend", attend) if forward \
            else contextlib.nullcontext():
        return steps.loss_and_grads(m, batch, cfg, "torch")


@functools.lru_cache(maxsize=None)
def _plain(arch, dtype):
    return grads_with(arch, dtype)


def deviation(arch: str, dtype: str, forward) -> float:
    """The largest gradient change from the plain arm's with ``forward`` in
    units of the card test's measure (``TRAIN_TOL`` of the entry plus
    ``TRAIN_TOL`` of the tensor's largest): above 1 the card test fails."""
    tol = TRAIN_TOL[getattr(torch, dtype)]
    _, want = _plain(arch, dtype)
    _, got = grads_with(arch, dtype, forward)
    return max(float(((got[n] - g).abs()
                      / (tol * g.abs() + tol * g.abs().max())).max())
               for n, g in want.items())


def noisy(eps: float, seed: int):
    """The kernel's plain forward with its output times ``1 + eps N(0,
    1)``."""
    gen = torch.Generator().manual_seed(seed)

    def forward(q, k, v, causal=True):
        o = fa.flash_attention_ref(q, k, v, causal=causal)
        return o * (1 + eps * torch.randn(o.shape, generator=gen)
                    .to(o.dtype))
    return forward


@functools.lru_cache(maxsize=None)
def sensitivity(arch: str) -> float:
    """The mean float32 :func:`deviation` under ``NOISE`` relative noise on
    the attention output, over ``NOISE_SEEDS``."""
    return sum(deviation(arch, "float32", noisy(NOISE, s))
               for s in NOISE_SEEDS) / len(NOISE_SEEDS)


@functools.lru_cache(maxsize=None)
def spread(arch: str) -> float:
    """The bf16 :func:`deviation` of the kernel's plain forward: how far
    two correct arms' rounding sets the gradients apart."""
    return deviation(arch, "bfloat16", fa.flash_attention_ref)


def tolerance(arch: str, dtype: str) -> float:
    """The card test's tolerance for ``arch`` in ``dtype``."""
    base = TRAIN_TOL[getattr(torch, dtype)]
    if dtype == "bfloat16":
        return base * max(1.0, BF16_MARGIN * spread(arch))
    if configs.get_smoke_config(arch).family == "hybrid":
        return base * sensitivity(arch) / sensitivity(DENSE)
    return base
