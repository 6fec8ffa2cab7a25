"""Weights from the seed, made on the device by the benchmark.

Every weight of :func:`gale_bench.reference.lm.param_specs` is ``scale``
times a standard normal cut to [-2, 2] (a norm gain is ones), drawn in
float32 from one ``torch.Generator`` on the device, in large calls: the
weights are taken in the specs' order, and each call draws at least
``CHUNK`` numbers for as many consecutive weights as that takes. A weight is
stored in its destination's dtype (bf16 for serving, float32 masters for
training). The same seed, specs and device give the same numbers, so the
reference draws again what the program was given, and never reads the
program's copy.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from .seeds import derive

CHUNK = 1 << 28

Visit = Callable[[str, torch.Tensor], None]


def draw(specs: List[Tuple[str, tuple, Optional[float]]], seed: int, device,
         visit: Visit) -> None:
    """Draw every weight of ``specs`` and hand it to ``visit(name,
    float32 values)``; the values are a view into a scratch buffer, valid
    during the call."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(derive(seed, "weights"))
    pending: List[Tuple[str, tuple, float]] = []
    size = 0

    def flush():
        nonlocal pending, size
        if not pending:
            return
        buf = torch.randn(size, generator=gen, device=dev,
                          dtype=torch.float32).clamp_(-2.0, 2.0)
        off = 0
        for name, shape, scale in pending:
            n = 1
            for s in shape:
                n *= s
            visit(name, buf[off:off + n].view(shape).mul_(scale))
            off += n
        pending, size = [], 0

    for name, shape, scale in specs:
        if scale is None:
            visit(name, torch.ones(shape, dtype=torch.float32, device=dev))
            continue
        pending.append((name, tuple(shape), float(scale)))
        size += int(torch.Size(shape).numel())
        if size >= CHUNK:
            flush()
    flush()


def fill(named: Dict[str, torch.Tensor], specs, seed: int) -> None:
    """Draw into the tensors ``named`` (name -> destination), which must be
    exactly the specs' names and shapes."""
    want = {n: tuple(s) for n, s, _ in specs}
    have = {n: tuple(t.shape) for n, t in named.items()}
    if want != have:
        missing = sorted(set(want) - set(have))[:4]
        extra = sorted(set(have) - set(want))[:4]
        shapes = sorted(n for n in set(want) & set(have)
                        if want[n] != have[n])[:4]
        raise ValueError(f"weights differ from the specs: missing {missing}, "
                         f"unexpected {extra}, shapes differ {shapes}")
    device = next(iter(named.values())).device

    def put(name, values):
        with torch.no_grad():
            named[name].copy_(values)
    draw(specs, seed, device, put)


def make(specs, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """Fresh tensors of ``dtype`` holding the seed's weights."""
    out = {n: torch.empty(s, dtype=dtype, device=device)
           for n, s, _ in specs}
    fill(out, specs, seed)
    return out
