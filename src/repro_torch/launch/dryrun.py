"""Dry run of the sharded LM: trace every (architecture x input shape x
mesh) cell without allocating anything, and record what one rank would
need. Ported from the reference's ``launch/dryrun.py``.

  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k \\
      --multipod
  python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch

A cell runs in a process of its own (``--all`` starts one per cell, as the
reference does: a process holds one default group). It starts a fake
process group (``backend="fake"`` on a ``FakeStore``: this process plays
rank 0 of the mesh's size and every collective returns at once), builds
the mesh, and under ``FakeTensorMode`` (tensors with shapes and no data)
builds the model, distributes it (``distribute_params``), makes the
batch, the optimizer state or the cache, and runs one step through the
port's step functions: forward and backward for ``train``
(``steps.loss_and_grads``, with the AdamW state held; the update itself,
elementwise with one parameter's temporaries at a time, reads the step
count on the host, which a fake tensor does not hold, so it is not
traced), one forward for ``prefill`` and ``decode``. Attention runs on
the ``"torch"`` arm: a ctypes kernel cannot take fake tensors, and the
reference's dry run lowers on the CPU without its Pallas kernel too.

What one rank needs is read off its local ops. DTensor turns each
operation into local operations on the rank's shards and collectives; a
dispatch mode that steps aside for DTensor (``NotImplemented``) sees only
those, as this rank would run them, and:

- counts their FLOPs with ``FlopCounterMode``'s formulas
  (``torch.utils.flop_counter``), backward included;
- runs the step on fake tensors outside the fake mode, so that the ops
  DTensor runs on global-shaped fakes to propagate shapes (under a fake
  mode of its own) are told apart and skipped;
- tracks their outputs' storages: a storage counts from the op that made
  it until it is freed (a weak reference's callback), each once however
  many views share it; the parameters', optimizer state's, batch's and
  cache's shards count from the start. The peak of that sum is
  ``memory.peak_bytes_per_dev``: live tensor bytes, without the
  allocator's caching and fragmentation or a library's workspace;
- counts the collectives by kind.

The reference's XLA-HLO analysis (``launch/roofline.py``'s parser: HBM and
interconnect bytes per device, while-loop trip counts, the roofline terms)
has no counterpart in a traced eager program, so a record holds none of
those keys. It does hold ``model_flops_global`` and
``model_flops_per_dev`` (:func:`~.roofline.model_flops`) and
``useful_flops_ratio``, the model's FLOPs per device over the counted
ones.

The port's own options: ``--layers`` cuts the depth, ``--batch`` and
``--seq`` replace the shape's, ``--mesh-shape`` gives a ``("data",
"model")`` mesh of any size (``4,1``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from collections import Counter
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..configs import ARCH_IDS, SHAPES, get_config, get_smoke_config, \
    shape_applicable
from ..distributed.sharding import (Runtime, make_param_shardings,
                                    distribute_params)
from . import roofline
from .mesh import (batch_axes, init_group, make_mesh, make_production_mesh,
                   make_test_mesh)
from .specs import input_specs
from .steps import loss_and_grads, make_prefill_step, make_serve_step

_COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
                "reduce_scatter_tensor", "all_to_all_single")


class Tally(TorchDispatchMode):
    """One rank's FLOPs, live tensor bytes and collectives over the local
    operations of a traced step (see the module docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        from torch.utils.weak import WeakIdKeyDictionary
        self.formulas = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.live = 0
        self.peak = 0
        self.collectives: Counter = Counter()
        self._seen = WeakIdKeyDictionary()
        self._fake = None

    def track(self, t) -> None:
        """Count ``t``'s storage from now until it is freed."""
        if isinstance(t, DTensor):
            t = t._local_tensor
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake = active_fake_mode()     # None: the step runs outside
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch._subclasses.fake_tensor import FakeTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # let DTensor run its local ops
        kwargs = kwargs or {}
        c10d = torch.ops._c10d_functional
        if func is c10d.wait_tensor.default and isinstance(args[0],
                                                           FakeTensor):
            # a fake wait returns a new tensor; a real one its input
            return args[0]
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake:
            # DTensor's shape propagation: the op on global-shaped fakes
            # under a fake mode of its own
            return out
        pkt = func._overloadpacket
        if pkt in self.formulas:
            self.flops += self.formulas[pkt](*args, **kwargs, out_val=out)
        name = pkt.__name__
        if func.namespace == "_c10d_functional" and name in _COLLECTIVES:
            self.collectives[name] += 1
        for t in tree_flatten(out)[0]:
            self.track(t)
        return out


def _mesh_of(mesh_kind: str, multi_pod: bool, mesh_shape):
    if mesh_shape:
        return make_mesh(mesh_shape, ("data", "model"), "cpu")
    if mesh_kind == "prod":
        return make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    return make_test_mesh(multi_pod=multi_pod, device_type="cpu")


def _n_devices(mesh_kind, multi_pod, mesh_shape) -> int:
    if mesh_shape:
        return int(mesh_shape[0]) * int(mesh_shape[1])
    per_pod = 256 if mesh_kind == "prod" else 4
    return per_pod * (2 if multi_pod else 1)


def _fake_batch(cfg, shape):
    out = {}
    for k, (s, dt) in input_specs(cfg, shape).items():
        out[k] = torch.zeros(s, dtype=dt)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             mesh_kind: str = "prod", smoke: bool = False,
             remat: str = "full", moe_impl: str = "shard_map",
             seq_parallel: bool = False, bf16_gather: bool = False,
             moe_ep: Optional[str] = None, serve_stationary: bool = False,
             loss_chunk: int = 0, n_layers: Optional[int] = None,
             batch: Optional[int] = None, seq: Optional[int] = None,
             mesh_shape=None) -> dict:
    """Trace one cell under the fake group (started here; the process
    must hold no other default group) and return its record."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models import lm
    from ..optim import adamw

    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if not moe_ep:
        moe_ep = getattr(cfg, "moe_ep_pref", "data")
    shape = SHAPES[shape_name]
    if batch or seq:
        shape = dataclasses.replace(shape, global_batch=batch
                                    or shape.global_batch,
                                    seq_len=seq or shape.seq_len)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "multipod" if multi_pod else "singlepod",
           "mesh_kind": mesh_kind, "kind": shape.kind,
           "n_layers": cfg.n_layers, "global_batch": shape.global_batch,
           "seq_len": shape.seq_len}
    if mesh_shape:
        rec["mesh_shape"] = [int(n) for n in mesh_shape]
    if not shape_applicable(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = ("long_500k requires sub-quadratic attention; "
                         "skipped for pure full-attention archs")
        return rec

    n_dev = _n_devices(mesh_kind, multi_pod, mesh_shape)
    init_group("fake", 0, n_dev)
    try:
        mesh = _mesh_of(mesh_kind, multi_pod, mesh_shape)
        long_ctx = shape_name == "long_500k"
        rt = Runtime(mesh=mesh, batch_axes=batch_axes(mesh), remat=remat,
                     moe_impl=moe_impl, seq_shard_decode=long_ctx,
                     seq_parallel=seq_parallel, bf16_gather=bf16_gather,
                     moe_ep=moe_ep, loss_chunk=loss_chunk)
        tally = Tally()
        t0 = time.time()
        with FakeTensorMode(allow_non_fake_inputs=True):
            stationary = serve_stationary and shape.kind != "train"
            model = lm.build(cfg, "cpu", torch.bfloat16 if stationary
                             else torch.float32, ep=rt.ep_size)
            distribute_params(model, make_param_shardings(
                mesh, model, fsdp=None if stationary else rt.fsdp_axis,
                tp=rt.tp_axis, moe_ep=moe_ep))
            params = dict(model.named_parameters())
            b = _fake_batch(cfg, shape)
            state = cache = None
            if shape.kind == "train":
                state = adamw.init_state(params, adamw.AdamWConfig())
            elif shape.kind == "decode":
                cache = lm.init_cache(cfg, shape.global_batch,
                                      shape.seq_len, "cpu", rt=rt)
            held = {"params": sum(_local_bytes(p) for p in params.values()),
                    "state": _tree_bytes(state), "cache": _tree_bytes(cache)}
        # the step runs on the fake tensors outside the fake mode, so that
        # DTensor's propagation (a fake mode of its own) tells apart
        for t in tree_flatten([params, state, cache])[0]:
            tally.track(t)
        with tally:
            if shape.kind == "train":
                loss_and_grads(model, b, cfg, "torch", rt,
                               loss_chunk=loss_chunk, remat=remat)
            elif shape.kind == "prefill":
                make_prefill_step(cfg, "torch", rt)(model, b)
            else:
                make_serve_step(cfg, "torch", rt)(model, cache, b)
        t_trace = time.time() - t0
    finally:
        dist.destroy_process_group()

    mflops = roofline.model_flops(cfg, shape)
    rec.update({
        "status": "ok",
        "n_devices": n_dev,
        "t_trace_s": round(t_trace, 2),
        "params": int(cfg.param_count()),
        "active_params": int(cfg.active_param_count()),
        "memory": {"peak_bytes_per_dev": tally.peak,
                   "param_bytes_per_dev": held["params"],
                   "opt_state_bytes_per_dev": held["state"],
                   "cache_bytes_per_dev": held["cache"]},
        "flops_per_dev": tally.flops,
        "collectives": dict(tally.collectives),
        "model_flops_global": mflops,
        "model_flops_per_dev": mflops / n_dev,
        "useful_flops_ratio": (mflops / n_dev) / tally.flops
        if tally.flops else None,
    })
    return rec


def _local_bytes(t) -> int:
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tree_bytes(tree) -> int:
    return sum(_local_bytes(t) for t in tree_flatten(tree)[0])


def _cell_subprocess(arch, shape, multipod, args) -> dict:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape]
    if multipod:
        cmd.append("--multipod")
    if args.smoke:
        cmd.append("--smoke")
    if args.mesh != "prod":
        cmd += ["--mesh", args.mesh]
    if args.remat != "full":
        cmd += ["--remat", args.remat]
    if args.serve_stationary:
        cmd.append("--serve-stationary")
    if args.seq_parallel:
        cmd.append("--seq-parallel")
    if args.loss_chunk:
        cmd += ["--loss-chunk", str(args.loss_chunk)]
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=args.timeout)
    for line in reversed(out.stdout.splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    return {"arch": arch, "shape": shape,
            "mesh": "multipod" if multipod else "singlepod",
            "status": "error",
            "stderr": out.stderr[-4000:], "stdout": out.stdout[-2000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--mesh", default="prod", choices=("prod", "test"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--remat", default="full",
                    choices=("none", "dots", "full"))
    ap.add_argument("--moe-impl", default="shard_map",
                    choices=("shard_map", "local"))
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--bf16-gather", action="store_true")
    ap.add_argument("--moe-ep", default="", choices=("", "data", "model"))
    ap.add_argument("--serve-stationary", action="store_true")
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers")
    ap.add_argument("--batch", type=int, default=0,
                    help="replace the shape's global batch")
    ap.add_argument("--seq", type=int, default=0,
                    help="replace the shape's sequence length")
    ap.add_argument("--mesh-shape", default="",
                    help="a (data, model) mesh of this shape, e.g. 4,1")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)

    if args.all:
        outdir = args.out or "experiments/dryrun_torch"
        os.makedirs(outdir, exist_ok=True)
        for arch in ARCH_IDS:
            for shape in SHAPES:
                for multipod in (False, True):
                    tag = f"{arch}__{shape}__" + \
                        ("multipod" if multipod else "singlepod")
                    path = os.path.join(outdir, tag + ".json")
                    if os.path.exists(path):
                        continue
                    t0 = time.time()
                    try:
                        rec = _cell_subprocess(arch, shape, multipod, args)
                    except subprocess.TimeoutExpired:
                        rec = {"arch": arch, "shape": shape,
                               "status": "timeout"}
                    rec["wall_s"] = round(time.time() - t0, 1)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    print(tag, rec.get("status"), f"{rec['wall_s']}s",
                          flush=True)
        return

    try:
        rec = run_cell(args.arch, args.shape, args.multipod, args.mesh,
                       args.smoke, args.remat, args.moe_impl,
                       seq_parallel=args.seq_parallel,
                       bf16_gather=args.bf16_gather,
                       moe_ep=args.moe_ep or None,
                       serve_stationary=args.serve_stationary,
                       loss_chunk=args.loss_chunk,
                       n_layers=args.layers or None,
                       batch=args.batch or None, seq=args.seq or None,
                       mesh_shape=[int(n) for n in
                                   args.mesh_shape.split(",")]
                       if args.mesh_shape else None)
    except Exception as e:  # noqa: BLE001 - the record carries the failure
        rec = {"arch": args.arch, "shape": args.shape, "status": "error",
               "error": repr(e), "trace": traceback.format_exc()[-4000:]}
    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
