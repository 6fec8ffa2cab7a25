"""One rank of the sharded LM's CPU checks (``tests/test_torch_distributed.py``
starts eight of these on a gloo group over a ``FileStore``). It imports the
port only, never JAX: the reference's inputs and outputs are computed in
the test process and handed over as numpy (``inputs.pkl``); rank 0 writes
every case's results, or its error, to ``results.pkl``.

    python tests/_dist_worker.py RANK WORLD WORKDIR
"""

import dataclasses
import os
import pickle
import sys
import traceback
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as meshes  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

# one SMOKE arch per family, float32
FAMILY_ARCHS = ("qwen2-7b", "qwen2-vl-7b", "granite-moe-3b-a800m",
                "mamba2-130m", "zamba2-2.7b", "whisper-base")
LM_B, LM_S, DECODE_STEPS = 4, 32, 3
# each Runtime option the model path branches on, with the parts it
# changes and the decode's batch, on qwen2-7b; seq_shard_decode is the
# long-context decode of one request (the reference's long_500k cell: its
# cache spec uses the data axis for the batch and the sequence, and drops
# it from the batch of 1)
OPTION_ARCH = "qwen2-7b"
OPTION_CASES = {"seq_shard_decode": (("decode",), 1),
                "seq_parallel": (("prefill", "train"), LM_B),
                "bf16_gather": (("train",), LM_B)}


def _np(t):
    if isinstance(t, shd.DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy()


def flash_decode_case(inp, mesh):
    q, K, V, pos = (torch.from_numpy(inp[k]) for k in ("q", "K", "V",
                                                        "pos"))
    out = {}
    for label, seq_shard, T in (("plain", False, None),
                                ("seq_shard", True, None),
                                ("indivisible", False, inp["T_indivisible"])):
        rt = shd.Runtime(mesh=mesh, batch_axes=("data",),
                         seq_shard_decode=seq_shard)
        got = rt.flash_decode(q, K[:, :T], V[:, :T], pos)
        out[label] = {"out": _np(got),
                      "placements": [str(p) for p in got.placements]}
    return out


def moe_case(inp, mesh):
    """Each EP axis: the forward and the gradients of sum(out * r) for x
    and every weight, on the mesh and (on rank 0) through the local
    moe_ffn from the same weights."""
    cfg = dataclasses.replace(configs.get_smoke_config(
        "granite-moe-3b-a800m"), moe_capacity_factor=8.0)
    x0 = torch.from_numpy(inp["x"])
    r = torch.from_numpy(inp["r"])
    out = {}
    for ep in ("data", "model", "local"):
        w = inp["weights"]
        rt = shd.Runtime(mesh=mesh, batch_axes=("pod", "data"),
                         moe_ep="data" if ep == "local" else ep,
                         moe_impl="local" if ep == "local" else "shard_map")
        res = {}
        for label, runtime in (("mesh", rt), ("local", None)):
            if runtime is None and dist.get_rank():
                continue
            p = SimpleNamespace(**{k: torch.from_numpy(v).requires_grad_()
                                   for k, v in w.items()})
            x = x0.clone().requires_grad_()
            y = runtime.moe_apply(p, x, cfg) if runtime else \
                moe_mod.moe_ffn(p, x, cfg)
            if isinstance(y, shd.DTensor):
                y = y.full_tensor()
            names = ("x",) + tuple(w)
            grads = torch.autograd.grad((y * r).sum(),
                                        [x] + [getattr(p, k) for k in w])
            res[label] = {"out": _np(y),
                          "grads": {n: _np(g) for n, g in zip(names,
                                                              grads)}}
        res["ep_size"] = rt.ep_size
        out[ep] = res
    return out


def spec_rules_case(mesh):
    """The spec -> placements rule on (2, 4): a tuple entry in mesh order
    splits one dim over both mesh dims (data the outer split, as JAX's),
    out of order it raises, and the drop rule."""
    from torch.distributed.tensor import distribute_tensor
    x = torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3)
    pl = shd.placements(mesh, (("data", "model"), None))
    d = distribute_tensor(x, mesh, pl)
    try:
        shd.placements(mesh, (("model", "data"), None))
        out_of_order = "accepted"
    except ValueError as e:
        out_of_order = str(e)
    r = dist.get_rank()
    return {"placements": [str(p) for p in pl],
            # rank r = data * 4 + model holds rows 2r, 2r + 1 (JAX's order)
            "rows_of_rank0": d.to_local()[:, 0].tolist() if r == 0 else None,
            "out_of_order": out_of_order,
            "dropped": [str(p) for p in shd.placements(
                mesh, ("model", "data"), shape=(3, 2))]}


def restore_case(inp, workdir):
    """Save on (4, 2) as ("data", "model"), restore on (2, 4) as
    ("model", "data")."""
    from torch.distributed.tensor import distribute_tensor
    d = os.path.join(workdir, "ckpt")
    mesh1 = meshes.make_mesh((4, 2), ("data", "model"), "cpu")
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    xs = distribute_tensor(x, mesh1, shd.placements(mesh1, ("data",
                                                            "model")))
    ckpt.save(d, {"w": xs}, step=1)
    mesh2 = meshes.make_mesh((2, 4), ("data", "model"), "cpu")
    sh2 = {"w": shd.NamedSharding(mesh2, ("model", "data"))}
    restored, step = ckpt.restore(d, {"w": x}, shardings=sh2)
    w = restored["w"]
    return {"step": step, "value": _np(w), "want": x.numpy(),
            "placements": [str(p) for p in w.placements],
            "want_placements": [str(p) for p in sh2["w"].placements],
            "same_mesh": w.device_mesh == mesh2,
            "local_shape": list(w.to_local().shape)}


def _decode_batches(cfg, B, n, T):
    """``n`` decode steps' inputs: row i of step t at position ``(11 t +
    8 i) % T``, so that the rows write into every slice of a cache split
    along its sequence."""
    rng = np.random.default_rng(3)
    out = []
    for t in range(n):
        pos = (11 * t + 8 * np.arange(B)) % T
        b = {"token": torch.from_numpy(rng.integers(
            0, cfg.vocab, (B, 1), dtype=np.int32)),
             "pos": torch.from_numpy(pos.astype(np.int32))}
        if cfg.family == "vlm":
            b["positions3d"] = b["pos"][None, :, None].expand(3, B, 1) \
                .contiguous()
        out.append(b)
    return out


def _batch(arrays):
    """A batch handed over as numpy (bf16 inputs as float32 beside their
    dtype's name) as torch tensors."""
    return {k: torch.from_numpy(a).to(getattr(torch, dt))
            for k, (a, dt) in arrays.items()}


def lm_case(arch, mesh, inp, options=None,
            parts=("prefill", "decode", "train"), B=LM_B):
    """``parts`` of ``arch``'s SMOKE config in float32 from the reference's
    weights and batches (``inp``; the decode's of ``B`` rows), on ``mesh``
    with the runtime's ``options`` and, on rank 0, with the same runtime
    without the mesh:
    the prefill's logits; three decode steps and one greedy
    ``make_serve_step``; ``loss_and_grads`` and one ``make_train_step``.
    Both arms train at ``remat="full"`` (the runtime's, the one source of
    ``make_train_step``'s remat), so the mesh arm's checkpointed blocks
    are held against the plain arm's."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32")
    if cfg.family == "moe":
        # capacity is per rank: with drops the sharded and the local
        # routing drop other pairs (in the reference too), so none here
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    rt = shd.Runtime(mesh=mesh, batch_axes=("data",), remat="full",
                     moe_ep=getattr(cfg, "moe_ep_pref", "data"),
                     **(options or {}))
    arms = [("mesh", rt)]
    if dist.get_rank() == 0:
        arms.append(("plain", dataclasses.replace(rt, mesh=None)))
    res = {}
    for label, runtime in arms:
        model = lm.params_from_reference(inp["tree"], cfg, "cpu",
                                         torch.float32)
        sharded = runtime.mesh is not None
        if sharded:
            shd.distribute_params(model, shd.make_param_shardings(
                mesh, model, moe_ep=rt.moe_ep))
        out = {}
        if "prefill" in parts or "decode" in parts:
            pre = runtime.shard_batch(_batch(inp["prefill"]), "prefill",
                                      cfg)
            logits, state = lm.prefill_fn(model, pre, cfg, "torch", runtime)
            out["prefill"] = _np(logits)
        if "decode" in parts:
            cache = lm.init_cache(cfg, B, LM_S, "cpu", rt=runtime)
            if cfg.family == "encdec":
                cache = (cache[0], state)          # the encoder states
            dec_logits = []
            batches = _decode_batches(cfg, B, DECODE_STEPS + 1, LM_S)
            for b in batches[:-1]:
                lg, cache = lm.decode_fn(
                    model, cache, runtime.shard_batch(b, "decode", cfg),
                    cfg, "torch", runtime)
                dec_logits.append(_np(lg))
            # one greedy step through make_serve_step too
            tok, cache = steps.make_serve_step(cfg, "torch", runtime)(
                model, cache, batches[-1])
            out["decode"] = np.stack(dec_logits)
            out["decode_token"] = tok.numpy()
            if sharded and cfg.family in ("dense", "moe", "vlm"):
                out["cache_placements"] = [str(p) for p in
                                           cache[0].placements]
        if "train" in parts:
            train = _batch(inp["train"])
            loss, grads = steps.loss_and_grads(model, train, cfg, "torch",
                                               runtime, remat=runtime.remat)
            out["loss"] = float(loss)
            out["grads"] = {n: _np(g) for n, g in grads.items()}
            opt = adamw.AdamWConfig(total_steps=4)
            state = adamw.init_state(dict(model.named_parameters()), opt)
            tstep = steps.make_train_step(cfg, opt, "torch", rt=runtime)
            before = {n: tuple(getattr(p, "placements", ()))
                      for n, p in model.named_parameters()}
            _, _, m = tstep(model, state, train)
            out["train_metrics"] = {k: float(v) for k, v in m.items()}
            # the in-place update keeps every parameter's and moment's
            # layout
            out["placements_kept"] = all(
                tuple(getattr(t, "placements", ())) == before[n]
                for n, p in model.named_parameters()
                for t in (p, state["mu"][n], state["nu"][n]))
            out["params"] = {n: _np(p) for n, p in model.named_parameters()}
        res[label] = out
    return res


def main():
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.manual_seed(0)
    torch.set_num_threads(1)
    meshes.init_group("gloo", rank, world, workdir)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    results = {}

    def run(name, fn, *args):
        try:
            results[name] = fn(*args)
        except Exception:                     # noqa: BLE001 - reported
            results[name] = {"error": traceback.format_exc()}
            raise

    try:
        run("flash_decode", flash_decode_case, inp["flash_decode"],
            meshes.make_mesh((2, 4), ("data", "model"), "cpu"))
        run("moe", moe_case, inp["moe"], meshes.make_mesh(
            (2, 2, 2), ("pod", "data", "model"), "cpu"))
        run("spec_rules", spec_rules_case,
            meshes.make_mesh((2, 4), ("data", "model"), "cpu"))
        run("restore", restore_case, inp, workdir)
        # two independent (2, 2) meshes: ranks 0-3 and 4-7
        lm_mesh = meshes.make_mesh((2, 2, 2), ("rep", "data", "model"),
                                   "cpu")["data", "model"]
        for arch in FAMILY_ARCHS:
            run(f"lm/{arch}", lm_case, arch, lm_mesh, inp["lm"][arch])
        for opt, (parts, B) in OPTION_CASES.items():
            run(f"lm/{OPTION_ARCH}/{opt}", lm_case, OPTION_ARCH, lm_mesh,
                inp["lm"][OPTION_ARCH], {opt: True}, parts, B)
    finally:
        if rank == 0:
            with open(os.path.join(workdir, "results.pkl"), "wb") as f:
                pickle.dump(results, f)
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
