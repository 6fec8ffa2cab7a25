"""Checkpoints of named tensors: atomic save, restore onto the caller's
devices, keep the newest three. Ported from the reference's
``checkpoint/ckpt.py``.

A tree is a nested dict of tensors (the model's float32 masters and the
optimizer state). ``save`` writes every leaf as a numpy ``.npy`` file
beside a manifest of names, shapes and dtypes, in a temporary directory
renamed into place once complete, so a crash never leaves a half-written
``step_<n>``; then it deletes all but the newest ``keep``. The reference
writes one ``.npz``; separate files spare the zip archive's checksum pass
over what is tens of GB at full width. bf16 leaves, which numpy lacks,
are stored as their raw 16-bit words. ``restore`` reads
a step into the structure of a tree like the one saved, each leaf on that
tree's device in its dtype, or, given ``shardings=``, onto any mesh
(elastic restore: the saved layout is the global one, whatever mesh wrote
it).

A tree of DTensors (the sharded LM's) is saved whole: each leaf gathered
once (``full_tensor``, a collective every rank joins), written by rank 0,
then a barrier.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


def flatten(tree, prefix="") -> Dict[str, torch.Tensor]:
    """A nested dict's leaves by path (``"opt/mu/layers.0.attn.wq"``)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "/"))
        else:
            out[name] = v
    return out


def _unflatten(flat: Dict[str, torch.Tensor], tree_like, prefix=""):
    return {k: _unflatten(flat, v, f"{prefix}{k}/") if isinstance(v, dict)
            else flat[f"{prefix}{k}"] for k, v in tree_like.items()}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def save(path: str, tree, step: int, keep: int = 3) -> str:
    """Atomic checkpoint: write to a temporary directory, fsync the
    manifest, rename. Returns the final directory."""
    base = os.path.abspath(path)
    os.makedirs(base, exist_ok=True)
    final = os.path.join(base, f"step_{step:08d}")
    flat = flatten(tree)
    sharded = any(isinstance(t, DTensor) for t in flat.values())
    if sharded:
        flat = {n: t.full_tensor() if isinstance(t, DTensor) else t
                for n, t in flat.items()}
        if dist.get_rank() != 0:
            dist.barrier()                 # rank 0 writes
            return final
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=base)
    for i, t in enumerate(flat.values()):
        np.save(os.path.join(tmp, f"a{i}.npy"), _to_numpy(t))
    manifest = {
        "step": step,
        "n_leaves": len(flat),
        "names": list(flat),
        "shapes": [list(t.shape) for t in flat.values()],
        "dtypes": [str(t.dtype).split(".")[-1] for t in flat.values()],
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(base, keep)
    if sharded:
        dist.barrier()
    return final


def _gc(base: str, keep: int):
    steps = sorted(d for d in os.listdir(base) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(base, d), ignore_errors=True)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = sorted(d for d in os.listdir(path) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def restore(path: str, tree_like, step: Optional[int] = None,
            shardings=None) -> Tuple[dict, int]:
    """The tensors of ``step`` (default: the latest) in the structure of
    ``tree_like``, each leaf a new tensor on its ``tree_like`` leaf's
    device and in its dtype. ``shardings``: a tree with the same names
    whose leaves have ``mesh`` and ``placements``
    (``distributed.sharding.NamedSharding``): each leaf is then a DTensor
    on them, in its ``tree_like`` leaf's dtype (``distribute_tensor``, from
    rank 0's read). Returns (tree, step)."""
    like = flatten(tree_like)
    if shardings is not None:
        shardings = flatten(shardings)
        if list(shardings) != list(like):
            raise ValueError(
                f"shardings name other tensors than the tree: missing "
                f"{sorted(set(like) - set(shardings))[:5]}, unexpected "
                f"{sorted(set(shardings) - set(like))[:5]}")
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = os.path.join(os.path.abspath(path), f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["names"] != list(like):
        raise ValueError(f"checkpoint {d} holds other tensors than the tree "
                         f"given ({manifest['n_leaves']} against "
                         f"{len(like)} leaves)")
    flat = {}
    for i, (name, ref) in enumerate(like.items()):
        t = torch.from_numpy(np.load(os.path.join(d, f"a{i}.npy")))
        if manifest["dtypes"][i] == "bfloat16":
            t = t.view(torch.bfloat16)
        if shardings is None:
            flat[name] = t.to(device=ref.device, dtype=ref.dtype)
        else:
            sh = shardings[name]
            flat[name] = distribute_tensor(
                t.to(device=sh.mesh.device_type, dtype=ref.dtype), sh.mesh,
                sh.placements)
    return _unflatten(flat, tree_like), step
