"""A benchmark tree of small cells for the CPU tests: the real cells' jobs,
metrics, references and limits, at widths a test can hold, written into a
temporary root the registry reads as it reads the repository's."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from . import registry

TINY_MODELS = {
    "tiny-dense": {"family": "dense", "n_layers": 2, "d_model": 64,
                   "n_heads": 4, "n_kv_heads": 2, "d_ff": 96, "vocab": 256,
                   "rope_theta": 10000.0, "norm_eps": 1e-6,
                   "tie_embeddings": False, "dtype": "float32"},
    "tiny-moe": {"family": "moe", "n_layers": 4, "d_model": 128,
                 "n_heads": 4, "n_kv_heads": 2, "head_dim": 32, "d_ff": 64,
                 "vocab": 256, "n_experts": 8, "top_k": 2,
                 "moe_capacity_factor": 1.25, "rope_theta": 10000.0,
                 "norm_eps": 1e-6, "tie_embeddings": True,
                 "dtype": "float32"},
}
# tiny cell -> (configuration, traffic changes, the real cell whose traffic
# and limits it takes)
TINY_CELLS = {
    "train.tiny": ("tiny-dense", {"batch": 2, "seq": 32},
                   "train.deepseek-7b-l4.b4s2048"),
    "prefill.tiny-dense": ("tiny-dense", {"buckets": [8, 16, 32, 64],
                                          "length_median": 16,
                                          "max_batch_tokens": 256,
                                          "pool_tokens": 1 << 14,
                                          "clients": 8},
                           "prefill.deepseek-7b-l4.c32"),
    "prefill.tiny-moe": ("tiny-moe", {"buckets": [8, 16, 32, 64],
                                      "length_median": 16,
                                      "max_batch_tokens": 256,
                                      "pool_tokens": 1 << 14,
                                      "clients": 8},
                         "prefill.granite-moe-3b.c32"),
}
_BLOCKS = {"dense": "dense_block", "moe": "granite_moe_block"}


def write_tree(root: Path, dtype: str = "float32") -> Path:
    """Write ``BENCHMARK.json`` and the small cells' files under ``root``
    (models computing in ``dtype``); returns ``root``."""
    real = registry.load_benchmark()
    bench = copy.deepcopy(real)
    pkg = root / registry.HERE.name
    for sub in ("configs", "traffic", "limits"):
        (pkg / sub).mkdir(parents=True, exist_ok=True)
    bench["configs"] = []
    for name, model in TINY_MODELS.items():
        m = dict(model, dtype=dtype)
        path = pkg / "configs" / f"{name}.json"
        path.write_text(json.dumps({"name": name, "model": m,
                                    "reference": _BLOCKS[m["family"]]}))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": str(path.relative_to(root)),
                                 "reduced": [], "why": "test"})
    real_wl = {w["name"]: w for w in real["workloads"]}
    bench["workloads"] = []
    for name, (conf, changes, like) in TINY_CELLS.items():
        mix = dict(registry.traffic(real_wl[like]["traffic"]), **changes)
        tname = name.replace(".", "_")
        (pkg / "traffic" / f"{tname}.json").write_text(json.dumps(mix))
        lim = registry.HERE / "limits" / f"{like}.json"
        (pkg / "limits" / f"{name}.json").write_text(lim.read_text())
        bench["workloads"].append({"name": name, "config": conf,
                                   "traffic": tname, "chips": 1,
                                   "why": "test"})
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if "workloads" in m:
                m["workloads"] = [t for t, (_, _, like) in TINY_CELLS.items()
                                  if like in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
