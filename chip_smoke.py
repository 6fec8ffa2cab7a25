"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

    PYTHONPATH=src python3 chip_smoke.py        # from the repository root

Phases, one JSON line each, in the order 1, 9-13, 2-8e (5b after 5): the
LM phases run on the card while a host process of the script's own
(``--meshes``) builds phase 2's meshes, which phases 2-8e then read:

  1. device: the card, and the kernel build from
     ``src/repro_torch/kernels/csrc`` (one nvcc per source, started
     together, sm_90a) with its ptxas report, and the registers, shared
     memory and spills of the VV, member, TT, sub-join, gather and mma
     flash kernels by entry function.
  2. mesh: ``structured_grid(96, 96, 96)`` with the quickstart's Gaussian
     field -> ``segment_mesh(capacity=64)`` -> ``precondition`` for
     VV/VE/VF/VT/FT/TT, once; the 96^3 phases below share it. The mesh
     process builds it, and phase 4b's two 48^3 segmentations, beside the
     LM phases; phase 2 waits for it and loads its pickle.
  3. kernels: each relation-entry kernel arm (VV, member for VE/VF/VT
     and sub-join for FT/EF/ET on both routes, the bitmask kernels and the
     sort kernels; TT) held bit for bit against its plain torch version on
     the card, on the 96^3 tables at B=64 and on edge cases (B=1; prime
     sizes, nvl 8/11/31/33/127 and row counts that are not multiples of
     32; -1 slots inside sub-join rows; a fully valid lane vector; rows
     with L > deg; tables on each side of the old whole-mask limit, now
     row shares, past the member one-row limit, and on each side of the
     sub-join's old NX 8192 limit, both now on the bitmask route; TT and
     sub-join lanes too large for shared memory, which run from a device
     workspace; the VV and member sort route past the arms' precondition
     (a vertex twice in a row, rows of thousands of entries, member ids
     past nvl, nvl 60,000 past the shared-memory histogram); the
     bitmask kernels, a TT table with faces of three and four cofacets and
     a sub-join table with a repeated face key run twice for equal
     blocks); then
     the two count kernels of the dense fallback (meet: the 96^3 FF, EE
     and VF tables;
     VV counts: the 96^3 tets, and at each row tile of 8, 16 and 32) the
     same way, on B=1, prime sizes, all -1 rows, nvl=257 and ids of an
     oversize nvl=2**11. Times from CUDA
     events beside the bound, the plain version's time and, for the count
     kernels, a one-hot ``torch.bmm`` (incidence prebuilt) as yardstick;
     each kernel's own time from CUDA-graph replay (``ms``) beside the
     eager loop's (``eager_ms``, bound by the wrapper's host cost when the
     kernel is faster than it); VV, VE/VF/VT and FT/EF/ET on both routes
     at the 96^3 shapes, with the bitmask launches' row shares.
  4. critical-points path: ``RelationEngine(["VV","VT"])`` ->
     ``critical_points`` on the kernels and on the plain torch arm, with
     the launch counters zeroed just before the kernels' run and read just
     after; ``types`` equal to the JAX reference's (pinned below); then
     the same path under ``assembly="dense"`` (the VV count and meet
     kernels) with its own counters, ``types`` equal to the same pin.
     Every VV, member and sub-join launch of the mesh paths (phases 4-6)
     takes the bitmask route. Then the same path on the 48^3 mesh
     segmented at capacity 1024 (NV 2048, NT 8576: whole masks past the
     shared-memory limit, so the bitmask kernels run in row shares), on
     both arms, counters zeroed just before the kernels' run and read just
     after, ``types`` equal to the capacity-64 segmentation's; both routes
     held and timed at its shapes (the sort kernels forced: no path of
     this segmentation reaches them). Then
     EF and ET over every segment of that segmentation (NE 11,520 > 8192,
     NF 18,048: the sub-join bitmask kernel in row shares) on the kernels
     and on the plain arm, counters zeroed just before and read just after
     (every sub-join launch on the bitmask route, none on the sort
     kernel), every block equal; the bitmask and the forced sort kernel
     held and timed at those shapes (B=64).
  5. gradient -> Morse-Smale path at 48^3 (phase 6 drives it at 96^3):
     ``RelationEngine(["VE","VF","VT","FT","TT"])`` ->
     ``discrete_gradient(co_prefetch=("TT",))`` -> ``morse_smale`` on the
     kernels, counters zeroed just before and read just after; Euler =
     chi, counts and SHA-256 digests equal to the JAX reference's;
     ``morse_smale(adjacency="ft")`` (the sub-join bitmask kernel over
     every segment) equal to the TT route; the plain torch arm equal too.
 5b. the gradient at capacity 8192: the 48^3 mesh in 14 segments of at
     most 8192 vertices (nvl 11,008, NF 111,616: VF past the member
     bitmask kernel's one-row limit), ``precondition(["VE","VF","VT"])``,
     ``RelationEngine(["VE","VF","VT"])`` -> ``discrete_gradient`` on the
     kernels and on the plain torch arm, counters zeroed just before the
     kernels' run and read just after: every VF launch on the sort route's
     ``member_entries_kernel`` and every VE and VT launch on the bitmask
     kernel (the wrapper's calls by relation against the route counters),
     Euler 1, counts and digest equal to the JAX reference's at that
     segmentation (``REF_GRAD_8192``), every VF block equal between the
     arms; the sort kernel held and timed at the 14 segments' VF tables.
  6. audit + persistence path at 96^3: ``RelationEngine(["VE","VF","VT",
     "FT","TT","FF"])`` -> ``discrete_gradient(audit=True)`` (TT and FF
     completion; FF blocks from the meet kernel) -> ``morse_smale`` ->
     ``persistence_pairs`` -> ``simplify_ms`` on the kernels, counters
     zeroed just before and read just after: the gradient, complex,
     diagram and simplified complex equal to the JAX reference's.
  7. completion gather: the resolve + gather kernel held bit for bit
     against its plain version on a real completion chunk of phase 6 (the
     plan of 1024 paired tets, the pool from ``get_full_dev_batch``, the T
     inverse maps, the engine's segment start table) and on edge cases:
     synthetic maps with empty segments, the last segment, segments past
     the table and below 0, runs of 1 to 3000 gids, maps cut to an odd K
     inside a run, and a combined key that wraps int32; timed like phase 3.
  8. the whole audit + persistence path on both arms at 48^3, with the
     audit of a corrupted field (every double claim found) and the
     completed FF rows of a seeded face sample, against the 48^3 pins.
 8b. the compared data structures on phase 2's mesh: ``critical_points``
     through ``ExplicitTriangulation``, ``TopoClusterDS``, ``ActopoDS``
     (one segment a launch, each synced at dispatch) and the GALE engine,
     launch counters zeroed before and read after each run, every
     ``types`` equal to phase 4's pin, every VV and member launch on the
     bitmask route, the baselines' launches equal to their segments
     produced, the explicit structure launching none; ``fused_extrema``
     (batch 8) equal to the pin's minima and maxima with one VV count
     launch a batch, its loop run again under
     ``torch.cuda.set_sync_debug_mode("error")`` (no host sync); the
     explicit structure's gradient -> Morse-Smale at 48^3 against phase
     5's pins; ``analyze_mesh.run("foot")`` (GALE and Explicit rows)
     against the reference example's pins (``REF_FOOT``). Phase 3 also
     holds and times the VV and VT bitmask kernels at B=1 (the baselines'
     launch) and the VV count kernel at the fused batch (B=8, and a batch
     ending in -1 padding segments).
 8c. segment shards on the one card: ``critical_points`` at 96^3 through
     ``RelationEngine(shards=4)`` (four logical shards on ``cuda:0``),
     ``types`` equal to the pin, every launch inside one shard,
     ``merged_shard_stats()`` equal to ``stats``, each shard producing
     its own VV and VT blocks once, beside phase 8b's one-shard wall; a
     VV sweep producing each shard's segments once; the completion
     exchange (``execute_completion_sharded``) for TT and FF on a real
     96^3 chunk across the cut of the 2- and 4-shard plans, equal to one
     shard's rows on both arms; the gather kernel's mask mode (one
     shard's half, ``gather_candidates``) held bit for bit against its
     plain version for a shard owning every pair, none, and the real
     halves, which sum to the single-pool gather, and timed like phase
     7; the whole audit -> persistence -> ``simplify_ms`` path at 48^3 on
     four shards and four workers against phase 8's 48^3 pins.
  8d. fault recovery (the engine's §12 ladder) on the card: first, that no
     phase before it ran the numpy host arm; then ``critical_points(...,
     batch_segments=8, workers=2)`` at 48^3 (device pools of 4096
     segments) under six explicit ``FaultPolicy`` schedules: none; 6
     transient VV launch faults; one 5 s sync hang against a 0.05 s
     watchdog polling the launch's CUDA event; 6 permanent VV faults
     behind a breaker of 2 at ``batch_max=1``; shard 0's device lost at
     ``shards=2``; two block-pool upload faults with pools of one
     launch. Each ``types`` equal to its pin,
     each run's recovery counters checked, every schedule with no
     permanent fault kept off the host arm (``degraded_launches`` 0),
     the launch identity (kernel wrapper launches = ``kernel_launches``
     - ``degraded_launches`` + ``failed_launches``; host arm calls =
     ``degraded_launches``) and the worker and shard merges held; the
     gather kernel's masked halves of a 2-shard 96^3 TT engine whose
     shard 0 (6,912 segments) was re-homed summing to its single-pool
     gather; the 48^3 audit -> persistence path at 2 shards and 2 workers
     under a seeded mixed schedule (launch, sync and device-lost faults)
     against phase 8's 48^3 pins; the host arm
     (``ops.relation_block_host``) held bit for bit against the kernels
     (both assemblies) for all ten relations on phase 3's B=64 96^3
     tables, and timed a batch.
  8e. kernel-parameter autotuning (``launch/autotune.py``): the VV and VT
     bitmask kernels on phase 3's 96^3 tables at B = 8, 16, 32 and 64, at
     1, 2, 4, 8 and 16 shares a segment, and FT's sub-join at B=64 (1, 2,
     4) and B=16 (2, 4, 8, 16), each held bit for bit against its plain
     version and timed by graph replay beside its roofline bound
     (``launch/roofline.py``) and the ranking model's prediction;
     ``candidate_configs`` for the 48^3 mesh (1728 segments): at the
     critical-points consumer's batch of 8 (launches of 8 + 8 of
     lookahead) the whole grid launches as ``KernelConfig()`` does and the
     ranking holds the default alone; at a batch of 64 the top three and
     the default are timed on the critical-points path (each from its own
     table, ``clear_cache`` before each run, three runs after a warm-up,
     in turns), each one's blocks held against a ``tune="off"`` engine's
     on a sample of segments, and ``autotune.pick_winner`` records the
     fastest only where it beats the default by more than the runs'
     spread, else the default; an engine built from the run's table
     adopting the recorded knobs, its ``types`` equal to ``REF_CP_48``,
     its blocks equal to the untuned engine's, and the wrappers' launches
     equal to its ``kernel_launches``. Every phase's engines take
     ``tune="auto"``: ``$REPRO_TORCH_TUNE_TABLE`` points at a fresh
     temporary file from the start, which only 8e writes, so no stray
     table changes a launch or a counter before it.
  9. flash attention: the kernels held against their plain version
     (float32 2e-5, bf16 2e-2), each case naming the kernel the wrapper
     routed it to (``flash_fwd_wgmma`` for bf16 at hd 64/128/256 on
     layouts TMA reads, ``flash_fwd_mma`` for every float32 input and the
     other bf16 ones), causal and unmasked, at head dims 16/28/64/80/128/
     256 with GQA 8/1 and 28/4 and MHA, ragged S and T in both orders,
     S=1, strided views, heads whose stride is no multiple of 16 bytes
     (the mma kernel's element loads, bit for bit its 16-byte loads), and
     the qwen2-7b prefill shape (B 4, S 4096, H 28, KV 4, hd 128, bf16),
     where the wgmma kernel is timed beside the SIMT kernel on the same
     inputs, one ``scaled_dot_product_attention`` call, the plain version
     and its bound; the SIMT kernel, on no route, held by force
     (``simt=True``); ``flash_fwd_mma`` held against the plain version
     and timed at its main path's two shapes (the float32 S=2048 pin of
     phase 10, beside the SIMT kernel, held too, float32 SDPA and the
     plain version; whisper-base's encoder, beside the SIMT kernel and
     float32 SDPA); ``flash_fwd_wgmma`` held against the plain version
     and timed at gemma-7b's shape (bf16, B 4, S 4096, 16 heads, hd 256,
     causal) beside one SDPA call and its bound; and at phase 11b's two
     path shapes (bf16, B 4, S 4096, causal): ``flash_fwd_wgmma`` at
     granite-moe-3b's (24 heads over 8 KV heads, hd 64) and
     ``flash_fwd_mma`` at zamba2-2.7b's (32 heads, hd 80), each beside
     one SDPA call, the plain version and its bound.
 10. the JAX reference's full-width LM pins (``LM_PINS``), on both
     attention arms: qwen2-7b at full width cut to two layers and
     whisper-base whole, weights from ``reference_tree``, in float32
     (every cuda-arm flash launch the mma kernel's) and in the reference's
     configured bf16 (``check_lm_pins_bf16``, each pin's port error
     printed beside its ``ref_err``; every cuda-arm launch
     ``flash_fwd_wgmma``'s, ``PIN_FLASH``).
 11. qwen2-7b served at full width and depth in bf16 (weights from a
     seeded generator on the card): ``serve.main`` (4 prompts of 32
     tokens, 16 generated), then ``make_prefill_step`` at B=4 and S=4096
     and S=1000 on both arms in turns, 28 flash launches per call on the
     kernels' arm, every one ``flash_fwd_wgmma``, and the arms' logits
     within ``LM_ARM_TOL``; walls, tokens/s and the peak device memory.
 11b. the vlm, moe, ssm and hybrid families, through the same entry points:
     (a) the JAX reference's float32 and bf16 pins (``LM_FAMILY_PINS``)
     on both arms: qwen2-vl-7b cut to two layers (256 vision tokens on a
     16 x 16 grid of (0, h, w) ids, 768 text tokens), granite-moe-3b cut
     to two layers (and its first layer's per-expert counts and dropped
     pairs, with ``moe.dispatch`` dropping as many; in bf16 within the
     pin's near ties), mamba2-130m whole, zamba2-2.7b cut to one group (6
     Mamba2 layers and the shared block), each prefill's flash launches
     counted (2, 2, 0, 1: float32 the mma kernel, bf16 wgmma but zamba2's
     hd 80 on mma), and ``generate``; (b) each family at full width, cut
     to about half its depth (``FAMILY_FLASH``: 14, 16, 12 and 30 layers), in
     bf16 with seeded weights: ``serve.main`` and ``generate`` (4 x 32 +
     16 tokens, no flash launch in decode), ``make_prefill_step`` at B 4,
     S 4096 on both arms in turns with the kernels' launches asserted per
     call (qwen2-vl 14 and granite 16 ``flash_fwd_wgmma``, zamba2 5
     ``flash_fwd_mma``, mamba2 none), the arms' logits within
     ``LM_ARM_TOL``, granite's flipped expert choices between the arms
     per layer, walls, tokens/s and the peak device memory.
 11c. gemma-7b, deepseek-7b, command-r-35b and phi3.5-moe-42b-a6.6b, as
     11b: (a) their float32 and bf16 pins (``LM_NEW_PINS``: each at full
     width cut to two layers, a prefill at B 2, S 2048 and a generate; 2
     flash launches a prefill, bf16 on ``flash_fwd_wgmma``, gemma's at hd
     256) on both arms; (b) each at full width in bf16, ``NEW_FLASH``'s
     depth (gemma and deepseek whole, command-r 20 and phi3.5-moe 16
     layers): ``serve.main``, ``generate``, ``make_prefill_step`` at B 4,
     S 4096 on both arms in turns with every call's launches asserted, the
     arms' logits within ``LM_ARM_TOL`` (phi3.5-moe's with the torch arm's
     expert choices replayed on the kernels' arm, its free-running first
     layer within ``ARM_FIRST_FLIPS``: ``ARM_ROUTED``), phi3.5-moe's
     flipped expert choices per layer, walls, tokens/s and the peak device
     memory.
 12. LM training: (a) the JAX reference's float32 training pins
     (``LM_TRAIN_PINS``) on both arms: deepseek-7b at full width cut to two
     layers, three ``make_train_step`` calls (AdamW on float32 masters)
     each step's loss, grad norm and lr within ``TRAIN_PIN_TOL``, with and
     without the chunked cross entropy, 2 ``flash_fwd_mma`` launches a
     step on the kernels' arm (the backward is plain torch); and
     ``"train"`` on the kernels' arm under ``remat="full"`` and
     ``"dots"`` against the same pin, 4 launches a step (each
     checkpointed block's forward runs again in the backward); (b)
     deepseek-7b at full width, ``TRAIN_LAYERS`` layers, bf16, through
     ``launch.train.main`` at B 4, S 2048: 8 steps, then the same with a
     checkpoint every 5 and a fault injected at step 6, the last losses
     within the reference's 1e-5, 4 ``flash_fwd_wgmma`` launches a step;
     ``flash_fwd_wgmma`` and the Function's gradient at the step's
     attention shape against the plain version and its autograd; every
     gradient of one step finite and nonzero on the kernels' arm, the
     arms' step-0 loss, grad norm and each attention weight's gradient
     norm within ``TRAIN_ARM_TOL``; step time, tokens/s, peak memory, the
     checkpoint's walls, the attention backward's share and a profile of
     one step; (c) mamba2-130m whole as ``examples/train_lm.py`` trains
     it, 20 steps: the loss falls.
 13. the sharded LM on the card: a world-size-1 NCCL group on a
     ``FileStore`` in a temporary directory and a (1, 1) ``("data",
     "model")`` mesh, destroyed at the end: (a) qwen2-7b at full width cut
     to ``MESH_LAYERS`` layers, bf16, seeded: one prefill at B 4, S 4096
     with ``Runtime(mesh)`` and without, the next tokens equal and the
     logits within ``LM_ARM_TOL``, 4 ``flash_fwd_wgmma`` launches a sharded
     prefill (run per rank through ``rt.local``), both arms timed in turns
     through ``make_prefill_step``; ``generate`` (4 x 32 + 16 tokens) on
     both, the tokens equal; (b) deepseek-7b at full width, 2 layers,
     float32 masters, bf16 compute, 3 ``make_train_step(rt=)`` steps at B
     4, S 2048 against the same without a mesh, losses and grad norms
     within ``TRAIN_ARM_TOL``; (c) ``Runtime.flash_decode`` on a one-shard
     cache against the plain attention; (d) ``ckpt.save`` of DTensors and
     ``restore(shardings=)`` onto the mesh; (e) the dry run
     (``repro_torch.launch.dryrun``, each cell a process of its own,
     started first): phase 12b's training on one device, its peak beside
     the one phase 12 measured, then deepseek-7b's full 30 layers on (N,
     1) meshes, N = 1, 2, 4, 8, as the per-device need.

Then the ``phase_walls`` line (each phase's seconds), the ``{"kernels":
[...]}`` summary, the ``nvidia-smi`` name and power limit, and the final
``{"ok": true, ...}`` line. Any failure exits non-zero
before that line; without a card it exits non-zero and prints no result.
"""

from __future__ import annotations

import atexit
import dataclasses
import gc
import hashlib
import itertools
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N = 96                       # grid vertices per axis on both paths
BATCH = 64                   # the engine's batch_max: the launch shape
CHUNK = 1024                 # morse_smale's completion chunk (64 * 16)
RELS = ["VV", "VE", "VF", "VT", "FT", "TT"]
MS_RELS = ["VE", "VF", "VT", "FT", "TT"]

# The JAX reference at N=96 (xla arm, tune="off", device consumer arm, one
# worker), computed on a CPU with:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c '<build the quickstart mesh at
#   n=96; RelationEngine(pre, ["VV","VT"], lookahead=8, backend="xla",
#   tune="off"); critical_points(...)>'
# -> 1728 launches, 27648 segments produced.
REF_COUNTS = {"minima": 322, "saddles1": 570, "saddles2": 345, "maxima": 23,
              "degenerate": 0, "regular": 883476}
REF_TYPES_SHA256 = ("46b39eccfd74eda185ac49442a81d318"
                    "a3959b05cadcc3b0239aa12a294395bd")
# the same at N=48 (216 launches, 3456 segments produced; 10.7 s on a CPU):
# the pin of phase 8d's 48^3 scenarios (breaker, device loss, upload OOM)
REF_CP_48 = {"counts": {"minima": 11, "saddles1": 23, "saddles2": 12,
                        "maxima": 7, "degenerate": 0, "regular": 110539},
             "types_sha256": ("59822a83e268ede63b1cabedda3e627e"
                              "315359709143fe50a7a3faeaf40fa432")}

# The JAX reference's gradient and Morse-Smale complex at N=96 and N=48,
# computed on a CPU with:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c '<build the quickstart mesh
#   at n; precondition(sm, ["VV","VE","VF","VT","FT","TT"]);
#   eng = RelationEngine(pre, ["VE","VF","VT","FT","TT"], lookahead=8,
#   dev_pool_segments=4096, backend="xla", tune="off");
#   g = discrete_gradient(eng, pre, total_order(sm.scalars),
#   batch_segments=16, co_prefetch=("TT",)); ms = morse_smale(eng, pre, g);
#   print the counts and digest(g, GRAD_FIELDS), digest(ms, MS_FIELDS)>'
# (digest as defined below). At N=96: 5833 launches, 78512 segments
# produced, 5144245 completion queries, Euler characteristic 1.
GRAD_FIELDS = ("pair_v2e", "pair_e2f", "pair_f2t", "pair_e2v", "pair_f2e",
               "pair_t2f", "crit_v", "crit_e", "crit_f", "crit_t")
MS_FIELDS = ("dest_min", "dest_max", "saddle1_ends", "saddle2_ends")
REF_MS = {
    96: {"grad": {"crit_v": 322, "crit_e": 663, "crit_f": 347, "crit_t": 5},
         "ms": {"saddle1": 663, "saddle2": 347, "basins_min": 322,
                "basins_max": 5, "arcs": 636},
         "grad_sha256": ("6eaf1a50521185ce4cc0e906643231c8"
                         "1d7cf66877d67090ea69ca499d11ce2a"),
         "ms_sha256": ("3ca5c8a9ff948955215d4e08b344e312"
                       "136a6786f9c19d4867e9262f48d9c27c")},
    48: {"grad": {"crit_v": 11, "crit_e": 23, "crit_f": 15, "crit_t": 2},
         "ms": {"saddle1": 23, "saddle2": 15, "basins_min": 11,
                "basins_max": 2, "arcs": 23},
         "grad_sha256": ("ab00c59ec42e415a2b29916dd1a5dab9"
                         "ba6a107d5398863209b628d2d313df9d"),
         "ms_sha256": ("e1e19bfeb3dcfd92673548454d5a5d44"
                       "67520f0cda52b0458829d87f5bd4753d")},
}
# The JAX reference's examples/analyze_mesh.py on "foot" (GALE and Explicit
# rows, equal), computed on a CPU with:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c '<load_dataset("foot",
#   scalar_fn=fields.gaussians(2, k=5, sigma=5.0)); segment_mesh(capacity=64);
#   precondition(sm, RELS); ds = ExplicitTriangulation(pre, RELS);
#   critical_points(ds, pre, rank, batch_segments=16); g =
#   discrete_gradient(ds, pre, rank, batch_segments=16, co_prefetch=("TT",));
#   morse_smale(ds, pre, g); d = persistence_pairs(ds, pre, rank, grad=g);
#   print the counts and d.digest()>'
REF_FOOT = {
    "critical": {"minima": 6, "saddles1": 12, "saddles2": 30, "maxima": 12,
                 "degenerate": 0, "regular": 5625},
    "gradient": {"crit_v": 6, "crit_e": 12, "crit_f": 9, "crit_t": 1},
    "ms": {"saddle1": 12, "saddle2": 9, "basins_min": 6, "basins_max": 1,
           "arcs": 12},
    "euler": 2,
    "persistence": {"pairs0": 5, "pairs2": 1, "essential0": 1,
                    "essential2": 0, "unpaired1": 7, "unpaired2": 8},
    "digest": "887f2f616a5c6104b56bdc1530f0d7f9be02ec50",
}
FUSED_BATCH = 8              # fused_extrema's segments a loop step
# The JAX reference's audit + persistence path at N=96 and N=48 (xla arm,
# tune="off", device consumer arm, one worker), computed on a CPU with:
#   PYTHONPATH=src:. JAX_PLATFORMS=cpu python -c '<build the quickstart
#   mesh at n; precondition(sm, RELS); eng = RelationEngine(pre, PATH_RELS,
#   lookahead=8, dev_pool_segments=4096, backend="xla", tune="off");
#   g = discrete_gradient(eng, pre, total_order(sm.scalars),
#   batch_segments=16, co_prefetch=("TT",)); ms = morse_smale(eng, pre, g);
#   d = persistence_pairs(eng, pre, rank, grad=g);
#   simp, rep = simplify_ms(ms, d, THRESHOLD); print d.counts(), d.digest(),
#   simp.counts(), rep, digest(simp, MS_FIELDS); at n=48 also
#   audit_gradient(eng, pre, chip_smoke.corrupt(g, eng)) and
#   rows_digest(*complete_adjacency(eng, "FF", ff_sample(pre.n_faces)))>'
# (the helpers imported from this file; at n=48 with cache_segments=1<<20,
# which changes how often a block is produced, never a result). Both n
# give the gradient / complex digests of REF_MS. The reference's dense FF
# production took 398 s on the CPU at 48^3 (454 launches); the 96^3 audit
# needs it for 8x as many segments, about an hour at that rate, so the
# corrupted audit and the FF rows are pinned, and run, at 48^3.
REF_PATH = {
    96: {"persistence": {"pairs0": 321, "pairs2": 5, "essential0": 1,
                         "essential2": 0, "unpaired1": 342,
                         "unpaired2": 342},
         "pd_digest": "86046ba24978d989d1a028409a85fb39402d49dc",
         "simplified": {"saddle1": 343, "saddle2": 344, "basins_min": 2,
                        "basins_max": 2, "arcs": 10},
         "cancelled": {"cancelled0": 320, "cancelled2": 3,
                       "minima_before": 322, "minima_after": 2,
                       "maxima_before": 5, "maxima_after": 2},
         "simplified_sha256": ("1d38e7f9c19703244169cc78dab985d8"
                               "0fae740ffbdf2995f8729d33097704cf")},
    48: {"persistence": {"pairs0": 10, "pairs2": 2, "essential0": 1,
                         "essential2": 0, "unpaired1": 13, "unpaired2": 13},
         "pd_digest": "c930cd649635c108b9cb7e511eeed18dbb03b83e",
         "simplified": {"saddle1": 14, "saddle2": 14, "basins_min": 2,
                        "basins_max": 1, "arcs": 5},
         "cancelled": {"cancelled0": 9, "cancelled2": 1, "minima_before": 11,
                       "minima_after": 2, "maxima_before": 2,
                       "maxima_after": 1},
         "simplified_sha256": ("b7574124c413e6b0e6d60ebde04c73fc"
                               "9e564d673ee91b53502d567fa87f454b"),
         "bad_audit": {"tt_conflicts": 8, "ff_conflicts": 8,
                       "reverse_mismatch": 11},
         "ff_sha256": ("a12a7fb9069853e4a125d1d65ccfe8f1"
                       "33bfebd299b38b8210ac4af0f6d1fe96")},
}
# the plain torch arm of phase 5, both arms of phase 8's pinned corrupted
# audit and FF rows, and phase 8d's fault schedules run at this size
SMALL_N = 48
# the row-share path: the SMALL_N mesh in segments of this many vertices
# (NV 2048, NT 8576: whole VV and VT masks past the opt-in limit, so the
# bitmask kernels split each segment's rows over 4 and 11 blocks)
BIG_CAPACITY = 1024
# the sub-join relations phase 4b produces over every segment at that
# capacity (NE 11,520 > 8192: the bitmask kernel in row shares, 115 and 55
# blocks a segment)
BIG_SUB_RELS = ["EF", "ET"]
# phase 5b: the SMALL_N mesh in segments of this many vertices (14
# segments; nvl 11,008, NE 68,480, NF 111,616, NT 54,016), past the member
# bitmask kernel's one-row limit for VF (NY 109,376 on an H100), so the
# gradient's VF blocks come from the sort route's member_entries_kernel
GRAD_CAPACITY = 8192
GRAD_RELS = ["VE", "VF", "VT"]
# The JAX reference's gradient at that segmentation (the segmentation moves
# edge and face ids, so the digest is not REF_MS[48]'s), computed on a CPU
# with:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c '<build the quickstart mesh
#   at n=48; sm = segment_mesh(mesh, capacity=8192); pre = precondition(sm,
#   ["VE","VF","VT"]); eng = RelationEngine(pre, ["VE","VF","VT"],
#   backend="xla", tune="off"); g = discrete_gradient(eng, pre,
#   total_order(sm.scalars), batch_segments=16); print g.euler(),
#   g.counts(), digest(g, GRAD_FIELDS)>'
# -> Euler characteristic 1, 3 launches, 42 segments produced (17.3 s).
REF_GRAD_8192 = {"grad": {"crit_v": 11, "crit_e": 23, "crit_f": 15,
                          "crit_t": 2},
                 "grad_sha256": ("7ca0954eef38472b7dbb04a41f6a75c7"
                                 "06a9e4b67eda3338fc931b2b18a2f985")}

# the H100 SXM peaks every bound below is priced at live in the port's
# roofline model (``repro_torch.launch.roofline``); tools/time_flash.py
# reads them from this module by these names
_PEAKS = ("HBM_BYTES_PER_S", "INT32_OPS_PER_S", "FLOPS_PER_S")


def __getattr__(name):
    if name in _PEAKS:
        from repro_torch.launch import roofline
        return getattr(roofline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

SR_SOURCE = "src/repro_torch/kernels/csrc/segment_relations.cu"
CG_SOURCE = "src/repro_torch/kernels/csrc/completion_gather.cu"
CT_SOURCE = "src/repro_torch/kernels/csrc/counts.cu"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FAW_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu"
FAM_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_mma.cu"
KERNELS = {
    "VV_bits": {"name": "vv_bits_kernel", "source": SR_SOURCE,
                "replaces": "src/repro/kernels/segment_relations.py:360"},
    "member_bits": {"name": "member_bits_kernel", "source": SR_SOURCE,
                    "replaces": "src/repro/kernels/segment_relations.py:343"},
    "VV_sort": {"name": "vv_entries_kernel", "source": SR_SOURCE,
                "replaces": "src/repro/kernels/segment_relations.py:360"},
    "member_sort": {"name": "member_entries_kernel", "source": SR_SOURCE,
                    "replaces": "src/repro/kernels/segment_relations.py:343"},
    "TT": {"name": "tt_entries_kernel", "source": SR_SOURCE,
           "replaces": "src/repro/kernels/segment_relations.py:381"},
    "sub_bits": {"name": "sub_bits_kernel", "source": SR_SOURCE,
                 "replaces": "src/repro/kernels/segment_relations.py:413"},
    "sub_sort": {"name": "sub_entries_kernel", "source": SR_SOURCE,
                 "replaces": "src/repro/kernels/segment_relations.py:413"},
    "gather": {"name": "resolve_gather_kernel", "source": CG_SOURCE,
               "replaces": "src/repro/kernels/completion_gather.py:209"},
    "meet": {"name": "meet_counts_kernel", "source": CT_SOURCE,
             "replaces": "src/repro/kernels/segment_relations.py:82"},
    "vv_counts": {"name": "vv_counts_kernel", "source": CT_SOURCE,
                  "replaces": "src/repro/kernels/segment_relations.py:101"},
    "flash": {"name": "flash_fwd_kernel", "source": FA_SOURCE,
              "replaces": "src/repro/kernels/flash_attention.py:27"},
    "flash_wgmma": {"name": "flash_fwd_wgmma", "source": FAW_SOURCE,
                    "replaces": "src/repro/kernels/flash_attention.py:27"},
    "flash_mma": {"name": "flash_fwd_mma", "source": FAM_SOURCE,
                  "replaces": "src/repro/kernels/flash_attention.py:27"},
}
_ARITY = {"E": 2, "F": 3, "T": 4}

# the audit + persistence path: the gradient's queues, TT/FT for the
# ascending connectivity, FF for the audit's edge -> face check
PATH_RELS = ["VE", "VF", "VT", "FT", "TT", "FF"]
THRESHOLD = 0.05             # simplify_ms persistence threshold
SITES = 8                    # double claims of each kind in the bad field
# the longest phase 2 waits for the mesh process once the LM phases end
# (its 96^3 precondition took 80.7 s in-line on an H100 80GB HBM3
# machine's host)
MESH_WAIT_S = 600
FF_SAMPLE = 512              # faces whose completed FF rows are digested

# the LM pins: name -> (B, S, input seed); weights from reference_tree(cfg,
# 0). qwen2 S=2048 takes the reference's _sdpa_chunked branch, S=100 its
# _sdpa (ragged for the kernel's 64-row tiles); a "generate" pin is B=2
# prompts of 16 tokens, 8 generated against a 64-slot cache; "vl" is 256
# vision tokens on a 16 x 16 grid and 768 text tokens (S counts both)
LM_PIN_SHAPES = {"S2048": (2, 2048, 1), "S100": (2, 100, 2),
                 "generate": (2, 16, 3), "whisper": (2, 64, 4),
                 "vl": (2, 1024, 5), "vl_generate": (2, 16, 6),
                 "granite": (2, 2048, 7), "granite_generate": (2, 16, 8),
                 "mamba2": (2, 2048, 9), "mamba2_generate": (2, 16, 10),
                 "zamba2": (2, 2048, 11), "zamba2_generate": (2, 16, 12),
                 "gemma": (2, 2048, 14), "gemma_generate": (2, 16, 15),
                 "deepseek": (2, 2048, 16), "deepseek_generate": (2, 16, 17),
                 "command_r": (2, 2048, 18), "command_r_generate": (2, 16, 19),
                 "phi35": (2, 2048, 20), "phi35_generate": (2, 16, 21)}
# the configuration each pin runs (lm_pin_cfg cuts its depth)
LM_PIN_ARCH = {"S2048": "qwen2-7b", "S100": "qwen2-7b",
               "generate": "qwen2-7b", "whisper": "whisper-base",
               "vl": "qwen2-vl-7b", "vl_generate": "qwen2-vl-7b",
               "granite": "granite-moe-3b-a800m",
               "granite_generate": "granite-moe-3b-a800m",
               "mamba2": "mamba2-130m", "mamba2_generate": "mamba2-130m",
               "zamba2": "zamba2-2.7b", "zamba2_generate": "zamba2-2.7b",
               "gemma": "gemma-7b", "gemma_generate": "gemma-7b",
               "deepseek": "deepseek-7b", "deepseek_generate": "deepseek-7b",
               "command_r": "command-r-35b",
               "command_r_generate": "command-r-35b",
               "phi35": "phi3.5-moe-42b-a6.6b",
               "phi35_generate": "phi3.5-moe-42b-a6.6b"}
# phase 10's pins, phase 11b's (the vlm, moe, ssm and hybrid families) and
# phase 11c's (the four configurations first served on the card in PR 29)
LM_DENSE_PINS = ("S2048", "S100", "generate", "whisper")
LM_FAMILY_PINS = ("vl", "vl_generate", "granite", "granite_generate",
                  "mamba2", "mamba2_generate", "zamba2", "zamba2_generate")
LM_NEW_PINS = ("gemma", "gemma_generate", "deepseek", "deepseek_generate",
               "command_r", "command_r_generate", "phi35", "phi35_generate")
# the bf16 pins' tolerance is this factor times the pin's ref_err, the
# reference's own bf16 error (check_lm_pins_bf16). Two bf16 results, each
# within ref_err of the float32 one, lie within 2 ref_err of each other.
# On a CPU (tests/test_torch_bf16_pins.py, every SMOKE arch) the port's
# torch arm in bf16 sat 0.66-1.48 ref_err from the float32 reference at
# its top-5 (phi3.5-moe the farthest); qwen2-7b's SMOKE port with its KV
# heads rolled by one sat 43.7 ref_err away and with its causal mask
# dropped 15.0, both failing at this factor
BF16_PIN_FACTOR = 2.0
LM_GEN, LM_CACHE = 8, 64
WHISPER_FRAMES = 1500        # whisper-base's encoder length (30 s of audio)
# phase 12a's float32 training pins: deepseek-7b (the reference trainer's
# default arch) at full width cut to two layers (lm_pin_cfg), weights
# reference_tree(cfg, 0), TRAIN_PIN_STEPS make_train_step calls on the
# batches of train_pin_batches, AdamW TRAIN_PIN_OPT; name -> the loss
# chunk ("train_chunked": the chunked cross entropy branch, which must give
# the unchunked loss)
LM_TRAIN_PINS = {"train": 0, "train_chunked": 128}
TRAIN_PIN_ARCH = "deepseek-7b"
TRAIN_PIN_B, TRAIN_PIN_S, TRAIN_PIN_STEPS, TRAIN_PIN_SEED = 1, 256, 3, 13
TRAIN_PIN_OPT = {"lr": 3e-4, "warmup_steps": 1, "total_steps": 3}
# train_batch_digests on the CPU that computed the pins (numpy 2.0.2)
TRAIN_BATCH_SHA256 = {
    "pins": "bcb31b7573f137b221de38e534e00b962770329cae66821f49331d4342d78325",
    "synthetic":
        "d3177b5e5c781e60deca54bac7323cecd6a6d096d82fa34e544ba9026ec1d801"}
# the training pins' tolerances (relative): on the CPU the port's float32
# steps met the reference's within 8.1e-8 (loss) and 9.3e-7 (grad norm),
# summation order alone (tools/lm_pins.py --port); on the card cuBLAS and
# the mma kernel's 3xTF32 (within 2e-5 of the plain version) sum in other
# orders again, so about 100x that; the lr is one float32 formula
TRAIN_PIN_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "lr": 1e-6}
# phase 12b's two arms at step 0, bf16 (relative): the loss, the global
# grad norm, and the gradient norm of each layer's wq, wk, wv and wo
# ("attn_grad_norm", the largest gap of the 16). The arms share the
# backward (layers.sdpa_backward) and differ in the forward's attention:
# the kernel rounds P to bf16 per key tile where _sdpa rounds the
# normalised probabilities. Measured on an H100: 5.9e-6, 1.9e-6 and
# 6.2e-5; each tolerance is 16-53x that
TRAIN_ARM_TOL = {"loss": 1e-4, "grad_norm": 1e-4, "attn_grad_norm": 1e-3}
# The JAX reference's LM pins: next tokens and the last position's top-5
# logit ids and values of prefill_fn / make_prefill_step, the tokens of
# generate, and for granite its first layer's per-expert pair counts and
# dropped pairs (routing_counts; none drop at this size: the CPU tests of
# tests/test_torch_moe.py hold the drop path), for the configurations of
# lm_pin_cfg in float32, weights reference_tree(cfg, 0), inputs
# lm_pin_inputs; computed on a CPU (all twelve pins 156.7 s, 12.9 GB peak;
# the four of qwen2-7b and whisper-base as before) with:
#   PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/lm_pins.py
# Since PR 29 also the float32 pins of gemma-7b, deepseek-7b, command-r-35b
# and phi3.5-moe (LM_NEW_PINS), and every name's pin in the reference's
# configured bf16, "<name>_bf16" (with ref_err and margin; a moe prefill's
# router_err and near_ties: tools/lm_pins.py's docstring), computed with
#   PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/lm_pins.py \
#       --dtype bfloat16 [NAME ...]
# in two runs on an 8-core CPU: the 18 names but command-r's, 932.1 s and
# 21.7 GB peak RSS; command_r and command_r_generate, 236.1 s and 36.3 GB
# (its two-layer tree is 22.4 GB); the twelve float32 pins above came out
# of it unchanged
LM_PINS = {
    "S2048": {
        "next": [75891, 80767],
        "top5_ids": [
            [75891, 144058, 109321, 141320, 142762],
            [80767, 5966, 2819, 115156, 66661],
        ],
        "top5_vals": [
            [3.831724166870117, 3.7599329948425293, 3.720322608947754,
             3.7033567428588867, 3.673661708831787],
            [4.035569190979004, 3.9780266284942627, 3.935800790786743,
             3.9269869327545166, 3.5532479286193848],
        ],
    },
    "S100": {
        "next": [58784, 97940],
        "top5_ids": [
            [58784, 88911, 41335, 44748, 149245],
            [97940, 108315, 94469, 45696, 48513],
        ],
        "top5_vals": [
            [4.077881813049316, 3.6961779594421387, 3.6643362045288086,
             3.5785322189331055, 3.554067850112915],
            [3.703197479248047, 3.5661468505859375, 3.5211055278778076,
             3.4783902168273926, 3.4681692123413086],
        ],
    },
    "generate": {
        "tokens": [
            [410, 56831, 5109, 141207, 105574, 64505, 67653, 76115],
            [28909, 93678, 130455, 112053, 57057, 74346, 55146, 24222],
        ],
    },
    "whisper": {
        "next": [32068, 28059],
        "top5_ids": [
            [32068, 36330, 41602, 27098, 31555],
            [28059, 38540, 31306, 21009, 36599],
        ],
        "top5_vals": [
            [3.3055849075317383, 3.1613049507141113, 3.140183925628662,
             3.132631778717041, 3.1045970916748047],
            [3.4208157062530518, 3.297736406326294, 3.2097878456115723,
             3.1924920082092285, 3.191192150115967],
        ],
    },
    "vl": {
        "next": [12363, 63931],
        "top5_ids": [
            [12363, 70163, 131240, 73391, 28940],
            [63931, 133735, 133549, 30193, 46908],
        ],
        "top5_vals": [
            [3.7177231311798096, 3.615222930908203,
             3.596891403198242, 3.55729341506958,
             3.4962661266326904],
            [3.9579238891601562, 3.8296234607696533,
             3.7116386890411377, 3.60048770904541,
             3.5197980403900146],
        ],
    },
    "vl_generate": {
        "tokens": [
            [69089, 134350, 11552, 1961, 80652, 123187, 81476,
             63512],
            [19089, 37040, 45476, 123311, 88553, 62369, 113478,
             27255],
        ],
    },
    "granite": {
        "next": [22779, 15893],
        "top5_ids": [
            [22779, 34391, 45919, 36311, 6862],
            [15893, 32378, 43014, 9975, 44010],
        ],
        "top5_vals": [
            [1278.262451171875, 141.71995544433594,
             139.6916961669922, 137.41705322265625,
             137.0718994140625],
            [1350.8909912109375, 150.31756591796875,
             146.41749572753906, 145.7859344482422,
             142.7532196044922],
        ],
        "counts": [
            769, 800, 775, 810, 806, 845, 812, 829, 866, 892, 840,
            838, 853, 845, 803, 840, 832, 777, 813, 843, 841, 791,
            804, 843, 826, 886, 778, 804, 837, 781, 800, 865, 798,
            758, 775, 767, 840, 801, 870, 815,
        ],
        "dropped": 0,
    },
    "granite_generate": {
        "tokens": [
            [18322, 18322, 18322, 18322, 18322, 18322, 18322,
             18322],
            [20791, 20791, 20791, 20791, 20791, 20791, 20791,
             20791],
        ],
    },
    "mamba2": {
        "next": [18886, 49199],
        "top5_ids": [
            [18886, 29463, 30372, 38240, 29621],
            [49199, 25624, 45334, 32757, 47429],
        ],
        "top5_vals": [
            [150.46279907226562, 103.60066223144531,
             100.83694458007812, 100.55513000488281,
             97.11344146728516],
            [106.94844818115234, 99.97207641601562,
             95.6868896484375, 95.27554321289062,
             93.44425964355469],
        ],
    },
    "mamba2_generate": {
        "tokens": [
            [42323, 42323, 42323, 42323, 42323, 42323, 35429,
             35429],
            [25324, 25324, 25324, 25324, 21210, 21210, 21210,
             21210],
        ],
    },
    "zamba2": {
        "next": [27255, 23942],
        "top5_ids": [
            [27255, 22077, 19485, 17376, 26684],
            [23942, 8357, 6777, 22410, 30665],
        ],
        "top5_vals": [
            [766.5870971679688, 191.55044555664062,
             189.30899047851562, 181.341552734375,
             175.15919494628906],
            [816.7860107421875, 184.12942504882812,
             173.65704345703125, 159.4117889404297,
             159.323974609375],
        ],
    },
    "zamba2_generate": {
        "tokens": [
            [3682, 3682, 3682, 3682, 3682, 3682, 3682, 3682],
            [14515, 14515, 14515, 14515, 14515, 14515, 14515,
             14515],
        ],
    },
    "gemma": {
        "next": [67109, 253695],
        "top5_ids": [
            [67109, 239945, 111107, 175580, 1317],
            [253695, 32304, 118988, 115412, 19334],
        ],
        "top5_vals": [
            [
                2147.191162109375, 225.1162872314453,
                212.4535369873047, 207.41395568847656,
                201.32635498046875
            ],
            [
                2219.472900390625, 231.30166625976562,
                224.08465576171875, 210.08212280273438,
                204.67457580566406
            ],
        ],
    },
    "gemma_generate": {
        "tokens": [
            [88411, 88411, 88411, 88411, 88411, 88411, 88411, 88411],
            [
                227631, 227631, 227631, 227631, 227631, 227631, 227631,
                227631
            ],
        ],
    },
    "deepseek": {
        "next": [37015, 11098],
        "top5_ids": [
            [37015, 5581, 43011, 19849, 44450],
            [11098, 12761, 26620, 87619, 3818],
        ],
        "top5_vals": [
            [
                3.7562315464019775, 3.74757719039917,
                3.7163257598876953, 3.6257452964782715,
                3.532689332962036
            ],
            [
                4.544949531555176, 3.698544979095459,
                3.5960853099823, 3.5730886459350586,
                3.553497314453125
            ],
        ],
    },
    "deepseek_generate": {
        "tokens": [
            [72677, 17001, 14750, 25391, 21454, 88511, 89225, 36670],
            [72266, 13064, 100050, 70440, 13082, 12802, 65534, 19145],
        ],
    },
    "command_r": {
        "next": [72063, 54562],
        "top5_ids": [
            [72063, 139603, 36074, 72182, 12618],
            [54562, 157654, 236779, 209119, 214245],
        ],
        "top5_vals": [
            [
                3.8520452976226807, 3.7578232288360596,
                3.7408194541931152, 3.669884204864502,
                3.608940839767456
            ],
            [
                3.721832036972046, 3.5936901569366455,
                3.523721218109131, 3.4465625286102295,
                3.4342432022094727
            ],
        ],
    },
    "command_r_generate": {
        "tokens": [
            [
                230694, 43913, 250821, 218798, 179462, 52422, 85786,
                206411
            ],
            [
                88835, 86392, 178933, 181887, 154103, 28500, 223986,
                218852
            ],
        ],
    },
    "phi35": {
        "next": [17031, 27387],
        "top5_ids": [
            [17031, 2249, 27932, 31045, 17530],
            [27387, 15939, 28766, 106, 16226],
        ],
        "top5_vals": [
            [
                3.289081573486328, 3.2801992893218994,
                3.276686668395996, 3.22818660736084,
                3.223055601119995
            ],
            [
                3.327521562576294, 3.292124032974243,
                3.281949281692505, 3.071254014968872,
                3.0453035831451416
            ],
        ],
        "counts": [
            465, 558, 559, 513, 503, 506, 488, 493, 490, 557, 536, 514,
            523, 495, 494, 498
        ],
        "dropped": 0,
    },
    "phi35_generate": {
        "tokens": [
            [14879, 14046, 27052, 8253, 29358, 26940, 16115, 9546],
            [19812, 16848, 7526, 13158, 12867, 15058, 6324, 8074],
        ],
    },
    "S2048_bf16": {
        "next": [75891, 80767],
        "top5_ids": [
            [75891, 144058, 109321, 141320, 142762],
            [80767, 5966, 115156, 2819, 66661],
        ],
        "top5_vals": [
            [3.828125, 3.75, 3.71875, 3.71875, 3.671875],
            [4.03125, 3.984375, 3.9375, 3.921875, 3.546875],
        ],
        "ref_err": 0.015393257141113281,
        "margin": [0.078125, 0.046875],
    },
    "S100_bf16": {
        "next": [58784, 97940],
        "top5_ids": [
            [58784, 88911, 41335, 44748, 149245],
            [97940, 108315, 94469, 45696, 48513],
        ],
        "top5_vals": [
            [4.09375, 3.6875, 3.65625, 3.5625, 3.546875],
            [3.703125, 3.5625, 3.515625, 3.484375, 3.46875],
        ],
        "ref_err": 0.01603221893310547,
        "margin": [0.40625, 0.140625],
    },
    "generate_bf16": {
        "tokens": [
            [410, 42308, 44536, 120416, 32712, 135807, 66475, 25820],
            [
                28909, 93678, 130455, 112053, 57057, 74346, 55146, 24222
            ],
        ],
        "margin": [
            [
                0.0625, 0.0, 0.078125, 0.03125, 0.328125, 0.171875,
                0.09375, 0.21875
            ],
            [
                0.109375, 0.25, 0.078125, 0.3125, 0.53125, 0.34375,
                0.03125, 0.0
            ],
        ],
        "ref_err": 0.022159337997436523,
    },
    "whisper_bf16": {
        "next": [32068, 28059],
        "top5_ids": [
            [32068, 36330, 41602, 27098, 31555],
            [28059, 38540, 31306, 36599, 21009],
        ],
        "top5_vals": [
            [3.296875, 3.15625, 3.140625, 3.125, 3.109375],
            [3.4375, 3.3125, 3.21875, 3.203125, 3.1875],
        ],
        "ref_err": 0.016684293746948242,
        "margin": [0.140625, 0.125],
    },
    "vl_bf16": {
        "next": [12363, 63931],
        "top5_ids": [
            [12363, 70163, 131240, 73391, 28940],
            [63931, 133735, 133549, 30193, 46908],
        ],
        "top5_vals": [
            [3.71875, 3.609375, 3.59375, 3.5625, 3.5],
            [3.96875, 3.828125, 3.703125, 3.609375, 3.515625],
        ],
        "ref_err": 0.01082611083984375,
        "margin": [0.109375, 0.140625],
    },
    "vl_generate_bf16": {
        "tokens": [
            [69089, 134350, 11552, 1961, 80652, 123187, 81476, 63512],
            [
                19089, 37040, 45476, 123311, 88553, 62369, 113478, 27255
            ],
        ],
        "margin": [
            [
                0.5, 0.015625, 0.015625, 0.21875, 0.15625, 0.421875,
                0.5625, 0.015625
            ],
            [
                0.375, 0.296875, 0.21875, 0.375, 0.359375, 1.046875,
                0.015625, 0.015625
            ],
        ],
        "ref_err": 0.02200794219970703,
    },
    "granite_bf16": {
        "next": [22779, 15893],
        "top5_ids": [
            [22779, 34391, 45919, 6862, 36311],
            [15893, 32378, 9975, 43014, 44010],
        ],
        "top5_vals": [
            [1280.0, 142.0, 140.0, 137.0, 137.0],
            [1352.0, 150.0, 146.0, 146.0, 143.0],
        ],
        "counts": [
            773, 798, 777, 813, 809, 845, 811, 827, 866, 893, 843, 838,
            850, 843, 803, 841, 828, 775, 817, 847, 840, 788, 799, 846,
            822, 887, 776, 804, 836, 784, 802, 867, 796, 758, 773, 766,
            839, 802, 870, 816
        ],
        "dropped": 0,
        "ref_err": 1.737548828125,
        "margin": [1138.0, 1202.0],
        "router_err": 0.0017573535442352295,
        "near_ties": 4605,
    },
    "granite_generate_bf16": {
        "tokens": [
            [18322, 18322, 18322, 18322, 18322, 18322, 18322, 18322],
            [20791, 20791, 20791, 20791, 20791, 20791, 20791, 20791],
        ],
        "margin": [
            [
                1080.0, 1080.0, 1072.0, 1072.0, 1062.0, 1045.0, 1036.0,
                1029.0
            ],
            [
                1099.0, 1095.0, 1101.0, 1087.0, 1083.0, 1075.0, 1059.0,
                1052.0
            ],
        ],
        "ref_err": 3.6385498046875,
    },
    "mamba2_bf16": {
        "next": [18886, 49199],
        "top5_ids": [
            [18886, 29463, 30372, 38240, 29621],
            [49199, 25624, 45334, 32757, 35600],
        ],
        "top5_vals": [
            [153.0, 102.0, 101.0, 99.5, 96.0],
            [109.5, 98.0, 96.5, 93.5, 92.5],
        ],
        "ref_err": 2.9442596435546875,
        "margin": [51.0, 11.5],
    },
    "mamba2_generate_bf16": {
        "tokens": [
            [42323, 42323, 42323, 42323, 42323, 42323, 35429, 35429],
            [13606, 13606, 13606, 13606, 13606, 13606, 13606, 13606],
        ],
        "margin": [
            [69.0, 31.5, 36.0, 46.5, 73.5, 31.5, 3.0, 89.5],
            [2.5, 31.0, 58.0, 45.0, 62.5, 76.0, 25.5, 23.5],
        ],
        "ref_err": 10.85467529296875,
    },
    "zamba2_bf16": {
        "next": [27255, 23942],
        "top5_ids": [
            [27255, 22077, 19485, 17376, 26684],
            [23942, 8357, 6777, 22410, 30665],
        ],
        "top5_vals": [
            [768.0, 192.0, 189.0, 182.0, 175.0],
            [816.0, 185.0, 175.0, 159.0, 158.0],
        ],
        "ref_err": 1.41290283203125,
        "margin": [576.0, 631.0],
    },
    "zamba2_generate_bf16": {
        "tokens": [
            [3682, 3682, 3682, 3682, 3682, 3682, 3682, 3682],
            [14515, 14515, 14515, 14515, 14515, 14515, 14515, 14515],
        ],
        "margin": [
            [663.0, 630.0, 656.0, 629.0, 633.0, 605.0, 582.0, 586.0],
            [676.0, 591.0, 620.0, 615.0, 593.0, 629.0, 586.0, 624.0],
        ],
        "ref_err": 9.597702026367188,
    },
    "gemma_bf16": {
        "next": [67109, 253695],
        "top5_ids": [
            [67109, 239945, 111107, 175580, 1317],
            [253695, 32304, 118988, 115412, 19334],
        ],
        "top5_vals": [
            [2144.0, 225.0, 213.0, 207.0, 201.0],
            [2224.0, 232.0, 224.0, 210.0, 204.0],
        ],
        "ref_err": 4.527099609375,
        "margin": [1919.0, 1992.0],
    },
    "gemma_generate_bf16": {
        "tokens": [
            [88411, 88411, 88411, 88411, 88411, 88411, 88411, 88411],
            [
                227631, 227631, 227631, 227631, 227631, 227631, 227631,
                227631
            ],
        ],
        "margin": [
            [
                1874.0, 1876.0, 1893.0, 1878.0, 1883.0, 1868.0, 1868.0,
                1851.0
            ],
            [
                1803.0, 1804.0, 1795.0, 1787.0, 1780.0, 1774.0, 1767.0,
                1760.0
            ],
        ],
        "ref_err": 7.712890625,
    },
    "deepseek_bf16": {
        "next": [37015, 11098],
        "top5_ids": [
            [37015, 5581, 43011, 19849, 44450],
            [11098, 12761, 26620, 87619, 70016],
        ],
        "top5_vals": [
            [3.765625, 3.75, 3.71875, 3.625, 3.546875],
            [4.53125, 3.703125, 3.59375, 3.578125, 3.5625],
        ],
        "ref_err": 0.014185667037963867,
        "margin": [0.015625, 0.828125],
    },
    "deepseek_generate_bf16": {
        "tokens": [
            [72677, 17001, 14750, 25391, 21454, 88511, 89225, 36670],
            [72266, 13064, 100050, 70440, 13082, 12802, 65534, 19145],
        ],
        "margin": [
            [
                0.046875, 0.125, 0.0625, 0.046875, 0.203125, 0.296875,
                0.078125, 0.078125
            ],
            [
                0.0625, 0.15625, 0.1875, 0.03125, 0.0625, 0.09375,
                0.140625, 0.390625
            ],
        ],
        "ref_err": 0.013074398040771484,
    },
    "command_r_bf16": {
        "next": [72063, 54562],
        "top5_ids": [
            [72063, 139603, 36074, 72182, 12618],
            [54562, 157654, 236779, 209119, 214245],
        ],
        "top5_vals": [
            [3.84375, 3.765625, 3.734375, 3.671875, 3.609375],
            [3.71875, 3.59375, 3.515625, 3.453125, 3.4375],
        ],
        "ref_err": 0.008295297622680664,
        "margin": [0.078125, 0.125],
    },
    "command_r_generate_bf16": {
        "tokens": [
            [
                230694, 43913, 250821, 218798, 179462, 52422, 85786,
                206411
            ],
            [
                88835, 86392, 178933, 161321, 125022, 116687, 144639,
                99001
            ],
        ],
        "margin": [
            [
                0.21875, 0.140625, 0.03125, 0.015625, 0.109375, 0.125,
                0.015625, 0.4375
            ],
            [
                0.03125, 0.125, 0.3125, 0.0, 0.25, 0.03125, 0.046875,
                0.015625
            ],
        ],
        "ref_err": 0.016859054565429688,
    },
    "phi35_bf16": {
        "next": [17031, 27387],
        "top5_ids": [
            [17031, 2249, 27932, 31045, 3799],
            [27387, 15939, 28766, 106, 13038],
        ],
        "top5_vals": [
            [3.296875, 3.28125, 3.28125, 3.234375, 3.21875],
            [3.328125, 3.296875, 3.265625, 3.0625, 3.046875],
        ],
        "counts": [
            464, 556, 560, 512, 505, 505, 489, 491, 492, 557, 537, 514,
            520, 496, 494, 500
        ],
        "dropped": 0,
        "ref_err": 0.016324281692504883,
        "margin": [0.015625, 0.03125],
        "router_err": 0.002077162265777588,
        "near_ties": 525,
    },
    "phi35_generate_bf16": {
        "tokens": [
            [14879, 14046, 27052, 8253, 29358, 26940, 16115, 9546],
            [19812, 16848, 7526, 13158, 12867, 15058, 6324, 8074],
        ],
        "margin": [
            [
                0.234375, 0.140625, 0.75, 0.09375, 0.046875, 0.359375,
                0.046875, 0.296875
            ],
            [
                0.109375, 0.34375, 0.15625, 0.25, 0.125, 0.15625,
                0.3125, 0.015625
            ],
        ],
        "ref_err": 0.014665842056274414,
    },
    # phase 12a: each step's loss, grad norm and lr (LM_TRAIN_PINS; both
    # pins 182.7 s and 29.8 GB peak RSS on a CPU, with --port)
    "train": {
        "loss": [11.872570037841797, 11.877230644226074, 11.847610473632812],
        "grad_norm": [6.7292351722717285, 6.73253870010376, 6.716893672943115],
        "lr": [0.0003000000142492354,
               0.0001649999903747812, 3.000000106112566e-05],
    },
    "train_chunked": {
        "loss": [11.872570037841797, 11.87723159790039, 11.847609519958496],
        "grad_norm": [6.7292351722717285,
                      6.732539176940918, 6.716893672943115],
        "lr": [0.0003000000142492354,
               0.0001649999903747812, 3.000000106112566e-05],
    },
}
# the bf16 prefill logits of the two attention arms at full depth: the
# wgmma kernel rounds the unnormalised probabilities of each key tile to
# bf16 where _sdpa rounds the normalised ones, its outputs round at other
# points, and 28 layers of random weights carry the difference; held within
# this share of the largest logit (on an H100 80GB HBM3 the arms differed
# by 0.022 of it at S=4096 and 0.018 at S=1000)
LM_ARM_TOL = 0.05
# phi3.5-moe's top-2 routing carries that rounding past LM_ARM_TOL: on an
# H100 80GB HBM3 at 16 layers, B 4, S 4096, the arms chose 26 of 32,768
# experts apart in the first layer and 2,169 in the last, and their logits
# differed by 0.347 of the largest. On a CPU (tools/moe_rounding.py, the
# torch arm with _sdpa against the flash kernels' plain version, a 512-wide
# stand-in of 16 layers) its routing took the logits 0.088 apart from 5
# flips of 4,096 in the first layer (granite's 0.0088, a dense FFN's
# 0.013), and K/V heads rolled by one took them 1.21 apart from 345 first-
# layer flips. So for these configurations phase 11b/11c holds the arms
# within LM_ARM_TOL with the torch arm's expert choices and gates replayed
# on the kernels' arm (as every moe's, granite's free-running too), and
# their free-running first layers within ARM_FIRST_FLIPS of the choices
ARM_ROUTED = ("phi3.5-moe-42b-a6.6b",)
ARM_FIRST_FLIPS = 0.01


def quickstart_mesh(n: int):
    """The quickstart's Gaussian field on an ``n``^3 structured grid."""
    from repro_torch.algorithms import fields
    from repro_torch.data.meshgen import structured_grid
    return structured_grid(n, n, n, scalar_fn=fields.gaussians(
        0, k=4, sigma=3.0, scale=n))


def build_meshes(out_path: str) -> int:
    """Phase 2's 96^3 mesh, phase 4b's two 48^3 segmentations and phase
    5b's, built and
    preconditioned on the host by ``chip_smoke.py --meshes PATH``: the
    parent starts this process before its kernel build and reads the
    pickle at ``PATH`` after the LM phases, so that the host numpy of the
    set-up runs beside the card's work instead of after it. The process's
    seconds by step go to ``PATH.json``, written last."""
    import pickle
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.algorithms.consume import degree_cols
    from repro_torch.core.mesh import segment_mesh
    from repro_torch.core.segtables import precondition

    t0 = time.perf_counter()
    mesh = quickstart_mesh(N)
    sm = segment_mesh(mesh, capacity=64)
    t1 = time.perf_counter()
    pre = precondition(sm, relations=RELS)
    t2 = time.perf_counter()
    # the consumers' exact column widths: one-time host work cached on
    # ``pre``, done here so that it lands in no path wall
    degree_cols(pre, ("VV", "VE", "VF", "VT"))
    t3 = time.perf_counter()
    psm = segment_mesh(quickstart_mesh(SMALL_N), capacity=64)
    ppre = precondition(psm, RELS)
    t4 = time.perf_counter()
    bsm = segment_mesh(quickstart_mesh(SMALL_N), capacity=BIG_CAPACITY)
    bpre = precondition(bsm, relations=["VV", "VT"])
    # the sub-join past NX 8192 (NE 11,520): EF and ET on the same segments
    epre = precondition(bsm, relations=BIG_SUB_RELS)
    t5 = time.perf_counter()
    gsm = segment_mesh(quickstart_mesh(SMALL_N), capacity=GRAD_CAPACITY)
    gpre = precondition(gsm, relations=GRAD_RELS)
    t6 = time.perf_counter()
    with open(out_path, "wb") as f:
        pickle.dump({"mesh": mesh, "sm": sm, "pre": pre, "psm": psm,
                     "ppre": ppre, "bsm": bsm, "bpre": bpre, "epre": epre,
                     "gsm": gsm, "gpre": gpre},
                    f, protocol=pickle.HIGHEST_PROTOCOL)
    t7 = time.perf_counter()
    times = {"segment_s": t1 - t0, "precondition_s": t2 - t1,
             "degree_bound_s": t3 - t2, "small_s": t4 - t3,
             "big_capacity_s": t5 - t4, "grad_capacity_s": t6 - t5,
             "dump_s": t7 - t6, "process_s": t7 - t0}
    with open(out_path + ".json", "w") as f:
        json.dump({k: round(v, 3) for k, v in times.items()}, f)
    return 0


def ff_sample(n_faces: int):
    """The seeded sample of face ids whose completed FF rows are pinned."""
    import numpy as np
    return np.sort(np.random.default_rng(13).choice(n_faces, FF_SAMPLE,
                                                    replace=False))


def rows_digest(M, L) -> str:
    """SHA-256 of completed rows: ``M`` (int64, as returned) then ``L``
    (int32)."""
    import numpy as np
    h = hashlib.sha256(np.ascontiguousarray(np.asarray(M, np.int64)))
    h.update(np.ascontiguousarray(np.asarray(L, np.int32)))
    return h.hexdigest()


def corrupt(grad, ds):
    """A copy of ``grad`` with ``SITES`` double claims of each kind, at
    seeded sites: a tet claims a face that another tet is paired with (the
    audit's TT check), and a face claims an edge that another face is
    paired with (its FF check). Numpy and the data structure's boundary
    relations only, so both packages corrupt the same sites."""
    import numpy as np
    rng = np.random.default_rng(7)
    bad = dataclasses.replace(grad, pair_t2f=grad.pair_t2f.copy(),
                              pair_f2e=grad.pair_f2e.copy())
    for owner, claimed, boundary in (
            (bad.pair_t2f, grad.pair_f2t, ds.boundary_TF),
            (bad.pair_f2e, grad.pair_e2f, ds.boundary_FE)):
        cand = rng.permutation(len(owner))[:64 * SITES]
        bnd = boundary(cand)
        done = 0
        for c, row in zip(cand, bnd):
            for s in row:
                if claimed[s] >= 0 and claimed[s] != c and owner[c] != s:
                    owner[c] = s
                    done += 1
                    break
            if done == SITES:
                break
        check(done == SITES, "too few double-claim sites")
    return bad


def reference_tree(cfg, seed: int):
    """A parameter tree in the JAX reference's layout (``lm.init_params``:
    nested dicts of float32 numpy arrays, each layer group stacked on its
    leading axes: ``(L, ...)``, ``(groups, attn_every, ...)`` for the
    hybrid's Mamba2 layers) for ``cfg`` of any family, drawn from children
    of ``SeedSequence(seed)``: truncated normals in [-2, 2] x the
    reference's scales (1/sqrt(fan-in); 1/sqrt(H*hd) for ``wo``, 1/sqrt(F)
    for an expert's ``wo``, 1/sqrt(K) for the conv taps; 1 for the
    embedding; 0.02 for the position tables), norm gains 1 + 0.1 n, small
    nonzero biases and ``conv_b`` 0.02 n, ``dt_bias`` 0.1 n, ``D`` 1 + 0.1
    n and ``A_log`` log(linspace(1, 16, h)) + 0.1 n, so that every add and
    scale is exercised. Pure numpy: the pin computation
    (``tools/lm_pins.py``) and the card build the same tree."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    f32 = np.float32
    root = np.random.SeedSequence(seed)
    D, F = cfg.d_model, cfg.d_ff
    pool = ThreadPoolExecutor(8)

    def normal(shape, trunc):
        """Standard normals (truncated to [-2, 2] when ``trunc``), drawn in
        chunks of 2**22, each from its own child of this array's seed, on
        threads: the numbers do not depend on the thread count."""
        out = np.empty(int(np.prod(shape)), f32)
        chunk = 1 << 22
        seeds = root.spawn(1)[0].spawn(-(-out.size // chunk))

        def fill(i):
            g = np.random.Generator(np.random.PCG64(seeds[i]))
            x = out[i * chunk:(i + 1) * chunk]
            g.standard_normal(x.size, dtype=f32, out=x)
            # redraw the entries past 2 in place, in index order, until
            # none is left: only the redrawn entries are tested again
            bad = np.flatnonzero(np.abs(x) > 2) if trunc else ()
            while len(bad):
                x[bad] = g.standard_normal(bad.size, dtype=f32)
                bad = bad[np.abs(x[bad]) > 2]
        list(pool.map(fill, range(len(seeds))))
        return out.reshape(shape)

    def tn(shape, scale):
        x = normal(shape, True)
        x *= f32(scale)
        return x

    def small(shape, scale=0.02):
        return f32(scale) * normal(shape, False)

    def norm(lead, d=D):
        p = {"g": f32(1) + f32(0.1) * normal(lead + (d,), False)}
        if cfg.norm == "layernorm":
            p["b"] = small(lead + (d,))
        return p

    def attn(lead, bias):
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        s = 1.0 / np.sqrt(D)
        p = {"wq": tn(lead + (D, H, hd), s), "wk": tn(lead + (D, KV, hd), s),
             "wv": tn(lead + (D, KV, hd), s),
             "wo": tn(lead + (H, hd, D), 1.0 / np.sqrt(H * hd))}
        if bias:
            p.update(bq=small(lead + (H, hd)), bk=small(lead + (KV, hd)),
                     bv=small(lead + (KV, hd)))
        return p

    def block(lead, cross=False):
        # the FFN first: the pinned trees drew it before the norms
        if cfg.family == "moe":
            E = cfg.n_experts
            s = 1.0 / np.sqrt(D)
            ffn = {"moe": {"router": tn(lead + (D, E), s),
                           "wi": tn(lead + (E, D, F), s),
                           "wg": tn(lead + (E, D, F), s),
                           "wo": tn(lead + (E, F, D), 1.0 / np.sqrt(F))}}
        else:
            names = ("wi", "wo") if cfg.norm == "layernorm" else \
                ("wi", "wg", "wo")
            ffn = {"mlp": {n: {"w": tn(lead + (F, D), 1.0 / np.sqrt(F))
                               if n == "wo"
                               else tn(lead + (D, F), 1.0 / np.sqrt(D))}
                           for n in names}}
        p = {"ln1": norm(lead), "attn": attn(lead, cfg.qkv_bias),
             "ln2": norm(lead), **ffn}
        if cross:
            p["ln_x"] = norm(lead)
            p["xattn"] = attn(lead, False)
        return p

    def mamba(lead):
        di, st, h, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
        C = di + 2 * st
        a_log = np.log(np.linspace(1.0, 16.0, h, dtype=f32))
        return {"ln": norm(lead),
                "mix": {"in_proj": {"w": tn(lead + (D, 2 * di + 2 * st + h),
                                            1.0 / np.sqrt(D))},
                        "conv_w": tn(lead + (K, C), 1.0 / np.sqrt(K)),
                        "conv_b": small(lead + (C,)),
                        "A_log": a_log + small(lead + (h,), 0.1),
                        "D": f32(1) + small(lead + (h,), 0.1),
                        "dt_bias": small(lead + (h,), 0.1),
                        "norm": norm(lead, di),
                        "out_proj": {"w": tn(lead + (di, D),
                                             1.0 / np.sqrt(di))}}}

    tree = {"embed": {"table": tn((cfg.vocab, D), 1.0)}, "ln_f": norm(())}
    if not cfg.tie_embeddings:
        tree["unembed"] = {"w": tn((D, cfg.vocab), 1.0 / np.sqrt(D))}
    if cfg.family in ("dense", "moe", "vlm"):
        tree["layers"] = block((cfg.n_layers,))
    elif cfg.family == "ssm":
        tree["layers"] = mamba((cfg.n_layers,))
    elif cfg.family == "hybrid":
        tree["layers"] = mamba((cfg.n_layers // cfg.attn_every,
                                cfg.attn_every))
        tree["shared_attn"] = block(())
        tree["shared_attn"]["in_proj"] = {
            "w": tn((2 * D, D), 1.0 / np.sqrt(2 * D))}
    else:
        tree["enc_layers"] = block((cfg.enc_layers,))
        tree["dec_layers"] = block((cfg.n_layers,), cross=True)
        tree["pos_enc"] = tn((cfg.max_pos, D), 0.02)
        tree["pos_dec"] = tn((cfg.max_pos, D), 0.02)
        tree["ln_enc"] = norm(())
    pool.shutdown()
    return tree


def grid_positions(nv: int, n_text: int, batch: int):
    """(3, batch, nv + n_text) int32 M-RoPE ids: nv vision tokens on a
    sqrt(nv) square grid as (0, h, w), then text continuing from the
    grid's side as (p, p, p)."""
    import numpy as np
    g = int(round(math.sqrt(nv)))
    h, w = np.divmod(np.arange(nv), g)
    pos = np.concatenate([np.stack([np.zeros(nv, np.int64), h, w]),
                          np.tile(g + np.arange(n_text), (3, 1))], axis=1)
    return np.ascontiguousarray(np.broadcast_to(
        pos.astype(np.int32)[:, None], (3, batch, nv + n_text)))


def lm_pin_inputs(cfg, name: str, shape=None, frames: int = WHISPER_FRAMES):
    """The seeded numpy inputs of one LM pin: ``tokens`` (B, S) int32 (and
    ``frames`` (B, 1500, D) float32 for whisper; for the vlm prefill
    ``tokens`` (B, S - nv), ``vision_embeds`` (B, nv, D) float32 and
    ``positions3d`` on a grid), or the prompts of a generate pin.
    ``shape`` (B, S, seed) and ``frames`` replace the pin's own (the CPU
    tests' small pins)."""
    import numpy as np
    B, S, seed = shape or LM_PIN_SHAPES[name]
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm" and not name.endswith("generate"):
        nv = cfg.n_vision_tokens
        return {"tokens": rng.integers(0, cfg.vocab, (B, S - nv),
                                       dtype=np.int32),
                "vision_embeds": rng.normal(0, 1, (B, nv, cfg.d_model))
                .astype(np.float32),
                "positions3d": grid_positions(nv, S - nv, B)}
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(0, 1, (B, frames, cfg.d_model)) \
            .astype(np.float32)
    return out


def train_pin_batches(vocab: int):
    """The training pins' TRAIN_PIN_STEPS batches: ``tokens`` (B, S) int32
    and ``labels``, the next tokens, drawn by ``Generator.integers`` as the
    other LM pins' inputs are. ``SyntheticTokens`` draws its tokens from
    ``Generator.zipf``, and its batches on the card gave other losses than
    the pins computed from it on a CPU (both arms; phase 12a's first run);
    ``train_batch_sha256`` prints their digest beside the numpy version."""
    import numpy as np
    rng = np.random.default_rng(TRAIN_PIN_SEED)
    out = []
    for _ in range(TRAIN_PIN_STEPS):
        a = rng.integers(0, vocab, (TRAIN_PIN_B, TRAIN_PIN_S + 1),
                         dtype=np.int32)
        out.append({"tokens": a[:, :-1].copy(), "labels": a[:, 1:].copy()})
    return out


def train_batch_digests(vocab: int, synthetic) -> dict:
    """SHA-256 of the training pins' batches, and of batch 0 of
    ``synthetic(vocab, seed=0)`` (a ``SyntheticTokens`` class) at their
    shape: the inputs a pin's machine and the card each drew."""
    out = {}
    for key, batches in (("pins", train_pin_batches(vocab)),
                         ("synthetic", [synthetic(vocab, seed=0).batch(
                             0, TRAIN_PIN_B, TRAIN_PIN_S)])):
        h = hashlib.sha256()
        for b in batches:
            h.update(b["tokens"].tobytes() + b["labels"].tobytes())
        out[key] = h.hexdigest()
    return out


def lm_pin_cfg(configs, arch: str, dtype: str = "float32"):
    """The configuration a pin runs, in ``dtype`` (float32 unless asked):
    qwen2-7b, qwen2-vl-7b, granite-moe-3b, deepseek-7b, gemma-7b,
    command-r-35b and phi3.5-moe at full width cut to two layers,
    zamba2-2.7b to one group (6 Mamba2 layers and the shared block),
    whisper-base and mamba2-130m whole. ``configs`` is either package's
    ``configs`` module."""
    cfg = configs.get_config(arch)
    if arch in ("qwen2-7b", "qwen2-vl-7b", "granite-moe-3b-a800m",
                "deepseek-7b", "gemma-7b", "command-r-35b",
                "phi3.5-moe-42b-a6.6b"):
        cfg = dataclasses.replace(cfg, n_layers=2)
    elif arch == "zamba2-2.7b":
        cfg = dataclasses.replace(cfg, n_layers=cfg.attn_every)
    return dataclasses.replace(cfg, dtype=dtype)


def routing_counts(eidx, cfg):
    """Per-expert pair counts of a moe layer's expert choices ``eidx`` (T,
    k) (numpy), and the pairs its capacity drops, by the reference's
    ``moe_ffn`` at ep = 1: c_send = ceil(T k cf), c_loc = min(c_send,
    ceil(c_send / E cf))."""
    import numpy as np
    T, k = eidx.shape
    counts = np.bincount(np.asarray(eidx).reshape(-1),
                         minlength=cfg.n_experts)
    c_send = int(np.ceil(T * k * cfg.moe_capacity_factor))
    c_loc = min(c_send, int(np.ceil(c_send / cfg.n_experts
                                    * cfg.moe_capacity_factor)))
    return {"counts": counts.tolist(),
            "dropped": int(np.maximum(counts - c_loc, 0).sum()),
            "c_loc": c_loc}


# the (dtype, backend) runs of each pin phase: the reference's float32 pins
# and its configured bf16 pins, each on both attention arms
PIN_RUNS = (("float32", "cuda"), ("float32", "torch"),
            ("bfloat16", "cuda"), ("bfloat16", "torch"))
# flash launches of each prefill pin's prefill_fn on the kernels' arm, and
# the kernel of its bf16 run: every float32 launch is flash_fwd_mma's;
# in bf16 the kernel _variant (kernels/flash_attention.py) picks for these
# contiguous heads: flash_fwd_wgmma at hd 64, 128 and 256 (the S100 pin's
# 100 ragged rows too), flash_fwd_mma at zamba2's hd 80. whisper-base:
# 6 encoder, 6 decoder and 6 cross attentions
PIN_FLASH = {"S2048": (2, "flash_wgmma"), "S100": (2, "flash_wgmma"),
             "whisper": (18, "flash_wgmma"), "vl": (2, "flash_wgmma"),
             "granite": (2, "flash_wgmma"), "mamba2": (0, None),
             "zamba2": (1, "flash_mma"), "gemma": (2, "flash_wgmma"),
             "deepseek": (2, "flash_wgmma"), "command_r": (2, "flash_wgmma"),
             "phi35": (2, "flash_wgmma")}


def pin_flash_want(names, dtype: str, backend: str) -> dict:
    """Each prefill pin's flash launches per kernel on ``backend`` in
    ``dtype`` (``PIN_FLASH``)."""
    out = {}
    for name in names:
        if name.endswith("generate"):
            continue
        n, kernel = PIN_FLASH[name]
        out[name] = {"flash_mma": 0, "flash_simt": 0, "flash_wgmma": 0}
        if backend == "cuda" and n:
            out[name]["flash_mma" if dtype == "float32" else kernel] = n
    return out


# arch -> a Future of its pin tree (reference_tree(lm_pin_cfg(arch), 0)),
# drawn ahead on a host thread by prefetch_trees; lm_pin_run takes it
_TREES: dict = {}


def prefetch_trees(archs) -> None:
    """Start drawing the pin trees of ``archs`` on one host thread, in
    order, for ``lm_pin_run`` to take: phase 11c's 11 B float32 parameters
    are drawn while the card runs phases 9-11b."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import configs
    pool = ThreadPoolExecutor(1)
    for arch in archs:
        _TREES[arch] = pool.submit(reference_tree,
                                   lm_pin_cfg(configs, arch), 0)
    pool.shutdown(wait=False)


def lm_pin_run(torch, dev, names):
    """The port's results for the LM pins ``names`` on ``dev``, for each
    (dtype, backend) of ``PIN_RUNS``: ``{(dtype, backend): (results,
    launches)}``, the results in ``LM_PINS``' layout (a bf16 prefill's
    with its logits at both pins' top-5 ids, ``prefill_result``), the
    launches each ``prefill_fn`` call's flash launches per kernel
    (counters zeroed just before, read just after). Each arch's tree is
    drawn once (by ``prefetch_trees``, else the next arch's on a host
    thread while this one's runs),
    its float32 model built from it and the bf16 model cast from that on
    the device (the same rounding as from the tree), and every backend of
    a dtype run on its model. A moe prefill also gives its first layer's
    routing counts, and checks that ``moe.dispatch`` drops the pairs they
    predict."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve, steps
    from repro_torch.models import lm, moe

    runs = PIN_RUNS
    res = {run: ({}, {}) for run in runs}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def prefill(model, cfg, batch, name, backend, out, launches):
        routed = []
        route = moe.route

        def recording(p, x, c):
            gates, eidx = route(p, x, c)
            routed.append(eidx)
            return gates, eidx
        moe.route = recording
        try:
            sync()
            for key in fa.LAUNCHES:
                fa.LAUNCHES[key] = 0
            logits, _ = lm.prefill_fn(model, batch, cfg, backend)
            sync()
        finally:
            moe.route = route
        launches[name] = {key: fa.LAUNCHES[key] for key in
                          ("flash_mma", "flash_simt", "flash_wgmma")}
        nxt = steps.make_prefill_step(cfg, backend)(model, batch)
        out[name] = prefill_result(
            torch, logits[:, -1], nxt, name,
            LM_PINS if cfg.dtype == "bfloat16" else None)
        if cfg.family == "moe":
            rc = routing_counts(routed[0].cpu().numpy(), cfg)
            plan = moe.dispatch(routed[0], cfg,
                                moe.padded_experts(cfg.n_experts, 1))
            dropped = int((~plan.keep2).sum()) - int(plan.counts[-1])
            check(plan.c_loc == rc["c_loc"] and dropped == rc["dropped"],
                  f"{name}: moe.dispatch drops {dropped} pairs at c_loc "
                  f"{plan.c_loc}, the counts say {rc}")
            out[name].update(counts=rc["counts"], dropped=rc["dropped"])

    archs = list(dict.fromkeys(LM_PIN_ARCH[n] for n in names))
    pool = ThreadPoolExecutor(1)

    def fetch(arch):
        return _TREES.pop(arch, None) or pool.submit(
            reference_tree, lm_pin_cfg(configs, arch), 0)
    trees = [fetch(archs[0])]
    for i, arch in enumerate(archs):
        tree = trees.pop().result()
        if i + 1 < len(archs):
            trees.append(fetch(archs[i + 1]))
        model = None
        for dtype in dict.fromkeys(d for d, _ in runs):
            cfg = lm_pin_cfg(configs, arch, dtype)
            if model is not None and model.embed.table.dtype == \
                    torch.float32:
                cast = lm.build(cfg, dev)
                cast.load_state_dict(model.state_dict())
                model = cast
                del cast
            else:
                model = None
                model = lm.params_from_reference(tree, cfg, dev)
            for name in (n for n in names if LM_PIN_ARCH[n] == arch):
                inputs = {k: torch.from_numpy(v).to(dev)
                          for k, v in lm_pin_inputs(cfg, name).items()}
                for backend in (b for d, b in runs if d == dtype):
                    out, launches = res[(dtype, backend)]
                    if name.endswith("generate"):
                        out[name] = {"tokens": serve.generate(
                            cfg, model, inputs["tokens"].cpu().numpy(),
                            LM_GEN, LM_CACHE, backend=backend).tolist()}
                    else:
                        prefill(model, cfg, inputs, name, backend, out,
                                launches)
        del model, tree
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    pool.shutdown()
    return res


def lm_pin_phase(torch, dev, names, phase: str, launches) -> None:
    """The pins ``names`` on both arms in float32 and in bf16
    (``lm_pin_run``): one ``phase`` line a run with the results, the
    flash launches per prefill and, in bf16, each pin's port error beside
    its ``ref_err``; the float32 pins by ``check_lm_pins``, the bf16 pins
    by ``check_lm_pins_bf16``, the launches by ``pin_flash_want``. Adds the
    kernels' arm's launches to ``launches``."""
    t0 = time.perf_counter()
    res = lm_pin_run(torch, dev, names)
    for (dtype, backend), (got, pin_launches) in res.items():
        line = {"phase": phase, "dtype": dtype, "backend": backend,
                "results": got, "flash_launches": pin_launches}
        if dtype == "bfloat16":
            line["port_err_vs_ref_err"] = {
                name: [bf16_port_err(got[name], LM_PINS[name]),
                       LM_PINS[f"{name}_bf16"]["ref_err"]] for name in names}
        emit(line)
    emit({"phase": f"{phase}_wall", "wall_s":
          round(time.perf_counter() - t0, 3)})
    for (dtype, backend), (got, pin_launches) in res.items():
        what = f"{backend} {dtype}"
        if dtype == "float32":
            check_lm_pins(got, what, names)
        else:
            check_lm_pins_bf16(got, what, names)
        want = pin_flash_want(names, dtype, backend)
        check(pin_launches == want, f"{what}: flash launches per prefill "
              f"{pin_launches} != {want}")
        if backend == "cuda":
            for n in pin_launches.values():
                for key in ("flash_mma", "flash_wgmma"):
                    launches[key] += n[key]


def check_lm_pins(got, what: str, names) -> None:
    """Tokens, top-5 ids and moe routing counts exactly the reference's,
    top-5 logit values within rtol 1e-3."""
    for name in names:
        want = LM_PINS[name]
        for key in ("next", "top5_ids", "tokens", "counts", "dropped"):
            if key in want:
                check(got[name][key] == want[key],
                      f"{what} {name}: {key} {got[name][key]} != reference "
                      f"{want[key]}")
        if "top5_vals" in want:
            for g, w in zip(sum(got[name]["top5_vals"], []),
                            sum(want["top5_vals"], [])):
                check(abs(g - w) <= 1e-3 * abs(w),
                      f"{what} {name}: top-5 logit {g} != reference {w}")


def prefill_result(torch, last, nxt, name=None, pins=None) -> dict:
    """The port's prefill pin in ``LM_PINS``' layout from the last
    position's logits ``last`` (B, V) and ``make_prefill_step``'s tokens
    ``nxt`` (B, 1); where ``pins`` is given, also ``last`` at the top-5
    ids of ``pins[name]`` (the float32 pin: ``at_f32_ids``) and of
    ``pins[name + "_bf16"]`` (``at_bf16_ids``), which
    ``bf16_pin_faults`` reads."""
    last = last.float()
    vals, ids = torch.topk(last, 5, dim=-1)
    out = {"next": nxt[:, 0].tolist(), "top5_ids": ids.tolist(),
           "top5_vals": vals.tolist()}
    if pins is not None:
        for key, pin in (("at_f32_ids", name), ("at_bf16_ids",
                                                f"{name}_bf16")):
            idx = torch.tensor(pins[pin]["top5_ids"], device=last.device)
            out[key] = last.gather(1, idx).tolist()
    return out


def bf16_port_err(got, f32_pin):
    """The port's largest |bf16 - float32 reference| at the float32 pin's
    top-5 ids (a prefill pin; None for a generate pin)."""
    if "at_f32_ids" not in got:
        return None
    return max(abs(g - w) for g, w in zip(sum(got["at_f32_ids"], []),
                                          sum(f32_pin["top5_vals"], [])))


def bf16_pin_faults(got, f32_pin, pin, factor=None) -> list:
    """Where the port's bf16 result ``got`` (``prefill_result`` with the
    pins, or ``{"tokens"}``, and a moe prefill's ``counts``) breaks the
    bf16 rule against the reference's float32 pin ``f32_pin`` and bf16 pin
    ``pin``, at ``tol = factor x pin["ref_err"]`` (``BF16_PIN_FACTOR``):
    (a) at the float32 pin's top-5 ids the port's logits lie within tol of
    the reference's float32 values; (b) at the bf16 pin's ids within 2 tol
    of the pin's values; (c) a next token equals the pin's where the pin's
    margin exceeds 2 tol, and elsewhere is one of the pin's top-5 with the
    port's logit there within tol of the pin's top-1; generated tokens
    equal the pin's up to each row's first step of margin <= 2 tol (none
    after it compared); (d) a moe pin's routing counts differ by at most
    its ``near_ties`` moved choices (half the summed |difference|).
    Returns one message a fault."""
    tol = (BF16_PIN_FACTOR if factor is None else factor) * pin["ref_err"]
    out = []
    if "top5_vals" in pin:
        for key, want, ids, lim in (
                ("at_f32_ids", f32_pin["top5_vals"], f32_pin["top5_ids"],
                 tol),
                ("at_bf16_ids", pin["top5_vals"], pin["top5_ids"],
                 2 * tol)):
            for b, (gr, wr) in enumerate(zip(got[key], want)):
                for i, (g, w) in enumerate(zip(gr, wr)):
                    if not abs(g - w) <= lim:
                        out.append(f"({'a' if lim == tol else 'b'}) row {b} "
                                   f"id {ids[b][i]}: {g} against {w} (tol "
                                   f"{lim})")
        for b, (n, w) in enumerate(zip(got["next"], pin["next"])):
            if pin["margin"][b] > 2 * tol:
                if n != w:
                    out.append(f"(c) row {b}: next {n} != {w} at margin "
                               f"{pin['margin'][b]} > 2 tol {2 * tol}")
                continue
            val = dict(zip(got["top5_ids"][b], got["top5_vals"][b])).get(n)
            if n not in pin["top5_ids"][b] or val is None or \
                    not abs(val - pin["top5_vals"][b][0]) <= tol:
                out.append(f"(c) row {b}: next {n} (logit {val}) is not "
                           f"within tol {tol} of the pin's top-1 "
                           f"{pin['top5_vals'][b][0]} among its top-5 "
                           f"{pin['top5_ids'][b]}")
    if "tokens" in pin:
        for b, (g, w) in enumerate(zip(got["tokens"], pin["tokens"])):
            stop = next((t for t, m in enumerate(pin["margin"][b])
                         if m <= 2 * tol), len(w))
            if list(g[:stop]) != list(w[:stop]):
                out.append(f"(c) row {b}: tokens {list(g)} != {w} before "
                           f"step {stop}")
    if "near_ties" in pin:
        moved = sum(abs(g - w) for g, w in zip(got["counts"],
                                                pin["counts"])) / 2
        if moved > pin["near_ties"]:
            out.append(f"(d) {moved} expert choices moved, near ties "
                       f"{pin['near_ties']}")
    return out


def check_lm_pins_bf16(got, what: str, names) -> None:
    """Every bf16 pin of ``names`` met by ``bf16_pin_faults`` against
    ``LM_PINS[name]`` and ``LM_PINS[name + "_bf16"]``."""
    faults = [f"{what} {name}_bf16 {f}" for name in names
              for f in bf16_pin_faults(got[name], LM_PINS[name],
                                       LM_PINS[f"{name}_bf16"])]
    check(not faults, "; ".join(faults))


# each phase's start on the host clock, in order (``mark``); the
# ``phase_walls`` line gives each phase's seconds
_MARKS: dict = {}


def mark(phase: str) -> None:
    _MARKS[phase] = time.perf_counter()


def phase_walls() -> dict:
    names = list(_MARKS)
    ends = [_MARKS[n] for n in names[1:]] + [time.perf_counter()]
    return {n: round(e - _MARKS[n], 3) for n, e in zip(names, ends)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failed(Exception):
    pass


def check(cond, msg) -> None:
    if not cond:
        raise Failed(msg)


# the arms with two routes, and their launch counters: per arm and route
ROUTED_ARMS = ("VV", "member", "sub")
ROUTED = tuple(f"{arm}{r}" for arm in ROUTED_ARMS
               for r in ("", "_bits", "_sort"))
# kernels that no path reaches: the VV and sub-join sort kernels since
# the bitmask route holds every table one mask row fits (VV within its
# int32 key guard, the sub-join past any NX a mesh builds), held and timed
# by force (route="sort") in phases 3-4; the SIMT flash kernel since the
# mma kernel takes float32, held and timed by force (simt=True) in phase 9;
# 0 launches on the paths. The member sort kernel has a path: phase 5b's
# VF tables
FORCED = ("VV_sort", "sub_sort", "flash")
# the kernel wrappers' counters of the engine's launches: one per launch
# that reaches a wrapper (VV, member, TT, sub-join; meet and VV counts on
# the dense assembly)
ENGINE_KERNELS = ("VV", "member", "TT", "sub", "meet", "vv_counts")
# the engine's fault-recovery counters (docs/DESIGN.md §12)
FAULT_COUNTERS = ("retries", "sync_timeouts", "failed_launches",
                  "failed_segments", "breaker_trips", "breaker_recoveries",
                  "degraded_launches", "degraded_segments", "degraded_reads",
                  "shards_lost", "rehomed_segments")


def all_bits(path: str, counts: dict) -> None:
    """Every VV, member and sub-join launch in ``counts`` took the bitmask
    route."""
    for arm in ROUTED_ARMS:
        if arm in counts:
            check(counts[arm] == counts[f"{arm}_bits"]
                  and counts[f"{arm}_sort"] == 0,
                  f"{path}: a {arm} launch took the sort route: {counts}")


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def digest(obj, names) -> str:
    """SHA-256 over the named array fields, each as int64, in order."""
    import numpy as np
    h = hashlib.sha256()
    for n in names:
        h.update(np.ascontiguousarray(
            np.asarray(getattr(obj, n)).astype(np.int64)).tobytes())
    return h.hexdigest()


def time_ms(torch, fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, from CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    out.sort()
    return out[len(out) // 2]


def graph_ms(torch, fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    the median over ``rounds`` replays of the replay's CUDA-event time over
    ``reps``. A kernel whose device time is below its wrapper's host cost
    (tens of microseconds) shows its own time here, where ``time_ms``
    shows the host's."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    out.sort()
    return out[len(out) // 2]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def lm_phases(torch, dev, max_err, timing, launches) -> None:
    """Phases 9-11: the flash kernels' cases and times, the full-width LM
    pins on both arms, and qwen2-7b served at full width and depth. Fills
    the three flash kernels' entries (``"flash"``, ``"flash_wgmma"``,
    ``"flash_mma"``) of ``max_err``, ``timing`` and ``launches``."""
    import contextlib
    import io

    import numpy as np

    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import roofline, serve, specs, steps
    from repro_torch.models import lm

    # -- 9. the flash-attention kernels against their plain version ---------
    mark("9")
    t_lm = time.perf_counter()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    fa_tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    max_err["flash"] = max_err["flash_wgmma"] = max_err["flash_mma"] = 0.0
    arm_of = {"simt": "flash", "wgmma": "flash_wgmma", "mma": "flash_mma"}

    def attn_inputs(B, S, T, H, KV, hd, dt):
        return [torch.randn(shape, device=dev, generator=gen).to(dt)
                for shape in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))]

    def flash_check(case, q, k, v, causal, simt=False, aligned=True):
        """One routed launch held against the plain version; the kernel
        that ran is read from the counters and must be the routing's:
        wgmma for bf16 at hd 64/128/256 on a layout TMA reads (``aligned``),
        the mma kernel for the rest; the SIMT kernel when forced."""
        dt, hd = q.dtype, q.shape[-1]
        want_variant = "simt" if simt else "wgmma" if aligned and \
            dt == torch.bfloat16 and hd in fa.WGMMA_HEAD_DIMS else "mma"
        before = dict(fa.LAUNCHES)
        got = fa.flash_attention_cuda(q, k, v, causal=causal, simt=simt)
        want = fa.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ran = [n for n in ("simt", "wgmma", "mma")
               if fa.LAUNCHES[f"flash_{n}"] != before[f"flash_{n}"]]
        err = float((got.float() - want.float()).abs().max())
        tol = fa_tol[dt]
        ok = got.dtype == dt and bool(torch.allclose(
            got.float(), want.float(), rtol=tol, atol=tol))
        if ran == [want_variant]:
            arm = arm_of[want_variant]
            max_err[arm] = max(max_err[arm], err)
        B, S, H, _ = q.shape
        T, KV = k.shape[1], k.shape[2]
        emit({"phase": "kernel_case", "case": case, "relation": "flash",
              "variant": "/".join(ran), "B": B, "S": S, "T": T, "H": H,
              "KV": KV, "hd": hd, "causal": causal,
              "dtype": str(dt).split(".")[-1],
              "strided": not q.is_contiguous(),
              "vec_loads": fa.vec_loads(k, v), "max_abs_err": err,
              "tol": tol, "close": ok})
        check(ran == [want_variant], f"{case}: ran {ran}, not "
                                     f"{want_variant}")
        check(ok, f"the flash kernel ({want_variant}) disagrees with its "
                  f"plain version ({case}, {dt}, causal={causal})")
        return got

    def flash_compare(case, B, S, T, H, KV, hd, causal, dt, simt=False):
        flash_check(case, *attn_inputs(B, S, T, H, KV, hd, dt), causal,
                    simt)

    # head dims of the reference's docstring and the mma kernel's smallest
    # (16, 28), each with a head layout: GQA 8/1, 28/4 and 4/2, MHA; ragged
    # S and T in both orders
    heads = {16: (4, 2), 28: (28, 4), 64: (8, 1), 80: (4, 4), 128: (28, 4),
             256: (16, 16)}
    for dt in (torch.float32, torch.bfloat16):
        for hd, (H, KV) in heads.items():
            for causal in (True, False):
                flash_compare(f"hd {hd} H {H} KV {KV}", 2, 130, 130, H, KV,
                              hd, causal, dt)
                flash_compare(f"hd {hd} S<T", 1, 100, 150, H, KV, hd,
                              causal, dt)
    for causal in (True, False):
        flash_compare("ragged S<T", 1, 1000, 1500, 8, 1, 64, causal,
                      torch.float32)
        flash_compare("ragged S>T", 1, 1500, 1000, 8, 1, 64, causal,
                      torch.float32)
        # the wgmma route's edges: ragged query and key tiles both ways,
        # S != T causal, GQA 28/4 and MHA
        flash_compare("ragged S<T", 1, 1000, 1500, 28, 4, 128, causal,
                      torch.bfloat16)
        flash_compare("ragged S>T", 1, 1500, 1000, 28, 4, 128, causal,
                      torch.bfloat16)
        flash_compare("ragged S>T MHA", 1, 1500, 1000, 8, 8, 64, causal,
                      torch.bfloat16)
        flash_compare("ragged S<T hd 256", 1, 300, 1000, 8, 2, 256, causal,
                      torch.bfloat16)
    for causal in (True, False):
        flash_compare("ragged S>T", 1, 1500, 1000, 28, 4, 128, causal,
                      torch.float32)
        flash_compare("ragged S<T hd 256", 1, 300, 1000, 8, 2, 256, causal,
                      torch.float32)
    # head dims short of the mma kernel's bucket (100 -> 128, 200 -> 256)
    for dt in (torch.float32, torch.bfloat16):
        flash_compare("hd 100 in bucket 128", 1, 200, 130, 4, 2, 100, True,
                      dt)
        flash_compare("hd 200 in bucket 256", 1, 130, 200, 8, 2, 200,
                      False, dt)
    flash_compare("S=1", 2, 1, 37, 8, 8, 64, True, torch.float32)
    flash_compare("S=1", 2, 1, 37, 28, 4, 128, True, torch.bfloat16)
    flash_compare("S=1 cross", 2, 1, WHISPER_FRAMES, 8, 8, 64, False,
                  torch.bfloat16)
    # strided views (the heads of a fused (B, S, H + 2 KV, hd) buffer), read
    # in place by TMA
    for hd, (H, KV) in ((128, (28, 4)), (64, (8, 1))):
        big = torch.randn((2, 333, H + 2 * KV, hd), device=dev,
                          generator=gen).to(torch.bfloat16)
        flash_check(f"strided views hd {hd}", big[:, :, :H],
                    big[:, :, H:H + KV], big[:, :, H + KV:], True)
        del big
    # the mma kernel's element loads: heads of a fused buffer whose head
    # stride (hd + 1 elements) is no multiple of 16 bytes, bit for bit the
    # 16-byte loads' result on contiguous copies where those run the mma
    # kernel too (bf16 hd 128 copies run the wgmma kernel)
    for dt, hds in ((torch.float32, (128, 64, 256)),
                    (torch.bfloat16, (80, 40, 128))):
        for hd in hds:
            H, KV = (28, 4) if hd == 128 else (8, 2)
            big = torch.randn((2, 333, H + 2 * KV, hd + 1), device=dev,
                              generator=gen).to(dt)[..., :hd]
            q, k, v = big[:, :, :H], big[:, :, H:H + KV], big[:, :, H + KV:]
            check(not fa.vec_loads(k, v), "the fused views passed as "
                                          "16-byte loads")
            got = flash_check(f"element loads hd {hd}", q, k, v, True,
                              aligned=False)
            vec = flash_check(f"16-byte loads hd {hd}", q.contiguous(),
                              k.contiguous(), v.contiguous(), True)
            if not (dt == torch.bfloat16 and hd in fa.WGMMA_HEAD_DIMS):
                check(torch.equal(got, vec), f"element and 16-byte loads "
                                             f"differ at hd {hd}, {dt}")
            del big, q, k, v
    # the SIMT kernel, on no route, by force: float32 and bf16
    for dt in (torch.float32, torch.bfloat16):
        for hd, (H, KV) in ((64, (8, 1)), (80, (4, 4)), (128, (28, 4))):
            flash_compare(f"SIMT by force hd {hd}", 2, 130, 130, H, KV, hd,
                          True, dt, simt=True)
    flash_compare("qwen2-7b prefill", 4, 4096, 4096, 28, 4, 128, True,
                  torch.bfloat16)

    # times at the qwen2-7b prefill shape: the wgmma kernel, the SIMT
    # kernel on the same bf16 inputs, one SDPA call on the same (B, S, H,
    # hd) views as yardstick, and the plain version
    B, S, H, KV, hd = 4, 4096, 28, 4, 128
    q, k, v = attn_inputs(B, S, S, H, KV, hd, torch.bfloat16)
    k_ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v,
                                                          causal=True),
                   reps=10)
    simt_ms = time_ms(torch, lambda: fa.flash_attention_cuda(
        q, k, v, causal=True, simt=True), reps=3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = time_ms(torch, lambda: torch.nn.functional
                     .scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True,
                                                   enable_gqa=True),
                     reps=10)
    p_ms = time_ms(torch, lambda: fa.flash_attention_ref(q, k, v,
                                                         causal=True),
                   reps=2, rounds=3)

    def flash_bound(q, k, v, causal):
        """(flops, bytes moved, bound ms, what sets it) of one launch on
        these inputs (``roofline.flash_work``)."""
        B, S, H, hd = q.shape
        work = roofline.flash_work(B, S, k.shape[1], H, k.shape[2], hd,
                                   causal, str(q.dtype).split(".")[-1])
        return (int(work.ops), int(work.nbytes), *work.bound_ms())

    flops, moved, b_ms, b_by = flash_bound(q, k, v, True)
    timing["flash_wgmma"] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": lib_ms}
    emit({"phase": "kernel_time", "arm": "flash_wgmma", "B": B, "S": S,
          "H": H, "KV": KV, "hd": hd, "causal": True, "dtype": "bfloat16",
          "flops": flops, "bytes": moved, "simt_ms": simt_ms,
          "tflops_per_s": flops / k_ms / 1e9,
          "simt_over_wgmma": simt_ms / k_ms, **timing["flash_wgmma"]})
    check(simt_ms >= 5 * k_ms, f"the wgmma kernel ({k_ms} ms) is not 5x "
                               f"faster than the SIMT kernel ({simt_ms} ms)")
    del q, k, v, qt, kt, vt

    # the mma kernel at the shape its main path gives it: the float32
    # qwen2-7b pin's prefill (phase 10), B 2, S 2048, H 28, KV 4, hd 128,
    # held against the plain version on the inputs it is then timed on,
    # beside the SIMT kernel on the same inputs (held too), one float32
    # SDPA call (the matmul TF32 switch stated False) and the plain
    # version; both kernels against the same bound (3xTF32 at 495 TFLOP/s)
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S = LM_PIN_SHAPES["S2048"][:2]
    q, k, v = attn_inputs(B, S, S, H, KV, hd, torch.float32)
    flash_check("float32 pin prefill", q, k, v, True)
    flash_check("float32 pin prefill", q, k, v, True, simt=True)
    m_ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v,
                                                          causal=True),
                   reps=10)
    s_ms = time_ms(torch, lambda: fa.flash_attention_cuda(
        q, k, v, causal=True, simt=True), reps=3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = time_ms(torch, lambda: torch.nn.functional
                     .scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True,
                                                   enable_gqa=True),
                     reps=5)
    p_ms = time_ms(torch, lambda: fa.flash_attention_ref(q, k, v,
                                                         causal=True),
                   reps=2, rounds=3)
    flops, moved, b_ms, b_by = flash_bound(q, k, v, True)
    for arm, ms in (("flash_mma", m_ms), ("flash", s_ms)):
        timing[arm] = {"ms": ms, "plain_ms": p_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "library_ms": lib_ms}
        emit({"phase": "kernel_time", "arm": arm, "B": B, "S": S, "H": H,
              "KV": KV, "hd": hd, "causal": True, "dtype": "float32",
              "flops": flops, "bytes": moved, "allow_tf32": False,
              "tflops_per_s": flops / ms / 1e9, **timing[arm]})
    check(m_ms < s_ms, f"the mma kernel ({m_ms} ms) is not faster than the "
                       f"SIMT kernel ({s_ms} ms) it took the route from")
    del q, k, v, qt, kt, vt

    # whisper-base's encoder shape (B 2, S 1500, H 8, hd 64, unmasked),
    # float32: the mma kernel, held against the plain version on the inputs
    # it is then timed on, beside the SIMT kernel and float32 SDPA
    B, S, H, KV, hd = 2, WHISPER_FRAMES, 8, 8, 64
    q, k, v = attn_inputs(B, S, S, H, KV, hd, torch.float32)
    flash_check("float32 whisper-base encoder", q, k, v, False)
    w_ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v,
                                                          causal=False))
    ws_ms = time_ms(torch, lambda: fa.flash_attention_cuda(
        q, k, v, causal=False, simt=True), reps=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    wl_ms = time_ms(torch, lambda: torch.nn.functional
                    .scaled_dot_product_attention(qt, kt, vt))
    flops, moved, b_ms, b_by = flash_bound(q, k, v, False)
    emit({"phase": "kernel_time", "arm": "flash_mma", "B": B, "S": S,
          "H": H, "KV": KV, "hd": hd, "causal": False, "dtype": "float32",
          "flops": flops, "bytes": moved, "allow_tf32": False, "ms": w_ms,
          "simt_ms": ws_ms, "library_ms": wl_ms, "bound_ms": b_ms,
          "bound_by": b_by, "tflops_per_s": flops / w_ms / 1e9})
    del q, k, v, qt, kt, vt

    # gemma-7b's shape (bf16, head_dim 256, 16 heads of their own KV): the
    # wgmma kernel's hd-256 tiles held against the plain version on the
    # inputs it is then timed on, beside one SDPA call and the bound
    B, S, H, KV, hd = 4, 4096, 16, 16, 256
    q, k, v = attn_inputs(B, S, S, H, KV, hd, torch.bfloat16)
    flash_check("gemma-7b prefill", q, k, v, True)
    g_ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v,
                                                          causal=True),
                   reps=10)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gl_ms = time_ms(torch, lambda: torch.nn.functional
                    .scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=True),
                    reps=10)
    flops, moved, b_ms, b_by = flash_bound(q, k, v, True)
    emit({"phase": "kernel_time", "arm": "flash_wgmma", "config": "gemma-7b",
          "B": B, "S": S, "H": H, "KV": KV, "hd": hd, "causal": True,
          "dtype": "bfloat16", "flops": flops, "bytes": moved, "ms": g_ms,
          "library_ms": gl_ms, "bound_ms": b_ms, "bound_by": b_by,
          "tflops_per_s": flops / g_ms / 1e9})
    del q, k, v, qt, kt, vt

    # phase 11b's two new path shapes, bf16, causal, at B 4 and S 4096:
    # granite-moe-3b's attention (24 heads over 8 KV heads, hd 64) on the
    # wgmma kernel and zamba2-2.7b's shared block (32 heads, hd 80) on the
    # mma kernel, each held against the plain version on the inputs it is
    # then timed on, beside one SDPA call, the plain version and the bound
    for config, arm, (H, KV, hd) in (
            ("granite-moe-3b-a800m", "flash_wgmma", (24, 8, 64)),
            ("zamba2-2.7b", "flash_mma", (32, 32, 80))):
        B, S = 4, 4096
        q, k, v = attn_inputs(B, S, S, H, KV, hd, torch.bfloat16)
        flash_check(f"{config} prefill", q, k, v, True)
        f_ms = time_ms(torch, lambda: fa.flash_attention_cuda(
            q, k, v, causal=True), reps=10)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fl_ms = time_ms(torch, lambda: torch.nn.functional
                        .scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True,
                            enable_gqa=KV != H), reps=10)
        fp_ms = time_ms(torch, lambda: fa.flash_attention_ref(
            q, k, v, causal=True), reps=2, rounds=3)
        flops, moved, b_ms, b_by = flash_bound(q, k, v, True)
        emit({"phase": "kernel_time", "arm": arm, "config": config,
              "B": B, "S": S, "H": H, "KV": KV, "hd": hd, "causal": True,
              "dtype": "bfloat16", "flops": flops, "bytes": moved,
              "ms": f_ms, "plain_ms": fp_ms, "library_ms": fl_ms,
              "bound_ms": b_ms, "bound_by": b_by,
              "tflops_per_s": flops / f_ms / 1e9})
        del q, k, v, qt, kt, vt

    # -- 10. the full-width LM pins of the JAX reference, on both arms, in
    # float32 and in the reference's configured bf16 -----------------------
    mark("10")
    launches["flash_mma"] = launches["flash_wgmma"] = 0
    lm_pin_phase(torch, dev, LM_DENSE_PINS, "lm_pins", launches)
    launches["flash"] = 0           # the SIMT kernel: on no path
    torch.cuda.empty_cache()

    # -- 11. qwen2-7b served at full width and depth, bf16 -----------------
    mark("11")
    cfg = configs.get_config("qwen2-7b")
    # the mesh phases' engines sit in reference cycles (their block store
    # holds a closure over the engine) with their tables and pools on the
    # card: collect them, so that the peak below is the LM's own
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for key in fa.LAUNCHES:
        fa.LAUNCHES[key] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        toks = serve.main(["--arch", "qwen2-7b", "--batch", "4",
                           "--prompt-len", "32", "--gen", "16",
                           "--cache-len", "128"])
    main_wall = time.perf_counter() - t0
    check(toks.shape == (4, 16) and toks.min() >= 0
          and toks.max() < cfg.vocab, f"serve.main gave {toks}")
    model = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32),
                                                dtype=np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = serve.generate(cfg, model, prompts, 16, 128)
    gen_wall = time.perf_counter() - t0
    emit({"phase": "lm_serve", "arch": cfg.name, "n_layers": cfg.n_layers,
          "serve_line": out.getvalue().strip(),
          "main_wall_s": round(main_wall, 3),
          "generate_wall_s": round(gen_wall, 3),
          "tokens_per_s": 4 * (32 + 16) / gen_wall,
          "same_tokens_as_main": bool(np.array_equal(again, toks)),
          "params": sum(p.numel() for p in model.parameters())})

    for S in (4096, 1000):
        batch = specs.concrete_batch(
            cfg, ShapeConfig(f"prefill_{S}", S, 4, "prefill"), rng=S,
            device=dev)
        logits, nxt, walls = {}, {}, {"cuda": [], "torch": []}
        for backend in ("cuda", "torch"):      # warm-up, and the logits
            logits[backend] = lm.prefill_fn(model, batch, cfg,
                                            backend)[0][:, -1].float()
        for backend in ("cuda", "torch", "torch", "cuda"):
            step = steps.make_prefill_step(cfg, backend)
            torch.cuda.synchronize()
            before = dict(fa.LAUNCHES)
            t0 = time.perf_counter()
            nxt[backend] = step(model, batch)
            torch.cuda.synchronize()
            walls[backend].append(time.perf_counter() - t0)
            n = {key: fa.LAUNCHES[key] - before[key] for key in before}
            per = cfg.n_layers if backend == "cuda" else 0
            check(n == {"flash": per, "flash_wgmma": per, "flash_mma": 0,
                        "flash_simt": 0},
                  f"{backend} prefill at S={S} launched the flash kernels "
                  f"{n} times")
        diff = float((logits["cuda"] - logits["torch"]).abs().max())
        scale = float(logits["torch"].abs().max())
        share = float((nxt["cuda"] == nxt["torch"]).float().mean())
        emit({"phase": "lm_prefill", "arch": cfg.name, "B": 4, "S": S,
              "walls_s": walls, "tokens_per_s": {
                  b: 4 * S / min(w) for b, w in walls.items()},
              "flash_launches_per_call": cfg.n_layers,
              "logit_max_abs_diff": diff, "logit_max_abs": scale,
              "equal_next_tokens": share,
              "kernel_share": (k_ms * cfg.n_layers / 1e3
                               / min(walls["cuda"]) if S == 4096 else None)})
        check(torch.isfinite(logits["cuda"]).all(), "non-finite logits")
        check(diff <= LM_ARM_TOL * scale,
              f"S={S}: the arms' bf16 logits differ by {diff} "
              f"(max |logit| {scale})")
    torch.cuda.synchronize()
    launches["flash_wgmma"] += fa.LAUNCHES["flash_wgmma"]
    emit({"phase": "lm_memory", "peak_allocated_gib":
          torch.cuda.max_memory_allocated() / 2 ** 30,
          "flash_launches": dict(fa.LAUNCHES),
          "lm_phases_wall_s": round(time.perf_counter() - t_lm, 3)})
    # three cuda-arm prefill calls at each of the two lengths, every one
    # of their launches the wgmma kernel's
    want = 6 * cfg.n_layers
    check(fa.LAUNCHES == {"flash": want, "flash_wgmma": want,
                          "flash_mma": 0, "flash_simt": 0},
          f"the LM path launched the flash kernels {fa.LAUNCHES}, not "
          f"{want} times flash_fwd_wgmma")
    del model, logits


# phase 11b: the four families served at full width, bf16, cut to about
# half their depth (28, 32, 24 and 54 layers; zamba2 in whole groups of
# six) so that the script keeps inside its time limit: the depth, the
# flash kernel each prefill's attention takes and its launches per call
FAMILY_FLASH = {"qwen2-vl-7b": (14, "flash_wgmma", 14),
                "granite-moe-3b-a800m": (16, "flash_wgmma", 16),
                "mamba2-130m": (12, None, 0),
                "zamba2-2.7b": (30, "flash_mma", 5)}
# phase 11c: the four configurations first served on the card, at full
# width in bf16; gemma-7b (28 layers, 8.54 B parameters, 17.1 GB) and
# deepseek-7b (30, 6.91 B, 13.8 GB) whole, command-r-35b (4.19 B of embed
# and unembed and 0.705 B a layer: 20 of 40 layers, 36.6 GB) and
# phi3.5-moe (1.30 B a layer: 16 of 32, 41.7 GB) cut to half their depth,
# as phase 11b cuts its families (neither fits the card whole); every
# prefill's attention on flash_fwd_wgmma (gemma's at hd 256)
NEW_FLASH = {"gemma-7b": (28, "flash_wgmma", 28),
             "deepseek-7b": (30, "flash_wgmma", 30),
             "command-r-35b": (20, "flash_wgmma", 20),
             "phi3.5-moe-42b-a6.6b": (16, "flash_wgmma", 16)}


def moe_flips(a, b, n_experts: int):
    """(token, expert) choices in ``a`` (T, k) that ``b`` lacks."""
    import torch
    oh = [torch.zeros((x.shape[0], n_experts), dtype=torch.bool,
                      device=x.device).scatter_(1, x, True) for x in (a, b)]
    return int((oh[0] & ~oh[1]).sum())


def device_breakdown(torch, fn, top: int = 6) -> dict:
    """``fn()`` once under ``torch.profiler``: its wall (host clock ending in
    a synchronise), the device's busy time (the kernels' summed device
    time), the idle share, the ``top`` kernels by device time and the
    ``top`` host operators by their own host time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    host = sorted((e for e in events if not str(e.device_type)
                   .endswith("CUDA")),
                  key=lambda e: e.self_cpu_time_total, reverse=True)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    busy = sum(dev_us(e) for e in kernels) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1 - busy / wall,
            "top": [{"name": e.key[:90], "count": e.count,
                     "ms": dev_us(e) / 1e3}
                    for e in sorted(kernels, key=dev_us, reverse=True)[:top]],
            "top_host": [{"name": e.key[:90], "count": e.count,
                          "ms": e.self_cpu_time_total / 1e3}
                         for e in host[:top]]}


def lm_family_phases(torch, dev, launches, phase="11b",
                     pins=LM_FAMILY_PINS, table=None,
                     profile: bool = True) -> None:
    """Phase 11b: the vlm, moe, ssm and hybrid families on the card
    (phase 11c: gemma-7b, deepseek-7b, command-r-35b and phi3.5-moe:
    ``pins`` ``LM_NEW_PINS``, ``table`` ``NEW_FLASH``, no profile). (a)
    their float32 and bf16 pins of the JAX reference on both arms
    (``lm_pin_phase``); (b) each configuration at full width, cut to
    ``table``'s depth (``FAMILY_FLASH``), in bf16 with seeded weights:
    ``serve.main``
    and ``generate`` (4 prompts of 32 tokens, 16 generated, a 128-slot
    cache), then ``make_prefill_step`` at B 4, S 4096 (qwen2-vl: 256
    vision tokens on a 16 x 16 grid and 3840 text tokens) on both arms in
    turns, the flash launches of every call asserted, the arms' logits
    within ``LM_ARM_TOL`` (a moe's also with the torch arm's expert choices
    replayed on the kernels' arm; for ``ARM_ROUTED`` only so, and its
    first layer's flips within ``ARM_FIRST_FLIPS``), a moe model's flipped
    expert choices between the arms per layer, walls, tokens/s, the peak
    device memory and, with
    ``profile``, where one prefill's and four decode steps' time goes.
    Adds the kernels' arm's flash launches to ``launches``."""
    import contextlib
    import io

    import numpy as np

    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve, specs, steps
    from repro_torch.models import lm, moe

    mark(phase)
    t11 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    # -- a. the float32 and bf16 pins, both arms ---------------------------
    lm_pin_phase(torch, dev, pins, "lm_family_pins", launches)
    gc.collect()
    torch.cuda.empty_cache()

    # -- b. full width, about half depth, bf16 ------------------------------
    S, Bp = 4096, 4
    for arch, (depth, kernel, per) in (table or FAMILY_FLASH).items():
        cfg = dataclasses.replace(configs.get_config(arch), n_layers=depth)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for key in fa.LAUNCHES:
            fa.LAUNCHES[key] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            toks = serve.main(["--arch", arch, "--batch", "4",
                               "--prompt-len", "32", "--gen", "16",
                               "--cache-len", "128", "--layers",
                               str(depth)])
        main_wall = time.perf_counter() - t0
        check(toks.shape == (4, 16) and toks.min() >= 0
              and toks.max() < cfg.vocab, f"{arch}: serve.main gave {toks}")
        model = lm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32),
                                                    dtype=np.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = serve.generate(cfg, model, prompts, 16, 128)
        gen_wall = time.perf_counter() - t0
        check(all(n == 0 for n in fa.LAUNCHES.values()),
              f"{arch}: decode launched the flash kernels {fa.LAUNCHES}")
        emit({"phase": "lm_serve", "arch": cfg.name,
              "n_layers": cfg.n_layers,
              "serve_line": out.getvalue().strip(),
              "main_wall_s": round(main_wall, 3),
              "generate_wall_s": round(gen_wall, 3),
              "tokens_per_s": 4 * (32 + 16) / gen_wall,
              "same_tokens_as_main": bool(np.array_equal(again, toks)),
              "params": sum(p.numel() for p in model.parameters())})

        batch = specs.concrete_batch(
            cfg, ShapeConfig(f"prefill_{S}", S, Bp, "prefill"), rng=S,
            device=dev)
        if cfg.family == "vlm":
            nv = cfg.n_vision_tokens
            batch["positions3d"] = torch.from_numpy(
                grid_positions(nv, S - nv, Bp)).to(dev)
        logits, nxt, walls = {}, {}, {"cuda": [], "torch": []}
        routed = {}
        route = moe.route
        for backend in ("cuda", "torch"):      # warm-up, logits, routing
            rec = routed[backend] = []

            def recording(p, x, c, rec=rec):
                gates, eidx = route(p, x, c)
                rec.append((gates, eidx))
                return gates, eidx
            moe.route = recording
            try:
                logits[backend] = lm.prefill_fn(model, batch, cfg,
                                                backend)[0][:, -1].float()
            finally:
                moe.route = route
        if cfg.family == "moe":
            # the kernels' arm again, each layer given the torch arm's
            # expert choices and gates: the arms' attention alone
            replayed = iter(routed["torch"])
            moe.route = lambda p, x, c: next(replayed)
            try:
                logits["routed"] = lm.prefill_fn(model, batch, cfg,
                                                 "cuda")[0][:, -1].float()
            finally:
                moe.route = route
        for key in fa.LAUNCHES:
            fa.LAUNCHES[key] = 0
        for backend in ("cuda", "torch", "torch", "cuda"):
            step = steps.make_prefill_step(cfg, backend)
            torch.cuda.synchronize()
            before = dict(fa.LAUNCHES)
            t0 = time.perf_counter()
            nxt[backend] = step(model, batch)
            torch.cuda.synchronize()
            walls[backend].append(time.perf_counter() - t0)
            n = {key: fa.LAUNCHES[key] - before[key] for key in before}
            want = {key: 0 for key in before}
            if backend == "cuda" and per:
                want.update({"flash": per, kernel: per})
            check(n == want, f"{arch} {backend} prefill launched the flash "
                             f"kernels {n} times, not {want}")
        if kernel:
            launches[kernel] += fa.LAUNCHES[kernel]
        diff = float((logits["cuda"] - logits["torch"]).abs().max())
        scale = float(logits["torch"].abs().max())
        share = float((nxt["cuda"] == nxt["torch"]).float().mean())
        line = {"phase": "lm_prefill", "arch": cfg.name, "B": Bp, "S": S,
                "walls_s": walls, "tokens_per_s": {
                    b: Bp * S / min(w) for b, w in walls.items()},
                "flash_kernel": kernel, "flash_launches_per_call": per,
                "logit_max_abs_diff": diff, "logit_max_abs": scale,
                "arm_gap_share": diff / scale, "equal_next_tokens": share}
        if profile:
            # where the time goes: one kernels'-arm prefill and four decode
            # steps against a 128-slot cache, under the profiler
            cache = lm.init_cache(cfg, Bp, 128, dev)
            serve_step = steps.make_serve_step(cfg)
            tok = batch["tokens"][:, :1]

            def decode4():
                c = cache
                for t in range(4):
                    b = {"token": tok, "pos": torch.full(
                        (Bp,), t, dtype=torch.int32, device=dev)}
                    if cfg.family == "vlm":
                        b["positions3d"] = torch.full(
                            (3, Bp, 1), t, dtype=torch.int32, device=dev)
                    _, c = serve_step(model, c, b)
            step = steps.make_prefill_step(cfg, "cuda")
            emit({"phase": "lm_profile", "arch": cfg.name,
                  "prefill": device_breakdown(
                      torch, lambda: step(model, batch)),
                  "decode_4_steps": device_breakdown(torch, decode4)})
            del cache
        if cfg.family == "moe":
            flips = [moe_flips(a[1], b[1], cfg.n_experts)
                     for a, b in zip(routed["cuda"], routed["torch"])]
            routed_diff = float((logits["routed"]
                                 - logits["torch"]).abs().max())
            line.update(flipped_choices_per_layer=flips,
                        choices_per_layer=Bp * S * cfg.top_k,
                        routed_as_torch_max_abs_diff=routed_diff,
                        routed_as_torch_gap_share=routed_diff / scale)
        emit(line)
        torch.cuda.synchronize()
        emit({"phase": "lm_memory", "arch": cfg.name,
              "peak_allocated_gib":
                  torch.cuda.max_memory_allocated() / 2 ** 30})
        check(torch.isfinite(logits["cuda"]).all()
              and torch.isfinite(logits["torch"]).all(),
              f"{arch}: non-finite logits")
        if cfg.family == "moe":
            check(routed_diff <= LM_ARM_TOL * scale,
                  f"{arch}: routed alike, the arms' bf16 logits differ by "
                  f"{routed_diff} (max |logit| {scale})")
        if arch in ARM_ROUTED:
            check(flips[0] <= ARM_FIRST_FLIPS * Bp * S * cfg.top_k,
                  f"{arch}: the arms' first layers chose {flips[0]} "
                  f"experts apart")
        else:
            check(diff <= LM_ARM_TOL * scale,
                  f"{arch}: the arms' bf16 logits differ by {diff} (max "
                  f"|logit| {scale})")
        del model, logits, routed
    emit({"phase": "lm_families_total", "phase_name": phase,
          "wall_s": round(time.perf_counter() - t11, 3)})


# phase 12b: deepseek-7b at full width cut to this depth (float32 masters,
# weights, gradients and two moments at ~16 bytes a parameter, 1.65 B
# parameters: ~27 GB; the full 30 layers, 6.91 B, would take ~110 GB), bf16
# compute, trained by launch.train.main: B x S tokens a step, TRAIN_STEPS
# steps, then again with a checkpoint every TRAIN_CKPT and a fault at
# TRAIN_FAULT (one save of ~20 GB, the one the restart reads; the clean
# run's checkpoints would be written and never read); mamba2-130m
# (examples/train_lm.py's model) for phase 12c
TRAIN_LAYERS = 4
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT, TRAIN_FAULT = 4, 2048, 8, 5, 6
SSM_TRAIN = ["--arch", "mamba2-130m", "--steps", "20", "--batch", "8",
             "--seq", "256", "--lr", "1e-3", "--ckpt-every", "100"]


def train_pin_run(torch, dev, backend, name, tree, remat=None):
    """The port's training pin ``name`` on ``dev`` through ``backend``:
    ``TRAIN_PIN_STEPS`` ``make_train_step`` calls from ``tree`` (the
    reference layout) as float32 masters, on the pin's batches, under
    ``remat`` (``"none"`` unless given). Returns each step's loss,
    grad norm and lr, and each step's flash launches per kernel (counters
    zeroed just before the step, read just after). ``tools/lm_pins.py
    --port`` runs it on the CPU."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    cfg = lm_pin_cfg(configs, TRAIN_PIN_ARCH)
    model = lm.params_from_reference(tree, cfg, dev, torch.float32)
    opt = adamw.AdamWConfig(**TRAIN_PIN_OPT)
    state = adamw.init_state(dict(model.named_parameters()), opt)
    step = steps.make_train_step(cfg, opt, backend,
                                 loss_chunk=LM_TRAIN_PINS[name], remat=remat)
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
    out, flash = {"loss": [], "grad_norm": [], "lr": []}, []
    for b in train_pin_batches(cfg.vocab):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        sync()
        for key in fa.LAUNCHES:
            fa.LAUNCHES[key] = 0
        model, state, m = step(model, state, batch)
        sync()
        flash.append({k: fa.LAUNCHES[k] for k in
                      ("flash_mma", "flash_simt", "flash_wgmma")})
        for k in out:
            out[k].append(float(m[k]))
    return out, flash


def lm_train_phases(torch, dev, max_err, launches) -> float:
    """Phase 12: LM training on the card. (a) the JAX reference's float32
    training pins on both arms; (b) deepseek-7b at full width, TRAIN_LAYERS
    layers, bf16, through ``launch.train.main``: a clean run and one with
    an injected fault, their last losses within the reference's 1e-5, the
    flash launches of every forward; the wgmma kernel and the Function's
    gradient at the step's attention shape against the plain version and
    its autograd; every gradient finite and nonzero on the kernels' arm,
    the arms' step-0 loss, grad norm and attention weights' gradient norms
    within ``TRAIN_ARM_TOL``, step time, tokens/s, peak memory, the
    attention backward's share and a profile of one step; (c) mamba2-130m
    whole as ``examples/train_lm.py`` trains it: the loss falls. Adds the
    kernels' arm's flash launches to ``launches`` and the training shape's
    error to ``max_err``. Returns (b)'s peak device memory, GiB."""
    import contextlib
    import io

    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps, train
    from repro_torch.models import layers, lm
    from repro_torch.optim import adamw

    mark("12")
    t12 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    # -- a. the float32 training pins, both arms ---------------------------
    import numpy as np
    cfg = lm_pin_cfg(configs, TRAIN_PIN_ARCH)
    tree = reference_tree(cfg, 0)
    digests = train_batch_digests(cfg.vocab, SyntheticTokens)
    emit({"phase": "train_batch_sha256", "numpy": np.__version__,
          "sha256": digests, "want": TRAIN_BATCH_SHA256})
    check(digests["pins"] == TRAIN_BATCH_SHA256["pins"],
          "the training pins' batches differ from those they were computed "
          "on")
    failed = []
    # the float32 pins on both arms, then "train" on the kernels' arm under
    # remat="full" and "dots": a checkpointed block is recomputed in the
    # backward, so its flash forward runs twice a step
    for backend, name, remat in [(b, n, None) for b in ("cuda", "torch")
                                 for n in LM_TRAIN_PINS] + [
            ("cuda", "train", "full"), ("cuda", "train", "dots")]:
        t0 = time.perf_counter()
        got, flash = train_pin_run(torch, dev, backend, name, tree,
                                   remat)
        emit({"phase": "lm_train_pins", "pin": name, "backend": backend,
              "remat": remat or "none",
              "results": got, "want": LM_PINS[name],
              "flash_launches_per_step": flash,
              "wall_s": round(time.perf_counter() - t0, 3)})
        for key, tol in TRAIN_PIN_TOL.items():
            if any(abs(g - w) > tol * abs(w) for g, w in
                   zip(got[key], LM_PINS[name][key])):
                failed.append(f"{backend} {name} remat {remat}: {key} "
                              f"{got[key]} != reference "
                              f"{LM_PINS[name][key]} (rtol {tol})")
        per = (4 if remat else 2) if backend == "cuda" else 0
        want = [{"flash_mma": per, "flash_simt": 0, "flash_wgmma": 0}] \
            * TRAIN_PIN_STEPS
        if flash != want:
            failed.append(f"{backend} {name}: flash launches per step "
                          f"{flash} != {want}")
        if backend == "cuda":
            launches["flash_mma"] += sum(f["flash_mma"] for f in flash)
        gc.collect()
        torch.cuda.empty_cache()
    del tree
    check(not failed, "; ".join(failed))

    # -- b. deepseek-7b, full width, TRAIN_LAYERS layers, bf16 -------------
    cfg = dataclasses.replace(configs.get_config(TRAIN_PIN_ARCH),
                              n_layers=TRAIN_LAYERS)
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    atexit.register(shutil.rmtree, ckpt_root, True)
    args = ["--arch", TRAIN_PIN_ARCH, "--layers", str(TRAIN_LAYERS),
            "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_B),
            "--seq", str(TRAIN_S)]
    runs = {}
    # each checkpoint's save and restore wall (host clock), per run
    io_s = {}
    save, restore = ckpt.save, ckpt.restore

    def timed(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                io_s.setdefault(key, []).append(time.perf_counter() - t0)
        return run
    ckpt.save, ckpt.restore = timed(save, "save_s"), timed(restore,
                                                           "restore_s")
    for label, extra in (("clean", ["--ckpt-every", str(TRAIN_STEPS + 1)]),
                         ("fault", ["--ckpt-every", str(TRAIN_CKPT),
                                    "--inject-fault-at", str(TRAIN_FAULT)])):
        io_s.clear()
        ckpt_dir = os.path.join(ckpt_root, label)
        for key in fa.LAUNCHES:
            fa.LAUNCHES[key] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            hist = train.main(args + extra + ["--ckpt-dir", ckpt_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_fwd = len(hist)
        runs[label] = {"wall_s": round(wall, 3), "steps_run": n_fwd,
                       "losses": [h["loss"] for h in hist],
                       "grad_norms": [h["grad_norm"] for h in hist],
                       "lines": out.getvalue().strip().splitlines(),
                       "flash_launches": dict(fa.LAUNCHES),
                       "free_disk_gb": shutil.disk_usage(ckpt_root).free
                       / 1e9, **io_s}
        want = {"flash": TRAIN_LAYERS * n_fwd,
                "flash_wgmma": TRAIN_LAYERS * n_fwd, "flash_mma": 0,
                "flash_simt": 0}
        check(fa.LAUNCHES == want, f"train.main ({label}) launched the "
                                   f"flash kernels {fa.LAUNCHES}, not "
                                   f"{want}")
        launches["flash_wgmma"] += fa.LAUNCHES["flash_wgmma"]
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    ckpt.save, ckpt.restore = save, restore
    last = {k: r["losses"][-1] for k, r in runs.items()}
    emit({"phase": "lm_train_replay", "arch": cfg.name, "B": TRAIN_B,
          "S": TRAIN_S, **runs, "step7_gap": abs(last["clean"]
                                                   - last["fault"])})
    check(runs["fault"]["steps_run"] == TRAIN_STEPS + TRAIN_FAULT
          - TRAIN_CKPT, f"the faulted run ran {runs['fault']['steps_run']} "
                        f"steps")
    check(abs(last["clean"] - last["fault"]) < 1e-5,
          f"the faulted run's last loss {last['fault']} != the clean run's "
          f"{last['clean']}")
    check(len(runs["fault"].get("save_s", [])) == 1
          and "save_s" not in runs["clean"],
          f"checkpoint saves: clean {runs['clean'].get('save_s')}, faulted "
          f"{runs['fault'].get('save_s')}; want none and one")

    # the wgmma kernel and the Function's gradient at the step's attention
    # shape (B, S, heads 32/32, hd 128, causal, bf16), against the plain
    # version and autograd through it: bf16 2e-2, of each gradient's
    # largest entry for (dq, dk, dv), as tests/test_torch_cuda.py holds them
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v, dout = (torch.randn((TRAIN_B, TRAIN_S, n, cfg.hd), device=dev,
                                 generator=gen).to(torch.bfloat16)
                     for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads,
                               cfg.n_heads))
    tol = 2e-2
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    want = fa.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    ran = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
    fwd_err = float((got.float() - want.float()).abs().max())
    fwd_ok = got.dtype == torch.bfloat16 and bool(torch.allclose(
        got.float(), want.float(), rtol=tol, atol=tol))
    del got, want
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(layers.flash_attention_trainable(
        q, k, v, causal=True), (q, k, v), dout)
    want = torch.autograd.grad(fa.flash_attention_ref(q, k, v, causal=True),
                               (q, k, v), dout)
    grad_err, grad_ok = {}, True
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = float(b.float().abs().max())
        grad_err[name] = float((a.float() - b.float()).abs().max()) / scale
        grad_ok &= a.dtype == torch.bfloat16 and bool(torch.allclose(
            a.float(), b.float(), rtol=tol, atol=tol * scale))
    del q, k, v, dout, got, want
    max_err["flash_wgmma"] = max(max_err["flash_wgmma"], fwd_err)
    emit({"phase": "kernel_case", "case": "train step attention",
          "relation": "flash", "launches": ran, "B": TRAIN_B, "S": TRAIN_S,
          "T": TRAIN_S, "H": cfg.n_heads, "KV": cfg.n_kv_heads, "hd": cfg.hd,
          "causal": True, "dtype": "bfloat16", "max_abs_err": fwd_err,
          "grad_err_of_max": grad_err, "tol": tol, "close": fwd_ok,
          "grad_close": grad_ok})
    check(ran["flash_wgmma"] == ran["flash"] == 1,
          f"the training shape ran {ran}, not one flash_fwd_wgmma")
    check(fwd_ok, "flash_fwd_wgmma disagrees with its plain version at the "
                  "training shape")
    check(grad_ok, f"the Function's gradient disagrees with autograd of the "
                   f"plain version at the training shape: {grad_err}")
    gc.collect()
    torch.cuda.empty_cache()

    # the gradients of one step on both arms, from one seeded model
    model = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev, torch.float32)
    batch = train.train_batch(cfg, SyntheticTokens(cfg.vocab, seed=0).batch(
        0, TRAIN_B, TRAIN_S), dev)
    arm, leaf_norms = {}, {}
    for backend in ("cuda", "torch"):
        loss, grads = steps.loss_and_grads(model, batch, cfg, backend)
        arm[backend] = {"loss": float(loss),
                        "grad_norm": float(adamw.global_norm(grads))}
        leaf_norms[backend] = {n: float(g.float().norm())
                               for n, g in grads.items()}
        if backend == "cuda":
            bad = [n for n, g in grads.items()
                   if not bool(torch.isfinite(g).all()) or not bool(g.any())]
            check(not bad, f"kernels' arm: gradients zero or not finite: "
                           f"{bad[:5]}")
        del grads
    leaf_gap = {n: abs(leaf_norms["cuda"][n] - w) / w
                for n, w in leaf_norms["torch"].items()}
    attn = [n for n in leaf_gap if ".attn.w" in n]
    check(len(attn) == 4 * TRAIN_LAYERS, f"attention weights found: {attn}")
    gaps = {k: abs(arm["cuda"][k] - arm["torch"][k]) / abs(arm["torch"][k])
            for k in ("loss", "grad_norm")}
    gaps["attn_grad_norm"] = max(leaf_gap[n] for n in attn)
    emit({"phase": "lm_train_arms", "arch": cfg.name, **arm,
          "rel_gap": gaps, "tol": TRAIN_ARM_TOL,
          "leaf_grad_norm_gap": leaf_gap, "params": lm.param_count(model)})
    for k, tol in TRAIN_ARM_TOL.items():
        check(gaps[k] <= tol, f"the arms' step-0 {k} differ by {gaps[k]} "
                              f"(rtol {tol}): {arm}")

    # step time, tokens/s, peak memory, where a step's time goes
    opt = adamw.AdamWConfig(total_steps=TRAIN_STEPS)
    state = adamw.init_state(dict(model.named_parameters()), opt)
    step = steps.make_train_step(cfg, opt, "cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step(model, state, batch)                          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        _, _, m = step(model, state, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((TRAIN_B, TRAIN_S, cfg.n_heads, cfg.hd), device=dev,
                    generator=gen).to(torch.bfloat16)
    k, v = (torch.randn((TRAIN_B, TRAIN_S, cfg.n_kv_heads, cfg.hd),
                        device=dev, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    bwd_ms = time_ms(torch, lambda: layers.sdpa_backward(q, k, v, q, True),
                     reps=3, rounds=3)
    fwd_ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v,
                                                            causal=True),
                     reps=10)
    del q, k, v
    emit({"phase": "lm_train_step", "arch": cfg.name,
          "n_layers": cfg.n_layers, "B": TRAIN_B, "S": TRAIN_S,
          "params": lm.param_count(model), "step_s": step_s,
          "tokens_per_s": TRAIN_B * TRAIN_S / step_s,
          "peak_allocated_gib": peak, "loss": float(m["loss"]),
          "attention_backward_ms": bwd_ms, "attention_forward_ms": fwd_ms,
          "attention_backward_share": cfg.n_layers * bwd_ms / 1e3 / step_s,
          "attention_forward_share": cfg.n_layers * fwd_ms / 1e3 / step_s,
          "profile": device_breakdown(torch, lambda: step(model, state,
                                                           batch))})
    del model, state, batch, step
    gc.collect()
    torch.cuda.empty_cache()

    # -- c. mamba2-130m, examples/train_lm.py's model ----------------------
    for key in fa.LAUNCHES:
        fa.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = train.main(SSM_TRAIN + ["--ckpt-dir",
                                       os.path.join(ckpt_root, "ssm")])
    torch.cuda.synchronize()
    losses = [h["loss"] for h in hist]
    emit({"phase": "lm_train_ssm", "lines": out.getvalue().strip()
          .splitlines(), "losses": losses,
          "wall_s": round(time.perf_counter() - t0, 3),
          "flash_launches": dict(fa.LAUNCHES)})
    check(all(n == 0 for n in fa.LAUNCHES.values()),
          f"mamba2-130m launched the flash kernels {fa.LAUNCHES}")
    check(len(losses) == 20 and losses[-1] < losses[0],
          f"mamba2-130m's loss did not fall: {losses}")
    emit({"phase": "lm_train_total",
          "wall_s": round(time.perf_counter() - t12, 3)})
    return peak


# phase 13: the sharded LM on the one card, through a world-size-1 NCCL
# group and a (1, 1) ("data", "model") mesh: qwen2-7b served and
# deepseek-7b trained at full width, cut to these depths, against the same
# models without a mesh; then the dry run's per-device need of deepseek-7b
MESH_LAYERS = {"qwen2-7b": 4, "deepseek-7b": 2}
MESH_B, MESH_S, MESH_TRAIN_S, MESH_TRAIN_STEPS = 4, 4096, 2048, 3
# the dry run of phase 12b's training (4 layers, B 4, S 2048, remat none,
# as train.main runs it) on one device, then the full 30 layers on (N, 1)
# meshes at 4 rows a device (global batch 4 N), remat full (the dry run's
# default, the reference's)
DRYRUN_NS = (1, 2, 4, 8)


def dryrun_cmds():
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            "deepseek-7b", "--shape", "train_4k", "--seq", str(TRAIN_S)]
    out = [("4 layers, (1, 1), remat none",
            base + ["--layers", str(TRAIN_LAYERS), "--batch", str(TRAIN_B),
                    "--mesh-shape", "1,1", "--remat", "none"])]
    for n in DRYRUN_NS:
        out.append((f"30 layers, ({n}, 1)",
                    base + ["--layers", "30", "--batch", str(TRAIN_B * n),
                            "--mesh-shape", f"{n},1"]))
    return out


def lm_mesh_phases(torch, dev, max_err, launches, measured_peak_gib) -> None:
    """Phase 13: the sharded LM on the card (a world-size-1 NCCL group on a
    ``FileStore``, a (1, 1) ``("data", "model")`` mesh, destroyed at the
    end). (a) qwen2-7b at full width, ``MESH_LAYERS`` layers, bf16: one
    prefill at B 4, S 4096 with ``Runtime(mesh)`` and without, the next
    tokens equal and the logits within ``LM_ARM_TOL``, 4 ``flash_fwd_wgmma``
    launches a sharded prefill (counters zeroed just before each call,
    read just after), both arms timed in turns; ``generate`` (4 x 32 + 16
    tokens) on both, the tokens equal. (b) deepseek-7b at full width, 2
    layers, float32 masters, bf16 compute: 3 ``make_train_step(rt=)``
    steps at B 4, S 2048 against the same without a mesh, each step's loss
    and grad norm within ``TRAIN_ARM_TOL``. (c) ``Runtime.flash_decode`` on
    a one-shard cache against the plain attention (float32 1e-5, bf16
    2e-2). (d) ``ckpt.save`` on the mesh and ``restore(shardings=)``: the
    values equal, the placements asked for. (e) the dry run (its own
    processes, started first): phase 12b's training on one device beside
    the peak phase 12 measured, then the full depth's per-device need on
    (N, 1) meshes. Adds the sharded prefills' and steps' flash launches to
    ``launches``."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as meshes
    from repro_torch.launch import serve, specs, steps, train
    from repro_torch.models import layers, lm
    from repro_torch.optim import adamw

    mark("13")
    t13 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    # -- e. the dry runs start first, each a process of its own ------------
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    runs = [(label, subprocess.Popen(argv, cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))
            for label, argv in dryrun_cmds()]
    for _, proc in runs:
        atexit.register(proc.kill)

    def zero():
        for key in fa.LAUNCHES:
            fa.LAUNCHES[key] = 0

    store = tempfile.mkdtemp(prefix="chip_smoke_group_")
    atexit.register(shutil.rmtree, store, True)
    torch.cuda.set_device(0)
    meshes.init_group("nccl", 0, 1, store)
    try:
        mesh = meshes.make_mesh((1, 1), ("data", "model"), "cuda")
        rt = shd.Runtime(mesh=mesh, batch_axes=meshes.batch_axes(mesh),
                         remat="none")

        # -- a. qwen2-7b served, full width, bf16 --------------------------
        cfg = dataclasses.replace(configs.get_config("qwen2-7b"),
                                  n_layers=MESH_LAYERS["qwen2-7b"])
        models = {}
        for arm in ("plain", "mesh"):
            models[arm] = lm.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), dev)
        shd.distribute_params(models["mesh"], shd.make_param_shardings(
            mesh, models["mesh"]))
        runtimes = {"plain": None, "mesh": rt}
        batch = specs.concrete_batch(cfg, ShapeConfig(
            "prefill_4096", MESH_S, MESH_B, "prefill"), rng=MESH_S,
            device=dev)
        logits, ran = {}, {}
        for arm in ("plain", "mesh"):
            r = runtimes[arm]
            b = r.shard_batch(batch, "prefill", cfg) if r else batch
            torch.cuda.synchronize()
            zero()
            lg = lm.prefill_fn(models[arm], b, cfg, "cuda", r)[0]
            torch.cuda.synchronize()
            ran[arm] = dict(fa.LAUNCHES)
            lg = lg.full_tensor() if r else lg
            logits[arm] = lg[:, -1].float()
        per = cfg.n_layers
        want = {"flash": per, "flash_wgmma": per, "flash_mma": 0,
                "flash_simt": 0}
        walls = {"plain": [], "mesh": []}
        nxt = {}
        for arm in ("plain", "mesh", "mesh", "plain"):
            step = steps.make_prefill_step(cfg, "cuda", runtimes[arm])
            torch.cuda.synchronize()
            zero()
            t0 = time.perf_counter()
            nxt[arm] = step(models[arm], batch)
            torch.cuda.synchronize()
            walls[arm].append(time.perf_counter() - t0)
            check(fa.LAUNCHES == want, f"the {arm} prefill launched the "
                                       f"flash kernels {fa.LAUNCHES}, not "
                                       f"{want}")
            if arm == "mesh":
                launches["flash_wgmma"] += fa.LAUNCHES["flash_wgmma"]
        diff = float((logits["mesh"] - logits["plain"]).abs().max())
        scale = float(logits["plain"].abs().max())
        same_next = bool(torch.equal(nxt["mesh"], nxt["plain"]))
        prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                    (MESH_B, 32),
                                                    dtype=np.int32)
        toks, gen_s = {}, {}
        for arm in ("plain", "mesh"):
            torch.cuda.synchronize()
            zero()
            t0 = time.perf_counter()
            toks[arm] = serve.generate(cfg, models[arm], prompts, 16, 128,
                                       backend="cuda", rt=runtimes[arm])
            torch.cuda.synchronize()
            gen_s[arm] = time.perf_counter() - t0
            check(fa.LAUNCHES["flash"] == 0,
                  f"{arm} decode launched the flash kernels {fa.LAUNCHES}")
        emit({"phase": "lm_mesh_serve", "arch": cfg.name,
              "n_layers": cfg.n_layers, "B": MESH_B, "S": MESH_S,
              "mesh": [1, 1], "flash_launches_first_call": ran,
              "prefill_walls_s": walls, "logit_max_abs_diff": diff,
              "logit_max_abs": scale, "equal_next_tokens": same_next,
              "generate_s": gen_s, "equal_generated": bool(
                  np.array_equal(toks["mesh"], toks["plain"])),
              "generated_sample": toks["mesh"][0][:8].tolist()})
        check(ran["mesh"] == want, f"the sharded prefill launched the flash "
                                   f"kernels {ran['mesh']}, not {want}")
        check(torch.isfinite(logits["mesh"]).all(), "non-finite logits")
        check(diff <= LM_ARM_TOL * scale,
              f"the sharded prefill's logits differ by {diff} (max |logit| "
              f"{scale})")
        check(same_next, "the sharded prefill's next tokens differ")
        check(np.array_equal(toks["mesh"], toks["plain"]),
              f"sharded decode gave {toks['mesh']}, without a mesh "
              f"{toks['plain']}")
        del models, logits
        gc.collect()
        torch.cuda.empty_cache()

        # -- b. deepseek-7b trained, full width, 2 layers -------------------
        cfg = dataclasses.replace(configs.get_config("deepseek-7b"),
                                  n_layers=MESH_LAYERS["deepseek-7b"])
        opt = adamw.AdamWConfig(total_steps=MESH_TRAIN_STEPS)
        source = SyntheticTokens(cfg.vocab, seed=0)
        batches = [train.train_batch(cfg, source.batch(
            i, TRAIN_B, MESH_TRAIN_S), dev) for i in range(MESH_TRAIN_STEPS)]
        hist = {}
        for arm in ("plain", "mesh"):
            r = runtimes[arm]
            model = lm.init_params(cfg, torch.Generator(
                device=dev).manual_seed(0), dev, torch.float32)
            if r is not None:
                shd.distribute_params(model, shd.make_param_shardings(
                    mesh, model))
            state = adamw.init_state(dict(model.named_parameters()), opt)
            step = steps.make_train_step(cfg, opt, "cuda", rt=r)
            rows = []
            for b in batches:
                torch.cuda.synchronize()
                zero()
                t0 = time.perf_counter()
                _, _, m = step(model, state, b)
                torch.cuda.synchronize()
                rows.append({"loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "lr": float(m["lr"]),
                             "step_s": time.perf_counter() - t0,
                             "flash": dict(fa.LAUNCHES)})
                check(fa.LAUNCHES["flash_wgmma"] == fa.LAUNCHES["flash"]
                      == cfg.n_layers,
                      f"{arm} train step launched {fa.LAUNCHES}")
                if r is not None:
                    launches["flash_wgmma"] += fa.LAUNCHES["flash_wgmma"]
            hist[arm] = rows
            del model, state, step
            gc.collect()
            torch.cuda.empty_cache()
        gaps = [{k: abs(m[k] - p[k]) / abs(p[k]) for k in ("loss",
                                                              "grad_norm")}
                for m, p in zip(hist["mesh"], hist["plain"])]
        emit({"phase": "lm_mesh_train", "arch": cfg.name,
              "n_layers": cfg.n_layers, "B": TRAIN_B, "S": MESH_TRAIN_S,
              "mesh": [1, 1], "steps": hist, "rel_gap": gaps,
              "tol": TRAIN_ARM_TOL})
        for i, g in enumerate(gaps):
            for k, v in g.items():
                check(v <= TRAIN_ARM_TOL[k],
                      f"step {i}: the sharded step's {k} is {v} apart")

        # -- c. flash_decode on a one-shard cache --------------------------
        gen = torch.Generator(device=dev).manual_seed(5)
        B, T, H, KV, hd = MESH_B, MESH_S, 28, 4, 128
        pos = torch.randint(0, T, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        dec = {}
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            q = torch.randn((B, 1, H, hd), generator=gen, device=dev)
            K, V = (torch.randn((B, T, KV, hd), generator=gen, device=dev)
                    for _ in range(2))
            q, K, V = (t.to(dtype) for t in (q, K, V))
            got = rt.flash_decode(q, K, V, pos).full_tensor()
            mask = (torch.arange(T, device=dev)[None, :]
                    <= pos.long()[:, None])[:, None, None, :]
            ref = layers._sdpa(q, layers.repeat_kv(K, H),
                               layers.repeat_kv(V, H), mask, dtype)
            err = float((got.float() - ref.float()).abs().max())
            dec[str(dtype)] = {"max_abs_err": err, "tol": tol}
            check(got.dtype == dtype and bool(torch.allclose(
                got.float(), ref.float(), rtol=tol, atol=tol)),
                f"flash_decode ({dtype}) is {err} from the plain attention")
        emit({"phase": "lm_mesh_flash_decode", "B": B, "T": T, "H": H,
              "KV": KV, "hd": hd, "cases": dec})

        # -- d. a checkpoint of DTensors, restored onto the mesh ------------
        from torch.distributed.tensor import distribute_tensor
        x = torch.randn((1024, 1024), generator=gen, device=dev)
        y = x.to(torch.bfloat16)
        tree = {"w": distribute_tensor(x, mesh, shd.placements(
            mesh, ("data", "model"))), "b": distribute_tensor(
            y, mesh, shd.placements(mesh, ()))}
        cdir = tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_")
        atexit.register(shutil.rmtree, cdir, True)
        ckpt.save(cdir, tree, 1)
        sh = {"w": shd.NamedSharding(mesh, ("model", "data")),
              "b": shd.NamedSharding(mesh, (None, None))}
        back, step_no = ckpt.restore(cdir, {"w": x, "b": y}, shardings=sh)
        ok = (step_no == 1 and all(
            torch.equal(back[k].full_tensor(), v) for k, v in
            (("w", x), ("b", y)))
              and all(tuple(back[k].placements) == sh[k].placements
                      and back[k].device_mesh == mesh for k in sh))
        emit({"phase": "lm_mesh_checkpoint", "equal_and_placed": ok,
              "placements": {k: [str(p) for p in back[k].placements]
                             for k in back}})
        check(ok, "the checkpoint restored onto the mesh differs")
    finally:
        dist.destroy_process_group()

    # -- e. the dry runs' records ------------------------------------------
    recs = {}
    for label, proc in runs:
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        recs[label] = json.loads(lines[-1]) if lines else \
            {"status": "no record", "stderr": err[-2000:]}
    bad = {k: r for k, r in recs.items() if r.get("status") != "ok"}
    check(not bad, f"dry runs failed: {bad}")
    first = recs[dryrun_cmds()[0][0]]
    dry_gib = first["memory"]["peak_bytes_per_dev"] / 2 ** 30
    emit({"phase": "lm_mesh_dryrun", "arch": "deepseek-7b",
          "cell": dryrun_cmds()[0][0], "B": TRAIN_B, "S": TRAIN_S,
          "dryrun_peak_gib": dry_gib, "measured_peak_gib": measured_peak_gib,
          "ratio": dry_gib / measured_peak_gib,
          "flops_per_dev": first["flops_per_dev"],
          "t_trace_s": first["t_trace_s"]})
    need = {label: {"devices": r["n_devices"], "batch": r["global_batch"],
                    "peak_gib": r["memory"]["peak_bytes_per_dev"] / 2 ** 30,
                    "params_gib": r["memory"]["param_bytes_per_dev"]
                    / 2 ** 30,
                    "opt_state_gib": r["memory"]["opt_state_bytes_per_dev"]
                    / 2 ** 30,
                    "flops_per_dev": r["flops_per_dev"],
                    "useful_flops_ratio": r["useful_flops_ratio"],
                    "fits_80gb": r["memory"]["peak_bytes_per_dev"] < 80e9,
                    "t_trace_s": r["t_trace_s"]}
            for label, r in recs.items() if label.startswith("30 layers")}
    emit({"phase": "lm_mesh_dryrun_full_depth", "arch": "deepseek-7b",
          "S": TRAIN_S, "rows_per_device": TRAIN_B, "per_device": need})
    emit({"phase": "lm_mesh_total",
          "wall_s": round(time.perf_counter() - t13, 3)})


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise Failed("torch.cuda.is_available() is False: needs an NVIDIA "
                     "card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise Failed(f"no src/repro_torch beside {Path(__file__).name}: run "
                     f"it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.algorithms.critical_points import MAXIMUM, MINIMUM, \
        critical_points, total_order
    from repro_torch.algorithms.discrete_gradient import audit_gradient, \
        discrete_gradient
    from repro_torch.algorithms.morse_smale import morse_smale
    from repro_torch.algorithms.persistence import persistence_pairs, \
        simplify_ms
    from repro_torch.core.adjacency import complete_adjacency, \
        plan_completion
    from repro_torch import analyze_mesh
    from repro_torch.core.engine import RelationEngine
    from repro_torch.core.explicit import ActopoDS, ExplicitTriangulation, \
        TopoClusterDS
    from repro_torch.core.faults import FaultInjector, FaultPolicy, \
        FaultSpec
    from repro_torch.core.mesh import segment_mesh
    from repro_torch.core.pipeline import fused_extrema, fused_masks, \
        stage_fused
    from repro_torch.core.scheduler import segment_batches
    from repro_torch.core.segtables import precondition
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import completion_gather as cg
    from repro_torch.kernels import segment_relations as sr
    from repro_torch.launch import autotune, roofline

    dev = torch.device("cuda")
    smi = nvidia_smi()
    t_start = time.perf_counter()
    # every engine takes tune="auto": its table is a fresh file of this run,
    # written only by phase 8e, so no stray table in the working directory
    # changes a launch or a counter of the other phases
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    atexit.register(shutil.rmtree, tune_dir, True)
    tune_path = os.path.join(tune_dir, "TUNE_torch_kernel_params.json")
    os.environ["REPRO_TORCH_TUNE_TABLE"] = tune_path

    # every call of the numpy host arm, the engine's degraded production:
    # no phase before 8d runs a fault schedule, so none may reach it
    host_arm = ops.relation_block_host
    host_calls = [0]

    def counted_host_arm(*args, **kw):
        host_calls[0] += 1
        return host_arm(*args, **kw)

    ops.relation_block_host = counted_host_arm

    # phase 2's meshes are built by a host process of their own from here
    # on, beside the build and the LM phases (``build_meshes``)
    mesh_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    atexit.register(shutil.rmtree, mesh_dir, True)
    mesh_file = os.path.join(mesh_dir, "meshes.pkl")
    mesh_proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--meshes",
         mesh_file], cwd=ROOT, env=dict(os.environ,
                                        PYTHONPATH=str(ROOT / "src")))
    atexit.register(mesh_proc.kill)

    # -- 1. device and build -------------------------------------------------
    mark("1")
    t0 = time.perf_counter()
    libs = _build.build(["segment_relations", "completion_gather", "counts",
                         "flash_attention", "flash_attention_wgmma",
                         "flash_attention_mma"])
    t_build = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in
                 (p.parent / "build.log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, p in libs.items()}
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(t_build, 3), "ptxas": ptxas,
          "smem_optin_bytes": sr.smem_limit(dev)})

    # the redesigned kernels' registers, shared memory and spills, by
    # entry function (both template variants of the TT kernel)
    def ptxas_of(lib, kernel):
        out, fn = {}, None
        for ln in (libs[lib].parent / "build.log").read_text().splitlines():
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1]
            elif fn and kernel in fn and ("registers" in ln or "spill" in ln):
                out.setdefault(fn, []).append(ln.strip())
        return out

    emit({"phase": "ptxas",
          **{arm: ptxas_of("segment_relations", k["name"])
             for arm, k in KERNELS.items() if k["source"] == SR_SOURCE},
          "gather": ptxas_of("completion_gather", "resolve_gather_kernel"),
          "flash_mma": ptxas_of("flash_attention_mma", "flash_fwd_mma")})

    # -- 9-13. the LM phases, while the host process builds the meshes -----
    max_err = {k: 0 for k in KERNELS}
    timing, launches = {}, {}
    prefetch_trees(dict.fromkeys(LM_PIN_ARCH[n] for n in LM_NEW_PINS))
    lm_phases(torch, dev, max_err, timing, launches)
    lm_family_phases(torch, dev, launches)
    lm_family_phases(torch, dev, launches, "11c", LM_NEW_PINS, NEW_FLASH,
                     profile=False)
    train_peak = lm_train_phases(torch, dev, max_err, launches)
    lm_mesh_phases(torch, dev, max_err, launches, train_peak)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 2. the 96^3 mesh, preconditioned once for both paths ---------------
    mark("2")
    t0 = time.perf_counter()
    try:
        rc = mesh_proc.wait(timeout=MESH_WAIT_S)
    except subprocess.TimeoutExpired:
        raise Failed(f"the mesh process ran past {MESH_WAIT_S} s") from None
    check(rc == 0, f"the mesh process exited with {rc}")
    t1 = time.perf_counter()
    with open(mesh_file + ".json") as f:
        built_times = json.load(f)
    with open(mesh_file, "rb") as f:
        built = pickle.load(f)
    os.remove(mesh_file)
    mesh, sm, pre = built["mesh"], built["sm"], built["pre"]
    t2 = time.perf_counter()
    tabs = pre.tables
    chi = sm.n_vertices - pre.n_edges + pre.n_faces - sm.n_tets
    rank = total_order(sm.scalars)
    emit({"phase": "mesh", "vertices": mesh.n_vertices,
          "edges": pre.n_edges, "faces": pre.n_faces, "tets": mesh.n_tets,
          "chi": chi, "segments": sm.n_segments, "NV": tabs.NV,
          "NE": tabs.NE, "NF": tabs.NF, "NT": tabs.NT, **built_times,
          "waited_s": round(t1 - t0, 3), "load_s": round(t2 - t1, 3)})

    # -- 3. each relation-entry kernel arm against its plain version --------
    mark("3")
    rng = np.random.default_rng(0)
    cu = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    arm_of = roofline.ENTRY_ARM

    def plain(relation, tx, ty, colg, nvl, deg):
        return ops.relation_block(relation, tx, ty, colg, nvl, deg=deg,
                                  backend="torch")

    def routed(arm, before):
        """The KERNELS key of the kernel that ran since ``before``: the
        route whose counter moved for VV, member and sub, else the arm."""
        if arm not in ROUTED_ARMS:
            return arm
        moved = [f"{arm}_{r}" for r in ("bits", "sort")
                 if sr.LAUNCHES[f"{arm}_{r}"] != before[f"{arm}_{r}"]]
        check(len(moved) == 1, f"{arm}: route counters moved {moved}")
        return moved[0]

    def compare(case, relation, tx, ty, colg, nvl, deg, route=None,
                want_route=None):
        """The wrapper (its own route, or ``route`` forced) against the
        plain arm, bit for bit; a bitmask block launched twice, equal."""
        arm = arm_of[relation]
        before = dict(sr.LAUNCHES)
        kw = {"route": route} if route else {}
        got = sr.relation_entries_cuda(relation, tx, ty, colg, nvl=nvl,
                                       deg=deg, **kw)
        key = routed(arm, before)
        want = plain(relation, tx, ty, colg, nvl, deg)
        again = got
        if key.endswith("_bits"):
            again = sr.relation_entries_cuda(relation, tx, ty, colg,
                                             nvl=nvl, deg=deg, **kw)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        max_err[key] = max(max_err[key], err)
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        twice = all(torch.equal(g, a) for g, a in zip(got, again))
        emit({"phase": "kernel_case", "case": case, "relation": relation,
              "kernel": KERNELS[key]["name"],
              "shape": [list(tx.shape), list(ty.shape)], "nvl": nvl,
              "deg": deg, "equal": ok, "equal_twice": twice,
              "max_L": int(want[1].max()) if want[1].numel() else 0})
        check(ok, f"{relation} kernel disagrees with the plain arm ({case})")
        check(twice, f"{relation}: two launches of {KERNELS[key]['name']} "
                     f"gave two blocks ({case})")
        check(want_route is None or key == f"{arm}_{want_route}",
              f"{relation} ({case}) ran {key}, not the {want_route} route")
        return want

    def rand_simplices(B, n, arity, nvl, fill=0.8):
        """(B, n, arity) rows of distinct random local vertices < nvl, the
        last rows -1 padding."""
        tab = np.full((B, n, arity), -1, dtype=np.int32)
        k = max(1, int(n * fill))
        for b in range(B):
            tab[b, :k] = np.argsort(rng.random((k, nvl)), axis=1)[:, :arity]
        return tab

    def rand_tets(B, NT, nvl, fill=0.7, valid_all=False):
        return rand_simplices(B, NT, 4, nvl, 1.0 if valid_all else fill)

    def next_prime(n):
        while n < 2 or any(n % d == 0 for d in range(2, int(n ** 0.5) + 1)):
            n += 1
        return n

    def sub_tables(tets, pad):
        """Edge and face tables of each segment's tets (every sub-simplex
        once, vertex and row order shuffled), padded with -1 rows to a
        prime count at least ``pad`` past the longest."""
        B = tets.shape[0]
        out = {"T": tets}
        for k, combos in (("E", list(itertools.combinations(range(4), 2))),
                          ("F", list(itertools.combinations(range(4), 3)))):
            per = []
            for b in range(B):
                t = np.sort(tets[b][(tets[b] >= 0).all(-1)], axis=1)
                rows = np.unique(t[:, combos].reshape(-1, _ARITY[k]), axis=0)
                rows = rng.permuted(rows[rng.permutation(len(rows))], axis=1)
                per.append(rows)
            n = next_prime(max(len(r) for r in per) + pad)
            tab = np.full((B, n, _ARITY[k]), -1, dtype=np.int32)
            for b, rows in enumerate(per):
                tab[b, :len(rows)] = rows
            out[k] = tab
        return out

    def colg_for(tab):
        c = rng.integers(0, 10 ** 6, tab.shape[:2]).astype(np.int32)
        c[(tab < 0).all(-1)] = -1
        return c

    nvl = tabs.NV
    T = cu(tabs.T_local[:BATCH])
    V = cu(tabs.table("V")[0][:BATCH])
    main_inputs = {
        "VV": (T, T, cu(tabs.LV_global[:BATCH])),
        "VE": (V, cu(tabs.E_local[:BATCH]), cu(tabs.LE_global[:BATCH])),
        "VF": (V, cu(tabs.F_local[:BATCH]), cu(tabs.LF_global[:BATCH])),
        "VT": (V, T, cu(tabs.LT_global[:BATCH])),
        "TT": (T, T, cu(tabs.LT_global[:BATCH])),
        "FT": (cu(tabs.F_local[:BATCH]), T, cu(tabs.LT_global[:BATCH])),
        "EF": (cu(tabs.E_local[:BATCH]), cu(tabs.F_local[:BATCH]),
               cu(tabs.LF_global[:BATCH])),
        "ET": (cu(tabs.E_local[:BATCH]), T, cu(tabs.LT_global[:BATCH])),
    }
    for relation, (tx, ty, colg) in main_inputs.items():
        deg = ops.DEFAULT_DEG[relation]
        routes = ("bits", "sort") if arm_of[relation] in ROUTED_ARMS \
            else (None,)
        narrow = {"VV": 4, "VE": 4, "VF": 4, "VT": 4, "TT": 2, "FT": 1,
                  "EF": 2, "ET": 2}
        for route in routes:
            what = f", {route} route" if route else ""
            compare("main" + what, relation, tx, ty, colg, nvl, deg,
                    route=route)
            compare("B=1" + what, relation, tx[:1].contiguous(),
                    ty[:1].contiguous(), colg[:1].contiguous(), nvl, deg,
                    route=route)
            want = compare("L>deg" + what, relation, tx, ty, colg, nvl,
                           narrow[relation], route=route)
            check(int(want[1].max()) > narrow[relation],
                  f"the {relation} L > deg case has no such row")
        if len(routes) == 2:
            compare("main, the wrapper's own route", relation, tx, ty, colg,
                    nvl, deg, want_route="bits")
    for n in (1, 7, 127):
        nv_ = max(8, n)
        tt = rand_tets(2, n, nv_)
        ct = cu(rng.integers(0, 10 ** 6, (2, n)).astype(np.int32))
        compare(f"prime {n}", "TT", cu(tt), cu(tt), ct, nv_, 8)
        st = sub_tables(rand_tets(2, n, 11), pad=3)
        for relation in ("FT", "EF", "ET"):
            tx, ty = st[relation[0]], st[relation[1]]
            for route in ("bits", "sort"):
                compare(f"prime {n}, {route} route", relation, cu(tx),
                        cu(ty), cu(colg_for(ty)), 11, 8, route=route)
    # the sub-join on -1 slots inside rows, nvl and row counts off a word's
    # edge, and a width below the true counts, on both routes
    st = sub_tables(rand_tets(3, 97, 33), pad=2)
    for relation in ("FT", "EF", "ET"):
        tx, ty = (np.where(rng.random(t.shape) < 0.08, -1, t)
                  .astype(np.int32) for t in (st[relation[0]],
                                              st[relation[1]]))
        for route in ("bits", "sort"):
            for deg in (8, 1):
                compare(f"-1 slots, deg {deg}, {route} route", relation,
                        cu(tx), cu(ty), cu(colg_for(ty)), 33, deg,
                        route=route)
    # VV and VE/VF/VT: nvl on both sides of a word's edge, tables of a
    # prime number of rows
    for n, nv_ in ((1, 8), (7, 8), (7, 31), (37, 33), (127, 127)):
        tt = rand_tets(2, n, nv_)
        st = sub_tables(tt, pad=3)
        cv = cu(rng.integers(0, 10 ** 6, (2, nv_)).astype(np.int32))
        compare(f"prime {n}, nvl {nv_}", "VV", cu(tt), cu(tt), cv, nv_, 8,
                want_route="bits")
        for relation in ("VE", "VF", "VT"):
            ty = st[relation[1]]
            compare(f"prime {n}, nvl {nv_}", relation, cu(ty), cu(ty),
                    cu(colg_for(ty)), nv_, 8, want_route="bits")
    # fully valid lane vectors: every lane a real entry, none padding
    tt = rand_tets(3, 128, 64, valid_all=True)       # 4 * 128 member lanes
    for route in ("sort", "bits"):
        compare(f"fully valid lanes, {route} route", "VT", cu(tt), cu(tt),
                cu(np.arange(3 * 128, dtype=np.int32).reshape(3, 128)), 64,
                64, route=route)
    compare("fully valid tets", "VV", cu(tt), cu(tt),
            cu(np.arange(3 * 64, dtype=np.int32).reshape(3, 64)), 64, 64,
            want_route="bits")
    compare("fully valid lanes", "TT", cu(tt), cu(tt),   # EJ = 4 * 128
            cu(np.arange(3 * 128, dtype=np.int32).reshape(3, 128)), 64, 64)
    fx = rng.integers(0, 40, (3, 64, 3)).astype(np.int32)   # 64 + 4 * 16
    ft = np.stack([np.stack([rng.choice(40, 4, replace=False)
                             for _ in range(16)]) for _ in range(3)]) \
        .astype(np.int32)
    compare("fully valid lanes", "FT", cu(fx), cu(ft), cu(colg_for(ft)),
            40, 16, route="sort")
    # tables whose lanes passed the opt-in limit in the block-a-segment
    # sort design (VV 1408 tets: 256 KB of lanes), on both routes
    big = 1408
    tt = rand_tets(2, big, 256)
    cv = cu(rng.integers(0, 10 ** 6, (2, 256)).astype(np.int32))
    for route in ("sort", "bits"):
        compare(f"1408 tets, {route} route", "VV", cu(tt), cu(tt), cv, 256,
                256, route=route)
    tv = rand_tets(2, 2 ** 14 // 4 + 64, 256)
    cv = cu(rng.integers(0, 10 ** 6, (2, tv.shape[1])).astype(np.int32))
    for route in ("sort", "bits"):
        compare(f"4160 tets, {route} route", "VT", cu(tv), cu(tv), cv, 256,
                128, route=route)
    # the VV and member sort route past the arms' precondition: -1 slots,
    # a vertex twice in a row, vertex 5 in most rows (a row of 900-3000
    # entries, VV three times as many with duplicates: sorted in the
    # workspace, past the 128 a warp sorts in registers), rows past deg,
    # empty rows (ids below 300 of nvl 400), member ids past nvl; VE at
    # nvl 60,000, whose row counts pass the shared-memory histogram
    for relation, n, nv_, deg in (("VV", 1000, 400, 16),
                                  ("VF", 4000, 400, 8),
                                  ("VE", 3000, 60000, 8)):
        a = 4 if relation == "VV" else _ARITY[relation[1]]
        tab = rand_simplices(2, n, a, 300, fill=0.99)
        for b in range(2):
            rows = np.flatnonzero(~(tab[b] == 5).any(-1) & (tab[b, :, 0]
                                                              >= 0))
            tab[b, rows[:int(0.9 * len(rows))], 0] = 5
        tab[rng.random(tab.shape) < 0.05] = -1
        tab[:, 3, :2] = 7
        if relation != "VV":
            tab[:, 10, 0] = nv_ + 3
        cv = rng.integers(0, 10 ** 6, (2, nv_ if relation == "VV" else n))
        want = compare(f"past the precondition, nvl {nv_}", relation,
                       cu(tab), cu(tab), cu(cv.astype(np.int32)), nv_, deg,
                       route="sort")
        check(int(want[1].max()) > deg and bool((want[1] == 0).any()),
              f"the {relation} sort-route case has no row past deg or no "
              f"empty row")
    # each side of the old whole-mask limit (on an H100's 227 KB: nvl 1344
    # and NY 6816 fit whole, 1376 and 6848 now take row shares) and a
    # member table past the one-row limit (NY 110,000: the sort kernel)
    limit = sr.smem_limit(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sides = []
    for relation, nv_, n in (("VV", 1344, 2000), ("VV", 1376, 2000),
                             ("VT", 256, 6816), ("VT", 256, 6848),
                             ("VT", 8, 110000)):
        side = sr.entry_route(relation, nv_, n, limit)
        fit = sr.bits_rows_fit(relation, nv_, n, limit)
        sides.append((side, sr.bits_blocks(relation, 2, nv_, n, n, limit,
                                           sms) or None))
        tt = rand_tets(2, n, nv_)
        cv = rng.integers(0, 10 ** 6, (2, nv_ if relation == "VV" else n))
        compare(f"{side} side of the route limit", relation, cu(tt), cu(tt),
                cu(cv.astype(np.int32)), nv_, 32, want_route=side)
    check([r for r, _ in sides] == ["bits"] * 4 + ["sort"],
          f"the route-limit cases fell on {sides} at {limit} bytes")
    emit({"phase": "route_limits", "limit": limit, "sides": sides})
    # TT: four real segments' tets as one (NT = 3584, EJ = 16384,
    # E = 32768), so faces are shared as in the mesh. Each segment's local
    # vertices are shifted to a range of their own: a face keeps at most
    # two cofacet tets, the kernels' precondition (with more, the order of
    # equal face keys would decide the entries)
    tt = tabs.T_local[:8].copy()
    for s in range(8):
        tt[s][tt[s] >= 0] += (s % 4) * nvl
    tt = tt.reshape(2, 4 * tabs.NT, 4)
    check(4 * sr.tt_lane_ints(tt.shape[1], 8) > sr.smem_limit(dev),
          "the TT workspace case fits shared memory")
    want = compare("device-workspace lanes", "TT", cu(tt), cu(tt),
                   cu(colg_for(tt)), 4 * nvl, 8)
    check(int(want[1].max()) >= 4, "the TT workspace case shares no faces")
    # TT past its precondition: faces of three and four cofacet tets. The
    # blocks then depend on the order of a face's cofacets, which the
    # kernel fixes by face lane: two runs give equal blocks
    tt = rand_tets(2, 131, 40)
    tt[:, 0] = [0, 1, 2, 3]
    tt[:, 1:3, :3] = [0, 1, 2]
    tt[:, 1:3, 3] = [[4], [5]]
    tt[1, 3] = [2, 1, 0, 7]
    ct = cu(colg_for(tt))
    first = sr.relation_entries_cuda("TT", cu(tt), cu(tt), ct, nvl=40, deg=8)
    again = sr.relation_entries_cuda("TT", cu(tt), cu(tt), ct, nvl=40, deg=8)
    torch.cuda.synchronize()
    ok = all(torch.equal(a, b) for a, b in zip(first, again))
    emit({"phase": "kernel_case", "case": "faces of 3 and 4 cofacets, twice",
          "relation": "TT", "shape": [list(tt.shape)], "deterministic": ok,
          "max_L": int(first[1].max())})
    check(ok, "the TT kernel gives two blocks for one table past its "
              "precondition")
    st = sub_tables(rand_tets(2, 2600, 200), pad=5)  # FT: E = 32768
    check(4 * sr.lane_ints(sr.next_pow2(st["F"].shape[1]
                                        + 4 * st["T"].shape[1]),
                           st["F"].shape[1]) > sr.smem_limit(dev),
          "the FT workspace case fits shared memory")
    compare("device-workspace lanes", "FT", cu(st["F"]), cu(st["T"]),
            cu(colg_for(st["T"])), 200, 4, route="sort")
    # each side of the sub-join's old one-row limit (NX 8192, where the
    # lookup of the whole segment's keys filled 128 KB): both now take the
    # bitmask kernel, whose lookup holds only a block's rows; its one-row
    # limit is NY (on an H100's 227 KB: 1,859,232 cofaces)
    ft = rand_tets(2, 1800, 200)
    fx = sub_tables(ft, pad=0)["F"]
    for nx in (8192, 8193):
        check(fx.shape[1] <= nx, "the FT limit case has too many faces")
        tx = np.full((2, nx, 3), -1, dtype=np.int32)
        tx[:, :fx.shape[1]] = fx
        compare(f"NX {nx}, each side of the old sub-join limit", "FT",
                cu(tx), cu(ft), cu(colg_for(ft)), 200, 4, want_route="bits")
    sides = [sr.entry_route("FT", 200, ny, limit)
             for ny in (1859232, 1859233)]
    emit({"phase": "route_limits", "relation": "FT", "limit": limit,
          "NY": [1859232, 1859233], "sides": sides})
    check(limit != 232448 or sides == ["bits", "sort"],
          f"the sub-join's one-row limit fell on {sides} at {limit} bytes")
    # the sub-join past its precondition: one face listed three times. The
    # bitmask kernel gives every entry of the key to the largest of the
    # three rows (its tie rule): two runs give equal blocks
    st = sub_tables(rand_tets(2, 300, 64), pad=3)
    tx = st["F"].copy()
    tx[:, 40] = tx[:, 3][:, ::-1]
    tx[:, 90] = tx[:, 3]
    ct = cu(colg_for(st["T"]))
    first = sr.relation_entries_cuda("FT", cu(tx), cu(st["T"]), ct, nvl=64,
                                     deg=4, route="bits")
    again = sr.relation_entries_cuda("FT", cu(tx), cu(st["T"]), ct, nvl=64,
                                     deg=4, route="bits")
    torch.cuda.synchronize()
    ok = all(torch.equal(a, b) for a, b in zip(first, again))
    tie = bool((first[1][:, 90] > 0).all() and
               (first[1][:, [3, 40]] == 0).all())
    emit({"phase": "kernel_case", "case": "a repeated face key, twice",
          "relation": "FT", "kernel": KERNELS["sub_bits"]["name"],
          "shape": [list(tx.shape)], "deterministic": ok,
          "largest_row_holds_the_key": tie})
    check(ok and tie, "the sub-join bitmask kernel gives two blocks, or "
                      "breaks its tie rule, past its precondition")

    def time_arm(key, relation, tx, ty, colg, deg, work, nv=nvl,
                 route=None, reps=20):
        """The kernel's graph-replay and eager times beside the plain arm's
        and the bound; ``reps`` launches a round (fewer for the sort
        kernels at capacity 1024, each 4-34 ms)."""
        kw = {"route": route} if route else {}
        launch = (lambda: sr.relation_entries_cuda(
            relation, tx, ty, colg, nvl=nv, deg=deg, **kw))
        before = dict(sr.LAUNCHES)
        launch()
        ran = routed(arm_of[relation], before)
        check(ran == key, f"{relation} timed on {ran}, not {key}")
        k_ms = graph_ms(torch, launch, reps=reps)
        e_ms = time_ms(torch, launch, reps=reps)
        p_ms = time_ms(torch, lambda: plain(relation, tx, ty, colg, nv,
                                            deg), reps=reps)
        b_ms, b_by = work.bound_ms()
        row = {"ms": k_ms, "eager_ms": e_ms, "plain_ms": p_ms,
               "bound_ms": b_ms, "bound_by": b_by}
        emit({"phase": "kernel_time", "arm": key, "relation": relation,
              "kernel": KERNELS[key]["name"],
              "shape": [list(tx.shape), list(ty.shape)], "nvl": nv,
              "deg": deg, **row, "bytes": int(work.nbytes),
              "ops": work.ops,
              **({"shares": shares_of(relation, tx, ty, nv)}
                 if key.endswith("_bits") else {})})
        return row

    def shares_of(relation, tx, ty, nv, k=None):
        """Blocks a segment of the wrapper's bitmask launch, at ``k``
        shares where given, else by the share rule."""
        return sr.bits_blocks(relation, tx.shape[0], nv, tx.shape[1],
                              ty.shape[1], limit, sms, k)

    def valid_rows(t):
        return (t >= 0).all(-1).sum(-1)               # per segment

    def entry_work(relation, tx, ty, colg, nv, deg):
        """The arm's work on these tables (``roofline.entry_work``), with
        the entries this run's data sorts: the valid entries, and for TT
        and the sub-join the emitted ones (the row bound counts the same
        work whatever implements it)."""
        arm = arm_of[relation]
        if relation == "VV":
            va = (tx >= 0).sum(-1)
            first = (va * (va - 1)).sum(-1)           # ordered pairs
        elif arm == "member":
            first = (ty >= 0).sum((1, 2))
        elif relation == "TT":
            first = 4 * valid_rows(tx)                # face keys
        else:
            n_sub = math.comb(ty.shape[2], tx.shape[2])
            first = valid_rows(tx) + n_sub * valid_rows(ty)
        emitted = None
        if arm in ("TT", "sub"):
            emitted = plain(relation, tx, ty, colg, nv, deg)[1].sum(-1) \
                .tolist()
        return roofline.entry_work(relation, tx.shape[0], nv, tx.shape[1],
                                   ty.shape[1], deg, first.tolist(),
                                   emitted)

    def shares_case(case, relation, tx, ty, colg, nv, deg, k, want):
        """The bitmask kernel at ``k`` shares a segment (or more, where
        shared memory asks for more) against the plain arm's ``want``, bit
        for bit; returns the launch and the blocks a segment it ran."""
        key = f"{arm_of[relation]}_bits"
        launch = (lambda: sr.relation_entries_cuda(
            relation, tx, ty, colg, nvl=nv, deg=deg, route="bits",
            shares=k))
        before = sr.LAUNCHES[key]
        got = launch()
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        max_err[key] = max(max_err[key], err)
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        blocks = shares_of(relation, tx, ty, nv, k)
        emit({"phase": "kernel_case", "case": case, "relation": relation,
              "kernel": KERNELS[key]["name"],
              "shape": [list(tx.shape), list(ty.shape)], "nvl": nv,
              "deg": deg, "shares": k, "blocks": blocks, "equal": ok})
        check(sr.LAUNCHES[key] == before + 1,
              f"{relation} ({case}) did not take the bitmask route")
        check(ok, f"{relation} at {k} shares disagrees with the plain arm "
                  f"({case})")
        return launch, blocks

    for relation in ("VV", "VE", "VF", "VT", "TT", "FT", "EF", "ET"):
        tx, ty, colg = main_inputs[relation]
        deg = ops.DEFAULT_DEG[relation]
        arm = arm_of[relation]
        work = entry_work(relation, tx, ty, colg, nvl, deg)
        if arm in ROUTED_ARMS:
            # the sort kernels forced onto the same tables, for comparison
            for route in ("bits", "sort"):
                row = time_arm(f"{arm}_{route}", relation, tx, ty, colg,
                               deg, work, route=route)
                if relation in ("VV", "VT", "FT") and (
                        route == "bits" or arm == "sub"):
                    timing[f"{arm}_{route}"] = row
        else:
            row = time_arm(arm, relation, tx, ty, colg, deg, work)
            timing[arm] = row
    # the localized baselines' launch: one segment (B=1), bitmask route
    for relation in ("VV", "VT"):
        tx, ty, colg = (t[:1].contiguous() for t in main_inputs[relation])
        deg = ops.DEFAULT_DEG[relation]
        time_arm(f"{arm_of[relation]}_bits", relation, tx, ty, colg, deg,
                 entry_work(relation, tx, ty, colg, nvl, deg), route="bits")

    # -- 3b. the count kernels of the dense fallback ------------------------
    mark("3b")
    def counts_compare(case, kind, *args):
        if kind == "meet":
            got = sr.relation_counts_meet_cuda(*args)
            want = ops.counts_meet(*args, backend="torch")
        else:                            # (T, nvl[, rows of a tile])
            got = sr.relation_counts_vv_cuda(*args)
            want = ops.counts_vv(*args[:2], backend="torch")
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() \
            else 0
        max_err[kind] = max(max_err[kind], err)
        ok = torch.equal(got, want)
        emit({"phase": "kernel_case", "case": case, "relation": kind,
              "shape": [list(a.shape) for a in args
                        if isinstance(a, torch.Tensor)],
              "nvl": args[1] if kind == "vv_counts" else None, "equal": ok,
              "max_C": int(want.max()) if want.numel() else 0})
        check(ok, f"the {kind} count kernel disagrees with the plain arm "
                  f"({case})")
        return want

    Fm = cu(tabs.F_local[:BATCH])
    Em = cu(tabs.E_local[:BATCH])
    Vm = cu(tabs.table("V")[0][:BATCH])
    meet_inputs = {"FF": (Fm, Fm), "EE": (Em, Em), "VF": (Vm, Fm)}
    for relation, (tx, ty) in meet_inputs.items():
        C = counts_compare(f"main {relation}", "meet", tx, ty)
        check(int(C.max()) == min(tx.shape[2], ty.shape[2]),
              f"no {relation} pair shares all of a row's vertices")
        counts_compare(f"B=1 {relation}", "meet", tx[:1].contiguous(),
                       ty[:1].contiguous())
    counts_compare("main", "vv_counts", T, nvl)
    counts_compare("B=1", "vv_counts", T[:1].contiguous(), nvl)
    for n in (1, 7, 127, 1931):
        m = next_prime(n + 1)
        counts_compare(f"prime {n}x{m}", "meet",
                       cu(rand_simplices(3, n, 3, 256)),
                       cu(rand_simplices(3, m, 4, 256)))
        counts_compare(f"prime {n}x{m}", "meet",
                       cu(rand_simplices(3, n, 2, 256)),
                       cu(rand_simplices(3, m, 2, 256)))
        counts_compare(f"prime NT={n}", "vv_counts",
                       cu(rand_tets(3, n, 256)), 256)
    empty = cu(np.full((2, 131, 3), -1, np.int32))
    C = counts_compare("all rows -1", "meet", empty, empty)
    check(int(C.abs().sum()) == 0, "-1 rows met")
    C = counts_compare("all rows -1", "vv_counts",
                       cu(np.full((2, 131, 4), -1, np.int32)), 64)
    check(int(C.abs().sum()) == 0, "-1 tets counted")
    t257 = rand_tets(2, 1931, 257)
    check(int(t257.max()) == 256, "no vertex id 256")
    counts_compare("nvl=257", "vv_counts", cu(t257), 257)
    counts_compare("ids past nvl", "vv_counts", cu(t257), 200)
    big = 2 ** 11
    counts_compare("oversize nvl=2**11", "meet",
                   cu(rand_simplices(2, 1931, 3, big)),
                   cu(rand_simplices(2, 1283, 4, big)))

    # times on the real 96^3 tables at B=64, beside the plain version and
    # one torch.bmm of prebuilt one-hot incidences (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False

    def onehot(tab, width):
        iota = torch.arange(width, device=dev, dtype=torch.int32)
        return (tab[:, :, None, :] == iota[None, None, :, None]).any(-1) \
            .to(torch.float32)                        # (B, N, width)

    Ax = onehot(Fm, nvl)
    At = onehot(T, nvl).transpose(1, 2).contiguous()  # (B, nvl, NT)
    C = ops.counts_meet(Fm, Fm)
    launch = (lambda: sr.relation_counts_meet_cuda(Fm, Fm))
    k_ms, e_ms = graph_ms(torch, launch), time_ms(torch, launch)
    p_ms = time_ms(torch, lambda: ops.counts_meet(Fm, Fm, backend="torch"),
                   reps=5)
    lib_ms = time_ms(torch, lambda: torch.bmm(Ax, Ax.transpose(1, 2)))
    epi_ms = time_ms(torch, lambda: ops._compact(ops._predicate(
        C, 2, True, False), cu(tabs.LF_global[:BATCH]), 48), reps=5)
    # the slot compares the outputs need: ax * ay per output
    b_ms, b_by = roofline.meet_work(BATCH, Fm.shape[1], 3, Fm.shape[1],
                                    3).bound_ms()
    timing["meet"] = {"ms": k_ms, "eager_ms": e_ms, "plain_ms": p_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib_ms}
    emit({"phase": "kernel_time", "arm": "meet", "relation": "FF",
          "shape": [list(Fm.shape), list(Fm.shape)], **timing["meet"],
          "epilogue_ms": epi_ms,
          "C_bytes": nbytes(C)})
    C = ops.counts_vv(T, nvl)
    launch = (lambda: sr.relation_counts_vv_cuda(T, nvl))
    k_ms, e_ms = graph_ms(torch, launch), time_ms(torch, launch)
    p_ms = time_ms(torch, lambda: ops.counts_vv(T, nvl, backend="torch"),
                   reps=5)
    lib_ms = time_ms(torch, lambda: torch.bmm(At, At.transpose(1, 2)))
    # one add per ordered slot pair of each valid tet
    b_ms, b_by = roofline.vv_counts_work(
        *T.shape[:2], nvl, int((T >= 0).all(-1).sum())).bound_ms()
    timing["vv_counts"] = {"ms": k_ms, "eager_ms": e_ms, "plain_ms": p_ms,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "library_ms": lib_ms}
    emit({"phase": "kernel_time", "arm": "vv_counts", "relation": "VV",
          "shape": [list(T.shape)], "nvl": nvl, **timing["vv_counts"],
          "C_bytes": nbytes(C)})
    # the fused loop's batch (FUSED_BATCH segments of the 96^3 tets), and
    # one whose last segments are -1 padding, as the loop's last batch is
    # when the segment count is no multiple of it
    T8 = T[:FUSED_BATCH].contiguous()
    counts_compare("fused batch", "vv_counts", T8, nvl)
    for rows in sr.VV_COUNT_ROWS:
        counts_compare(f"fused batch, {rows}-row tiles", "vv_counts", T8,
                       nvl, rows)
        counts_compare(f"main, {rows}-row tiles", "vv_counts", T, nvl, rows)
    Tpad = T8.clone()
    Tpad[FUSED_BATCH - 3:] = -1
    counts_compare("fused batch, padding segments", "vv_counts", Tpad, nvl)
    A8 = onehot(T8, nvl).transpose(1, 2).contiguous()
    C = ops.counts_vv(T8, nvl)
    launch = (lambda: sr.relation_counts_vv_cuda(T8, nvl))
    k_ms, e_ms = graph_ms(torch, launch), time_ms(torch, launch)
    p_ms = time_ms(torch, lambda: ops.counts_vv(T8, nvl, backend="torch"),
                   reps=5)
    lib_ms = time_ms(torch, lambda: torch.bmm(A8, A8.transpose(1, 2)))
    b_ms, b_by = roofline.vv_counts_work(
        *T8.shape[:2], nvl, int((T8 >= 0).all(-1).sum())).bound_ms()
    # the wrapper's tile (vv_count_rows) beside each forced one
    tile_ms = {rows: graph_ms(torch, lambda rows=rows:
                              sr.relation_counts_vv_cuda(T8, nvl, rows))
               for rows in sr.VV_COUNT_ROWS}
    emit({"phase": "kernel_time", "arm": "vv_counts", "relation": "VV",
          "case": "fused batch", "shape": [list(T8.shape)], "nvl": nvl,
          "ms": k_ms, "eager_ms": e_ms, "plain_ms": p_ms, "bound_ms": b_ms,
          "bound_by": b_by, "library_ms": lib_ms, "C_bytes": nbytes(C),
          "rows": sr.vv_count_rows(FUSED_BATCH, nvl, sms),
          "tile_ms": tile_ms})
    del Ax, At, A8, C, T8, Tpad

    # -- 4. the critical-points path -----------------------------------------
    mark("4")
    # warm the arms up on a small mesh first (module loading, allocator
    # pools), so that the walls below compare like with like
    wsm = segment_mesh(quickstart_mesh(16), capacity=64)
    wpre = precondition(wsm, relations=RELS)
    wrank = total_order(wsm.scalars)
    for backend in ("cuda", "torch"):
        for assembly in ("sparse", "dense"):
            critical_points(RelationEngine(wpre, ["VV", "VT"], device="cuda",
                                           backend=backend,
                                           assembly=assembly),
                            wpre, wrank)
        weng = RelationEngine(wpre, PATH_RELS, device="cuda", backend=backend)
        wg = discrete_gradient(weng, wpre, wrank, batch_segments=16,
                               co_prefetch=("TT",), audit=True)
        wms = morse_smale(weng, wpre, wg)
        simplify_ms(wms, persistence_pairs(weng, wpre, wrank, grad=wg),
                    THRESHOLD)
    for backend in ("cuda", "torch"):
        if backend == "cuda":
            for k in sr.LAUNCHES:
                sr.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = RelationEngine(pre, ["VV", "VT"], lookahead=8, device="cuda",
                             backend=backend)
        types, counts = critical_points(eng, pre, rank)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if backend == "cuda":
            cp_launches = {k: sr.LAUNCHES[k] for k in ROUTED}
            cp_types = types
        s = eng.stats
        digest_t = hashlib.sha256(types.astype(np.int32).tobytes()).hexdigest()
        emit({"phase": "critical_points_path", "backend": backend, "n": N,
              "counts": counts, "kernel_launches": s.kernel_launches,
              "segments_produced": s.segments_produced,
              "cache_hits": s.cache_hits, "cache_misses": s.cache_misses,
              "devpool_hits": s.devpool_hits,
              "devpool_uploads": s.devpool_uploads,
              "wall_s": round(wall, 3), "t_sync_s": round(s.t_sync, 3),
              "t_kernel_s": round(s.t_kernel, 3),
              "types_sha256": digest_t,
              **({"kernel_counters": cp_launches}
                 if backend == "cuda" else {})})
        check(types.shape == (mesh.n_vertices,), "types has the wrong shape")
        check(counts == REF_COUNTS,
              f"{backend} counts {counts} != reference {REF_COUNTS}")
        check(digest_t == REF_TYPES_SHA256,
              f"{backend} types differ from the reference's")
        check(s.segments_produced == 2 * sm.n_segments,
              "a block was produced twice or not at all")
        check(backend == "cuda" or np.array_equal(types, cp_types),
              "cuda and plain torch arms give different types")
    check(cp_launches["VV_bits"] > 0 and cp_launches["member_bits"] > 0,
          f"a kernel was not launched on the critical-points path: "
          f"{cp_launches}")
    all_bits("the critical-points path", cp_launches)

    # the same path under assembly="dense": VV through the VV count kernel,
    # VT through the meet kernel, predicate and compaction in torch
    for k in sr.LAUNCHES:
        sr.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = RelationEngine(pre, ["VV", "VT"], lookahead=8, device="cuda",
                         assembly="dense")
    types, counts = critical_points(eng, pre, rank)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dense_launches = dict(sr.LAUNCHES)
    digest_t = hashlib.sha256(types.astype(np.int32).tobytes()).hexdigest()
    emit({"phase": "critical_points_path", "backend": "cuda",
          "assembly": "dense", "n": N, "counts": counts,
          "kernel_launches": eng.stats.kernel_launches,
          "segments_produced": eng.stats.segments_produced,
          "wall_s": round(wall, 3), "t_sync_s": round(eng.stats.t_sync, 3),
          "t_kernel_s": round(eng.stats.t_kernel, 3),
          "types_sha256": digest_t, "kernel_counters": dense_launches})
    check(digest_t == REF_TYPES_SHA256,
          "the dense-assembly types differ from the reference's")
    check(dense_launches["vv_counts"] > 0 and dense_launches["meet"] > 0,
          f"a count kernel was not launched on the dense critical-points "
          f"path: {dense_launches}")
    check(dense_launches["VV"] == dense_launches["member"] == 0,
          "the dense assembly launched a sparse entry kernel")

    # -- 4b. segments whose whole masks do not fit: the row-share path ----
    mark("4b")
    psm, ppre = built["psm"], built["ppre"]
    prank = total_order(psm.scalars)
    bsm, bpre, epre = built["bsm"], built["bpre"], built["epre"]
    gsm, gpre = built["gsm"], built["gpre"]
    del built
    brank = total_order(bsm.scalars)
    bt = bpre.tables
    # built beside the LM phases by the mesh process (phase 2)
    setup_s = built_times["big_capacity_s"]
    for relation in ("VV", "VT"):
        O = bt.NV if relation == "VV" else bt.NT
        check(sr.bits_smem_bytes(bt.NV, O) > limit
              and sr.entry_route(relation, bt.NV, bt.NT, limit) == "bits",
              f"the capacity-{BIG_CAPACITY} {relation} mask fits shared "
              f"memory whole, or not one row of it does")
    small_types = critical_points(RelationEngine(
        ppre, ["VV", "VT"], lookahead=8, device="cuda"), ppre, prank)[0]
    for backend in ("cuda", "torch"):
        if backend == "cuda":
            for k in sr.LAUNCHES:
                sr.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = RelationEngine(bpre, ["VV", "VT"], lookahead=8, device="cuda",
                             backend=backend)
        types, counts = critical_points(eng, bpre, brank)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if backend == "cuda":
            big_launches = {k: sr.LAUNCHES[k] for k in ROUTED}
        emit({"phase": "critical_points_path", "backend": backend,
              "n": SMALL_N, "capacity": BIG_CAPACITY,
              "segments": bsm.n_segments, "NV": bt.NV, "NT": bt.NT,
              "setup_s": round(setup_s, 3), "counts": counts,
              "kernel_launches": eng.stats.kernel_launches,
              "segments_produced": eng.stats.segments_produced,
              "wall_s": round(wall, 3),
              "t_sync_s": round(eng.stats.t_sync, 3),
              "t_kernel_s": round(eng.stats.t_kernel, 3),
              **({"kernel_counters": big_launches}
                 if backend == "cuda" else {})})
        check(np.array_equal(types, small_types),
              f"{backend}: the capacity-{BIG_CAPACITY} types differ from "
              f"the capacity-64 segmentation's")
    check(big_launches["VV_bits"] > 0 and big_launches["member_bits"] > 0,
          f"a bitmask kernel was not launched on the capacity-"
          f"{BIG_CAPACITY} path: {big_launches}")
    all_bits(f"the capacity-{BIG_CAPACITY} path", big_launches)
    # both routes held and timed at this path's shapes: the bitmask kernels
    # in row shares, the sort kernels forced (rows 1c and 2c of PERF.md;
    # the member sort kernel's kernels-line entry is phase 5b's path shape)
    bT, bV = cu(bt.T_local[:BATCH]), cu(bt.table("V")[0][:BATCH])
    for relation, tx, ty, colg in (
            ("VV", bT, bT, cu(bt.LV_global[:BATCH])),
            ("VT", bV, bT, cu(bt.LT_global[:BATCH]))):
        deg = ops.DEFAULT_DEG[relation]
        work = entry_work(relation, tx, ty, colg, bt.NV, deg)
        for route in ("bits", "sort"):
            key = f"{arm_of[relation]}_{route}"
            want = compare(f"capacity-{BIG_CAPACITY} tables, {route} route",
                           relation, tx, ty, colg, bt.NV, deg, route=route,
                           want_route=route)
            row = time_arm(key, relation, tx, ty, colg, deg, work,
                           nv=bt.NV, route=route,
                           reps=4 if route == "sort" else 20)
            if key == "VV_sort":
                timing[key] = row
        # share counts given: 1 gives way to the shared-memory floor
        # (ceil(R / fit): VV 3, VT 11 blocks), 8 splits finer where it can
        for k in (1, 8):
            _, blocks = shares_case(f"capacity-{BIG_CAPACITY} tables, "
                                    f"{k} shares", relation, tx, ty, colg,
                                    bt.NV, deg, k, want)
            check(blocks >= k, f"{relation}: {blocks} blocks for {k} "
                               f"shares")
    del bT, bV, bpre

    # the sub-join past NX 8192: EF and ET over every segment (NE 11,520,
    # NF 18,048, NT 8576), on the kernels and on the plain torch arm,
    # counters zeroed just before the kernels' run and read just after;
    # every launch on the bitmask route in row shares, none on the sort
    # kernel, every block equal between the arms
    t4s = time.perf_counter()
    et = epre.tables
    for relation, NY in (("EF", et.NF), ("ET", et.NT)):
        check(et.NE > 8192 and sr.entry_route(relation, et.NV, NY, limit)
              == "bits", f"the capacity-{BIG_CAPACITY} {relation} table is "
                         f"not past NX 8192 on the bitmask route")
    segs = list(range(bsm.n_segments))
    sub_blocks = {}
    for backend in ("cuda", "torch"):
        if backend == "cuda":
            for k in sr.LAUNCHES:
                sr.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = RelationEngine(epre, BIG_SUB_RELS, lookahead=8, device="cuda",
                             backend=backend)
        for relation in BIG_SUB_RELS:
            eng.request(relation, segs)
        sub_blocks[backend] = {(relation, s): eng.get_full(relation, s)
                               for relation in BIG_SUB_RELS for s in segs}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if backend == "cuda":
            big_sub_launches = {k: sr.LAUNCHES[k]
                                for k in ("sub", "sub_bits", "sub_sort")}
        emit({"phase": "subjoin_path", "backend": backend, "n": SMALL_N,
              "capacity": BIG_CAPACITY, "relations": BIG_SUB_RELS,
              "segments": bsm.n_segments, "NV": et.NV, "NE": et.NE,
              "NF": et.NF, "NT": et.NT,
              "kernel_launches": eng.stats.kernel_launches,
              "segments_produced": eng.stats.segments_produced,
              "max_L": max(int(L.max()) for _, L in
                           sub_blocks[backend].values()),
              "wall_s": round(wall, 3),
              **({"kernel_counters": big_sub_launches}
                 if backend == "cuda" else {})})
        check(eng.stats.segments_produced == len(BIG_SUB_RELS) * len(segs),
              f"{backend}: {eng.stats.segments_produced} EF/ET blocks "
              f"produced for {len(segs)} segments")
        del eng
    same = all(np.array_equal(a, b)
               for key, got in sub_blocks["cuda"].items()
               for a, b in zip(got, sub_blocks["torch"][key]))
    check(same, f"the capacity-{BIG_CAPACITY} EF/ET blocks differ between "
                f"the kernels and the plain arm")
    check(big_sub_launches["sub_bits"] == big_sub_launches["sub"] > 0
          and big_sub_launches["sub_sort"] == 0,
          f"the capacity-{BIG_CAPACITY} EF/ET production took the sort "
          f"kernel or no sub-join kernel: {big_sub_launches}")
    del sub_blocks
    # both routes held and timed at those shapes (B = 64): the bitmask
    # kernel in row shares, the sort kernel forced (device workspace)
    bE = cu(et.E_local[:BATCH])
    for relation, ty, colg in (
            ("EF", cu(et.F_local[:BATCH]), cu(et.LF_global[:BATCH])),
            ("ET", cu(et.T_local[:BATCH]), cu(et.LT_global[:BATCH]))):
        deg = ops.DEFAULT_DEG[relation]
        work = entry_work(relation, bE, ty, colg, et.NV, deg)
        for route in ("bits", "sort"):
            compare(f"capacity-{BIG_CAPACITY} tables, {route} route",
                    relation, bE, ty, colg, et.NV, deg, route=route,
                    want_route=route)
            time_arm(f"sub_{route}", relation, bE, ty, colg, deg, work,
                     nv=et.NV, route=route,
                     reps=4 if route == "sort" else 20)
        del ty, colg
    del bE, epre, bsm
    emit({"phase": "subjoin_wall", "wall_s": round(time.perf_counter() - t4s,
                                                   3)})

    # -- 5. the gradient -> Morse-Smale path ---------------------------------
    mark("5")
    def ms_path(p, r, backend, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = RelationEngine(p, MS_RELS, lookahead=8, dev_pool_segments=4096,
                             device="cuda", backend=backend)
        g = discrete_gradient(eng, p, r, batch_segments=16,
                              co_prefetch=("TT",))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ms = morse_smale(eng, p, g)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        s = eng.stats
        out = {"phase": "gradient_ms_path", "backend": backend, "n": n,
               "euler": g.euler(), "grad": g.counts(), "ms": ms.counts(),
               "grad_sha256": digest(g, GRAD_FIELDS),
               "ms_sha256": digest(ms, MS_FIELDS),
               "gradient_wall_s": round(t1 - t0, 3),
               "ms_wall_s": round(t2 - t1, 3),
               "kernel_launches": s.kernel_launches,
               "segments_produced": s.segments_produced,
               "requests": s.requests, "cache_hits": s.cache_hits,
               "cache_misses": s.cache_misses,
               "devpool_hits": s.devpool_hits,
               "devpool_uploads": s.devpool_uploads,
               "completion_queries": s.completion_queries,
               "completion_fanout_blocks": s.completion_fanout_blocks,
               "completion_raw_neighbors": s.completion_raw_neighbors,
               "completion_neighbors": s.completion_neighbors,
               "completion_dedup_ratio": round(s.completion_dedup_ratio, 6),
               "t_sync_s": round(s.t_sync, 3),
               "t_kernel_s": round(s.t_kernel, 3)}
        ref = REF_MS[n]
        check(g.euler() == 1, f"{backend}: Euler {g.euler()} != chi 1")
        check(out["grad"] == ref["grad"] and out["ms"] == ref["ms"],
              f"{backend} counts {out['grad']} {out['ms']} != reference "
              f"{ref['grad']} {ref['ms']}")
        check(out["grad_sha256"] == ref["grad_sha256"],
              f"{backend} gradient field differs from the reference's")
        check(out["ms_sha256"] == ref["ms_sha256"],
              f"{backend} Morse-Smale complex differs from the reference's")
        return eng, g, ms, out

    # at 48^3: the audit + persistence path below drives the same gradient
    # and complex at 96^3, against the same pins
    check(chi == 1, f"the mesh's Euler characteristic is {chi}, not 1")
    for k in sr.LAUNCHES:
        sr.LAUNCHES[k] = 0
    cg.LAUNCHES["gather"] = 0
    eng, g, ms, out = ms_path(ppre, prank, "cuda", SMALL_N)
    ms_launches = {k: sr.LAUNCHES[k] for k in ROUTED + ("TT",)
                   if not k.startswith("VV")}
    ms_launches["gather"] = cg.LAUNCHES["gather"]
    emit({**out, "kernel_counters": ms_launches})
    check(all(ms_launches[k] > 0 for k in ("member_bits", "TT", "sub_bits",
                                           "gather")),
          f"a kernel was not launched on the gradient -> Morse-Smale path: "
          f"{ms_launches}")
    all_bits("the gradient -> Morse-Smale path", ms_launches)
    # the critical-points paths at 96^3 and at capacity 1024, then the
    # gradient -> Morse-Smale path
    launches.update({k: cp_launches[k] + big_launches[k] for k in
                     ("VV_bits", "VV_sort", "member_bits", "member_sort")})
    launches["member_bits"] += ms_launches["member_bits"]
    launches["member_sort"] += ms_launches["member_sort"]
    launches.update({
        k: ms_launches[k] for k in ("TT", "sub_bits", "sub_sort", "gather")})
    launches["sub_bits"] += big_sub_launches["sub_bits"]

    # the FT-gather route: the sub-join kernel over every segment
    t0 = time.perf_counter()
    sub_before = {k: sr.LAUNCHES[k] for k in ("sub", "sub_bits", "sub_sort")}
    ms_ft = morse_smale(eng, ppre, g, adjacency="ft")
    torch.cuda.synchronize()
    ft_launches = {k: sr.LAUNCHES[k] - v for k, v in sub_before.items()}
    emit({"phase": "ms_ft_route", "wall_s": round(time.perf_counter() - t0,
                                                  3),
          "kernel_counters": ft_launches,
          "ms_sha256": digest(ms_ft, MS_FIELDS)})
    check(digest(ms_ft, MS_FIELDS) == out["ms_sha256"],
          "morse_smale(adjacency='ft') differs from the TT route")
    check(ft_launches["sub_bits"] > 0, f"the FT route launched no sub-join "
                                       f"kernel: {ft_launches}")
    all_bits("the FT route", ft_launches)

    # the plain torch arm of the same path
    _, _, _, pout = ms_path(ppre, prank, "torch", SMALL_N)
    emit(pout)
    del eng, g

    # -- 5b. the gradient at capacity 8192: VF on the sort route -----------
    mark("5b")
    gt = gpre.tables
    grank = total_order(gsm.scalars)
    g_routes = {r: sr.entry_route(r, gt.NV, gt.table(r[1])[0].shape[1],
                                  limit) for r in GRAD_RELS}
    check(g_routes == {"VE": "bits", "VF": "sort", "VT": "bits"},
          f"the capacity-{GRAD_CAPACITY} tables route {g_routes}")
    # the wrapper's calls by relation, beside the route counters: VF's
    # calls must be the member sort launches, VE's and VT's the bitmask ones
    entries_cuda = sr.relation_entries_cuda
    calls = {r: 0 for r in GRAD_RELS}
    calls_lock = threading.Lock()

    def counted_entries(relation, *args, **kw):
        with calls_lock:
            calls[relation] += 1
        return entries_cuda(relation, *args, **kw)

    vf_blocks = {}
    for backend in ("cuda", "torch"):
        if backend == "cuda":
            for k in sr.LAUNCHES:
                sr.LAUNCHES[k] = 0
            sr.relation_entries_cuda = counted_entries
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            eng = RelationEngine(gpre, GRAD_RELS, lookahead=8, device="cuda",
                                 backend=backend)
            g = discrete_gradient(eng, gpre, grank, batch_segments=16)
            torch.cuda.synchronize()
        finally:
            sr.relation_entries_cuda = entries_cuda
        wall = time.perf_counter() - t0
        if backend == "cuda":
            grad_launches = {k: sr.LAUNCHES[k] for k in
                             ("member", "member_bits", "member_sort")}
        s = eng.stats
        gout = {"phase": "gradient_path", "backend": backend, "n": SMALL_N,
                "capacity": GRAD_CAPACITY, "segments": gsm.n_segments,
                "NV": gt.NV, "NE": gt.NE, "NF": gt.NF, "NT": gt.NT,
                "routes": g_routes, "euler": g.euler(), "grad": g.counts(),
                "grad_sha256": digest(g, GRAD_FIELDS),
                "wall_s": round(wall, 3),
                "setup_s": round(built_times["grad_capacity_s"], 3),
                "kernel_launches": s.kernel_launches,
                "segments_produced": s.segments_produced,
                "t_sync_s": round(s.t_sync, 3),
                "t_kernel_s": round(s.t_kernel, 3),
                **({"kernel_counters": grad_launches,
                    "wrapper_calls": dict(calls)}
                   if backend == "cuda" else {})}
        emit(gout)
        check(g.euler() == 1, f"{backend}: Euler {g.euler()} != chi 1")
        check(gout["grad"] == REF_GRAD_8192["grad"],
              f"{backend} counts {gout['grad']} != reference "
              f"{REF_GRAD_8192['grad']}")
        check(gout["grad_sha256"] == REF_GRAD_8192["grad_sha256"],
              f"{backend}: the capacity-{GRAD_CAPACITY} gradient differs "
              f"from the reference's")
        vf_blocks[backend] = [eng.get_full("VF", seg)
                              for seg in range(gsm.n_segments)]
        del eng, g
    check(grad_launches["member_sort"] > 0
          and grad_launches["member_sort"] == calls["VF"]
          and grad_launches["member_bits"] == calls["VE"] + calls["VT"] > 0
          and grad_launches["member"] == sum(calls.values()),
          f"the capacity-{GRAD_CAPACITY} gradient's VF did not take the "
          f"sort kernel, or VE/VT not the bitmask kernel: {grad_launches} "
          f"for {calls}")
    same = all(np.array_equal(a, b)
               for got, want in zip(vf_blocks["cuda"], vf_blocks["torch"])
               for a, b in zip(got, want))
    check(same, f"the capacity-{GRAD_CAPACITY} VF blocks differ between the "
                f"kernels and the plain arm")
    launches["member_sort"] += grad_launches["member_sort"]
    launches["member_bits"] += grad_launches["member_bits"]
    del vf_blocks
    # the sort kernel held and timed at the path's shape: all 14 segments'
    # VF tables in one launch (PERF.md row 2e)
    gV, gF, gcolg = (cu(a) for a in (gt.table("V")[0], gt.F_local,
                                     gt.LF_global))
    deg = ops.DEFAULT_DEG["VF"]
    compare(f"capacity-{GRAD_CAPACITY} VF tables", "VF", gV, gF, gcolg,
            gt.NV, deg, want_route="sort")
    timing["member_sort"] = time_arm(
        "member_sort", "VF", gV, gF, gcolg, deg,
        entry_work("VF", gV, gF, gcolg, gt.NV, deg), nv=gt.NV)
    del gV, gF, gcolg, gpre, gsm

    # -- 6. the audit + persistence path at 96^3 (its engine serves phase 7)
    mark("6")
    def audit_path(p, r, backend, n, shards=1, workers=1, policy=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = RelationEngine(p, PATH_RELS, lookahead=8,
                             dev_pool_segments=4096, device="cuda",
                             backend=backend, shards=shards,
                             fault_policy=policy)
        # raises ValueError unless every audit count is zero
        g = discrete_gradient(eng, p, r, batch_segments=16,
                              co_prefetch=("TT",), audit=True,
                              workers=workers)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ms = morse_smale(eng, p, g, workers=workers)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        d = persistence_pairs(eng, p, r, grad=g, workers=workers)
        simp, rep = simplify_ms(ms, d, THRESHOLD)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        s = eng.stats
        rep = {k: v for k, v in rep.items() if k != "threshold"}
        out = {"phase": "audit_persistence_path", "backend": backend,
               "n": n, "shards": shards, "workers": workers,
               "clean_audit": "zero (audit=True raised nothing)",
               "grad_sha256": digest(g, GRAD_FIELDS),
               "ms_sha256": digest(ms, MS_FIELDS),
               "persistence": d.counts(), "pd_digest": d.digest(),
               "simplified": simp.counts(), "cancelled": rep,
               "simplified_sha256": digest(simp, MS_FIELDS),
               "gradient_audit_wall_s": round(t1 - t0, 3),
               "ms_wall_s": round(t2 - t1, 3),
               "persistence_wall_s": round(t3 - t2, 3),
               "kernel_launches": s.kernel_launches,
               "segments_produced": s.segments_produced,
               "completion_queries": s.completion_queries,
               "completion_fanout_blocks": s.completion_fanout_blocks,
               "t_sync_s": round(s.t_sync, 3),
               "t_kernel_s": round(s.t_kernel, 3)}
        ref, want = REF_MS[n], REF_PATH[n]
        check(out["grad_sha256"] == ref["grad_sha256"]
              and out["ms_sha256"] == ref["ms_sha256"],
              f"{backend} {n}^3: gradient or complex differs from the "
              f"reference's")
        for key in ("persistence", "pd_digest", "simplified", "cancelled",
                    "simplified_sha256"):
            check(out[key] == want[key],
                  f"{backend} {n}^3: {key} {out[key]} != reference "
                  f"{want[key]}")
        return eng, g, out

    def bad_audit(eng, p, g):
        t0 = time.perf_counter()
        report = audit_gradient(eng, p, corrupt(g, eng))
        t1 = time.perf_counter()
        M, L = complete_adjacency(eng, "FF", ff_sample(p.n_faces))
        t2 = time.perf_counter()
        return {"bad_audit": report, "ff_sha256": rows_digest(M, L),
                "bad_audit_wall_s": round(t1 - t0, 3),
                "ff_sample_wall_s": round(t2 - t1, 3)}

    for k in sr.LAUNCHES:
        sr.LAUNCHES[k] = 0
    cg.LAUNCHES["gather"] = 0
    eng, g, out = audit_path(pre, rank, "cuda", N)
    path_launches = {k: sr.LAUNCHES[k] for k in ROUTED + ("TT", "meet")
                     if not k.startswith("VV")}
    path_launches["gather"] = cg.LAUNCHES["gather"]
    emit({**out, "kernel_counters": path_launches})
    check(path_launches["meet"] > 0 and path_launches["gather"] > 0,
          f"a kernel was not launched on the audit + persistence path: "
          f"{path_launches}")
    all_bits("the audit + persistence path", path_launches)
    check(path_launches["sub_bits"] > 0,
          f"the sub-join kernel was not launched on the audit + persistence "
          f"path: {path_launches}")
    for k in ("member_bits", "member_sort", "TT", "sub_bits", "sub_sort",
              "gather"):
        launches[k] += path_launches[k]
    launches["meet"] = dense_launches["meet"] + path_launches["meet"]
    launches["vv_counts"] = dense_launches["vv_counts"]

    # -- 7. the completion gather kernel against its plain version, on a
    mark("7")
    # real 96^3 completion chunk of phase 6's engine
    paired = np.nonzero(g.pair_t2f >= 0)[0]
    ids = paired[len(paired) // 2:len(paired) // 2 + CHUNK]
    # phase 8c's chunk: as many paired tets around the segment where the 2-
    # and 4-shard plans both cut, so its pairs fall on several shards
    # (tets are numbered by owner segment)
    cut = int(np.searchsorted(pre.owner_segment("T", paired),
                              sm.n_segments // 2))
    tt_cross = paired[max(0, cut - CHUNK // 2):cut + CHUNK // 2]
    plan = plan_completion(eng, "TT", ids, prefetch=False)
    S = ops.bucket_rows(len(plan.segments))
    pool_M, pool_L = eng.get_full_dev_batch("TT", plan.segments, pad_to=S)
    inv_seg, inv_gid, inv_row, inv_key, n_glob = eng.dev_inverse("T")
    inv_start = eng.dev_inverse_starts("T")
    P = len(plan.pair_seg)
    P_pad = ops.bucket_rows(P)
    slot = np.full(P_pad, -1, np.int32)
    slot[:P] = np.searchsorted(plan.segments, plan.pair_seg)
    seg = np.zeros(P_pad, np.int32)
    seg[:P] = plan.pair_seg
    gid = np.full(P_pad, -1, np.int32)
    gid[:P] = plan.ids[plan.pair_query]
    pairs = (cu(slot), cu(seg), cu(gid))

    def gather_compare(case, *args, inv=None, key=None, n_global=0,
                       start=None, pool=None):
        inv = inv or (inv_seg, inv_gid, inv_row)
        a = (*(pool or (pool_M, pool_L)), *inv, *args)
        got = cg.resolve_gather_cuda(*a, inv_key=key, n_global=n_global,
                                     inv_start=inv_start if start is None
                                     else start)
        want = cg.resolve_gather_torch(*a, inv_key=key, n_global=n_global)
        torch.cuda.synchronize()
        ok = all(torch.equal(x, y) for x, y in zip(got, want))
        err = max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
                  for x, y in zip(got, want))
        max_err["gather"] = max(max_err["gather"], err)
        emit({"phase": "kernel_case", "case": case, "relation": "gather",
              "pairs": int(args[0].shape[0]), "K": int(inv[0].shape[0]),
              "key_search": key is not None, "equal": ok,
              "resolved": int((want[1] > 0).sum())})
        check(ok, f"the gather kernel disagrees with the plain arm ({case})")
        return want

    check(inv_key is None, "the 96^3 T keys fit int32: no lex case")
    check(inv_seg.shape[0] & (inv_seg.shape[0] - 1) != 0,
          "K is a power of two")
    want = gather_compare("main chunk", *pairs)
    check(int((want[1] > 0).sum()) >= len(ids), "the chunk resolved no rows")
    gather_compare("P=1", *(t[:1].contiguous() for t in pairs))
    gather_compare("P not a block multiple", *(t[:P - 3].contiguous()
                                               for t in pairs))
    far = seg.copy()                                 # a far segment: the
    far[:P:3] = (far[:P:3] + sm.n_segments // 2) % sm.n_segments  # tet is
    gather_compare("unresolved pairs", pairs[0], cu(far), pairs[2])  # absent
    past = seg.copy()
    past[:P:5] = sm.n_segments + 3                   # lo == K
    gather_compare("past the last key", pairs[0], cu(past), pairs[2])
    # maps cut just below the chunk's pair at the 90th percentile of
    # (seg, gid) order: K is odd, and the pairs at or past the cut end
    # their search at lo == K
    q = np.sort(seg[:P].astype(np.int64) * n_glob + gid[:P])[P * 9 // 10]
    qs, qg = int(q // n_glob), int(q % n_glob)
    K2 = int(((inv_seg < qs) | ((inv_seg == qs) & (inv_gid < qg))).sum())
    K2 -= 1 - K2 % 2
    gather_compare("K odd, cut inside the chunk", *pairs,
                   inv=tuple(t[:K2].contiguous() for t in
                             (inv_seg, inv_gid, inv_row)))
    # the single-key search, on the 16^3 mesh whose keys fit int32
    weng = RelationEngine(wpre, ["TT"], device="cuda")
    wids = np.arange(0, wsm.n_tets, 3)[:CHUNK]
    wplan = plan_completion(weng, "TT", wids, prefetch=False)
    wM, wL = weng.get_full_dev_batch(
        "TT", wplan.segments, pad_to=ops.bucket_rows(len(wplan.segments)))
    ws, wg, wr, wk, wn = weng.dev_inverse("T")
    check(wk is not None, "the 16^3 T keys do not fit int32")
    wslot = np.searchsorted(wplan.segments, wplan.pair_seg).astype(np.int32)
    wa = (cu(wslot), cu(wplan.pair_seg.astype(np.int32)),
          cu(wplan.ids[wplan.pair_query].astype(np.int32)))
    wst = weng.dev_inverse_starts("T")
    got = cg.resolve_gather_cuda(wM, wL, ws, wg, wr, *wa, inv_key=wk,
                                 n_global=wn, inv_start=wst)
    want = cg.resolve_gather_torch(wM, wL, ws, wg, wr, *wa, inv_key=wk,
                                   n_global=wn)
    lex = cg.resolve_gather_cuda(wM, wL, ws, wg, wr, *wa, inv_start=wst)
    torch.cuda.synchronize()
    ok = all(torch.equal(x, y) for x, y in zip(got, want)) and \
        all(torch.equal(x, y) for x, y in zip(lex, want))
    emit({"phase": "kernel_case", "case": "single-key search (16^3)",
          "relation": "gather", "pairs": int(wa[0].shape[0]),
          "K": int(ws.shape[0]), "key_search": True, "equal": ok})
    check(ok, "the gather kernel's key search disagrees with the plain arm")

    # synthetic maps, both arms: runs of 1 to 3000 gids (one to three
    # narrowing rounds), empty segments, the last segment, segments past S
    # and below 0, the padding pair, and the maps cut to an odd K inside a
    # run (the start table of the whole maps clamped to K)
    def synthetic_maps(runs, n_seg, n_global):
        sseg = np.concatenate([np.full(n, q) for q, n in runs.items()])
        sgid = np.concatenate([np.sort(rng.choice(n_global, n, replace=False))
                               for n in runs.values()])
        key = sseg.astype(np.int64) * n_global + sgid
        check(key[-1] < 2 ** 31, "synthetic keys past int32")
        start = np.searchsorted(sseg, np.arange(n_seg + 1))
        return (sseg.astype(np.int32), sgid.astype(np.int32),
                rng.integers(0, 40, len(sseg)).astype(np.int32),
                key.astype(np.int32), start.astype(np.int32))

    spool = (cu(rng.integers(-1, 10 ** 5, (6, 40, 4)).astype(np.int32)),
             cu(rng.integers(0, 5, (6, 40)).astype(np.int32)))
    sseg, sgid, srow, skey, sstart = synthetic_maps(
        {0: 3000, 1: 700, 2: 33, 3: 0, 4: 1, 5: 32, 6: 200, 7: 0, 8: 1500},
        9, 5000)
    pick = rng.integers(0, len(sseg), 600)
    qs, qg = sseg[pick].copy(), sgid[pick].copy()
    qg[::3] = rng.integers(-1, 5001, len(qg[::3]))            # absent
    qs[1:12] = [3, 7, 8, 8, 9, 13, -1, -5, 0, 0, 0]
    qg[1:12] = [5, 0, sgid[-1], 4999, 0, 3, sgid[0], 0, -1, sgid[0],
                sgid[2999]]
    sslot = rng.integers(-1, 6, 600).astype(np.int32)
    sslot[-8:], qs[-8:], qg[-8:] = -1, 0, -1                   # padding
    spairs = (cu(sslot), cu(qs), cu(qg))
    for K_ in (len(sseg), 1501):
        inv = tuple(cu(a[:K_]) for a in (sseg, sgid, srow))
        for key in (None, cu(skey[:K_])):
            want = gather_compare(
                f"synthetic runs, K={K_}", *spairs, inv=inv, key=key,
                n_global=5000, start=cu(sstart), pool=spool)
            check(int((want[1] > 0).sum()) > (100 if K_ == len(sseg)
                                              else 20),
                  "the synthetic gather case resolved too few pairs")
    # the inv_key arm: a combined key past 2**31 wraps onto another
    # segment's appearance, which the plain arm finds (start table of 4100
    # segments, so the wrapping pairs lie inside it)
    sseg, sgid, srow, skey, sstart = synthetic_maps(
        {0: 50, 1: 50, 2040: 50}, 4100, 2 ** 20)
    wq = (cu(np.zeros(7, np.int32)),
          cu(np.array([4096, 4097, 4096, 2048, 2040, 1, 4099], np.int32)),
          cu(np.array([sgid[0], sgid[60], 7, sgid[3], sgid[120], sgid[70],
                       0], np.int32)))
    want = gather_compare("key wraps int32", *wq,
                          inv=tuple(cu(a) for a in (sseg, sgid, srow)),
                          key=cu(skey), n_global=2 ** 20, start=cu(sstart),
                          pool=(spool[0], torch.full_like(spool[1], 4)))
    check(want[1][:2].tolist() == [4, 4],
          "the wrapped keys found no appearance")

    launch = (lambda: cg.resolve_gather_cuda(
        pool_M, pool_L, inv_seg, inv_gid, inv_row, *pairs,
        inv_start=inv_start))
    k_ms, e_ms = graph_ms(torch, launch), time_ms(torch, launch)
    p_ms = time_ms(torch, lambda: cg.resolve_gather_torch(
        pool_M, pool_L, inv_seg, inv_gid, inv_row, *pairs))
    cand, clen = cg.resolve_gather_torch(
        pool_M, pool_L, inv_seg, inv_gid, inv_row, *pairs)
    degp = pool_M.shape[2]
    # the bytes this chunk's work needs (roofline.gather_work): the pair
    # columns in, each pair's bisection reads, its pool row and length, and
    # cand + clen out
    check(nbytes(*pairs, cand, clen) == P_pad * (12 + (degp + 1) * 4),
          "the gather's pairs or rows are not the shapes its bound counts")
    b_ms, b_by = roofline.gather_work(P_pad, int(inv_seg.shape[0]),
                                      degp).bound_ms()
    timing["gather"] = {"ms": k_ms, "eager_ms": e_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "kernel_time", "arm": "gather", "pairs": P_pad,
          "K": int(inv_seg.shape[0]), "pool": list(pool_M.shape),
          **timing["gather"]})

    # -- 8. the corrupted audit and the FF rows, at 48^3 --------------------
    mark("8")
    # the corrupted field's audit and a face sample's FF rows on both arms
    # at 48^3, against the reference's pins (the 96^3 audit is phase 6's)
    del eng
    for backend in ("cuda", "torch"):
        seng, sg, sout = audit_path(ppre, prank, backend, SMALL_N)
        small = bad_audit(seng, ppre, sg)
        emit({**sout, **small})
        check(small["bad_audit"]["tt_conflicts"] >= SITES
              and small["bad_audit"]["ff_conflicts"] >= SITES,
              f"{backend}: the corrupted audit missed a double claim: "
              f"{small['bad_audit']}")
        for key in ("bad_audit", "ff_sha256"):
            check(small[key] == REF_PATH[SMALL_N][key],
                  f"{backend} {SMALL_N}^3: {key} {small[key]} != reference "
                  f"{REF_PATH[SMALL_N][key]}")
        del seng

    # -- 8b. the compared data structures, the fused loop, analyze_mesh ----
    mark("8b")
    def zero_counts():
        for k in sr.LAUNCHES:
            sr.LAUNCHES[k] = 0
        cg.LAUNCHES["gather"] = 0
        torch.cuda.synchronize()

    def read_counts():
        torch.cuda.synchronize()
        return {**sr.LAUNCHES, "gather": cg.LAUNCHES["gather"]}

    # the four structures' critical points at 96^3 against the pin
    def structure(label):
        t0 = time.perf_counter()
        if label == "Explicit":
            ds = ExplicitTriangulation(pre, ["VV", "VT"])
        elif label == "TopoCluster":
            ds = TopoClusterDS(pre, ["VV", "VT"])
        elif label == "ACTOPO":
            ds = ActopoDS(pre, ["VV", "VT"])
        else:
            ds = RelationEngine(pre, ["VV", "VT"], lookahead=8,
                                device="cuda")
        return ds, time.perf_counter() - t0

    cp_walls = {}
    for label in ("Explicit", "TopoCluster", "ACTOPO", "GALE"):
        ds, init_s = structure(label)
        zero_counts()
        t0 = time.perf_counter()
        types, counts = critical_points(ds, pre, rank)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counters = read_counts()
        eng_ = getattr(ds, "engine", ds)
        s = ds.stats
        digest_t = hashlib.sha256(types.astype(np.int32).tobytes()).hexdigest()
        row = {"phase": "structure_critical_points", "structure": label,
               "n": N, "counts": counts, "wall_s": round(wall, 3),
               "init_s": round(init_s, 3),
               "requests": s.requests, "kernel_launches": s.kernel_launches,
               "segments_produced": s.segments_produced,
               "cache_hits": s.cache_hits, "cache_misses": s.cache_misses,
               "evictions": s.evictions, "devpool_hits": s.devpool_hits,
               "devpool_uploads": s.devpool_uploads,
               "t_sync_s": round(s.t_sync, 3),
               "t_kernel_s": round(s.t_kernel, 3),
               "types_sha256": digest_t, "kernel_counters": counters}
        if label == "Explicit":
            row.update(init_time_s=round(ds.init_time, 3),
                       memory_bytes=ds.memory_bytes())
        else:
            row["cache_nbytes"] = eng_.cache_nbytes()
        emit(row)
        cp_walls[label] = wall
        check(digest_t == REF_TYPES_SHA256 and counts == REF_COUNTS,
              f"{label}: types differ from the reference's")
        all_bits(f"{label}'s critical points", counters)
        if label == "Explicit":
            check(not any(counters.values()),
                  f"the explicit structure launched kernels: {counters}")
            continue
        check(counters["VV_bits"] > 0 and counters["member_bits"] > 0,
              f"{label}: a bitmask kernel was not launched: {counters}")
        if label != "GALE":
            # B=1: one launch a segment produced, each synced at dispatch
            check(not eng_.async_dispatch and eng_.batch_max == 1
                  and s.kernel_launches == s.segments_produced
                  == counters["VV_bits"] + counters["member_bits"],
                  f"{label}: launches {s.kernel_launches} != segments "
                  f"produced {s.segments_produced} or counters {counters}")
            for k in ("VV_bits", "member_bits"):
                launches[k] += counters[k]
        del ds, eng_

    # the fused loop at 96^3: the pin's minima and maxima, one VV count
    # launch a batch, and no host sync inside the loop
    want_min = np.nonzero(cp_types == MINIMUM)[0]
    want_max = np.nonzero(cp_types == MAXIMUM)[0]
    zero_counts()
    t0 = time.perf_counter()
    fmin, fmax = fused_extrema(pre, rank, batch=FUSED_BATCH)
    fused_wall = time.perf_counter() - t0
    fused_counts = read_counts()
    staged = stage_fused(pre, rank, FUSED_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mins, maxs = fused_masks(*staged)
        loop_enqueue = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    loop_wall = time.perf_counter() - t0
    lv = staged[1].reshape(-1, staged[1].shape[2]).cpu().numpy()
    loop_min = np.sort(lv[mins.cpu().numpy()])
    loop_max = np.sort(lv[maxs.cpu().numpy()])
    n_batches = -(-sm.n_segments // FUSED_BATCH)
    emit({"phase": "fused_extrema", "n": N, "batch": FUSED_BATCH,
          "batches": n_batches, "minima": len(fmin), "maxima": len(fmax),
          "wall_s": round(fused_wall, 3),
          "loop_wall_s": round(loop_wall, 3),
          "loop_enqueue_s": round(loop_enqueue, 3),
          "sync_debug_mode": "error (no sync raised)",
          "kernel_counters": fused_counts})
    check(np.array_equal(fmin, want_min) and np.array_equal(fmax, want_max),
          "the fused extrema differ from the pinned types' minima/maxima")
    check(np.array_equal(loop_min, want_min)
          and np.array_equal(loop_max, want_max),
          "the sync-free loop's extrema differ from fused_extrema's")
    check(fused_counts["vv_counts"] == n_batches
          and sum(fused_counts.values()) == n_batches,
          f"the fused loop launched {fused_counts}, not {n_batches} VV "
          f"count kernels")
    launches["vv_counts"] += fused_counts["vv_counts"]
    del staged, mins, maxs

    # gradient -> Morse-Smale through the explicit structure at 48^3
    zero_counts()
    t0 = time.perf_counter()
    ex = ExplicitTriangulation(ppre, MS_RELS)
    t1 = time.perf_counter()
    g = discrete_gradient(ex, ppre, prank, batch_segments=16,
                          co_prefetch=("TT",))
    ms = morse_smale(ex, ppre, g)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counters = read_counts()
    ex_out = {"phase": "explicit_gradient_ms", "n": SMALL_N,
              "euler": g.euler(), "grad": g.counts(), "ms": ms.counts(),
              "grad_sha256": digest(g, GRAD_FIELDS),
              "ms_sha256": digest(ms, MS_FIELDS),
              "init_time_s": round(ex.init_time, 3),
              "memory_bytes": ex.memory_bytes(),
              "build_wall_s": round(t1 - t0, 3),
              "wall_s": round(t2 - t1, 3),
              "requests": ex.stats.requests,
              "devpool_uploads": ex.stats.devpool_uploads,
              "completion_queries": ex.stats.completion_queries,
              "kernel_counters": counters}
    emit(ex_out)
    ref = REF_MS[SMALL_N]
    for key in ("grad", "ms", "grad_sha256", "ms_sha256"):
        check(ex_out[key] == ref[key],
              f"explicit {SMALL_N}^3: {key} differs from the reference's")
    check(not any(counters.values()),
          f"the explicit path launched kernels: {counters}")
    del ex, g, ms

    # analyze_mesh on "foot": the GALE and Explicit rows against the pins
    zero_counts()
    t0 = time.perf_counter()
    header, rows = analyze_mesh.run("foot")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counters = read_counts()
    emit({"phase": "analyze_mesh", "dataset": "foot", **header,
          "wall_s": round(wall, 3), "kernel_counters": counters,
          **{label: {k: r[k] for k in ("critical", "gradient", "ms", "euler",
                                        "persistence", "digest")}
             | {"wall_s": round(r["wall_s"], 3),
                "t_sync_s": round(r["ds"].stats.t_sync, 3)}
             for label, r in rows.items()}})
    for label, r in rows.items():
        for key, want in REF_FOOT.items():
            check(r[key] == want, f"analyze_mesh foot {label}: {key} "
                                  f"{r[key]} != reference {want}")
    all_bits("analyze_mesh", counters)
    check(all(counters[k] > 0 for k in ("VV_bits", "member_bits", "TT",
                                        "gather")),
          f"a kernel was not launched on analyze_mesh's GALE row: "
          f"{counters}")
    for k in ("VV_bits", "member_bits", "TT", "sub_bits", "gather"):
        launches[k] += counters[k]
    del rows

    # -- 8c. segment shards on the one card ----------------------------------
    mark("8c")
    # a. critical points at 96^3 through four logical shards on cuda:0,
    # against the pin, beside phase 8b's one-shard GALE wall (same call)
    SHARDS = 4
    t8c = time.perf_counter()
    zero_counts()
    t0 = time.perf_counter()
    seng = RelationEngine(pre, ["VV", "VT"], lookahead=8, device="cuda",
                          shards=SHARDS)
    init_s = time.perf_counter() - t0
    splan = seng.shard_plan
    impure = []
    launch_device = seng._launch_device

    def shard_pure(relation, batch, shard, attempt):
        # every launch reads one shard's tables: its segments are all that
        # shard's
        if {int(x) for x in seng._seg_shard[batch]} != {shard}:
            impure.append((relation, shard, batch[0], batch[-1]))
        return launch_device(relation, batch, shard, attempt)

    seng._launch_device = shard_pure
    t0 = time.perf_counter()
    types, counts = critical_points(seng, pre, rank)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counters = read_counts()
    st, mst = seng.stats, seng.merged_shard_stats()
    digest_t = hashlib.sha256(types.astype(np.int32).tobytes()).hexdigest()
    sizes = [hi - lo for lo, hi in zip(splan.bounds[:-1], splan.bounds[1:])]
    per_shard = {k: {"segments_produced": v.segments_produced,
                     "kernel_launches": v.kernel_launches,
                     "devpool_hits": v.devpool_hits}
                 for k, v in sorted(seng.shard_stats.items())}
    emit({"phase": "sharded_critical_points", "n": N, "shards": SHARDS,
          "devices": [str(d) for d in splan.devices],
          "bounds": list(splan.bounds), "counts": counts,
          "wall_s": round(wall, 3), "init_s": round(init_s, 3),
          "one_shard_wall_s": round(cp_walls["GALE"], 3),
          "kernel_launches": st.kernel_launches,
          "segments_produced": st.segments_produced,
          "t_sync_s": round(st.t_sync, 3),
          "t_kernel_s": round(st.t_kernel, 3), "per_shard": per_shard,
          "impure_launches": len(impure), "types_sha256": digest_t,
          "kernel_counters": counters})
    check(digest_t == REF_TYPES_SHA256 and counts == REF_COUNTS,
          "the 4-shard critical points differ from the reference's")
    for f in ("kernel_launches", "segments_produced", "devpool_hits",
              "devpool_uploads"):
        check(getattr(mst, f) == getattr(st, f),
              f"merged_shard_stats().{f} {getattr(mst, f)} != stats "
              f"{getattr(st, f)}")
    check(not impure, f"launches spanned shards: {impure[:4]}")
    check([per_shard[k]["segments_produced"] for k in range(SHARDS)]
          == [2 * n for n in sizes],
          f"a shard produced other than its own VV and VT blocks once: "
          f"{per_shard}")
    check(counters["VV_bits"] > 0 and counters["member_bits"] > 0,
          f"the 4-shard critical points launched no bitmask kernel: "
          f"{counters}")
    all_bits("the 4-shard critical points", counters)
    for k in ("VV_bits", "member_bits"):
        launches[k] += counters[k]
    del seng

    # a full VV sweep, one consumer batch of 64 at a time: each shard
    # produces its own segments exactly once
    veng = RelationEngine(pre, ["VV"], lookahead=8, device="cuda",
                          shards=SHARDS)
    t0 = time.perf_counter()
    for b in segment_batches(sm.n_segments, BATCH, veng.shard_plan):
        veng.get_batch("VV", b)
    torch.cuda.synchronize()
    sweep = {k: v.segments_produced
             for k, v in sorted(veng.shard_stats.items())}
    emit({"phase": "sharded_vv_sweep", "n": N, "shards": SHARDS,
          "wall_s": round(time.perf_counter() - t0, 3),
          "segments_produced": sweep, "shard_sizes": sizes,
          "kernel_launches": veng.stats.kernel_launches})
    check([sweep.get(k, 0) for k in range(SHARDS)] == sizes,
          f"the VV sweep produced {sweep}, not each shard's {sizes} once")
    del veng

    # b. the sharded completion exchange on a real 96^3 chunk of phase 6's
    # paired tets, and on as many faces, both across the cut of the 2- and
    # 4-shard plans: TT and FF rows at 2 and 4 shards equal one shard's, on
    # both arms
    zero_counts()
    f0 = int(pre.I_F[sm.n_segments // 2])
    faces = np.arange(f0 - CHUNK // 2, f0 + CHUNK // 2)
    exchange = {}
    for backend in ("cuda", "torch"):
        for relation, q in (("TT", tt_cross), ("FF", faces)):
            rows = {}
            for k in (1, 2, SHARDS):
                xeng = RelationEngine(pre, [relation], lookahead=8,
                                      device="cuda", backend=backend,
                                      shards=k)
                t0 = time.perf_counter()
                M, L = complete_adjacency(xeng, relation, q, path="device",
                                          shards=k)
                torch.cuda.synchronize()
                rows[k] = (M, L, time.perf_counter() - t0)
                del xeng
            exchange[f"{backend}_{relation}"] = {
                "rows_sha256": rows_digest(*rows[1][:2]),
                "wall_s": {k: round(v[2], 3) for k, v in rows.items()}}
            for k in (2, SHARDS):
                check(np.array_equal(rows[k][0], rows[1][0])
                      and np.array_equal(rows[k][1], rows[1][1]),
                      f"{backend} {relation}: the {k}-shard exchange differs "
                      f"from one shard's rows")
    x_counters = read_counts()
    emit({"phase": "sharded_exchange", "n": N, "queries":
          {"TT": len(tt_cross), "FF": len(faces)}, **exchange,
          "kernel_counters": x_counters})
    check(exchange["cuda_TT"]["rows_sha256"]
          == exchange["torch_TT"]["rows_sha256"]
          and exchange["cuda_FF"]["rows_sha256"]
          == exchange["torch_FF"]["rows_sha256"],
          "the sharded exchange differs between the arms")
    check(x_counters["gather"] > 0 and x_counters["TT"] > 0
          and x_counters["meet"] > 0,
          f"a kernel was not launched on the sharded exchange: {x_counters}")
    for k in ("TT", "meet", "gather", "sub_bits", "member_bits"):
        launches[k] += x_counters[k]

    # the gather kernel's mask mode (one shard's half) against the plain
    # arm on the same inputs: phase 7's chunk as a shard owning every pair
    # and as one owning none, then the real halves of a 4-shard engine
    def masked_compare(case, *args, pool=None, start=None):
        a = (*(pool or (pool_M, pool_L)), inv_seg, inv_gid, inv_row, *args)
        got = cg.gather_candidates(*a, backend="cuda",
                                   inv_start=start if start is not None
                                   else inv_start)
        want = cg.gather_candidates(*a, backend="torch")
        torch.cuda.synchronize()
        ok = all(torch.equal(x, y) for x, y in zip(got, want))
        err = max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
                  for x, y in zip(got, want))
        max_err["gather"] = max(max_err["gather"], err)
        emit({"phase": "kernel_case", "case": case, "relation": "gather",
              "mask": True, "pairs": int(args[0].shape[0]), "equal": ok,
              "owned_resolved": int((want[1] > 0).sum()),
              "zero_rows": int((want[0] == 0).all(1).sum())})
        check(ok, f"the masked gather kernel disagrees with the plain arm "
                  f"({case})")
        return want

    every = masked_compare("a shard owning every pair", *pairs)
    plain_rows = cg.resolve_gather_torch(pool_M, pool_L, inv_seg, inv_gid,
                                         inv_row, *pairs)
    check(torch.equal(every[1], plain_rows[1]),
          "the masked lengths differ from the unmasked gather's")
    none = masked_compare("a shard owning no pair",
                          torch.full_like(pairs[0], -1), *pairs[1:])
    check(not none[0].any() and not none[1].any(),
          "a shard owning no pair gave a nonzero row")
    def masked_halves(meng, label=""):
        """Phase 7's 96^3 chunk of paired tets gathered as each shard's
        masked half of ``meng``'s pools, each half held against the plain
        arm; the halves must sum to the single-pool gather of the same
        pairs. Returns the pairs each shard owns."""
        mplan = plan_completion(meng, "TT", tt_cross, prefetch=False)
        mshard = meng.shard_plan.shard_of_array(mplan.pair_seg)
        MP = len(mplan.pair_seg)
        MP_pad = ops.bucket_rows(MP)
        mcols = np.zeros((2, MP_pad), np.int32)
        mcols[1] = -1
        mcols[0, :MP] = mplan.pair_seg
        mcols[1, :MP] = mplan.ids[mplan.pair_query]
        mpairs = (cu(mcols[0]), cu(mcols[1]))
        mstart = meng.dev_inverse_starts("T")
        # the single-pool gather of the same pairs, unmasked
        sM, sL = meng.get_full_dev_batch(
            "TT", mplan.segments,
            pad_to=ops.bucket_rows(len(mplan.segments)))
        sslot = np.full(MP_pad, -1, np.int32)
        sslot[:MP] = np.searchsorted(mplan.segments, mplan.pair_seg)
        single = cg.resolve_gather_torch(sM, sL, inv_seg, inv_gid, inv_row,
                                         cu(sslot), *mpairs)
        halves, owned = [], []
        n_shards = meng.n_shards
        for k in range(n_shards):
            lo, hi = meng.shard_plan.shard_bounds(k)
            segs_k = mplan.segments[(mplan.segments >= lo)
                                    & (mplan.segments < hi)]
            if len(segs_k) == 0:
                continue
            kM, kL = meng.get_full_dev_batch(
                "TT", segs_k, pad_to=ops.bucket_rows(len(segs_k)))
            kslot = np.full(MP_pad, -1, np.int32)
            kslot[:MP] = np.where(
                mshard == k, np.searchsorted(segs_k, mplan.pair_seg), -1)
            halves.append(masked_compare(
                f"shard {k} of {n_shards}{label} "
                f"({int((mshard == k).sum())} pairs)",
                cu(kslot), *mpairs, pool=(kM, kL), start=mstart))
            owned.append(int((mshard == k).sum()))
        check(len(halves) >= 2, f"the chunk lies on {len(halves)} shard(s)")
        summed = [sum(h[i] for h in halves) for i in range(2)]
        check(torch.equal(summed[1], single[1])
              and torch.equal(summed[0][single[1] > 0],
                              single[0][single[1] > 0]),
              f"the shards' masked halves{label} do not sum to the "
              f"single-pool gather")
        return owned

    meng = RelationEngine(pre, ["TT"], device="cuda", shards=SHARDS)
    owned = masked_halves(meng)
    # timed like phase 7: the whole chunk as one shard's half (the same
    # work as row 5's unmasked launch, plus the zeroed rows' stores)
    launch = (lambda: cg.resolve_gather_cuda(
        pool_M, pool_L, inv_seg, inv_gid, inv_row, *pairs, mask=True,
        inv_start=inv_start))
    k_ms, e_ms = graph_ms(torch, launch), time_ms(torch, launch)
    p_ms = time_ms(torch, lambda: cg.gather_candidates(
        pool_M, pool_L, inv_seg, inv_gid, inv_row, *pairs))
    b_ms, b_by = roofline.gather_work(P_pad, int(inv_seg.shape[0]),
                                      degp).bound_ms()
    masked_timing = {"ms": k_ms, "eager_ms": e_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "unmasked_ms": timing["gather"]["ms"]}
    emit({"phase": "kernel_time", "arm": "gather_masked", "pairs": P_pad,
          "K": int(inv_seg.shape[0]), "pool": list(pool_M.shape),
          "shard_pairs": owned, **masked_timing})
    del meng, every, none

    # c. the whole sharded path at 48^3: audit -> Morse-Smale ->
    # persistence -> simplify_ms on four shards and four workers, against
    # phase 8's 48^3 pins
    zero_counts()
    sheng, _, sout = audit_path(ppre, prank, "cuda", SMALL_N, shards=SHARDS,
                                workers=4)
    s_counters = read_counts()
    mst = sheng.merged_shard_stats()
    emit({**sout, "phase": "sharded_audit_persistence_path",
          "per_shard_segments": {k: v.segments_produced for k, v in
                                 sorted(sheng.shard_stats.items())},
          "kernel_counters": s_counters})
    check(mst.segments_produced == sheng.stats.segments_produced
          and mst.kernel_launches == sheng.stats.kernel_launches,
          "the 48^3 sharded path's shard stats do not merge to its stats")
    check(all(s_counters[k] > 0 for k in ("member_bits", "TT", "sub_bits",
                                          "meet", "gather")),
          f"a kernel was not launched on the sharded path: {s_counters}")
    all_bits("the sharded audit + persistence path", s_counters)
    for k in ("member_bits", "TT", "sub_bits", "meet", "gather"):
        launches[k] += s_counters[k]
    del sheng
    emit({"phase": "sharded_total",
          "wall_s": round(time.perf_counter() - t8c, 3)})

    # -- 8d. fault recovery on the card -------------------------------------
    mark("8d")
    t8d = time.perf_counter()
    emit({"phase": "host_arm_before_faults", "calls": host_calls[0]})
    check(host_calls[0] == 0,
          f"the host arm ran {host_calls[0]} time(s) before phase 8d: a "
          f"fault-free phase degraded")

    def launch_identity(label, counters, eng):
        """Every engine launch that reached a kernel wrapper is counted
        there once: the wrappers' launches equal ``kernel_launches`` less
        the host arm's launches plus the launches the watchdog or a device
        loss abandoned (their ``kernel_launches`` bump is reversed). The
        per-worker stats merge to ``stats``."""
        st = eng.stats
        wrapped = sum(counters[k] for k in ENGINE_KERNELS)
        want = st.kernel_launches - st.degraded_launches + st.failed_launches
        check(wrapped == want,
              f"{label}: {wrapped} kernel launches != kernel_launches "
              f"{st.kernel_launches} - degraded {st.degraded_launches} + "
              f"failed {st.failed_launches}")
        ints = {k: v for k, v in dataclasses.asdict(st).items()
                if isinstance(v, int)}
        merged = dataclasses.asdict(eng.merged_worker_stats())
        check(all(merged[k] == v for k, v in ints.items()),
              f"{label}: merged_worker_stats() != stats")
        return wrapped

    def fault_cp(label, policy, **kw):
        """critical_points at 48^3 in consumer batches of 8 on two workers
        under ``policy``, launch counters zeroed just before and read just
        after; ``types`` against the pin. The device pool holds 4096
        segments a shard, as the audit path's: at the default 256 two
        workers thrash it (at 96^3 on an H100 80GB HBM3: 27,376 uploads of
        27,648 reads, 22.4 s against one worker's 7.1 s)."""
        p, r = ppre, prank
        ref_counts, ref_sha = REF_CP_48["counts"], REF_CP_48["types_sha256"]
        kw.setdefault("dev_pool_segments", 4096)
        zero_counts()
        host0 = host_calls[0]
        t0 = time.perf_counter()
        eng = RelationEngine(p, ["VV", "VT"], device="cuda",
                             fault_policy=policy, **kw)
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        types, counts = critical_points(eng, p, r, batch_segments=8,
                                        workers=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = read_counts()
        st = eng.stats
        out = {"phase": "fault_scenario", "scenario": label, "n": SMALL_N,
               "wall_s": round(wall, 3), "init_s": round(init_s, 3),
               **{k: getattr(st, k) for k in FAULT_COUNTERS},
               "kernel_launches": st.kernel_launches,
               "segments_produced": st.segments_produced,
               "devpool_uploads": st.devpool_uploads,
               "t_sync_s": round(st.t_sync, 3),
               "injected": (len(policy.injector.injected)
                            if policy.injector is not None else 0),
               "host_arm_calls": host_calls[0] - host0,
               "kernel_counters": {k: c[k] for k in ENGINE_KERNELS}}
        digest_t = hashlib.sha256(types.astype(np.int32).tobytes()) \
            .hexdigest()
        check(digest_t == ref_sha and counts == ref_counts,
              f"{label}: the critical points differ from the reference's")
        out["wrapper_launches"] = launch_identity(label, c, eng)
        check(out["host_arm_calls"] == st.degraded_launches,
              f"{label}: {out['host_arm_calls']} host arm calls != "
              f"degraded_launches {st.degraded_launches}")
        mst = eng.merged_shard_stats()
        for f in ("kernel_launches", "segments_produced", "failed_launches",
                  "degraded_launches", "devpool_hits", "devpool_uploads"):
            check(getattr(mst, f) == getattr(st, f),
                  f"{label}: merged_shard_stats().{f} != stats")
        all_bits(label, c)
        for k in ("VV_bits", "member_bits"):
            launches[k] += c[k]
        return eng, out

    def on_card(label, out):
        # a schedule with no permanent fault must recover on the card: a
        # watchdog timeout of a real launch also enters the ladder, and
        # enough of them would open the breaker onto the host arm
        check(out["degraded_launches"] == 0 and out["host_arm_calls"] == 0,
              f"{label}: production left the card: {out}")

    # every schedule at 48^3 beside a 48^3 baseline (at 96^3 the
    # baseline, transient-launch and hung-sync runs took 16.8, 15.1 and
    # 15.5 s on an H100 80GB HBM3, the breaker's one segment a launch 33.1
    # s; the 96^3 re-home is held below, on the gather)
    eng, out = fault_cp("baseline-48", FaultPolicy())
    base48_wall = out["wall_s"]
    emit(out)
    check(all(out[k] == 0 for k in FAULT_COUNTERS),
          f"the fault-free 48^3 run moved a fault counter: {out}")
    on_card("baseline-48", out)

    inj = FaultInjector([FaultSpec(kind="launch", relation="VV", attempt=1,
                                   count=6)])
    eng, out = fault_cp("transient-launch",
                        FaultPolicy(injector=inj, backoff_s=0.001))
    emit({**out, "baseline_wall_s": base48_wall})
    check(out["injected"] == 6 and out["retries"] >= 6
          and out["failed_launches"] == 0, f"transient-launch: {out}")
    on_card("transient-launch", out)

    inj = FaultInjector([FaultSpec(kind="launch", relation="VV",
                                   transient=False, count=6)])
    eng, out = fault_cp("degraded-breaker",
                        FaultPolicy(injector=inj, breaker_threshold=2,
                                    breaker_cooldown_s=0.01),
                        batch_max=1, lookahead=0)
    emit({**out, "baseline_wall_s": base48_wall})
    check(out["breaker_trips"] >= 1 and out["breaker_recoveries"] >= 1
          and out["degraded_launches"] >= 1, f"degraded-breaker: {out}")

    inj = FaultInjector([FaultSpec(kind="sync", hang_s=5.0, count=1)])
    eng, out = fault_cp("hung-sync",
                        FaultPolicy(injector=inj, sync_timeout_s=0.05,
                                    sync_poll_s=0.005))
    emit({**out, "baseline_wall_s": base48_wall})
    check(out["sync_timeouts"] >= 1 and out["failed_launches"] >= 1
          and out["wall_s"] < base48_wall + 5.0, f"hung-sync: {out}")
    on_card("hung-sync", out)

    inj = FaultInjector([FaultSpec(kind="device-lost", shard=0, count=1)])
    eng, out = fault_cp("device-lost", FaultPolicy(injector=inj),
                        shards=2)
    lo, hi = eng.shard_plan.shard_bounds(0)
    out["shard0_segments"] = hi - lo
    out["pool_route"] = list(eng.store._route)
    emit({**out, "baseline_wall_s": base48_wall})
    check(out["shards_lost"] == 1 and out["rehomed_segments"] == hi - lo
          == psm.n_segments // 2 and out["pool_route"] == [1, 1],
          f"device-lost: {out}")
    on_card("device-lost", out)

    inj = FaultInjector([FaultSpec(kind="upload", count=2)])
    # one launch a shard pool, so that reads find evicted blocks and upload
    eng, out = fault_cp("upload-oom", FaultPolicy(injector=inj),
                        dev_pool_segments=BATCH)
    emit({**out, "baseline_wall_s": base48_wall})
    check(out["injected"] == 2 and out["degraded_reads"] >= 1
          and out["devpool_uploads"] >= 1, f"upload-oom: {out}")
    on_card("upload-oom", out)
    del eng

    # the gather kernel's masked halves of a 2-shard TT engine whose shard
    # 0 was lost at its first launch: the re-staged slice and the rerouted
    # pool give halves that sum to the single-pool gather
    inj = FaultInjector([FaultSpec(kind="device-lost", shard=0, count=1)])
    reng = RelationEngine(pre, ["TT"], device="cuda", shards=2,
                          fault_policy=FaultPolicy(injector=inj))
    rowned = masked_halves(reng, " after the re-home")
    emit({"phase": "rehomed_masked_gather", "shard_pairs": rowned,
          "shards_lost": reng.stats.shards_lost,
          "rehomed_segments": reng.stats.rehomed_segments,
          "pool_route": list(reng.store._route)})
    check(reng.stats.shards_lost == 1 and list(reng.store._route) == [1, 1]
          and reng.stats.rehomed_segments == sm.n_segments // 2,
          f"the TT engine's shard 0 was not re-homed: "
          f"{reng.stats.rehomed_segments} segments")
    del reng

    # the chaos run: the whole 48^3 audit -> persistence path on two shards
    # and two workers under a seeded mixed schedule, against phase 8's pins
    inj = FaultInjector([
        FaultSpec(kind="launch", relation="TT", count=1),
        FaultSpec(kind="launch", relation="VT", transient=False, count=2),
        FaultSpec(kind="launch", relation="FT", p=0.5, count=2),
        # long enough that the first reader must wait out the watchdog
        FaultSpec(kind="sync", hang_s=5.0, count=1),
        FaultSpec(kind="device-lost", shard=1, count=1)], seed=22)
    zero_counts()
    ceng, _, cout = audit_path(
        ppre, prank, "cuda", SMALL_N, shards=2, workers=2,
        policy=FaultPolicy(injector=inj, backoff_s=0.001,
                           breaker_threshold=2, breaker_cooldown_s=0.01,
                           sync_timeout_s=0.05, sync_poll_s=0.005))
    c = read_counts()
    st = ceng.stats
    kinds = sorted({e[0] for e in inj.injected})
    cout = {**cout, "phase": "fault_chaos_path",
            # (kind, relation, first segment, segments, attempt, shard)
            "injected": [(k, r, segs[0], len(segs), a, sh)
                         for k, r, segs, a, sh in inj.injected],
            **{k: getattr(st, k) for k in FAULT_COUNTERS},
            "kernel_counters": c}
    cout["wrapper_launches"] = launch_identity("the chaos run", c, ceng)
    emit(cout)
    check(kinds == ["device-lost", "launch", "sync"],
          f"the chaos schedule fired only {kinds}")
    check(st.shards_lost == 1 and st.sync_timeouts >= 1
          and st.retries >= 1, f"the chaos run recovered nothing: {cout}")
    check(all(c[k] > 0 for k in ("member_bits", "TT", "sub_bits", "meet",
                                 "gather")),
          f"a kernel was not launched on the chaos run: {c}")
    all_bits("the chaos run", c)
    for k in ("member_bits", "TT", "sub_bits", "meet", "gather"):
        launches[k] += c[k]
    del ceng

    # the host arm against the kernels for all ten relations, on phase 3's
    # B=64 96^3 tables, bit for bit, both assemblies; one batch timed
    host_ms = {}
    for relation in sorted(ops.DEFAULT_DEG):
        if relation == "VV":
            hx = hy = tabs.T_local[:BATCH]
            hcol = tabs.LV_global[:BATCH]
        else:
            hx = tabs.table(relation[0])[0][:BATCH]
            hy, hcol = (a[:BATCH] for a in tabs.table(relation[1]))
        t0 = time.perf_counter()
        hM, hL = ops.relation_block_host(relation, hx, hy, hcol, nvl)
        host_ms[relation] = (time.perf_counter() - t0) * 1e3
        zero_counts()
        eq = {}
        for assembly in ("sparse", "dense"):
            kM, kL = ops.relation_block(relation, cu(hx), cu(hy), cu(hcol),
                                        nvl, backend="cuda",
                                        assembly=assembly)
            eq[assembly] = (np.array_equal(kM.cpu().numpy(), hM)
                            and np.array_equal(kL.cpu().numpy(), hL))
        c = read_counts()
        ran = sorted(k for k in ENGINE_KERNELS if c[k])
        emit({"phase": "host_arm", "relation": relation, "B": BATCH,
              "shape": [list(hx.shape), list(hy.shape)],
              "host_ms": round(host_ms[relation], 3), "equal": eq,
              "kernels": ran, "max_L": int(hL.max())})
        check(all(eq.values()), f"the host arm's {relation} blocks differ "
                                f"from the kernels' ({eq})")
        check(len(ran) == 2 or relation in ("EE", "FF"),
              f"{relation}: the two assemblies ran {ran}")
    emit({"phase": "fault_total", "host_arm_ms_per_batch": host_ms,
          "wall_s": round(time.perf_counter() - t8d, 3)})

    # -- 8e. kernel-parameter autotuning -------------------------------------
    mark("8e")
    t8e = time.perf_counter()
    check(not os.path.exists(tune_path),
          "a tuning table existed before phase 8e")
    # (i) the row shares, one kernel at a time: the first B segments of
    # phase 3's B=64 96^3 tables, each share count held bit for bit
    # against the plain arm, timed by graph replay (and the eager loop:
    # the wrapper's host cost) beside its bound and the model's prediction
    shapes = {"NV": tabs.NV, "NE": tabs.NE, "NF": tabs.NF, "NT": tabs.NT}
    sweep = [(r, B, (1, 2, 4, 8, 16)) for B in (8, 16, 32, BATCH)
             for r in ("VV", "VT")]
    sweep += [("FT", BATCH, (1, 2, 4)), ("FT", 16, (2, 4, 8, 16))]
    for relation, B, counts in sweep:
        tx, ty, colg = (t[:B].contiguous() for t in main_inputs[relation])
        deg = ops.DEFAULT_DEG[relation]
        want = plain(relation, tx, ty, colg, nvl, deg)
        b_ms, b_by = entry_work(relation, tx, ty, colg, nvl, deg).bound_ms()
        rule = shares_of(relation, tx, ty, nvl)
        for k in counts:
            launch, blocks = shares_case(f"B={B}, {k} shares", relation, tx,
                                         ty, colg, nvl, deg, k, want)
            emit({"phase": "share_time", "relation": relation, "B": B,
                  "shares": k, "blocks": blocks, "rule_blocks": rule,
                  "ms": graph_ms(torch, launch),
                  "eager_ms": time_ms(torch, launch),
                  "predicted_ms": autotune.predicted_kernel_s(
                      relation, B, k, shapes, deg, sms, limit) * 1e3,
                  "bound_ms": b_ms, "bound_by": b_by})

    # (ii) the ranking for the 48^3 mesh. Critical points at the consumer's
    # batch of 8 segments launches 8 + 8 of lookahead: every batch_max >=
    # 16 launches 16, and 1728 = 108 * 16 leaves no tail for a floor to
    # pad, so the whole grid launches as the default does and the ranking
    # holds the default alone. At a batch of CP_BATCH segments (+ 8 of
    # lookahead) the batch_max values launch apart: the top three and the
    # default there, each from a table of its own: warm-up, then
    # clear_cache and a timed run, three times, in turns (the middle round
    # reversed, so no candidate always runs last). The fastest is recorded
    # only where it beats the default by more than the repeats' spread
    pt = ppre.tables
    pshapes = {"NV": pt.NV, "NE": pt.NE, "NF": pt.NF, "NT": pt.NT}
    ns = psm.n_segments
    widths = {r: ops.DEFAULT_DEG[r] for r in ("VV", "VT")}
    default = autotune.KernelConfig()

    def ranking(demand):
        cands = autotune.candidate_configs(ns, pshapes, ("VV", "VT"),
                                           demand=demand, sms=sms,
                                           smem=limit)
        predicted = {c: autotune._predicted_launch_s(
            c, ns, pshapes, ("VV", "VT"), widths, demand, sms, limit)
            for c in cands + [default]}
        emit({"phase": "tune_candidates", "n": SMALL_N, "segments": ns,
              "shapes": pshapes, "demand": demand,
              "ranked": [{**c.to_dict(), "predicted_s_per_segment":
                          predicted[c]} for c in cands],
              "default_predicted_s_per_segment": predicted[default]})
        return cands, predicted

    cands, _ = ranking(8 + 8)
    check(cands == [default], f"at the consumer's batch of 8 the grid "
                              f"launched apart from the default: {cands}")
    CP_BATCH = 64
    cands, predicted = ranking(CP_BATCH + 8)
    measured = list(dict.fromkeys(cands[:3] + [default]))
    check(len(measured) >= 3, f"the ranking gave {cands}")
    engines = {}
    for i, cfg in enumerate(measured):
        path = os.path.join(tune_dir, f"candidate{i}.json")
        autotune.record("cuda", ns, cfg, path=path)
        eng = RelationEngine(ppre, ["VV", "VT"], lookahead=8, device="cuda",
                             tune=path)
        check(eng.kernel_config == cfg,
              f"candidate {cfg} built {eng.kernel_config}")
        critical_points(eng, ppre, prank, batch_segments=CP_BATCH)  # warm
        engines[cfg] = eng
    walls = {cfg: [] for cfg in measured}
    for order in (measured, measured[::-1], measured):
        for cfg in order:
            eng = engines[cfg]
            eng.clear_cache()
            eng.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            types, counts = critical_points(eng, ppre, prank,
                                            batch_segments=CP_BATCH)
            torch.cuda.synchronize()
            walls[cfg].append(time.perf_counter() - t0)
            check(counts == REF_CP_48["counts"] and hashlib.sha256(
                types.astype(np.int32).tobytes()).hexdigest()
                == REF_CP_48["types_sha256"],
                f"candidate {cfg}: the critical points differ from the pin")
    winner = autotune.pick_winner(walls)
    oeng = RelationEngine(ppre, ["VV", "VT"], lookahead=8, device="cuda",
                          tune="off")
    check(oeng.kernel_config == default,
          "tune='off' did not give the built-in knobs")
    sample = list(range(0, ns, 97))
    for cfg, eng in engines.items():
        st = eng.stats
        same = all(np.array_equal(a, b)
                   for r in ("VV", "VT") for s in sample
                   for a, b in zip(eng.get(r, s), oeng.get(r, s)))
        emit({"phase": "tune_measured", **cfg.to_dict(),
              "batch_segments": CP_BATCH, "default": cfg == default,
              "walls_s": walls[cfg], "best_s": min(walls[cfg]),
              "spread_s": max(walls[cfg]) - min(walls[cfg]),
              "predicted_s": predicted[cfg] * ns,
              "kernel_launches": st.kernel_launches,
              "segments_produced": st.segments_produced,
              "devpool_uploads": st.devpool_uploads,
              "t_kernel_s": st.t_kernel, "t_sync_s": st.t_sync,
              "blocks_equal_untuned": same})
        check(same, f"candidate {cfg}: blocks differ from the untuned "
                    f"engine's")
    autotune.record("cuda", ns, winner, path=tune_path,
                    score_s=min(walls[winner]))
    del engines

    # (iii) the round trip: an engine from the run's table (tune="auto")
    # adopts the recorded knobs, gives the pin, and its blocks equal a
    # tune="off" engine's; its launches are the wrappers' launches
    zero_counts()
    teng = RelationEngine(ppre, ["VV", "VT"], lookahead=8, device="cuda")
    check(teng.kernel_config == winner,
          f"the tuned engine took {teng.kernel_config}, not {winner}")
    types, counts = critical_points(teng, ppre, prank,
                                    batch_segments=CP_BATCH)
    c = read_counts()
    wrapped = sum(c[k] for k in ENGINE_KERNELS)
    tuned_launches = teng.stats.kernel_launches
    check(counts == REF_CP_48["counts"] and hashlib.sha256(
        types.astype(np.int32).tobytes()).hexdigest()
        == REF_CP_48["types_sha256"],
        "the tuned engine's critical points differ from the pin")
    check(wrapped == tuned_launches,
          f"{wrapped} wrapper launches != kernel_launches {tuned_launches}")
    check(c["VV_bits"] > 0 and c["member_bits"] > 0,
          f"the tuned path launched no bitmask kernel: {c}")
    all_bits("the tuned critical-points path", c)
    for k in ("VV_bits", "member_bits"):
        launches[k] += c[k]
    same = all(np.array_equal(a, b)
               for r in ("VV", "VT") for s in sample
               for a, b in zip(teng.get(r, s), oeng.get(r, s)))
    emit({"phase": "tune_round_trip", "table": autotune.load_table(),
          "winner": winner.to_dict(), "winner_is_default": winner == default,
          "kernel_launches": tuned_launches,
          "wrapper_launches": wrapped, "kernel_counters":
              {k: c[k] for k in ENGINE_KERNELS},
          "sample_segments": len(sample), "blocks_equal_untuned": same,
          "wall_s": round(time.perf_counter() - t8e, 3)})
    check(same, "the tuned engine's blocks differ from the untuned one's")
    del teng, oeng

    # -- summary -------------------------------------------------------------
    mark("summary")
    check(all(launches[arm] > 0 for arm in KERNELS if arm not in FORCED),
          f"a kernel was launched no time on its path: {launches}")
    emit({"phase": "total", "wall_s": round(time.perf_counter() - t_start,
                                            3)})
    emit({"phase": "phase_walls", "walls_s": phase_walls()})
    emit({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": launches[arm],
         "max_abs_err": max_err[arm], "ms": timing[arm]["ms"],
         "plain_ms": timing[arm]["plain_ms"],
         "bound_ms": timing[arm]["bound_ms"],
         "bound_by": timing[arm]["bound_by"],
         "library_ms": timing[arm].get("library_ms")}
        for arm, k in KERNELS.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--meshes"]:
        sys.exit(build_meshes(sys.argv[2]))
    try:
        sys.exit(main())
    except Failed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
