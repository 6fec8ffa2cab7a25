"""Thread-parallel consumer scheduler (paper Fig. 8/9 consumer axis;
docs/DESIGN.md §8).

GALE's CPU side is *multi-consumer*: while the producer keeps the
accelerator busy, **several host threads** execute the analysis algorithm
over the segment-batch stream. This module is the worker pool the drivers
run their batch loops through:

  - :func:`partition` assigns the batch stream to ``workers`` threads by
    striding (worker *w* takes batches *w*, *w+W*, *w+2W*, ...), so each
    worker's share preserves the global traversal order and production
    interleaves along the traversal exactly like the serial pipeline's
    lookahead.
  - Each worker runs the per-batch consumer arm (device or host) with the
    **depth-1 double buffer preserved per worker**: it prefetches its next
    own batch before consuming the current one, and finalizes (downloads)
    batch *k* only after batch *k+1* has been dispatched.
  - Results are reduced **in batch order on the calling thread**
    (:func:`run_partitioned`'s ``reduce``), so the output is bit-identical
    for any worker count and any thread interleaving.

Thread safety of the shared data structure is the engine's job (one lock +
condition variable, see ``core/engine.py``); the scheduler only requires
``consume``/``finalize`` to be safe to call from worker threads and calls
``reduce`` from a single thread. A worker exception aborts the pool: other
workers stop at their next batch boundary, and the first error (lowest
batch index) propagates to the caller instead of hanging the pool.

``workers <= 1`` runs the identical pipeline inline on the calling thread
(no threads are spawned).

On a sharded engine (docs/DESIGN.md §9) the batch stream restarts at every
shard boundary (:func:`segment_batches` with a plan) and the workers take
shard-affine shares (:func:`partition` with ``shard_of``), so a worker
drives one shard's pipeline; the in-order reduce is unchanged.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence

_PENDING = object()   # slot sentinel: batch not finished yet


def partition(n_items: int, workers: int,
              shard_of: Optional[Callable[[int], int]] = None
              ) -> List[List[int]]:
    """Strided assignment of ``n_items`` batch indices to at most
    ``workers`` workers (never more workers than items; each share is in
    ascending order).

    ``shard_of`` (item index -> segment shard) composes workers with
    segment shards: each worker's share stays *within* shards as much as
    possible. With W workers and K shards, W <= K assigns shards
    round-robin to workers (worker w owns shards w, w+W, ...); W > K
    spreads the workers over the shards (worker w serves shard w mod K)
    and strides within each shard. Either way the shares are disjoint,
    cover every index and are ascending."""
    if n_items <= 0:
        return []
    w = max(1, min(int(workers), n_items))
    if shard_of is None or w == 1:
        return [list(range(k, n_items, w)) for k in range(w)]
    shards = [int(shard_of(i)) for i in range(n_items)]
    uniq = sorted(set(shards))
    K = len(uniq)
    rank = {s: j for j, s in enumerate(uniq)}
    if w <= K:
        shares = [[i for i in range(n_items) if rank[shards[i]] % w == j]
                  for j in range(w)]
    else:
        per = [0] * K                 # workers serving each shard
        for j in range(w):
            per[j % K] += 1
        shares = []
        for j in range(w):
            s, r = j % K, j // K
            own = [i for i in range(n_items) if rank[shards[i]] == s]
            shares.append(own[r::per[s]])
    return [sh for sh in shares if sh]


def segment_batches(n_segments: int, batch_segments: int,
                    plan=None) -> List[List[int]]:
    """The drivers' contiguous segment-batch stream: the plain
    ``[b0, b0+batch_segments)`` chop, restarted at every shard boundary
    when a :class:`~repro_torch.distributed.sharding.ShardPlan` of more
    than one shard is given, so each batch (and the shard-pure launches
    its prefetch triggers) stays on one shard. Per-row driver results do
    not depend on batch boundaries, so the re-chunking keeps them bit
    for bit."""
    if plan is None or plan.n_shards <= 1:
        bounds = ((0, n_segments),)
    else:
        bounds = tuple(zip(plan.bounds[:-1], plan.bounds[1:]))
    batches = []
    for lo, hi in bounds:
        for b0 in range(lo, hi, batch_segments):
            batches.append(list(range(b0, min(b0 + batch_segments, hi))))
    return batches


def run_collect(
    items: Sequence,
    consume: Callable,
    *,
    workers: int = 1,
    finalize: Optional[Callable] = None,
    prefetch: Optional[Callable] = None,
    scope=None,
    name: str = "collect",
    shard_of: Optional[Callable[[int], int]] = None,
) -> List:
    """:func:`run_partitioned` with the common list-building reduce: returns
    ``[result(items[0]), result(items[1]), ...]`` in item order, independent
    of worker count and interleaving."""
    out: List = [None] * len(items)

    def reduce(i, res):
        out[i] = res

    run_partitioned(items, consume, reduce, workers=workers,
                    finalize=finalize, prefetch=prefetch, scope=scope,
                    name=name, shard_of=shard_of)
    return out


def _worker_scope(ds, name: str):
    """The stat-attribution scope for one worker: ``ds.worker_scope`` when
    the data structure keeps per-worker stats, a no-op otherwise."""
    scope = getattr(ds, "worker_scope", None)
    return scope(name) if scope is not None else contextlib.nullcontext()


def run_partitioned(
    items: Sequence,
    consume: Callable,
    reduce: Callable,
    *,
    workers: int = 1,
    finalize: Optional[Callable] = None,
    prefetch: Optional[Callable] = None,
    scope=None,
    name: str = "consumer",
    shard_of: Optional[Callable[[int], int]] = None,
) -> None:
    """Run ``consume(i, items[i])`` over every item with ``workers`` CPU
    threads and reduce the results deterministically.

    Per-item pipeline (each worker, over its strided share of the stream):

      1. ``prefetch(items[next own item])`` — non-blocking producer
         dispatch ahead of the consume (the first own item is prefetched
         before the loop, priming the pipeline);
      2. ``inter = consume(i, items[i])`` — the per-batch consumer arm; may
         return device tensors still computing;
      3. ``finalize(prev_inter)`` — called one batch *later* (depth-1
         double buffer): downloads the previous batch while the current one
         computes. ``None`` means ``consume`` already returned final
         results.

    Finalized results are handed to ``reduce(i, result)`` on the CALLING
    thread in ascending item order. ``scope`` is the data structure whose
    ``worker_scope`` attributes stats to workers (``w0``, ``w1``, ...).
    ``shard_of`` (item index -> segment shard) makes the partition
    shard-affine (see :func:`partition`); it never changes the reduce
    order, only which worker serves which item.

    Error contract: the first worker exception (lowest item index) is
    re-raised here after all workers stopped, with the failing worker id
    and batch index appended to its message; remaining workers abort at
    their next item boundary, so a raising worker can never hang the pool.
    """
    n = len(items)
    if n == 0:
        return
    shares = partition(n, workers, shard_of)

    if len(shares) == 1 and workers <= 1:
        # inline serial pipeline (no threads): identical order of
        # prefetch/consume/finalize/reduce to a 1-worker pool
        with _worker_scope(scope, "w0"):
            pending = None
            if prefetch is not None:
                prefetch(items[0])
            for i in range(n):
                if prefetch is not None and i + 1 < n:
                    prefetch(items[i + 1])
                inter = consume(i, items[i])
                if pending is not None:
                    pi, pinter = pending
                    reduce(pi, finalize(pinter) if finalize else pinter)
                pending = (i, inter)
            pi, pinter = pending
            reduce(pi, finalize(pinter) if finalize else pinter)
        return

    results: List = [_PENDING] * n
    errors: List = []            # (item index, worker index, exception)
    cond = threading.Condition()
    abort = threading.Event()

    def post(i, res) -> None:
        with cond:
            results[i] = res
            cond.notify_all()

    def fail(i, widx, exc) -> None:
        with cond:
            errors.append((i, widx, exc))
            abort.set()
            cond.notify_all()

    def work(widx: int, share: List[int]) -> None:
        with _worker_scope(scope, f"w{widx}"):
            pending = None
            at = -1   # current item, for error attribution
            try:
                if prefetch is not None:
                    prefetch(items[share[0]])
                for j, i in enumerate(share):
                    if abort.is_set():
                        return
                    at = i
                    if prefetch is not None and j + 1 < len(share):
                        prefetch(items[share[j + 1]])
                    inter = consume(i, items[i])
                    if pending is not None:
                        pi, pinter = pending
                        at = pi
                        post(pi, finalize(pinter) if finalize else pinter)
                        at = i
                    pending = (i, inter)
                if pending is not None:
                    pi, pinter = pending
                    at = pi
                    post(pi, finalize(pinter) if finalize else pinter)
            except BaseException as exc:  # propagate, never hang the pool
                fail(at if at >= 0 else share[0], widx, exc)

    threads = [
        threading.Thread(target=work, args=(w, share), daemon=True,
                         name=f"{name}-w{w}")
        for w, share in enumerate(shares)
    ]
    for t in threads:
        t.start()

    try:
        for i in range(n):
            with cond:
                while results[i] is _PENDING and not abort.is_set():
                    # the scheduler's handoff point: workers post results
                    # and notify  # contract: syncer-handoff
                    if not cond.wait(timeout=1.0):
                        if (not any(t.is_alive() for t in threads)
                                and results[i] is _PENDING
                                and not errors):
                            raise RuntimeError(
                                f"{name}: workers exited without "
                                f"finishing batch {i}")
                if results[i] is _PENDING:
                    break          # aborted before this batch finished
                res = results[i]
                results[i] = None  # free as we go
            reduce(i, res)
    finally:
        # harmless after normal completion (every result already posted);
        # stops the workers at their next batch if the caller's reduce
        # raised or a worker error broke the loop above
        abort.set()
        for t in threads:
            t.join()

    if errors:
        errors.sort(key=lambda e: e[0])
        i, widx, exc = errors[0]
        note = f"[{name}: worker w{widx} failed at batch {i}]"
        if exc.args and isinstance(exc.args[0], str):
            if note not in exc.args[0]:
                exc.args = (f"{exc.args[0]} {note}",) + exc.args[1:]
        elif not exc.args:
            exc.args = (note,)
        raise exc
