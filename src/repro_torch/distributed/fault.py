"""Fault tolerance for the training loop, a copy of the reference's
``distributed/fault.py`` (it imports nothing of JAX):

  * checkpoint/restart — atomic checkpoints every N steps; on any step
    failure the loop restores the latest checkpoint and replays (the data
    pipeline is deterministic in (seed, step), so replay is bit-identical).
  * fault injection — ``FaultInjector`` raises at configurable steps to
    exercise the recovery path in tests/examples.
  * heartbeat / straggler watchdog — per-step wall times; steps slower
    than ``factor`` x the trailing median are logged as stragglers. On a
    multi-host deployment this signal would feed the coordinator that
    evicts the slow host and restarts from the last checkpoint.
"""

from __future__ import annotations

import collections
import statistics
import time
from typing import Callable, Optional


class FaultInjector:
    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.injected = []

    def maybe_fail(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.injected.append(step)
            raise RuntimeError(f"injected fault at step {step}")


class StragglerWatchdog:
    def __init__(self, window: int = 32, factor: float = 3.0):
        self.times = collections.deque(maxlen=window)
        self.factor = factor
        self.stragglers = []

    def record(self, step: int, dt: float):
        if len(self.times) >= 8:
            med = statistics.median(self.times)
            if dt > self.factor * med:
                self.stragglers.append((step, dt, med))
        self.times.append(dt)


def resilient_loop(
    step_fn: Callable,            # (state, batch) -> (state, metrics)
    state,
    batch_for_step: Callable,     # step -> batch
    n_steps: int,
    save_fn: Callable,            # (state, step) -> None
    restore_fn: Callable,         # () -> (state, step) | None
    ckpt_every: int = 50,
    injector: Optional[FaultInjector] = None,
    watchdog: Optional[StragglerWatchdog] = None,
    log: Callable = print,
    max_restarts: int = 5,
):
    """Run a training loop that survives step failures via checkpoint
    restart. Returns (final_state, history)."""
    step = 0
    restored = restore_fn()
    if restored is not None:
        state, step = restored
        log(f"[fault] resumed from checkpoint at step {step}")
    history = []
    restarts = 0
    while step < n_steps:
        try:
            if injector is not None:
                injector.maybe_fail(step)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_for_step(step))
            dt = time.perf_counter() - t0
            if watchdog is not None:
                watchdog.record(step, dt)
            history.append({"step": step, "dt": dt, **{
                k: float(v) for k, v in metrics.items()}})
            step += 1
            if step % ckpt_every == 0:
                save_fn(state, step)
        except Exception as e:  # noqa: BLE001 — any step failure
            restarts += 1
            log(f"[fault] step {step} failed ({e}); restart {restarts}")
            if restarts > max_restarts:
                raise
            restored = restore_fn()
            if restored is None:
                log("[fault] no checkpoint; restarting from step 0")
                step = 0
            else:
                state, step = restored
                log(f"[fault] restored step {step}")
    return state, history
