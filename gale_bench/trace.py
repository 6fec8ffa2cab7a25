"""The device trace of a ``--trace 1`` window, reduced to what the metrics
read: ``torch.profiler`` (CUPTI) over the window, then

- ``busy_s``: the sum of the device operations' own times (kernels, copies,
  fills), as the port's ``profile_path.py`` sums them;
- ``kernel_s``: device seconds by operation name;
- ``op_device_s``: device seconds of the operations each host op launched,
  itself or below it (``aten::index_add_`` -> its kernels), by op name;
- ``device_ops``: the ten device operations that took most time;
- ``idle_gaps``: the device's idle time between operations, by what the
  host was doing at the gap (the innermost host op running then, a
  ``gale.*`` span of the harness where no op ran), the ten largest.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.autograd import DeviceType

_SCAN = 4000        # host events looked back through for a gap's owner
SPAN_PREFIX = "gale."


def span(name: str):
    """A host span of the harness in the trace, ``gale.<name>`` (a no-op
    when not tracing beyond the profiler's record call)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def profiler():
    """A profiler of the host and the device (CUPTI) for a ``with``
    block."""
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def _top(d: Dict[str, float], n: int = 10) -> List[List]:
    return [[k[:120], v] for k, v in
            sorted(d.items(), key=lambda kv: kv[1], reverse=True)[:n]]


def summarize(prof) -> dict:
    events = list(prof.events())
    # the harness's own spans come back on the device's timeline too (as
    # annotations of the work under them): they are no device operation
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith(SPAN_PREFIX)]
    host = [e for e in events if e.device_type == DeviceType.CPU
            and not getattr(e, "is_async", False)]
    kernel_s: Dict[str, float] = defaultdict(float)
    spans: List[Tuple[float, float]] = []
    for e in dev:
        tr = e.time_range
        kernel_s[e.name] += (tr.end - tr.start) / 1e6
        spans.append((tr.start, tr.end))
    busy_s = sum(kernel_s.values())

    op_device_s: Dict[str, float] = defaultdict(float)
    for e in host:
        ks = getattr(e, "kernels", None) or []
        dur = sum(k.duration for k in ks) / 1e6
        if dur <= 0:
            continue
        seen = set()
        p = e
        while p is not None:
            if p.name not in seen:
                seen.add(p.name)
                op_device_s[p.name] += dur
            p = p.cpu_parent

    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    gaps: Dict[str, float] = defaultdict(float)
    spans.sort()
    end = spans[0][1] if spans else 0.0
    for s, t in spans[1:]:
        if s > end:
            gaps[_owner(host, starts, (s + end) / 2)] += (s - end) / 1e6
        end = max(end, t)
    return {"busy_s": busy_s, "kernel_s": dict(kernel_s),
            "op_device_s": dict(op_device_s), "device_ops": _top(kernel_s),
            "idle_gaps": _top(gaps)}


def _owner(host, starts, t: float) -> str:
    """The innermost host event running at ``t``: the latest-starting one
    that has not ended (a runtime call is named after the op it serves)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - _SCAN, -1), -1):
        e = host[j]
        if e.time_range.end >= t:
            if e.name.startswith("cuda") and e.cpu_parent is not None:
                return f"{e.cpu_parent.name} ({e.name})"
            return e.name
    return "(no host op)"
