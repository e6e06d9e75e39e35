"""One profiled stretch of requests under ``torch.profiler``, reduced to
device intervals, busy time and a breakdown.

The stretch is short and taken early in the process: traces taken after
long use of the profiler in one process have come back without some of
their kernels' records on the card.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch

STRETCH = "perfbench.stretch"
REQUEST = "perfbench.request"
HOST_READ = "perfbench.host_read"


@dataclasses.dataclass
class DeviceEvent:
    name: str
    start_ns: int
    end_ns: int
    kind: str  # kernel | memcpy | memset


@dataclasses.dataclass
class Trace:
    """The stretch's device events (clipped to it), its length and the
    device's busy time in it, and the breakdown lists of the result line."""

    events: list
    window_s: float
    busy_s: float
    device_ops: list
    idle_gaps: list

    def kernels(self, pattern=None) -> list:
        return [e for e in self.events if e.kind == "kernel" and (pattern is None or pattern.search(e.name))]

    @staticmethod
    def seconds(events) -> float:
        return sum(e.end_ns - e.start_ns for e in events) * 1e-9


def _kind(ev) -> str | None:
    """``host`` for a host event; for a device activity ``kernel``,
    ``memcpy`` or ``memset``, or None for what is not work on the device
    (the annotations of :data:`STRETCH` and :data:`REQUEST` mirrored on the
    card's timeline)."""
    if ev.device_type() != torch.autograd.DeviceType.CUDA:
        return "host"
    name = ev.name()
    if name.startswith("perfbench.") or (hasattr(ev, "is_user_annotation") and ev.is_user_annotation()):
        return None
    act = ev.activity_type() if hasattr(ev, "activity_type") else None
    if act is not None:
        return {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}.get(act)
    return "memcpy" if name.startswith("Memcpy") else "memset" if name.startswith("Memset") else "kernel"


def _union(intervals):
    """Merged, sorted ``[(start, end), ...]``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, points):
    """For each sorted point, the name of the innermost host event (host
    events of one thread nest as a call stack) that covers it, or None."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))  # (start, end, name)
    names, stack, j = [], [], 0
    for p in points:
        while j < len(host) and host[j][0] <= p:
            while stack and stack[-1][1] <= host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        names.append(stack[-1][2] if stack else None)
    return names


def _top(pairs, n=10):
    return [[k, v] for k, v in sorted(pairs.items(), key=lambda kv: -kv[1])[:n]]


def reduce(kineto_events, device_index: int) -> Trace:
    """The :class:`Trace` of the stretch annotation among ``kineto_events``
    (``prof.profiler.kineto_results.events()``), for the device
    ``device_index``."""
    stretch = [e for e in kineto_events if e.name() == STRETCH and _kind(e) == "host"]
    if not stretch:
        raise RuntimeError(f"the profile holds no {STRETCH!r} annotation")
    t0, t1 = stretch[0].start_ns(), stretch[0].start_ns() + stretch[0].duration_ns()
    thread = stretch[0].start_thread_id()
    events, host = [], []
    for e in kineto_events:
        kind = _kind(e)
        s, d = e.start_ns(), e.duration_ns()
        if kind == "host":
            if e.start_thread_id() == thread and e.name() != STRETCH and d > 0:
                host.append((s, s + d, e.name()))
            continue
        if kind is None or e.device_index() != device_index or s + d <= t0 or s >= t1:
            continue
        events.append(DeviceEvent(e.name(), max(s, t0), min(s + d, t1), kind))
    busy = _union([(e.start_ns, e.end_ns) for e in events])
    busy_ns = sum(e - s for s, e in busy)
    ops = defaultdict(float)
    for e in events:
        ops[e.name[:200]] += (e.end_ns - e.start_ns) * 1e-9
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
    mids = sorted(((s + e) // 2, e - s) for s, e in gaps)
    idle = defaultdict(float)
    for (_, length), name in zip(mids, _innermost(host, [m for m, _ in mids])):
        idle[(name or "no host event")[:200]] += length * 1e-9
    return Trace(events=sorted(events, key=lambda e: e.start_ns), window_s=(t1 - t0) * 1e-9,
                 busy_s=busy_ns * 1e-9, device_ops=_top(ops), idle_gaps=_top(idle))


def profiled(fn, device: torch.device):
    """``fn()`` inside the stretch annotation under the profiler (CUDA
    activity on a card); returns ``(fn's result, Trace)``, the trace None
    off a card."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        with record_function(STRETCH):
            out = fn()
        if on_card:
            torch.cuda.synchronize(device)
    if not on_card:
        return out, None
    return out, reduce(prof.profiler.kineto_results.events(), device.index or 0)
