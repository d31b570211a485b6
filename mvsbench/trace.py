"""Spans around the program's modules and the reduction of a profiler
trace to device busy time, per-span kernel time and a breakdown.

A span is a set of the program's modules picked by a pattern over their
names (the reference checkpoint's state-dict prefixes). Forward hooks
that the benchmark registers record a CUDA event at each call's entry and
exit, so a span's time is the card's time between them, summed over the
window; while a profiler runs, each call is also a ``record_function``
range, which the profiler projects onto the device timeline, and the
kernels that run inside it are the span's, whatever their names.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

import torch

LABEL = "mvsbench::"


class Spans:
    def __init__(self, model: torch.nn.Module, patterns: dict[str, str]):
        self.records: dict[str, list] = defaultdict(list)
        self.annotate = False
        self.handles = []
        for name, module in model.named_modules():
            for span, pattern in patterns.items():
                if re.fullmatch(pattern, name):
                    self.handles.append(module.register_forward_pre_hook(self._enter(span)))
                    self.handles.append(module.register_forward_hook(self._leave(span)))
        self._open: dict[int, list] = defaultdict(list)

    def _enter(self, span):
        def hook(module, args):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            rf = None
            if self.annotate:
                rf = torch.autograd.profiler.record_function(LABEL + span)
                rf.__enter__()
            self._open[id(module)].append((span, start, rf))
        return hook

    def _leave(self, span):
        def hook(module, args, out):
            span_, start, rf = self._open[id(module)].pop()
            if rf is not None:
                rf.__exit__(None, None, None)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.records[span_].append((start, end))
        return hook

    def reset(self):
        self.records.clear()

    def totals_ms(self) -> dict[str, float]:
        """Milliseconds on the card per span, summed over every call since
        the last reset (call after a synchronise)."""
        return {span: sum(s.elapsed_time(e) for s, e in recs) for span, recs in self.records.items()}

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []


def busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (as the port's
    ``tools/profile.py::busy_us``)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _host_label(cpu: list, starts: list, t: float) -> str:
    """The innermost host event running at time t."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 5000, -1), -1):
        if cpu[j][1] >= t:
            return cpu[j][2]
    return "host: no traced op"


def summarise(prof, top: int = 10) -> dict:
    """From a finished ``torch.profiler.profile``: busy microseconds (the
    union of kernel, copy and set intervals), each span's kernel
    microseconds and call count, the device operations that took most
    time, and idle time by the innermost host op running at the start of
    each of the 300 longest gaps."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events if e.device_type == cuda]
    notes = [e for e in device if e.name.startswith(LABEL)]
    ops = [e for e in device if not e.name.startswith(LABEL)]
    spans: dict[str, dict] = {}
    if not ops:
        return {"busy_us": 0.0, "spans": spans, "device_ops": [], "idle_gaps": []}
    by_span: dict[str, list] = defaultdict(list)
    for e in notes:
        by_span[e.name[len(LABEL):]].append((e.time_range.start, e.time_range.end))
    for span, ivs in by_span.items():
        ranges = merged(ivs)
        starts = [s for s, _ in ranges]
        us = 0.0
        for e in ops:
            mid = 0.5 * (e.time_range.start + e.time_range.end)
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and mid <= ranges[i][1]:
                us += e.time_range.elapsed_us()
        spans[span] = {"kernel_us": us, "calls": len(ivs)}
    by_name: dict[str, float] = defaultdict(float)
    for e in ops:
        by_name[e.name[:100]] += e.time_range.elapsed_us()
    intervals = [(e.time_range.start, e.time_range.end) for e in ops]
    busy = merged(intervals)
    cpu = sorted((e.time_range.start, e.time_range.end, e.name[:100]) for e in events
                 if e.device_type != cuda)
    starts = [c[0] for c in cpu]
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]), reverse=True)
    idle: dict[str, float] = defaultdict(float)
    for length, t in gaps[:300]:
        idle[_host_label(cpu, starts, t)] += length
    return {
        "busy_us": busy_us(intervals),
        "spans": spans,
        "device_ops": [[n, us / 1e6] for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, us / 1e6] for n, us in sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
    }
