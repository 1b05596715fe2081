"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over part of
the window, reduced to what the per-layer metrics and the breakdown read.

The raw events are read from the profiler's kineto results, not through
``key_averages()``, whose Python processing costs ~0.3 ms an event (a
flush of the served cell launches ~50 000 kernels). CPU operators are
recorded in the thread that starts the profiler; the CUDA runtime's calls
and the device's kernels, copies and fills in every thread.

Idle time is the part of the profiled interval in which no device
operation ran. Each idle gap is named by what the host was doing at its
middle: the innermost CPU operator then open in the thread that launched
the operation which ended the gap, and the innermost program span then
open (``repro_torch.obs`` spans, waits on a result left out), as
``span/operator``.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

TOP = 10
NAME_CHARS = 120
WAIT_SPANS = ("serve.block",)


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: int                       # kernel records (copies excluded)
    by_name: Dict[str, Tuple[int, float]]   # device op -> (count, seconds)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)
    start_perf: float = 0.0            # host clock of the interval
    stop_perf: float = 0.0
    requests: int = 0                  # answered within the interval

    def time_of(self, needles) -> Tuple[int, float]:
        """(count, seconds) of the device ops whose name holds any of
        ``needles``."""
        n, t = 0, 0.0
        for name, (c, s) in self.by_name.items():
            if any(k in name for k in needles):
                n, t = n + c, t + s
        return n, t


MARKS = ("portbench.start", "portbench.stop")


def _profile():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def warm_up(device) -> None:
    """Start and stop the profiler once around a small operation, so that
    its one-time start-up (CUPTI's) falls in set-up and not in the window.
    Call from the thread that will start the profiler."""
    import torch
    with _profile():
        torch.ones(8, device=device).sum().item()


class Profiler:
    """Starts and stops ``torch.profiler`` (from one thread) and reduces
    its trace. Two marks recorded just after the start and just before the
    stop give the interval on the trace's own clock and on the host's."""

    def __init__(self):
        self._prof = None

    def start(self) -> None:
        from torch.profiler import record_function
        self._prof = _profile()
        self._prof.start()
        with record_function(MARKS[0]):
            self.start_perf = time.perf_counter()

    def stop(self, span_records=(), span_offset_s: float = 0.0) -> Summary:
        """Stop and reduce. ``span_records`` are the program's span
        records; ``span_offset_s`` turns their ``start_s`` into the host
        clock (``time.perf_counter``)."""
        from torch.profiler import record_function
        with record_function(MARKS[1]):
            self.stop_perf = time.perf_counter()
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        marks = {e.name(): e.start_ns() for e in events
                 if e.name() in MARKS}
        if len(marks) != 2:
            raise RuntimeError(f"the trace lacks its marks: {sorted(marks)}")
        start_ns, stop_ns = marks[MARKS[0]], marks[MARKS[1]]
        spans = [(r["start_s"] + span_offset_s,
                  r["start_s"] + span_offset_s + r["duration_s"], r["name"])
                 for r in span_records if r["name"] not in WAIT_SPANS]
        return reduce(events, start_ns, stop_ns, self.start_perf,
                      self.stop_perf, spans)


def _union(intervals):
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


class _Sweep:
    """Innermost covering interval at increasing query times: ``at(t)``
    gives the name of the shortest (lo, hi, name) with lo <= t <= hi."""

    def __init__(self, items):
        self.items = sorted(items)
        self.next = 0
        self.open = []

    def at(self, t):
        while self.next < len(self.items) and self.items[self.next][0] <= t:
            self.open.append(self.items[self.next])
            self.next += 1
        self.open = [it for it in self.open if it[1] >= t]
        if not self.open:
            return None
        return min(self.open, key=lambda it: it[1] - it[0])[2]


def reduce(events, t0_ns: int, t1_ns: int, t0_perf: float, t1_perf: float,
           spans=()) -> Summary:
    """Busy time, kernel records, the top device ops and the idle time by
    host activity within [t0_ns, t1_ns] (kineto's clock, ns)."""
    from torch.autograd import DeviceType

    dev, cpu_by_tid, launch_tid = [], defaultdict(list), {}
    for e in events:
        lo, hi = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if hi <= t0_ns or lo >= t1_ns:
                continue
            corr = (e.correlation_id(), e.linked_correlation_id())
            dev.append((max(lo, t0_ns), min(hi, t1_ns), e.name(), corr))
        else:
            tid = e.start_thread_id()
            cpu_by_tid[tid].append((lo, hi, e.name()))
            if e.name().startswith("cuda"):
                launch_tid[e.correlation_id()] = tid

    by_name = defaultdict(lambda: [0, 0.0])
    kernels = 0
    for lo, hi, name, _ in dev:
        slot = by_name[name[:NAME_CHARS]]
        slot[0] += 1
        slot[1] += (hi - lo) / 1e9
        if not name.startswith(("Memcpy", "Memset")):
            kernels += 1
    busy = _union([(lo, hi) for lo, hi, _, _ in dev])
    busy_s = sum(hi - lo for lo, hi in busy) / 1e9

    # idle gaps, each ending where a device op starts (or at t1), named
    # at their middles, which increase
    ends_at = {}
    for lo, _, _, corr in sorted(dev, key=lambda d: d[0], reverse=True):
        ends_at[lo] = corr
    threads = {tid: _Sweep(items) for tid, items in cpu_by_tid.items()}
    span_sweep = _Sweep(spans)
    idle = defaultdict(float)
    edge = t0_ns
    for lo, hi in busy + [[t1_ns, t1_ns]]:
        if lo > edge:
            mid = (edge + lo) / 2
            tid = next((launch_tid[c] for c in ends_at.get(lo, ())
                        if c in launch_tid), None)
            op = threads[tid].at(mid) if tid in threads else None
            sp = span_sweep.at(t0_perf + (mid - t0_ns) / 1e9)
            idle[f"{sp or 'no span'}/{op or 'no op'}"] += (lo - edge) / 1e9
        edge = max(edge, hi)

    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return Summary(
        window_s=(t1_ns - t0_ns) / 1e9, busy_s=busy_s, kernels=kernels,
        by_name={k: (c, s) for k, (c, s) in by_name.items()},
        device_ops=[[k, s] for k, (c, s) in ranked[:TOP]],
        idle_gaps=[[k, s] for k, s in sorted(idle.items(),
                                             key=lambda kv: -kv[1])[:TOP]],
        start_perf=t0_perf, stop_perf=t1_perf)


def trace_fields(summary: Optional[Summary]) -> dict:
    """The result line's ``device`` additions and ``breakdown``."""
    if summary is None:
        return {}
    return {"busy_s": summary.busy_s, "window_s": summary.window_s,
            "breakdown": {"device_ops": summary.device_ops,
                          "idle_gaps": summary.idle_gaps}}
