"""Device and host records of a traced stretch after the window, and the
readings the per-layer metrics share (busy time, operations a step, the
breakdown, a call's device busy time, the host's time to issue a call).

Frozen from ``chip_smoke.py`` (``traces``, ``union_us``, ``device_ms``):
the profiler's raw records are read (its parsed ``events()`` take ~20x
longer to build), busy time is the union of the device intervals, and a
call is queued behind a spin kernel so that the device runs it without
waiting on the host (here: so that the host's issuing is timed without
the device holding it back).
"""

from __future__ import annotations

import bisect
import re
import statistics
from collections import defaultdict
from typing import NamedTuple

class Record(NamedTuple):
    name: str
    start: float  # us
    end: float


def union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def busy_intervals(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Profiler:
    """``torch.profiler`` over the CUDA activity (device records and the
    host's CUDA runtime calls; the CPU activity's operator records cost
    the host more than the step's own work), started and stopped around a
    stretch of the window. ``warm()`` runs a short trace in set-up so
    that the first trace does not pay the tracer's start."""

    def __init__(self, torch):
        self.torch = torch

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA])

    def warm(self):
        torch = self.torch
        with self._profile():
            torch.ones(8, device="cuda").sum()
            torch.cuda.synchronize()

    def start(self):
        self.prof = self._profile()
        self.prof.__enter__()

    def stop(self):
        """(device records, host records) of the stretch."""
        from torch.autograd import DeviceType

        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            r = Record(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            (dev if e.device_type() == DeviceType.CUDA else host).append(r)
        del self.prof
        return dev, host


def clean(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


class Trace:
    """The records of ``steps`` steps traced over ``window_s`` seconds."""

    def __init__(self, dev, host, steps: int, window_s: float):
        self.dev, self.host = dev, host
        self.steps = steps
        self.window_s = window_s
        self.busy_s = union_us([(r.start, r.end) for r in dev]) / 1e6

    def device_s(self, marks) -> float | None:
        """Seconds of the device records whose name holds a mark; None
        when no record does."""
        hit = [r for r in self.dev if any(m in r.name for m in marks)]
        if not hit:
            return None
        return sum(r.end - r.start for r in hit) / 1e6

    def breakdown(self) -> dict:
        """The ten device items that took most time, and the ten longest
        idle stretches by what the host was doing (the innermost host
        record around the gap's midpoint)."""
        by = defaultdict(float)
        for r in self.dev:
            by[clean(r.name)] += (r.end - r.start) / 1e6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        busy = busy_intervals([(r.start, r.end) for r in self.dev])
        host = sorted(self.host, key=lambda r: r.start)
        starts = [r.start for r in host]
        gaps = defaultdict(float)
        for (a0, a1), (b0, _) in zip(busy, busy[1:]):
            mid = 0.5 * (a1 + b0)
            k = bisect.bisect_right(starts, mid) - 1
            name = "no_operator"
            for idx in range(k, max(k - 64, -1), -1):
                if host[idx].end >= mid:
                    name = clean(host[idx].name)
                    break
            gaps[name] += (b0 - a1) / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


def busy_ms(torch, fn, reps=5):
    """Device busy time of one call: the union of the device intervals of
    ``reps`` calls under the profiler, over ``reps``. The host's issuing
    (slowed by the profiler) adds gaps, never busy time."""
    fn()
    torch.cuda.synchronize()
    prof = Profiler(torch)
    prof.start()
    for _ in range(reps):
        fn()
    dev, _host = prof.stop()
    if not dev:
        return None
    return union_us([(r.start, r.end) for r in dev]) / 1e3 / reps


def host_ms(torch, fn, reps=7, tries=4):
    """Median over ``reps`` samples of the host's wall time to issue one
    call, untraced: each call is issued behind a spin kernel, and a sample
    counts only if the spin outlasted the issuing, so the device never
    held the host back (a full launch queue or a wait would). None when a
    call synchronises with the host (sync debug mode "error") or no
    sample is covered in ``tries`` doublings of the spin."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = max(10_000_000, int(6e9 * issue_s))
    samples, misses = [], 0
    while len(samples) < reps:
        torch.cuda._sleep(spin)
        mark = torch.cuda.Event()
        mark.record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            fn()
            dt = time.perf_counter() - t0
        except RuntimeError:
            return None
        finally:
            torch.cuda.set_sync_debug_mode("default")
        covered = not mark.query()
        torch.cuda.synchronize()
        if covered:
            samples.append(dt * 1e3)
        else:
            misses += 1
            if misses > tries:
                return None
            spin *= 2
    return statistics.median(samples)
