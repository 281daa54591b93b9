"""Host spans of the harness, and the reduction of a device trace.

A traced run records the card's activity with ``torch.profiler`` (CUPTI;
device activity only, so the host pays no cost per operator) and reads
the raw events, whose timestamps are on the host's wall clock
(``time.time_ns``).  The harness records its own spans on the same
clock, around the calls it makes into the program, and the program's
own spans (monotonic clock) are moved onto it.  From these:

* ``busy_s``: the union of the intervals in which a kernel, a copy or a
  memset ran, inside the window; ``window_s`` the window's length;
* the seconds of the kernels whose names a predicate picks;
* ``breakdown``: the device operations that took most time, and the idle
  gaps summed by the innermost host span open at each gap's middle.
"""
from __future__ import annotations

import bisect
import contextlib
import re
import time

__all__ = ["Spans", "DeviceTrace", "start_device_trace", "stop_device_trace",
           "short_name", "setup_parts"]

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host spans on the wall clock, in nanoseconds: (name, start, end)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.items: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))

    def add_program_events(self, events: list[dict], mono_to_wall_ns: int,
                           names=None) -> None:
        """Add the program tracer's complete spans (``ph == "X"``, ``ts``
        and ``dur`` in us of the monotonic clock)."""
        for ev in events:
            if ev.get("ph") != "X" or (names and ev["name"] not in names):
                continue
            t0 = int(ev["ts"] * 1e3) + mono_to_wall_ns
            self.items.append((ev["name"], t0, t0 + int(ev["dur"] * 1e3)))


def setup_parts(marks: list[float], names: tuple) -> dict:
    """The seconds of each stage of set-up, ``setup_<name>_s``, from
    successive ``time.perf_counter`` marks; ``setup_start_s`` is the
    first mark."""
    out = {"setup_start_s": marks[0]}
    out.update({f"setup_{n}_s": b - a
                for n, a, b in zip(names, marks, marks[1:])})
    return out


def short_name(name: str) -> str:
    """A kernel's name without its parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(", 1)[0].strip()
    return re.sub(r"^void\s+", "", name)[:120]


def start_device_trace():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop_device_trace(prof) -> list[tuple[str, int, int]]:
    """Stop the profiler; the device's kernels, copies and memsets as
    (name, start ns, end ns) on the wall clock."""
    prof.__exit__(None, None, None)
    out = []
    for e in prof.profiler.kineto_results.events():
        if _is_device_op(e):
            s = int(e.start_ns())
            out.append((e.name(), s, s + int(e.duration_ns())))
    return out


def _is_device_op(e) -> bool:
    """A kernel, copy or memset: not a host event, not a range that a
    ``record_function`` left on the device's timeline."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in _DEVICE_KINDS
    import torch

    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    annotation = getattr(e, "is_user_annotation", None)
    return not (annotation is not None and annotation())


class DeviceTrace:
    """Device events clipped to the window [t0, t1] (ns, wall clock)."""

    def __init__(self, events, t0_ns: int, t1_ns: int):
        self.t0, self.t1 = int(t0_ns), int(t1_ns)
        self.events = sorted(
            (n, max(s, self.t0), min(e, self.t1)) for n, s, e in events
            if e > self.t0 and s < self.t1)
        self.window_s = (self.t1 - self.t0) / 1e9
        self._busy = self._union()

    def _union(self) -> list[tuple[int, int]]:
        iv = sorted((s, e) for _, s, e in self.events)
        out: list[list[int]] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy) / 1e9

    def seconds(self, pred) -> float:
        """Summed time of the events whose full name ``pred`` accepts."""
        return sum(e - s for n, s, e in self.events if pred(n)) / 1e9

    def top_ops(self, k: int = 10) -> list[list]:
        by: dict[str, int] = {}
        for n, s, e in self.events:
            key = short_name(n)
            by[key] = by.get(key, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns / 1e9] for n, ns in top]

    def gaps(self) -> list[tuple[int, int]]:
        edges = [self.t0] + [x for iv in self._busy for x in iv] + [self.t1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def idle_by_host(self, spans: Spans, k: int = 10) -> list[list]:
        """Idle seconds summed by the innermost host span open at each
        gap's middle ("no span" where none is)."""
        items = sorted(spans.items, key=lambda x: (x[1], -x[2]))
        starts = [s for _, s, _ in items]
        by: dict[str, int] = {}
        for g0, g1 in self.gaps():
            mid = (g0 + g1) // 2
            label = "no span"
            i = bisect.bisect_right(starts, mid) - 1
            # the latest-starting span that still holds the middle is the
            # innermost (host spans nest); a few steps back find it
            for j in range(i, max(i - 4096, -1), -1):
                if items[j][2] >= mid:
                    label = items[j][0]
                    break
            by[label] = by.get(label, 0) + (g1 - g0)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns / 1e9] for n, ns in top]
