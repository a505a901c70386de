"""The traced run: `record_function` ranges that the benchmark opens and
closes around the port's layers (module hooks, a wrapped method, the
optimizer's step hooks), `torch.profiler` over a part of the window, and
the reduction of its device events to what the per-layer readers read."""

from __future__ import annotations

import bisect
import re
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

PREFIX = "bench::"
WINDOW = PREFIX + "window"
CUDA = torch.autograd.DeviceType.CUDA
_API = re.compile(r"^cu(da)?[A-Z]")  # CUDA runtime and driver calls: cudaLaunchKernel, cuLaunchKernelEx


def _kind(e) -> str:
    """"kernel", "copy" (memcpy, memset), "api" (a CUDA runtime or driver
    call on the host), "range" (a host annotation) or "op" (anything else on
    the host). By device and name, which every torch version gives."""
    name = e.name()
    if e.device_type() == CUDA:
        if e.is_user_annotation():
            return "device_range"
        return "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"
    if e.is_user_annotation():
        return "range"
    return "api" if _API.match(name) else "op"


class Ranges:
    """Named ranges around calls into the port, installed for the traced
    part of a run only."""

    def __init__(self) -> None:
        self._undo: List[Callable[[], None]] = []

    def module(self, mod: torch.nn.Module, name: str) -> None:
        """A range over each call of `mod` (its forward hooks)."""
        stack = []

        def pre(_m, _args):
            rf = record_function(PREFIX + name)
            rf.__enter__()
            stack.append(rf)

        def post(_m, _args, _out):
            stack.pop().__exit__(None, None, None)

        for h in (mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)):
            self._undo.append(h.remove)

    def method(self, obj: object, attr: str, name: str) -> None:
        """A range over each call of `obj.attr` (a method the port calls
        directly, not through `__call__`)."""
        inner = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            with record_function(PREFIX + name):
                return inner(*args, **kwargs)

        setattr(obj, attr, wrapped)
        self._undo.append(lambda: delattr(obj, attr))

    def optimizer(self, opt: torch.optim.Optimizer, name: str = "optimizer") -> None:
        stack = []

        def pre(_opt, _args, _kwargs):
            rf = record_function(PREFIX + name)
            rf.__enter__()
            stack.append(rf)

        def post(_opt, _args, _kwargs):
            stack.pop().__exit__(None, None, None)

        for h in (opt.register_step_pre_hook(pre), opt.register_step_post_hook(post)):
            self._undo.append(h.remove)

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()


def start_profiler() -> profile:
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _union(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of `intervals` clipped to [lo, hi], sorted."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Trace:
    """What the readers read of one traced window."""

    def __init__(self, prof: profile) -> None:
        events = prof.profiler.kineto_results.events()
        kinds = [_kind(e) for e in events]
        self.activity_counts = Counter(kinds)
        win = [e for e in events if e.name() == WINDOW]
        if not win:
            raise RuntimeError("the traced window's range is missing from the trace")
        self.lo, self.hi = win[0].start_ns(), win[0].end_ns()
        self.window_s = (self.hi - self.lo) * 1e-9
        device = [(e, k) for e, k in zip(events, kinds) if k in ("kernel", "copy")]
        launches = {e.correlation_id(): e.start_ns() for e, k in zip(events, kinds) if k == "api"}
        ranges: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        for e, k in zip(events, kinds):
            if k == "range" and e.name().startswith(PREFIX) and e.name() != WINDOW:
                ranges[e.name()[len(PREFIX):]].append((e.start_ns(), e.end_ns()))
        starts = {k: sorted(v) for k, v in ranges.items()}
        # device seconds by kernel name, and by the range its launch lay in
        self.kernels: Dict[str, List[float]] = defaultdict(list)
        self.range_s: Dict[str, float] = defaultdict(float)
        self.unattributed_s = 0.0
        intervals = []
        for e, k in device:
            a, b = e.start_ns(), e.end_ns()
            if b <= self.lo or a >= self.hi:
                continue
            dur = e.duration_ns() * 1e-9
            intervals.append((a, b))
            if k == "kernel":
                self.kernels[e.name()].append(dur)
            t = launches.get(e.correlation_id())
            if t is None:
                self.unattributed_s += dur
                continue
            for name, spans in starts.items():
                i = bisect.bisect_right(spans, (t, float("inf"))) - 1
                if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                    self.range_s[name] += dur
        self.busy = _union(intervals, self.lo, self.hi)
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-9
        self._host = sorted((e.start_ns(), e.end_ns(), e.name())
                            for e, k in zip(events, kinds)
                            if k in ("op", "range") and e.name() != WINDOW)

    def launches(self, pattern: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name matches."""
        rx = re.compile(pattern)
        hits = [d for name, ds in self.kernels.items() if rx.search(name) for d in ds]
        return len(hits), sum(hits)

    def top_ops(self, n: int = 10) -> List[list]:
        tot = sorted(((sum(ds), name) for name, ds in self.kernels.items()), reverse=True)
        return [[name, s] for s, name in tot[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest idle gaps of the device in the window, each named by
        the innermost host range or op that was running when it began."""
        gaps, prev = [], self.lo
        for a, b in self.busy:
            if a > prev:
                gaps.append((prev, a))
            prev = b
        if self.hi > prev:
            gaps.append((prev, self.hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            out.append([self._host_at(a), (b - a) * 1e-9])
        return out

    def _host_at(self, t: int) -> str:
        i = bisect.bisect_right(self._host, (t, float("inf"), "")) - 1
        best: Optional[Tuple[int, int, str]] = None
        while i >= 0 and self._host[i][0] >= t - 5 * 10**7:  # ops begun up to 50 ms before
            s, e, name = self._host[i]
            if s <= t <= e and (best is None or s > best[0]):
                best = (s, e, name)
            i -= 1
        return "host: " + (best[2] if best else "outside any op")
