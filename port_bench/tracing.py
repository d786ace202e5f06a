"""Reading a torch.profiler trace of a traced slice: the device's busy time,
the device operations that took most time, and the idle gaps labelled by
what the host was doing.

`busy_us` is the union of the device's kernel, copy and set intervals (the
arithmetic of the repository's chip smoke, copied here); idle share =
1 - busy / window. A gap's label is the benchmark's own range open on the
host at the gap's middle (`RANGE_PREFIX`; "outside" when none) and the
innermost host operation open then ("python" when none: the interpreter
between operators).
"""

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

RANGE_PREFIX = "bench:"


@dataclass(frozen=True)
class Interval:
    name: str
    start: float     # microseconds, the profiler's clock
    end: float


def busy_us(spans: List[Interval]) -> float:
    """Microseconds covered by the union of `spans`."""
    if not spans:
        return 0.0
    ordered = sorted((s.start, s.end) for s in spans)
    total, cur_start, cur_end = 0.0, *ordered[0]
    for start, end in ordered[1:]:
        if start > cur_end:
            total += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    return total + cur_end - cur_start


def idle_gaps(spans: List[Interval], start: float, end: float) -> List[Tuple[float, float]]:
    """The stretches of [start, end] that no span covers."""
    gaps, cursor = [], start
    for s, e in sorted((s.start, s.end) for s in spans):
        if s > cursor:
            gaps.append((cursor, min(s, end)))
        cursor = max(cursor, e)
    if cursor < end:
        gaps.append((cursor, end))
    return [(a, b) for a, b in gaps if b > a]


def _innermost_at(host: List[Interval], points: List[float]) -> List[Optional[Interval]]:
    """For each of the sorted `points`, the innermost of the properly nested
    `host` intervals (one thread's) that contains it, by one sweep."""
    evs = sorted(host, key=lambda h: (h.start, -h.end))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(evs) and evs[i].start <= t:
            while stack and stack[-1].end < evs[i].start:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def label_gaps(gaps, host: List[Interval]) -> Dict[str, float]:
    """{label: seconds} of the idle gaps, by the host's state at each gap's
    middle. `host` is the benchmark thread's intervals."""
    gaps = sorted(gaps)
    mids = [(a + b) / 2 for a, b in gaps]
    ranges = _innermost_at([h for h in host if h.name.startswith(RANGE_PREFIX)], mids)
    ops = _innermost_at([h for h in host if not h.name.startswith(RANGE_PREFIX)], mids)
    out: Dict[str, float] = {}
    for (a, b), r, op in zip(gaps, ranges, ops):
        label = (r.name[len(RANGE_PREFIX):] if r else "outside") + " / " + (op.name if op else "python")
        out[label] = out.get(label, 0.0) + (b - a) / 1e6
    return out


@dataclass
class Slice:
    """What a traced slice leaves for the per-layer readers."""
    device: List[Interval]
    host: List[Interval]
    window_s: float
    units: int

    @property
    def busy_s(self) -> float:
        return busy_us(self.device) / 1e6

    def device_seconds(self, match) -> float:
        """Seconds of device operations whose name `match(name)` accepts."""
        return sum(e.end - e.start for e in self.device if match(e.name)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for e in self.device:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.end - e.start) / 1e6
        t0 = min((e.start for e in self.device + self.host), default=0.0)
        t1 = max((e.end for e in self.device + self.host), default=0.0)
        gaps = label_gaps(idle_gaps(self.device, t0, t1), self.host)
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_name), "idle_gaps": rank(gaps)}


class Tracer:
    """torch.profiler over a slice that begins and ends with the device
    drained (`start`, `stop`), and host ranges opened and closed from
    forward hooks (`enter`, `leave`)."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self._open: Dict[str, List] = {}

    @property
    def active(self):
        return self.prof is not None and self.t1 is None

    def _drain(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self._drain()
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        self._drain()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def enter(self, name: str):
        if self.active:
            cm = torch.profiler.record_function(RANGE_PREFIX + name)
            cm.__enter__()
            self._open.setdefault(name, []).append(cm)

    def leave(self, name: str):
        stack = self._open.get(name)
        if stack:
            stack.pop().__exit__(None, None, None)

    def slice(self, units: int) -> Slice:
        dev, host = [], []
        events = self.prof.events()
        # the benchmark's thread and autograd's (the backward pass), not the loader's
        threads = {e.thread for e in events
                   if e.name.startswith(RANGE_PREFIX) or e.name.startswith("autograd::")}
        for e in events:
            iv = Interval(e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not e.name.startswith(RANGE_PREFIX):   # the ranges' own device-side marks
                    dev.append(iv)
            elif not threads or e.thread in threads:
                host.append(iv)
        if not dev:
            raise RuntimeError("the profiler recorded no device operation in the traced slice")
        return Slice(dev, host, self.t1 - self.t0, units)


@contextlib.contextmanager
def hooked_ranges(tracer: Tracer, modules: Dict[str, torch.nn.Module]):
    """A host range around every forward of each named module while the
    tracer is active."""
    handles = []
    for name, m in modules.items():
        handles.append(m.register_forward_pre_hook(lambda mod, a, n=name: tracer.enter(n)))
        handles.append(m.register_forward_hook(lambda mod, a, o, n=name: tracer.leave(n)))
    try:
        yield
    finally:
        for h in handles:
            h.remove()
