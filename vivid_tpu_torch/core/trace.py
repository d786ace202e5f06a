"""Profiling and the program's spans.

Counterpart of vivid_tpu/core/trace.py on `torch.profiler`, with a span
recorder beside it:

    from vivid_tpu_torch.core.trace import span, spans, trace
    with span("generate.batch", rows=32):     # always recorded, in memory
        ...
    with trace("traces/", enabled=True) as prof:
        state = step_fn(state, batch, generator)
    # prof.trace_file: a Chrome / Perfetto trace (JSON) in traces/

`span(name, **attrs)` times a block (or, as a decorator, each call of a
function) on the host's monotonic clock: its name, start and end
(`time.perf_counter_ns()`), thread, id, the id of the span it opened in
(one stack a thread) and the id of its root. The spans of one unit of work,
one batch of samples or one training step, share the root's id, and counts
ride on them as attributes. Work handed to another thread names its span's
parent (`span(..., parent=root)`): opened on an empty stack, the span takes
that parent and its root, and may end after its root does (the sampling
entry's `generate.png`, written on a writer thread while the next batch
samples). A span that ends by an exception carries the
exception's type name in `error`. Finished spans go into a bounded deque in
memory (`MAX_SPANS`, the oldest dropped first): `spans()` lists them and
`drain()` takes them out. Nothing is written to disk.

`trace` records the host's operators and, where there is a card, its
kernels. Inside it every span is also a `torch.profiler.record_function`
range of the same name (the trace keeps no attributes), so the exported
trace puts the program's spans and the card's kernels on one timeline.
Outside it spans open no range: a profiler that another tool runs sees none
of them.
"""

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import List, Optional

import torch

MAX_SPANS = 65536

_finished = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()
_tracing = False          # inside `trace()`: spans open profiler ranges


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One timed block of the program; see the module's docstring. A span
    is entered once; as a decorator it makes a fresh one for each call."""

    __slots__ = ("name", "attrs", "start", "end", "id", "parent", "root", "thread", "error",
                 "_outer", "_range")

    def __init__(self, name: str, attrs: dict, parent: Optional["Span"] = None):
        self.name, self.attrs, self._outer = name, attrs, parent
        self.start = self.end = None          # ns, time.perf_counter_ns()
        self.id = self.parent = self.root = self.thread = None
        self.error: Optional[str] = None
        self._range = None

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with Span(self.name, dict(self.attrs), self._outer):
                return fn(*args, **kwargs)
        return wrapper

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else self._outer
        self.id = next(_ids)
        self.parent = outer.id if outer is not None else None
        self.root = outer.root if outer is not None else self.id
        self.thread = threading.get_ident()
        if _tracing:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, kind, value, tb):
        self.end = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if kind is not None:
            self.error = kind.__name__
        if self._range is not None:
            self._range.__exit__(kind, value, tb)
            self._range = None
        _finished.append(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, root={self.root}, "
                f"attrs={self.attrs}, error={self.error})")


def span(name: str, parent: Optional[Span] = None, **attrs) -> Span:
    """A span `name` with counts `attrs` (a context manager or a decorator);
    the span's `attrs` may be added to while it is open. `parent`, an
    entered span, is its parent where this thread has no open span (work
    handed to another thread)."""
    return Span(name, attrs, parent)


def spans() -> List[Span]:
    """The finished spans held, oldest first by end."""
    return list(_finished)


def drain() -> List[Span]:
    """The finished spans held, taken out of the recorder."""
    out = []
    while True:
        try:
            out.append(_finished.popleft())
        except IndexError:
            return out


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the block; on exit write `trace_<pid>_<ms>.json` into
    `log_dir` and set the profiler's `trace_file` to its path. Yields the
    `torch.profiler.profile` (None when not `enabled`)."""
    global _tracing
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        outer, _tracing = _tracing, True
        try:
            yield prof
        finally:
            _tracing = outer
    prof.trace_file = os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(prof.trace_file)
