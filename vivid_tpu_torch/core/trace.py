"""Profiling helpers: traces, ranges and phase timers.

Counterpart of vivid_tpu/core/trace.py on `torch.profiler`:

    from vivid_tpu_torch.core.trace import annotate, trace
    with trace("traces/", enabled=True) as prof:
        state = step_fn(state, batch, generator)
    # prof.trace_file: a Chrome / Perfetto trace (JSON) in traces/

`trace` records the host's operators and, where there is a card, its
kernels; `annotate(name)` puts a function's calls in a named range of the
trace (`torch.profiler.record_function`); `phase_timer` reports a host
phase's wall time as `Timing/<name>_sec` into the stats stream.
"""

import contextlib
import functools
import os
import time
from typing import Optional

import torch

from vivid_tpu_torch.core import stats as stats_mod


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the block; on exit write `trace_<pid>_<ms>.json` into
    `log_dir` and set the profiler's `trace_file` to its path. Yields the
    `torch.profiler.profile` (None when not `enabled`)."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.trace_file = os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(prof.trace_file)


@contextlib.contextmanager
def phase_timer(name: str, stats: Optional[stats_mod.Stats] = None):
    """Times a host-side phase and reports 'Timing/<name>_sec'."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        (stats or stats_mod.default_stats).report(f"Timing/{name}_sec",
                                                  time.perf_counter() - t0)


def annotate(name: str):
    """Decorator: each call of the function is a range `name` in a trace."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco
