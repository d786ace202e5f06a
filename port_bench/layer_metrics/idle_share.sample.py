"""idle_share.sample: the share of the window's time in which no kernel, copy
or set ran on the card. The device's busy time an evaluation comes from the
traced slice (the union of its device intervals over its evaluations, which
the profiler does not inflate); the wall time an evaluation from the untraced
window before it (its seconds over its evaluations, PNGs and loading
included), since the profiler slows the host and would inflate the idle
share of the traced slice itself. 1 - busy / wall, per evaluation."""


def read(out, run):
    s = out.slice
    if s is None or out.unit != "eval" or s.units <= 0 or out.units <= 0 or out.window_s <= 0:
        return None
    return 100 * (1 - (s.busy_s / s.units) / (out.window_s / out.units))
