"""device_ms_per_eval.sample: the card's busy milliseconds (union of the
device intervals) per evaluation of the traced slice; a guided evaluation
counts the net and its guide as one."""


def read(out, run):
    s = out.slice
    if s is None or out.unit != "eval":
        return None
    return 1e3 * s.busy_s / s.units
