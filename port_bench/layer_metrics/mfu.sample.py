"""mfu.sample: the model operations of the window's evaluations (from the
configuration's shapes, counts/model.py) over the window's seconds, as a
share of one card's bf16 dense peak."""

from port_bench.counts import PEAKS


def read(out, run):
    if out.unit != "eval" or out.window_s <= 0:
        return None
    return 100 * out.flops_per_unit * out.units / out.window_s / PEAKS["bf16_flops"]
