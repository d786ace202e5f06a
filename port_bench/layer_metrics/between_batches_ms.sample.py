"""between_batches_ms.sample: the median, over consecutive batches of the
window, of the host's milliseconds from the end of one batch's
`generate.decode` to the start of the next batch's `generate.sample` (the
program's spans, `port_bench/spans.py`). The decode's copy to the host has
drained the card's stream, so the card idles through this interval but for
the next batch's few small preparing kernels: PNGs, the loader's wait, the
inputs' encoding, the benchmark's loop between batches."""

import statistics

from port_bench import spans


def read(out, run):
    num_steps = int(run.config["sampling"]["num_steps"])
    gaps = spans.between_batches_ms(spans.recorded(run), num_steps)
    return statistics.median(gaps) if gaps else None
