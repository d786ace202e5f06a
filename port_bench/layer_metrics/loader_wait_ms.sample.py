"""loader_wait_ms.sample: the loader's steady wait. The mean, over the
window's batches after its first, of the milliseconds the sampling entry's
thread waited on the loader's prefetch queue for the batch (the program's
`loader.wait` spans under each batch's root, `port_bench/spans.py`). The
window's first batch is left out: the loader starts with the call, so that
batch waits for its start, and a mean over a window of three or four batches
would move with their number. None where the window has no second batch."""

from port_bench import spans


def read(out, run):
    recorded = spans.recorded(run)
    window = spans.window(recorded, int(run.config["sampling"]["num_steps"]))
    if len(window) < 2:
        return None
    waits = [sum(s.end - s.start for s in spans.parts(recorded, b).get("loader.wait", [])) / 1e6
             for b in window[1:]]
    return sum(waits) / len(waits)
