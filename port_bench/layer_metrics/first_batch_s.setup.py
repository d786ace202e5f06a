"""first_batch_s.setup: the seconds of the run's first batch through the
sampling entry (its first `generate.batch` span, `port_bench/spans.py`): the
benchmark's warm call, which inside the set-up that `setup_s` times loads the
kernel library, starts the loader and meets each shape's first cuDNN choice
(the first two only in a process's first run)."""

from port_bench import spans


def read(out, run):
    first = spans.first_batch(spans.recorded(run))
    return None if first is None else (first.end - first.start) / 1e9
