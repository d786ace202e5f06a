"""The benchmark's door to the program's span recorder
(`vivid_tpu_torch.core.trace`), read after a run in the run's process, as
`program.py` is the door to the rest of the program.

The sampling entry makes one root span `generate.batch` a batch (attributes
`batch_idx`, `num_steps`, `call`: the id of the `generate_images_nvs` call)
over its parts (`loader.wait`, `generate.prepare`, `generate.sample`,
`generate.decode`, `generate.png`, `generate.barrier`). Times are the host's
`time.perf_counter_ns()`, the clock of the harness's window. A run reads the
spans that started after its own `t_start` alone: a process that runs the
cell more than once holds the earlier runs' spans too.

A program without the recorder (an older checkout) gives no spans: every
function here then returns nothing, and the readers None.
"""

from typing import Dict, List, Optional


def recorded(run) -> list:
    """The program's finished spans of `run` (those started since its
    `t_start`), or [] where the program records none."""
    try:
        from vivid_tpu_torch.core import trace
    except ImportError:
        return []
    spans = getattr(trace, "spans", None)
    if not callable(spans):
        return []
    since = run.t_start * 1e9
    return [s for s in spans() if s.start >= since]


def batches(spans: list) -> list:
    """The `generate.batch` spans, by start."""
    return sorted((s for s in spans if s.name == "generate.batch"), key=lambda s: s.start)


def window(spans: list, num_steps: int) -> list:
    """The window's batches: the complete (no error) `generate.batch` spans of
    the `generate_images_nvs` call that has the most of them at `num_steps`,
    by batch index. (The warm call runs other steps; the traced slice's batch
    ends with an error.)"""
    by_call: Dict[int, list] = {}
    for s in batches(spans):
        if s.error is None and s.attrs.get("num_steps") == num_steps:
            by_call.setdefault(s.attrs.get("call"), []).append(s)
    if not by_call:
        return []
    best = max(by_call.values(), key=len)
    return sorted(best, key=lambda s: s.attrs["batch_idx"])


def parts(spans: list, batch) -> Dict[str, list]:
    """The spans under a batch's root, by name, by start."""
    out: Dict[str, list] = {}
    for s in sorted(spans, key=lambda s: s.start):
        if s.root == batch.id and s.id != batch.id:
            out.setdefault(s.name, []).append(s)
    return out


def between_batches_ms(spans: list, num_steps: int) -> List[float]:
    """For each pair of consecutive window batches, the host ms from the end of
    one's `generate.decode` to the start of the next one's `generate.sample`."""
    win = window(spans, num_steps)
    out = []
    for a, b in zip(win, win[1:]):
        if b.attrs["batch_idx"] != a.attrs["batch_idx"] + 1:
            continue
        decode = parts(spans, a).get("generate.decode")
        sample = parts(spans, b).get("generate.sample")
        if decode and sample:
            out.append((sample[0].start - decode[-1].end) / 1e6)
    return out


def first_batch(spans: list) -> Optional[object]:
    """The first `generate.batch` span, if it ended without error."""
    found = batches(spans)
    return found[0] if found and found[0].error is None else None
