"""Tools of the port, run as `python -m vivid_tpu_torch.tools.<name>`: the
kernel labs (check a kernel against its plain version, then time it on the
card), the convergence proof (`overfit_smoke`), the memory reports
(`mem_report`, `guided_mem`), the serving-protocol snapshots
(`make_protocol_snapshots`) and the smoke's helpers."""

import statistics

import torch


def tool_device(name):
    """The device a tool runs on: the card, unless `name` asks for the CPU
    (a lab's parity checks alone: a time is the card's). Raises without a
    card."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card found; pass --device cpu to run on the CPU")
    return torch.device(name or "cuda")


def cuda_ms(fn, reps: int = 10, calls: int = 1) -> float:
    """Median of `reps` times by CUDA events, after one warm-up, each of
    `calls` calls back to back and divided by them: one call includes the
    host's time to launch it, many back to back hide it behind the card's."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def normalize_rows(x, eps: float = 1e-4):
    """Pixel norm of the last axis, as the blocks normalise q and k."""
    x32 = x.float()
    norm = torch.linalg.vector_norm(x32, dim=-1, keepdim=True)
    return (x32 / (eps + norm / x.shape[-1] ** 0.5)).to(x.dtype)


def rel_l2(got, want) -> float:
    return ((got.double() - want.double()).norm() / want.double().norm()).item()
