"""Parameter table and operation counts.

Counterpart of vivid_tpu/core/summary.py:
  * `param_table` / `count_params` over the port's state_dict: the names go
    through `compat.from_jax.to_jax` into the JAX package's tree, so both
    packages print the same table for the same model (the Fourier features,
    buffers here, are parameters there);
  * `flops_analysis`, the counterpart of XLA's cost analysis (the
    reference's DeepSpeed profiler): the formulas of
    `torch.utils.flop_counter.FlopCounterMode` count the operators
    (products, convolutions, attention), and the hand-written kernels, which
    they cannot see, add their own (`kernels/flash.py` `flops`). An
    attention operator of `kernels/flash.py` is counted by its kernel's
    tally where a kernel ran, else by its formula: once either way.
"""

from typing import Callable, Dict

import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from vivid_tpu_torch.compat.from_jax import to_jax
from vivid_tpu_torch.kernels import flash


def param_table(state: Dict, max_depth: int = 2) -> str:
    """Counts grouped to the first `max_depth` segments of the JAX tree
    path; `state` maps names to tensors (a state_dict)."""
    counts: Dict[str, int] = {}

    def walk(node, path):
        for k, v in node.items():
            p = path + (k,)
            if isinstance(v, dict):
                walk(v, p)
            else:
                key = "/".join(p[:max_depth])
                counts[key] = counts.get(key, 0) + int(np.prod(v.shape))

    walk(to_jax(state), ())
    total = sum(counts.values())
    width = max((len(k) for k in counts), default=10) + 2
    lines = [f"{'Module':<{width}}{'Params':>12}"]
    lines.append("-" * (width + 12))
    for k in sorted(counts):
        lines.append(f"{k:<{width}}{counts[k]:>12,}")
    lines.append("-" * (width + 12))
    lines.append(f"{'Total':<{width}}{total:>12,}")
    return "\n".join(lines)


def count_params(state: Dict) -> int:
    return sum(int(t.numel()) for t in state.values())


class _OperatorCounter(TorchDispatchMode):
    """Adds up FlopCounterMode's formula for each operator that has one. The
    mode itself first runs an operator's decomposition where there is one,
    which rounds otherwise than the operator: counted under it, a training
    step's gradients change in the last bits. Here every operator runs as
    it would without the counter."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ours = func in flash.OPERATORS
        tallied = sum(flash.flops.values()) if ours else 0
        out = func(*args, **kwargs)
        if ours and sum(flash.flops.values()) != tallied:
            return out   # a kernel ran: `flops_analysis` adds its tally
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        return out


def flops_analysis(fn: Callable, *args, **kwargs) -> dict:
    """Run fn(*args, **kwargs) once and count its operations (2 a
    multiply-add): {"flops": the total, "operators": the operators' count,
    "kernels": {kernel: its count}, "result": fn's result}. Unlike XLA's
    analysis, which compiles without running, this runs `fn`; its results
    are what they are without the count."""
    before = dict(flash.flops)
    with _OperatorCounter() as counter:
        result = fn(*args, **kwargs)
    kernels = {k: n - before[k] for k, n in flash.flops.items() if n != before[k]}
    return {"flops": counter.flops + sum(kernels.values()), "operators": counter.flops,
            "kernels": kernels, "result": result}

