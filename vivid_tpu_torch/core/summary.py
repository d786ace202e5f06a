"""Parameter table of a model, in the JAX package's layout.

Counterpart of vivid_tpu/core/summary.py `param_table` / `count_params`
over the port's state_dict: the names go through `compat.from_jax.to_jax`
into the JAX package's tree, so both packages print the same table for the
same model (the Fourier features, buffers here, are parameters there).
XLA's cost analysis (`flops_analysis`) has no counterpart.
"""

from typing import Dict

import numpy as np

from vivid_tpu_torch.compat.from_jax import to_jax


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
