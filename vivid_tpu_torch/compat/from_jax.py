"""The JAX package's parameter tree <-> the port's state_dict.

The names and layouts are those of vivid_tpu/compat/torch_export.py
`tree_to_torch_state` (the reference's own): tree keys join with ".", the
"enc/<block>" and "dec/<block>" keys split at "/", leaf "w" becomes
"weight", conv HWIO -> OIHW and linear [in, out] -> [out, in]; gains and
Fourier buffers pass through. With those, `load_state_dict(strict=True)` is
the whole bridge. The tree holds numpy arrays (a snapshot's `ema`).
"""

from typing import Dict

import numpy as np
import torch


def from_jax(params) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays -> {reference name: fp32 tensor}."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k.replace("/", ".") + ".")
                continue
            arr = np.asarray(v, np.float32)
            if k == "w":
                if arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
                elif arr.ndim == 2:
                    arr = arr.transpose(1, 0)                # [in,out] -> [out,in]
                out[prefix + "weight"] = torch.tensor(arr)
            else:
                out[prefix + k] = torch.tensor(arr)

    walk(params, "")
    return out


def to_jax(state) -> dict:
    """{reference name: tensor} -> nested dict of fp32 numpy arrays, the
    inverse of `from_jax`."""
    tree: dict = {}
    for name, t in state.items():
        arr = t.detach().float().cpu().numpy()
        parts = name.split(".")
        if parts[-1] == "weight":
            parts[-1] = "w"
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)              # OIHW -> HWIO
            elif arr.ndim == 2:
                arr = arr.transpose(1, 0)
        keys, i = [], 0
        while i < len(parts):
            if parts[i] in ("enc", "dec") and i + 1 < len(parts):
                keys.append(parts[i] + "/" + parts[i + 1])
                i += 2
            else:
                keys.append(parts[i])
                i += 1
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.ascontiguousarray(arr)
    return tree
