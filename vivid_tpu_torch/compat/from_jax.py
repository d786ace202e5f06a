"""The JAX package's parameter tree <-> the port's state_dict.

The names and layouts are those of vivid_tpu/compat/torch_export.py
`tree_to_torch_state` (the reference's own): tree keys join with ".", the
"enc/<block>" and "dec/<block>" keys split at "/", leaf "w" becomes
"weight", conv HWIO -> OIHW and linear [in, out] -> [out, in]; gains and
Fourier buffers pass through. With those, `load_state_dict(strict=True)` is
the whole bridge. The tree holds numpy arrays (a snapshot's `ema`).

`train_state_from_jax` / `train_state_to_jax` carry a whole train state
(vivid_tpu/train/step.py `TrainState` with numpy leaves) across the same
way. The JAX package keeps the Fourier features in its parameter tree, with
Adam moments and EMA copies of their own; in the port they are buffers with
neither. So one way drops those leaves (the buffers take the values of
`params`), and the other fills zero moments and copies the buffers into
every EMA tree.
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
        # (ascontiguousarray alone would turn a 0-dim gain into shape (1,).)
        node[keys[-1]] = np.ascontiguousarray(arr).reshape(arr.shape)
    return tree


def _field(state, name):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def train_state_from_jax(state, cfg, device="cpu"):
    """A JAX TrainState (or a dict of its fields) with numpy leaves -> the
    port's TrainState around a new NVPrecond(cfg) in training mode."""
    from vivid_tpu_torch.nn.precond import NVPrecond
    from vivid_tpu_torch.train.step import TrainState
    net = NVPrecond(cfg, device="meta").to_empty(device=device)
    net.load_state_dict(from_jax(_field(state, "params")), strict=True)
    net.train()
    names, params = map(list, zip(*net.named_parameters()))

    def aligned(tree):
        flat = from_jax(tree)
        return [flat[n].to(device) for n in names]

    return TrainState(
        net=net, names=names, params=params,
        adam_m=aligned(_field(state, "adam_m")), adam_v=aligned(_field(state, "adam_v")),
        emas=[aligned(t) for t in _field(state, "emas")],
        adam_step=int(_field(state, "adam_step")), cur_nimg=int(_field(state, "cur_nimg")))


def train_state_to_jax(state) -> dict:
    """The port's TrainState -> dict(params, adam_m, adam_v, adam_step, emas,
    cur_nimg) of numpy trees in the JAX layout."""
    full = state.net.state_dict()
    buffers = {k: v for k, v in full.items() if k not in set(state.names)}
    zeros = {k: torch.zeros_like(v) for k, v in buffers.items()}

    def tree(tensors, rest):
        return to_jax({**rest, **dict(zip(state.names, tensors))})

    return dict(
        params=to_jax(full),
        adam_m=tree(state.adam_m, zeros), adam_v=tree(state.adam_v, zeros),
        adam_step=np.int32(state.adam_step),
        emas=[tree(ema, buffers) for ema in state.emas],
        cur_nimg=np.int64(state.cur_nimg))
