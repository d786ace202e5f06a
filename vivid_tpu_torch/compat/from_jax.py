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

`inception_from_jax` and `vit_from_jax` carry the JAX package's detector
trees (metrics/inception_jax.py, nn/dinov2.py; numpy leaves) into the
port's InceptionV3 and DinoViT state dicts: conv HWIO -> OIHW with the
batch norm's mean, var and beta; the ViT's separate q, k, v back into the
original fused `qkv`, linear [in, out] -> [out, in]. `depth_anything_from_jax`
does the same for the JAX DepthAnythingV2 tree (the ViT and the DPT head).
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
    cur_nimg) of numpy trees in the JAX layout (under FSDP every tensor
    gathered whole: a collective, on every rank)."""
    from vivid_tpu_torch.core.sharding import full_state_dict
    full = full_state_dict(state.net.state_dict())
    buffers = {k: v for k, v in full.items() if k not in set(state.names)}
    zeros = {k: torch.zeros_like(v) for k, v in buffers.items()}

    def tree(tensors, rest):
        return to_jax({**rest, **dict(zip(state.names, full_state_dict(list(tensors))))})

    return dict(
        params=to_jax(full),
        adam_m=tree(state.adam_m, zeros), adam_v=tree(state.adam_v, zeros),
        adam_step=np.int32(state.adam_step),
        emas=[tree(ema, buffers) for ema in state.emas],
        cur_nimg=np.int64(state.cur_nimg))


def inception_from_jax(params) -> Dict[str, torch.Tensor]:
    """{TF-slim conv name: {w, mean, var, beta}} -> InceptionV3's state dict."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        out[f"convs.{name}.weight"] = torch.tensor(
            np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1))
        for k in ("mean", "var", "beta"):
            out[f"convs.{name}.{k}"] = torch.tensor(np.asarray(p[k], np.float32))
    return out


def vit_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The JAX ViT tree (cls_token, pos_embed, patch_embed, blocks, norm) ->
    an original-naming DINOv2 state dict."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32))   # noqa: E731
    sd = {"cls_token": t(tree["cls_token"]).reshape(1, 1, -1),
          "pos_embed": t(tree["pos_embed"])[None],
          "patch_embed.proj.weight": t(np.asarray(tree["patch_embed"]["w"]).transpose(3, 2, 0, 1)),
          "patch_embed.proj.bias": t(tree["patch_embed"]["b"]),
          "norm.weight": t(tree["norm"]["g"]), "norm.bias": t(tree["norm"]["b"])}
    for i, blk in enumerate(tree["blocks"]):
        pre = f"blocks.{i}"
        sd[f"{pre}.attn.qkv.weight"] = torch.cat([t(blk[n]["w"]).T for n in "qkv"])
        sd[f"{pre}.attn.qkv.bias"] = torch.cat([t(blk[n]["b"]) for n in "qkv"])
        for ours, theirs in (("attn.proj", "proj"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            sd[f"{pre}.{ours}.weight"] = t(blk[theirs]["w"]).T.contiguous()
            sd[f"{pre}.{ours}.bias"] = t(blk[theirs]["b"])
        for norm in ("norm1", "norm2"):
            sd[f"{pre}.{norm}.weight"] = t(blk[norm]["g"])
            sd[f"{pre}.{norm}.bias"] = t(blk[norm]["b"])
        sd[f"{pre}.ls1.gamma"] = t(blk["ls1"])
        sd[f"{pre}.ls2.gamma"] = t(blk["ls2"])
    return sd


def depth_anything_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX DepthAnythingV2 tree (vivid_tpu/geometry/depth_anything.py
    `params_from_state_dict`: the ViT's keys, then projects, resize0/1/3,
    layer_rn, fusion deepest first, head) -> an original-naming checkpoint:
    the ViT under `pretrained.`, the DPT head under `depth_head.`; convs HWIO
    -> OIHW, the transposed convs already in torch's [Cin, Cout, k, k]."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32))   # noqa: E731
    sd = {f"pretrained.{k}": v for k, v in vit_from_jax(params).items()}

    def conv(name, p):
        sd[f"depth_head.{name}.weight"] = t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
        if "b" in p:
            sd[f"depth_head.{name}.bias"] = t(p["b"])

    for i in range(4):
        conv(f"projects.{i}", params["projects"][i])
        conv(f"scratch.layer{i + 1}_rn", params["layer_rn"][i])
    for i in (0, 1):
        sd[f"depth_head.resize_layers.{i}.weight"] = t(params[f"resize{i}"]["w"])
        sd[f"depth_head.resize_layers.{i}.bias"] = t(params[f"resize{i}"]["b"])
    conv("resize_layers.3", params["resize3"])
    for j, stage in enumerate(params["fusion"]):   # fusion[j] is refinenet{4 - j}
        rn = f"scratch.refinenet{4 - j}"
        conv(f"{rn}.out_conv", stage["proj"])
        for ours, theirs in (("resConfUnit1", "res1"), ("resConfUnit2", "res2")):
            for c in ("conv1", "conv2"):
                conv(f"{rn}.{ours}.{c}", stage[theirs][c])
    for ours, theirs in (("output_conv1", "conv1"), ("output_conv2.0", "conv2"),
                         ("output_conv2.2", "conv3")):
        conv(f"scratch.{ours}", params["head"][theirs])
    return sd
