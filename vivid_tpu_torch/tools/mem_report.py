"""Memory of one training step on the card, itemised.

    python -m vivid_tpu_torch.tools.mem_report --sr --batch 16 --remat save_dots
    VIVID_REMAT_HIRES_AREA=4096 python -m vivid_tpu_torch.tools.mem_report --sr \
        --batch 16 --remat save_dots

The counterpart of tools/mem_report.py, with its flags (`--sr` the 256px
super-resolution model, `--flagship` vivid-base at ch 128, else a 64px model
at `--ch`; `--batch`; `--remat true|false|save_dots`). The JAX tool reads
XLA's static memory analysis of the compiled step; here the step runs (two
steps, random weights and inputs) and the tool prints what the allocator
saw: the parameters', Adam moments' and EMA copies' bytes, the bytes held
for the backward pass (allocated after the loss's forward minus before it),
and the peaks of allocated and reserved memory. A configuration that does
not fit raises torch.cuda.OutOfMemoryError and exits nonzero.
"""

import argparse
import json
import os
import sys

import torch

GIB = 2.0 ** 30


def build_config(ch=64, remat="save_dots", sr=False, flagship=False):
    """The JAX tool's PrecondConfig for these flags, as the port's."""
    from vivid_tpu_torch.nn.precond import PrecondConfig
    kw = dict(img_resolution=64, num_sources=2, extra_attn=1, use_bf16=True, remat=remat)
    if flagship:
        kw.update(model_channels=128, source_label_dim=20, target_label_dim=40)
    elif sr:
        kw.update(img_resolution=256, model_channels=64, super_res=True, extra_attn=1,
                  num_sources=1, source_label_dim=20, target_label_dim=20)
    else:
        kw.update(model_channels=ch)
    return PrecondConfig(**kw)


def parse_remat(text):
    return {"true": True, "false": False, "save_dots": "save_dots"}[str(text).lower()]


def _bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def report(cfg, batch: int, device="cuda", steps: int = 2, seed: int = 0) -> dict:
    """Run `steps` training steps of `cfg` at `batch` on the card -> the
    memory figures in bytes (the last step's bytes held for the backward
    pass; the peaks over all steps)."""
    from vivid_tpu_torch.diffusion.loss import NVLoss, SRNVLoss
    from vivid_tpu_torch.nn.precond import NVPrecond
    from vivid_tpu_torch.nn.unet import remat_hires_area
    from vivid_tpu_torch.train.step import TrainConfig, init_train_state, make_train_step
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the memory report reads the CUDA allocator: it needs a card")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    net = NVPrecond(cfg, device=device, seed=seed).train()
    tcfg = TrainConfig(batch_size=batch, ref_lr=1e-3, rampup_Mimg=0,
                       nimg_mult=1 if cfg.super_res else 6, num_accum=1)
    state = init_train_state(net, tcfg)
    inner = (SRNVLoss if cfg.super_res else NVLoss)(P_mean=-0.8, P_std=1.6)
    held = []

    def loss_fn(*args, **kwargs):
        before = torch.cuda.memory_allocated(device)
        out = inner(*args, **kwargs)
        held.append(torch.cuda.memory_allocated(device) - before)
        return out

    step = make_train_step(loss_fn, tcfg)
    gen = torch.Generator(device).manual_seed(seed)
    res, ns = cfg.img_resolution, cfg.num_sources
    data = dict(src=torch.rand(batch, ns, res, res, 3, generator=gen, device=device) * 2 - 1,
                tgt=torch.rand(batch, res, res, 3, generator=gen, device=device) * 2 - 1,
                geometry=torch.randn(batch, ns, 20, generator=gen, device=device))
    for _ in range(steps):
        step(state, data, gen)
    torch.cuda.synchronize(device)
    return dict(
        params=sum(p.numel() for p in state.params), res=res, batch=batch, remat=cfg.remat,
        hires_area=remat_hires_area(),
        param_bytes=_bytes(state.params), optimizer_bytes=_bytes(state.adam_m + state.adam_v),
        ema_bytes=sum(_bytes(e) for e in state.emas), activation_bytes=held[-1],
        peak_allocated_bytes=torch.cuda.max_memory_allocated(device),
        peak_reserved_bytes=torch.cuda.max_memory_reserved(device))


def print_report(r: dict):
    print(f"model: {r['params'] / 1e6:.2f}M params, res={r['res']}, batch={r['batch']}, "
          f"remat={r['remat']}, hires_area={r['hires_area']}")
    for key in ("param_bytes", "optimizer_bytes", "ema_bytes", "activation_bytes",
                "peak_allocated_bytes", "peak_reserved_bytes"):
        print(f"{key:36s} {r[key] / GIB:8.3f} GiB")
    print(json.dumps(r, default=str), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ch", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--remat", type=str, default="save_dots", help="true|false|save_dots")
    ap.add_argument("--sr", action="store_true")
    ap.add_argument("--flagship", action="store_true")
    args = ap.parse_args(argv)
    from vivid_tpu_torch.tools import tool_device
    device = tool_device(None)
    cfg = build_config(args.ch, parse_remat(args.remat), args.sr, args.flagship)
    print(f"hires area: {os.environ.get('VIVID_REMAT_HIRES_AREA', '16384 (default)')}",
          flush=True)
    print_report(report(cfg, args.batch, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
