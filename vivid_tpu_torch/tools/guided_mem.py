"""Memory of guided sampling on the card, by batch.

    python -m vivid_tpu_torch.tools.guided_mem [--ch 64] [--batches 32,64] [--steps 32]

The counterpart of tools/guided_mem.py: a 64px dual-source model at `--ch`
guided by its unconditional twin (guidance 1.5, random weights), sampled
with `--steps` Heun steps at each batch of `--batches`. The JAX tool reads
XLA's static memory analysis of the compiled sampler; here the sampler runs
and the tool prints the weights' bytes and the allocator's peaks (peak
memory does not depend on the step count, so a short run measures it). A
batch that does not fit raises torch.cuda.OutOfMemoryError and exits
nonzero.
"""

import argparse
import json
import sys

import torch

GIB = 2.0 ** 30


def configs(ch: int):
    """(base, guide) PrecondConfigs: the JAX tool's."""
    from vivid_tpu_torch.nn.precond import PrecondConfig
    kw = dict(img_resolution=64, num_sources=2, model_channels=ch, extra_attn=1,
              use_bf16=True, remat=False)
    return PrecondConfig(**kw), PrecondConfig(**kw, uncond=True)


def report(ch: int, batch: int, num_steps: int = 32, device="cuda") -> dict:
    """Sample `batch` images guided at width `ch` -> the memory figures in
    bytes, with the sampler's wall seconds."""
    import time
    from vivid_tpu_torch.diffusion.sampler import edm_sampler, make_denoiser
    from vivid_tpu_torch.nn.precond import NVPrecond
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the memory report reads the CUDA allocator: it needs a card")
    cfg, gcfg = configs(ch)
    torch.cuda.empty_cache()
    net = NVPrecond(cfg, device=device, seed=0).eval().requires_grad_(False)
    gnet = NVPrecond(gcfg, device=device, seed=2).eval().requires_grad_(False)
    gen = torch.Generator(device).manual_seed(0)
    src = torch.rand(batch, 2, 64, 64, 3, generator=gen, device=device) * 2 - 1
    geometry = torch.randn(batch, 2, 20, generator=gen, device=device)
    noise = torch.randn(batch, 64, 64, 3, generator=gen, device=device)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        out = edm_sampler(make_denoiser(net, src, geometry), noise,
                          gnet_denoise=make_denoiser(gnet), guidance=1.5, num_steps=num_steps)
    torch.cuda.synchronize(device)
    if not bool(torch.isfinite(out).all()):
        raise FloatingPointError("guided samples are not finite")
    weights = sum(p.numel() * p.element_size() for m in (net, gnet) for p in m.parameters())
    return dict(ch=ch, batch=batch, steps=num_steps, weight_bytes=weights,
                working_bytes=torch.cuda.max_memory_allocated(device) - before,
                peak_allocated_bytes=torch.cuda.max_memory_allocated(device),
                peak_reserved_bytes=torch.cuda.max_memory_reserved(device),
                seconds=time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ch", type=int, default=64)
    ap.add_argument("--batches", default="32,64")
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args(argv)
    from vivid_tpu_torch.tools import tool_device
    device = tool_device(None)
    for b in [int(x) for x in args.batches.split(",")]:
        r = report(args.ch, b, args.steps, device)
        print(f"--- guided ch={args.ch} b={b} ({args.steps} steps)")
        for key in ("weight_bytes", "working_bytes", "peak_allocated_bytes",
                    "peak_reserved_bytes"):
            print(f"{key:36s} {r[key] / GIB:8.3f} GiB")
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
