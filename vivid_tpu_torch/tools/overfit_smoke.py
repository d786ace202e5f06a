"""Convergence proof of the port: overfit a small model on a few synthetic
scenes and show that (a) the training loss falls and (b) sampled novel views
approach the targets (PSNR rises over the untrained model's).

    python -m vivid_tpu_torch.tools.overfit_smoke [--steps 2000] [--out overfit_smoke.json]

The counterpart of tools/overfit_smoke.py, with its defaults (2000 steps,
batch 16, ch 64, 32 px, attention at 16 and 8, a 16-step evaluation from
sigma_max = 2, PSNR over a span of 2) and its JSON keys. It runs on the
first CUDA card unless --device cpu, writes the loss curve and the PSNRs to
--out and exits 1 when a gate fails. The loss gate is
tail < head - 0.3 |head| over the first and last thirds of the curve: the
JAX tool's tail < 0.7 head is the same for a positive loss, but this loss is
uncertainty-weighted and goes negative, where 0.7 head lies above head and
passes a loss that rose (`loss_gate_passes`).
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch


def psnr(a, b, span=2.0):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(span ** 2 / max(mse, 1e-12))


def loss_gate_passes(head: float, tail: float) -> bool:
    """The loss fell by 30% of its first third's magnitude, whatever its sign."""
    return tail < head - 0.3 * abs(head)


def model_config(imsize=32, ch=64):
    from vivid_tpu_torch.nn.precond import PrecondConfig
    return PrecondConfig(img_resolution=imsize, num_sources=2, model_channels=ch,
                         attn_resolutions=(imsize // 2, imsize // 4), use_bf16=True,
                         remat=False)


def evaluate(net, src, geometry, noise, tgt, num_steps=16, sigma_max=2.0):
    """Samples of `net` from `noise` (16 Heun steps from sigma_max = 2,
    inside the noise range that a short overfit trains) and their PSNR
    against the target latents -> (samples, dB)."""
    from vivid_tpu_torch.diffusion.sampler import edm_sampler, make_denoiser
    with torch.no_grad():
        out = edm_sampler(make_denoiser(net, src=src, geometry=geometry), noise,
                          num_steps=num_steps, sigma_max=sigma_max)
    return out, psnr(out.cpu(), tgt.cpu())


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ch", type=int, default=64)
    ap.add_argument("--imsize", type=int, default=32)
    ap.add_argument("--out", default="overfit_smoke.json")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    from vivid_tpu_torch.core.rngs import fold_in
    from vivid_tpu_torch.data.collate import BatchLoader, DualSourceCollate
    from vivid_tpu_torch.data.encoders import StandardRGBEncoder
    from vivid_tpu_torch.data.scenes import SceneDataset, make_synthetic_dataset
    from vivid_tpu_torch.diffusion.loss import NVLoss
    from vivid_tpu_torch.nn.precond import NVPrecond
    from vivid_tpu_torch.tools import tool_device
    from vivid_tpu_torch.train.step import TrainConfig, init_train_state, make_train_step

    device = tool_device(args.device)
    cfg = model_config(args.imsize, args.ch)
    with tempfile.TemporaryDirectory(prefix="overfit_scenes_") as data_dir:
        make_synthetic_dataset(data_dir, num_scenes=4, num_views=6, imsize=args.imsize)
        loader = BatchLoader(iter(SceneDataset(data_dir, seed=0)),
                             DualSourceCollate(imsize=args.imsize, seed=0),
                             batch_size=args.batch, prefetch=2, num_threads=2)
        try:
            net = NVPrecond(cfg, device=device, seed=0).train()
            eval_net = NVPrecond(cfg, device="meta").to_empty(device=device)
            eval_net.eval().requires_grad_(False)
            tcfg = TrainConfig(batch_size=args.batch, ref_lr=8e-3, rampup_Mimg=0.002,
                               nimg_mult=1, ema_stds=(0.05,))
            state = init_train_state(net, tcfg)
            step = make_train_step(NVLoss(P_mean=-0.8, P_std=1.6), tcfg)
            enc = StandardRGBEncoder()

            # A fixed evaluation batch, for the PSNR before and after.
            ev = next(loader)
            ev_src = enc.encode_latents(ev["src_image"], device=device)
            ev_tgt = enc.encode_latents(ev["tgt_image"], device=device)
            ev_geo = torch.as_tensor(ev["geometry"], device=device)
            ev_noise = torch.randn(ev_tgt.shape, generator=torch.Generator(device).manual_seed(99),
                                   device=device)

            def psnr_of(weights):
                eval_net.load_state_dict(weights)
                return evaluate(eval_net, ev_src, ev_geo, ev_noise, ev_tgt)[1]

            psnr_before = psnr_of(net.state_dict())
            # A model that ignores the geometry and copies the first source scores this.
            psnr_src_floor = psnr(ev_src[:, 0].cpu(), ev_tgt.cpu())

            losses = []
            generator = torch.Generator(device)
            t0 = time.time()
            for i in range(args.steps):
                batch = next(loader)
                b = {"src": enc.encode_latents(batch["src_image"], device=device),
                     "tgt": enc.encode_latents(batch["tgt_image"], device=device),
                     "geometry": torch.as_tensor(batch["geometry"], device=device)}
                generator.manual_seed(fold_in(1, i))
                st = step(state, b, generator)
                if i % 20 == 0 or i == args.steps - 1:
                    losses.append((i, float(st["Loss/loss"])))
                    print(f"step {i:4d}  loss {losses[-1][1]:.4f}  ({time.time() - t0:.0f}s)",
                          flush=True)
            wall = time.time() - t0
        finally:
            loader.close()
    psnr_ema = psnr_of(state.ema_state_dict(0))
    psnr_raw = psnr_of(net.state_dict())
    psnr_after = max(psnr_ema, psnr_raw)

    curve = [v for _, v in losses]
    third = max(len(curve) // 3, 1)
    head, tail = float(np.mean(curve[:third])), float(np.mean(curve[-third:]))
    result = dict(steps=args.steps, batch=args.batch, ch=args.ch, imsize=args.imsize,
                  loss_curve=losses, loss_head_third=head, loss_tail_third=tail,
                  psnr_before_db=psnr_before, psnr_after_db=psnr_after,
                  psnr_src_floor_db=psnr_src_floor, psnr_after_ema_db=psnr_ema,
                  psnr_after_raw_db=psnr_raw, wall_s=round(wall, 1),
                  device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "loss_curve"}))
    ok = loss_gate_passes(head, tail) and psnr_after > psnr_before + 3.0
    print("CONVERGENCE", "OK" if ok else "FAILED",
          f"(loss {head:.3f}->{tail:.3f}, psnr {psnr_before:.1f}->{psnr_after:.1f} dB, "
          f"copy-src floor {psnr_src_floor:.1f})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
