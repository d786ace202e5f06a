"""Training loop: scenes -> batches -> train steps -> status lines and
per-EMA snapshots.

Counterpart of vivid_tpu/train/loop.py `training_loop`, cut to what a run
on one card needs: it trains `vivid-base` / `vivid-uncond` style models, the
256px super-resolution model (`sr_training`) and single-source models
(`vanilla_mode`) on a directory of scene files. Not ported yet, and absent
here: resume and training-state checkpoints, sample grids, metric ticks, the
stats file, single-image co-training, depth conditioning and more than one
process.

Every `Status:` line goes to stdout and to `<run_dir>/log.txt`. Intervals are
in images (nimg), as in the JAX package; one step advances the count by
`batch_size * collate.nimg_mult` (6 in dual-source mode, 1 in vanilla mode).
"""

import os
import time
from typing import Optional

import torch

from vivid_tpu_torch.core.easydict import EasyDict
from vivid_tpu_torch.core.rngs import fold_in
from vivid_tpu_torch.data.collate import BatchLoader, DualSourceCollate, VanillaCollate
from vivid_tpu_torch.data.encoders import StandardRGBEncoder
from vivid_tpu_torch.diffusion.loss import NVLoss, SRNVLoss
from vivid_tpu_torch.generate import open_scene_dataset
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.train.snapshots import save_snapshot
from vivid_tpu_torch.train.step import TrainConfig, init_train_state, make_train_step


def format_time(seconds: float) -> str:
    s = int(round(seconds))
    if s < 60:
        return f"{s}s"
    if s < 3600:
        return f"{s // 60}m {s % 60:02d}s"
    return f"{s // 3600}h {s // 60 % 60:02d}m {s % 60:02d}s"


def training_loop(
    run_dir: str,
    dataset_kwargs: Optional[dict] = None,
    network_kwargs: Optional[dict] = None,
    loss_kwargs: Optional[dict] = None,
    lr_kwargs: Optional[dict] = None,
    ema_stds=(0.050, 0.100),
    seed: int = 0,
    batch_size: int = 64,
    batch_gpu: Optional[int] = None,
    total_nimg: int = 192_000_000,
    status_nimg: Optional[int] = 960,
    snapshot_nimg: Optional[int] = 10000,
    loss_scaling: float = 1.0,
    force_finite: bool = True,
    sr_training: bool = False,
    vanilla_mode: bool = False,
    plain_mse: bool = False,
    max_steps: Optional[int] = None,
    device=None,
):
    """Train an NVS diffusion model; `max_steps` also bounds the number of
    optimizer steps. `sr_training` trains a `super_res` model at 256px with
    `SRNVLoss`; `vanilla_mode` feeds one source view per pair. Runs on the
    first CUDA card unless `device` says otherwise. Returns
    EasyDict(state, ticks): the final TrainState and one dict per status tick
    (nimg, steps, loss, loss_std, learning_rate, grad_norm as means over the
    tick's steps, seconds)."""
    start_time = time.time()
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card found; pass device='cpu' to train on the CPU")
    os.makedirs(run_dir, exist_ok=True)

    num_sources = 1 if vanilla_mode else 2
    net_kwargs = dict(network_kwargs or {})
    net_kwargs.setdefault("img_resolution", 256 if sr_training else 64)
    net_kwargs.setdefault("num_sources", num_sources)
    net_kwargs.setdefault("source_label_dim", 20)
    net_kwargs.setdefault("target_label_dim", 20 * num_sources)
    net_kwargs.setdefault("super_res", sr_training)
    model_cfg = PrecondConfig(**net_kwargs)
    if model_cfg.num_sources != num_sources or model_cfg.super_res != sr_training:
        raise ValueError(
            f"network_kwargs (num_sources {model_cfg.num_sources}, super_res "
            f"{model_cfg.super_res}) disagree with vanilla_mode={vanilla_mode}, "
            f"sr_training={sr_training}")

    dataset_kwargs = dict(dataset_kwargs or {})
    dataset = open_scene_dataset(
        dataset_kwargs["path"], seed=seed,
        **{k: v for k, v in dataset_kwargs.items() if k not in ("path", "class_name")})
    collate_cls = VanillaCollate if vanilla_mode else DualSourceCollate
    collate = collate_cls(imsize=model_cfg.img_resolution, seed=seed)
    encoder = StandardRGBEncoder()
    loss_cls = SRNVLoss if sr_training else NVLoss
    loss_fn = loss_cls(plain_mse=plain_mse, **dict(loss_kwargs or {}))

    num_accum = 1
    if batch_gpu and batch_gpu < batch_size:
        if batch_size % batch_gpu:
            raise ValueError(f"batch {batch_size} not divisible by batch_gpu {batch_gpu}")
        num_accum = batch_size // batch_gpu
    lr_args = dict(lr_kwargs or {})
    train_cfg = TrainConfig(
        batch_size=batch_size, loss_scaling=loss_scaling, force_finite=force_finite,
        ref_lr=lr_args.get("ref_lr", 100e-4), ref_batches=lr_args.get("ref_batches", 70e3),
        rampup_Mimg=lr_args.get("rampup_Mimg", 10.0), ema_stds=tuple(ema_stds),
        nimg_mult=collate.nimg_mult, loss_clamp_3sigma=not plain_mse,
        force_wn=model_cfg.force_wn, num_accum=num_accum)

    net = NVPrecond(model_cfg, device=device, seed=seed).train()
    state = init_train_state(net, train_cfg)
    step_fn = make_train_step(loss_fn, train_cfg)
    generator = torch.Generator(device=device)
    nimg_per_step = batch_size * train_cfg.nimg_mult
    n_params = sum(t.numel() for t in net.state_dict().values())

    log = open(os.path.join(run_dir, "log.txt"), "a")

    def say(line):
        print(line, flush=True)
        log.write(line + "\n")
        log.flush()

    def interval_hit(interval, cur, prev):
        if interval is None:
            return False
        return cur // interval != prev // interval or cur == 0

    say(f"Parameters: {n_params / 1e6:.2f} M on {device}; batch {batch_size} in "
        f"{num_accum} microbatch(es); {nimg_per_step} nimg per step "
        f"(nimg_mult {train_cfg.nimg_mult})")
    loader = BatchLoader(iter(dataset), collate, batch_size=batch_size)
    ticks, pending = [], []
    steps_done = 0
    tick_start = time.time()
    try:
        while True:
            cur_nimg = state.cur_nimg
            prev_nimg = cur_nimg - nimg_per_step
            done = cur_nimg >= total_nimg or (max_steps is not None
                                              and steps_done >= max_steps)
            if interval_hit(status_nimg, cur_nimg, prev_nimg) or done:
                # Reading the stats waits for the device: a tick's time is real.
                vals = [{k: float(v) for k, v in s.items()} for s in pending]
                mean = lambda k: (sum(v[k] for v in vals) / len(vals)) if vals else float("nan")
                now = time.time()
                tick = dict(nimg=cur_nimg, steps=len(vals), loss=mean("Loss/loss"),
                            loss_std=mean("Loss/loss_std"),
                            learning_rate=mean("Loss/learning_rate"),
                            grad_norm=mean("Grad/global_norm"), seconds=now - tick_start)
                ticks.append(tick)
                # The JAX package's fields first, at its widths; the port's after.
                say(f"Status: kimg {cur_nimg / 1e3:<9.1f} loss {tick['loss']:<8.4f} "
                    f"time {format_time(now - start_time):<12s} "
                    f"sec/tick {tick['seconds']:<8.2f} "
                    f"gnorm {tick['grad_norm']:<10.4f} lr {tick['learning_rate']:<10.3e}")
                pending = []
                tick_start = now
            if interval_hit(snapshot_nimg, cur_nimg, prev_nimg) and cur_nimg != 0:
                for i, std in enumerate(train_cfg.ema_stds):
                    fname = os.path.join(
                        run_dir, f"network-snapshot-{cur_nimg // 1000:07d}-{std:.3f}.pkl")
                    save_snapshot(fname, net, state.ema_state_dict(i),
                                  dataset_kwargs=dataset_kwargs, loss_kwargs=loss_kwargs)
                    say(f"Saved {fname}")
            if done:
                break

            raw = next(loader)
            batch = {"src": encoder.encode_latents(raw["src_image"], device=device),
                     "tgt": encoder.encode_latents(raw["tgt_image"], device=device),
                     "geometry": torch.as_tensor(raw["geometry"], device=device)}
            # One stream per step, a function of (seed, nimg) alone.
            generator.manual_seed(fold_in(seed, cur_nimg))
            pending.append(step_fn(state, batch, generator))
            steps_done += 1
    finally:
        loader.close()
        log.close()
    return EasyDict(state=state, ticks=ticks)
