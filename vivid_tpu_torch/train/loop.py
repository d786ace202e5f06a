"""Training loop: scenes -> batches -> train steps, with status ticks and
`stats.jsonl`, per-EMA snapshots, training-state checkpoints, resume,
slices and suspend, and sample grids.

Counterpart of vivid_tpu/train/loop.py `training_loop`. It
trains `vivid-base` / `vivid-uncond` style models, the 256px
super-resolution model (`sr_training`) and single-source models
(`vanilla_mode`) on a directory of scene files, optionally mixed with rows
synthesised from single images (`single_image_mix`), optionally conditioned
on depth (`depth_model`: a callable, or 'small' | 'base' | 'large' from
$VIVID_DEPTH_DIR; each source view of the training batch, of the sample
grid's and of the metrics tick's gets its predicted depth as a fourth
channel, inverse-normalised for a `depth_input` model).

Over several processes (`torch.distributed`, `core/dist.py`) each rank
drives one card and takes batch_size / world_size rows of every step (a
batch that does not divide is refused): its own scenes (`process_index`,
`process_count`), its own share of single-image rows and its own step
generator (the step seed folded with the rank). Gradients are averaged
over the ranks (data parallel), or with `fsdp` parameters, gradients, Adam
moments and EMAs are sharded over them (FSDP2, `core/sharding.py`).
Checkpoints and snapshots hold whole tensors in one layout with and without
`fsdp`; rank 0 writes them, the sample grids and the stats file. After each
checkpoint the ranks check that they hold the same parameters
(`core/consistency.py`).

A metrics tick (`metrics_nimg`) measures EMA 0 with `metrics_fn(net, cfg)`,
by default `metrics/api.py get_metrics` on 100 unguided samples at batch 25
over the test tree (`metrics_list`, default FID, FD-DINOv2, their joint
variants and PSNR). It prints `Metrics: {...}`, reports `Metrics/<name>` into
the next row of `stats.jsonl` and appends a row to `metrics.jsonl`; on a
rank whose results are None it does none of these.

Intervals are in images (nimg), as in the JAX package; one step advances the
count by `batch_size * collate.nimg_mult` (6 in dual-source mode, 1 in
vanilla mode). Everything the loop prints goes to stdout and to
`<run_dir>/log.txt`. A run resumes from the latest `training-state-*.pt` in
`run_dir`. It stops at `total_nimg`, after `max_steps` steps, at the end of
a slice (`slice_nimg`), or when a suspend is requested (SIGTERM); the last
two write a checkpoint where they stop. With `deterministic`, a resumed
run's loaders replay the rows the earlier run consumed, so killing and
resuming a run changes no bit of its result; on a CUDA card it also selects
deterministic algorithms, which needs CUBLAS_WORKSPACE_CONFIG=:4096:8 in the
environment before the process makes its first cuBLAS call.
"""

import contextlib
import json
import os
import resource
import time
from typing import Optional

import numpy as np
import PIL.Image
import torch

from vivid_tpu_torch.core import checkpoint, dist, stats as stats_mod
from vivid_tpu_torch.core.consistency import check_param_consistency
from vivid_tpu_torch.core.easydict import EasyDict
from vivid_tpu_torch.core.logger import Logger, format_time
from vivid_tpu_torch.core.rngs import fold_in
from vivid_tpu_torch.core.summary import count_params, param_table
from vivid_tpu_torch.data.collate import BatchLoader, DualSourceCollate, VanillaCollate
from vivid_tpu_torch.data.encoders import StandardRGBEncoder
from vivid_tpu_torch.diffusion.loss import NVLoss, SRNVLoss, down_up_resize
from vivid_tpu_torch.diffusion.sampler import edm_sampler, make_denoiser
from vivid_tpu_torch.generate import open_scene_dataset, resolve_model, sr_cascade
from vivid_tpu_torch.geometry.depth import add_depth, resolve_depth_model
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.train.snapshots import save_snapshot
from vivid_tpu_torch.train.step import TrainConfig, init_train_state, make_train_step

CUBLAS_WORKSPACE = (":4096:8", ":16:8")   # the values that make cuBLAS deterministic


@contextlib.contextmanager
def deterministic_algorithms(enabled: bool):
    """Deterministic algorithms and cuDNN for the block, then the previous
    settings back."""
    if not enabled:
        yield
        return
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in CUBLAS_WORKSPACE:
        raise RuntimeError(
            "deterministic training on a CUDA card needs CUBLAS_WORKSPACE_CONFIG=:4096:8 "
            "(or :16:8) in the environment before the first cuBLAS call; set it when "
            "starting the process")
    cudnn = torch.backends.cudnn
    old = (torch.are_deterministic_algorithms_enabled(), cudnn.deterministic, cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0])
        cudnn.deterministic, cudnn.benchmark = old[1], old[2]


def training_loop(
    run_dir: str,
    dataset_kwargs: Optional[dict] = None,
    test_dataset_path: Optional[str] = None,
    encoder_kwargs: Optional[dict] = None,
    network_kwargs: Optional[dict] = None,
    loss_kwargs: Optional[dict] = None,
    lr_kwargs: Optional[dict] = None,
    ema_stds=(0.050, 0.100),
    seed: int = 0,
    batch_size: int = 64,
    batch_gpu: Optional[int] = None,
    total_nimg: int = 192_000_000,
    slice_nimg: Optional[int] = None,
    status_nimg: Optional[int] = 960,
    samples_nimg: Optional[int] = 9600,
    metrics_nimg: Optional[int] = None,
    snapshot_nimg: Optional[int] = 10000,
    checkpoint_nimg: Optional[int] = 10000,
    loss_scaling: float = 1.0,
    force_finite: bool = True,
    eval_samples: int = 8,
    sr_training: bool = False,
    vanilla_mode: bool = False,
    plain_mse: bool = False,
    single_image_mix: Optional[float] = None,
    single_image_mix_path: Optional[str] = None,
    sr_model=None,
    depth_model=None,
    metrics_fn=None,
    metrics_list=None,
    max_steps: Optional[int] = None,
    debug: Optional[bool] = None,
    fsdp: bool = False,
    deterministic: bool = False,
    progress_bar: bool = False,
    device=None,
):
    """Train an NVS diffusion model; `max_steps` also bounds the number of
    optimizer steps. `sr_training` trains a `super_res` model at 256px with
    `SRNVLoss`; `vanilla_mode` feeds one source view per pair. Sample grids
    (EMA 0, unguided, 32 Heun steps; through `sr_model` when given) need
    `test_dataset_path`. `debug` turns off the stats file, the progress bar
    and wandb; the progress bar (tqdm) is drawn only with `progress_bar`,
    wandb only when WANDB_PROJECT is set. Runs on this process's card
    (cuda:LOCAL_RANK) unless `device` says otherwise; `fsdp` shards the
    training state over the ranks of the process group. Returns EasyDict(state, ticks): the final
    TrainState and one dict per status tick (nimg, steps, loss, loss_std,
    learning_rate, grad_norm as means over the tick's steps, seconds)."""
    args = dict(locals())
    args["device"] = device = torch.device(device) if device else dist.default_device()
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card found; pass device='cpu' to train on the CPU")
    os.makedirs(os.path.join(run_dir, "results"), exist_ok=True)
    dist.init(device=device)
    with Logger(os.path.join(run_dir, "log.txt"), "a"), \
            deterministic_algorithms(deterministic and device.type == "cuda"):
        return _train(**args)


def _train(run_dir, dataset_kwargs, test_dataset_path, encoder_kwargs, network_kwargs,
           loss_kwargs, lr_kwargs, ema_stds, seed, batch_size, batch_gpu, total_nimg,
           slice_nimg, status_nimg, samples_nimg, metrics_nimg, snapshot_nimg,
           checkpoint_nimg, loss_scaling, force_finite, eval_samples, sr_training,
           vanilla_mode, plain_mse, single_image_mix, single_image_mix_path, sr_model,
           depth_model, metrics_fn, metrics_list, max_steps, debug, fsdp, deterministic,
           progress_bar, device):
    start_time = time.time()
    print0 = dist.print0
    rank, world = dist.get_rank(), dist.get_world_size()
    if batch_size % world:
        raise ValueError(f"batch {batch_size} does not divide over {world} processes")
    local_batch = batch_size // world
    if fsdp and dist.group() is None:
        raise ValueError("fsdp shards over a process group: start the processes with "
                         "torchrun (or VIVID_COORDINATOR)")
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
    resolution = model_cfg.img_resolution

    dataset_kwargs = dict(dataset_kwargs or {})
    dataset = open_scene_dataset(
        dataset_kwargs["path"], seed=seed, process_index=rank, process_count=world,
        **{k: v for k, v in dataset_kwargs.items() if k not in ("path", "class_name")})
    collate_cls = VanillaCollate if vanilla_mode else DualSourceCollate
    collate = collate_cls(imsize=resolution, seed=seed)

    # Single-image co-training: a fixed share of every process's batch is
    # synthesised from single images by random camera rotations; each rank
    # draws its own (the JAX package gives every process the same stream).
    main_batch, n_single, single_ds = local_batch, 0, None
    if single_image_mix:
        from vivid_tpu_torch.data.single_images import SingleImages
        n_single = min(local_batch - 1, max(1, int(local_batch * single_image_mix)))
        single_ds = SingleImages(single_image_mix_path or dataset_kwargs["path"],
                                 imsize=resolution, num_sources=num_sources,
                                 seed=seed + 2 if rank == 0 else fold_in(seed + 2, rank))
        main_batch = local_batch - n_single

    sr_model = resolve_model(sr_model, device)
    depth_model = resolve_depth_model(depth_model, device=device)
    if (model_cfg.depth_input or model_cfg.warp_depth_coor) and depth_model is None:
        raise ValueError("a depth_input or warp_depth_coor model needs a depth_model")
    test_split = dataset_kwargs.get("split", "test")   # a RealEstate10K tree's split
    grids = bool(test_dataset_path and eval_samples)
    test_loader = None
    if grids and rank == 0:
        test_collate = collate_cls(imsize=resolution, seed=seed + 1,
                                   sr_size=sr_model.cfg.img_resolution if sr_model else None)
        test_dataset = open_scene_dataset(test_dataset_path, seed=seed + 1, split=test_split)
        test_loader = BatchLoader(iter(test_dataset), test_collate,
                                  batch_size=eval_samples, prefetch=1)
    if metrics_fn is None and metrics_nimg is not None:
        if not test_dataset_path:
            raise ValueError("metrics_nimg needs test_dataset_path (or a metrics_fn)")

        def metrics_fn(net, cfg):
            from vivid_tpu_torch.metrics.api import get_metrics
            return get_metrics(EasyDict(net=net, cfg=cfg), encoder=encoder, num_images=100,
                               metrics=metrics_list, max_batch_size=25, device=device,
                               depth_model=depth_model,
                               datakwargs={"path": test_dataset_path, "split": test_split})

    if encoder_kwargs:
        from vivid_tpu_torch.core.registry import construct_class_by_name
        encoder = construct_class_by_name(**dict(encoder_kwargs))
    else:
        encoder = StandardRGBEncoder()
    loss_cls = SRNVLoss if sr_training else NVLoss
    loss_fn = loss_cls(plain_mse=plain_mse, **dict(loss_kwargs or {}))

    num_accum = 1
    if batch_gpu and batch_gpu < local_batch:
        if local_batch % batch_gpu:
            raise ValueError(f"batch {local_batch} a process not divisible by batch_gpu "
                             f"{batch_gpu}")
        num_accum = local_batch // batch_gpu
    lr_args = dict(lr_kwargs or {})
    train_cfg = TrainConfig(
        batch_size=batch_size, loss_scaling=loss_scaling, force_finite=force_finite,
        ref_lr=lr_args.get("ref_lr", 100e-4), ref_batches=lr_args.get("ref_batches", 70e3),
        rampup_Mimg=lr_args.get("rampup_Mimg", 10.0), ema_stds=tuple(ema_stds),
        nimg_mult=collate.nimg_mult, loss_clamp_3sigma=not plain_mse,
        force_wn=model_cfg.force_wn, num_accum=num_accum)

    net = NVPrecond(model_cfg, device=device, seed=seed).train()
    print0(param_table(net.state_dict()))
    print0(f"Parameters: {count_params(net.state_dict()) / 1e6:.2f} M")
    if fsdp:
        from vivid_tpu_torch.core.sharding import fsdp_shard
        fsdp_shard(net)
    state = init_train_state(net, train_cfg)
    step_fn = make_train_step(loss_fn, train_cfg, group=dist.group())
    generator = torch.Generator(device=device)
    nimg_per_step = batch_size * train_cfg.nimg_mult
    print0(f"{world} process(es), {dist.num_devices()} CUDA card(s) on this host, "
           f"{'fsdp' if fsdp else 'data parallel' if world > 1 else 'one process'}; "
           f"rank 0 on {device}; batch {batch_size} ({local_batch} a process in "
           f"{num_accum} microbatch(es)); {nimg_per_step} nimg per step "
           f"(nimg_mult {train_cfg.nimg_mult})")

    ckpt = checkpoint.CheckpointIO(state=state)
    resumed = checkpoint.latest_checkpoint(run_dir)
    if resumed is not None:
        print0(f"Resuming from {resumed} ...")
        t0 = time.perf_counter()
        ckpt.load(resumed)
        print0(f"Resumed at {state.cur_nimg} nimg, step {state.adam_step}, in "
               f"{time.perf_counter() - t0:.3f} s")

    stop_at_nimg = total_nimg
    if slice_nimg is not None:
        granularity = checkpoint_nimg or snapshot_nimg or batch_size
        stop_at_nimg = min(stop_at_nimg,
                           (state.cur_nimg + slice_nimg) // granularity * granularity)
    if stop_at_nimg <= state.cur_nimg:
        raise ValueError(f"nothing to train: at {state.cur_nimg} nimg, stop at {stop_at_nimg}")
    print0(f"Training from {state.cur_nimg // 1000} kimg to {stop_at_nimg // 1000} kimg "
           f"({(stop_at_nimg - state.cur_nimg) // nimg_per_step} steps):")

    # The loaders come after the resume: in deterministic mode they replay
    # the draws of the rows the earlier run consumed, one batch per step.
    steps_prev = state.cur_nimg // nimg_per_step
    loader = BatchLoader(iter(dataset), collate, batch_size=main_batch,
                         skip_rows=steps_prev * main_batch if deterministic else 0)
    single_loader = None
    if single_ds is not None:
        single_loader = BatchLoader(iter(single_ds), single_ds, batch_size=n_single,
                                    prefetch=1,
                                    skip_rows=steps_prev * n_single if deterministic else 0)

    wandb_run = None
    if rank == 0 and not debug and os.environ.get("WANDB_PROJECT"):
        try:
            import wandb
            wandb_run = wandb.init(project=os.environ["WANDB_PROJECT"], dir=run_dir,
                                   config=dict(batch_size=batch_size, seed=seed,
                                               network=net_kwargs))
        except ImportError:
            print0("wandb not installed; skipping wandb logging")
    pbar = None
    if progress_bar and not debug:
        try:
            from tqdm.auto import tqdm
            pbar = tqdm(total=stop_at_nimg, initial=state.cur_nimg, unit="img",
                        unit_scale=True, dynamic_ncols=True, desc="train")
        except ImportError:
            pass

    loader_wait = [0.0, 0]   # seconds blocked on the scene loader, rows fetched

    def with_depth(src, raw_src):
        """Source latents [B, S, H, W, C] with each view's predicted depth
        appended, from its pixels `raw_src`."""
        if depth_model is None:
            return src
        with torch.no_grad():
            flat = add_depth(depth_model, torch.as_tensor(raw_src, device=device).flatten(0, 1),
                             src.flatten(0, 1), inv_norm=model_cfg.depth_input)
        return flat.reshape(src.shape[:2] + flat.shape[1:])

    def fetch_batch():
        t0 = time.time()
        raw = next(loader)
        loader_wait[0] += time.time() - t0
        loader_wait[1] += len(raw["tgt_image"])
        if single_loader is not None:
            extra = next(single_loader)
            raw = {k: np.concatenate([raw[k], extra[k]], axis=0) for k in raw}
        return {"src": with_depth(encoder.encode_latents(raw["src_image"], device=device),
                                  raw["src_image"]),
                "tgt": encoder.encode_latents(raw["tgt_image"], device=device),
                "geometry": torch.as_tensor(raw["geometry"], device=device)}

    def save_snapshots(cur_nimg):
        for i, std in enumerate(train_cfg.ema_stds):
            ema = state.ema_state_dict(i)   # whole tensors: a collective under fsdp
            if rank != 0:
                continue
            fname = os.path.join(run_dir,
                                 f"network-snapshot-{cur_nimg // 1000:07d}-{std:.3f}.pkl")
            save_snapshot(fname, net, ema, dataset_kwargs=dataset_kwargs,
                          loss_kwargs=loss_kwargs)
            print0(f"Saved {fname}")

    eval_net = None   # a model holding EMA 0's weights, made at the first grid or tick

    def ema0_net():
        nonlocal eval_net
        if eval_net is None:
            eval_net = NVPrecond(model_cfg, device="meta").to_empty(device=device)
            eval_net.eval().requires_grad_(False)
        eval_net.load_state_dict(state.ema_state_dict(0))
        return eval_net

    def generate_sample_grid(cur_nimg):
        """Sources, samples and targets of `eval_samples` test rows in three
        rows of one PNG; the samples from EMA 0, unguided, 32 Heun steps, and
        through `sr_model` at its resolution when given. Rank 0 draws it; every
        rank takes part in gathering EMA 0."""
        eval_net = ema0_net()
        if rank != 0:
            return
        raw = next(test_loader)
        gen = torch.Generator(device=device).manual_seed(fold_in(seed, cur_nimg + 1))
        src = with_depth(encoder.encode_latents(raw["src_image"], device=device),
                         raw["src_image"])
        geometry = torch.as_tensor(raw["geometry"], device=device)
        noise = torch.randn(raw["tgt_image"].shape, generator=gen, device=device)
        cond = None
        if model_cfg.super_res:
            cond = down_up_resize(encoder.encode_latents(raw["tgt_image"], device=device), 4)
        with torch.no_grad():
            latents = edm_sampler(make_denoiser(eval_net, src, geometry,
                                                conditioning_image=cond, generator=gen),
                                  noise, num_steps=32)
            if sr_model is not None:
                res = sr_model.cfg.img_resolution
                sr_noise = torch.randn((len(latents), res, res, sr_model.cfg.img_channels),
                                       generator=gen, device=device)
                latents = sr_cascade(sr_model, encoder, latents, raw["sr_src_image"],
                                     raw["sr_geometry"], sr_noise, gen, num_steps=32)
                raw = dict(raw, src_image=raw["sr_src_image"], tgt_image=raw["sr_tgt_image"])
        rows = (np.clip(raw["src_image"][:, 0], 0, 255).astype(np.uint8),
                encoder.decode(latents), np.clip(raw["tgt_image"], 0, 255).astype(np.uint8))
        grid = np.concatenate([np.concatenate(list(row), axis=1) for row in rows], axis=0)
        out = os.path.join(run_dir, "results", f"generated-samples-{cur_nimg // 1000:07d}.png")
        PIL.Image.fromarray(grid, "RGB").save(out)
        print0(f"Saved {out}")
        if wandb_run is not None:
            import wandb
            wandb_run.log({"samples": wandb.Image(grid)}, step=cur_nimg)

    def metrics_tick(cur_nimg):
        """EMA 0 through `metrics_fn`; on a rank without results (None),
        nothing is printed or recorded."""
        results = metrics_fn(ema0_net(), model_cfg)
        if results is None:
            return
        print0(f"Metrics: {results}", flush=True)
        for k, v in results.items():
            stats_mod.report0(f"Metrics/{k}", float(v))
        if dist.get_rank() == 0:
            with open(os.path.join(run_dir, "metrics.jsonl"), "at") as f:
                f.write(json.dumps({"nimg": int(cur_nimg), "timestamp": time.time(),
                                    **{k: float(v) for k, v in results.items()}}) + "\n")
        if wandb_run is not None:
            wandb_run.log({f"metrics_{k}": float(v) for k, v in results.items()},
                          step=cur_nimg)

    start_nimg = state.cur_nimg

    def interval_hit(interval, cur, prev):
        """True when an interval boundary was crossed since the previous step."""
        if interval is None:
            return False
        return cur // interval != prev // interval or cur == start_nimg == 0

    # Reports left over by an earlier run in this process are not this run's.
    stats_mod.default_collector.update()
    stats_mod.default_collector.as_dict()
    stats_jsonl = None
    ticks, pending = [], []
    steps_done = 0
    cumulative_training_time = 0.0
    tick_start = time.time()
    prev_status_nimg = state.cur_nimg
    suspend_save = False   # set at a suspend tick: forces a checkpoint there
    try:
        while True:
            cur_nimg = state.cur_nimg
            prev_nimg = cur_nimg - nimg_per_step
            done = cur_nimg >= stop_at_nimg or (max_steps is not None
                                                and steps_done >= max_steps)
            if interval_hit(status_nimg, cur_nimg, prev_nimg) or done:
                # Reading the stats waits for the device: a tick's time is real.
                for s in pending:
                    stats_mod.report_dict({k: float(v) for k, v in s.items()})
                now = time.time()
                tick_time = now - tick_start
                report0 = stats_mod.report0
                report0("Progress/kimg", cur_nimg / 1e3)
                report0("Progress/iter", cur_nimg / nimg_per_step)
                report0("Timing/total_sec", now - start_time)
                report0("Timing/sec_per_tick", tick_time)
                report0("Timing/sec_per_kimg", cumulative_training_time
                        / max(cur_nimg - prev_status_nimg, 1) * 1e3)
                report0("Timing/maintenance_sec", tick_time - cumulative_training_time)
                report0("Timing/loader_wait_sec", loader_wait[0])
                report0("Timing/loader_rows_per_s", loader_wait[1] / max(tick_time, 1e-9))
                loader_wait[:] = [0.0, 0]
                report0("Resources/cpu_mem_gb",
                        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
                if device.type == "cuda":
                    report0("Resources/peak_gpu_mem_gb",
                            torch.cuda.max_memory_allocated(device) / 2**30)
                    report0("Resources/peak_gpu_mem_reserved_gb",
                            torch.cuda.max_memory_reserved(device) / 2**30)
                stats_mod.default_collector.update()
                snap = stats_mod.default_collector.as_dict()
                mean = lambda k: snap[k].mean if k in snap else float("nan")
                tick = dict(nimg=cur_nimg, steps=len(pending), loss=mean("Loss/loss"),
                            loss_std=mean("Loss/loss_std"),
                            learning_rate=mean("Loss/learning_rate"),
                            grad_norm=mean("Grad/global_norm"), seconds=tick_time)
                ticks.append(tick)
                if pbar is not None:
                    pbar.set_postfix(loss=f"{tick['loss']:.4f}", refresh=False)
                # The JAX package's fields first, at its widths; the port's after.
                print0(f"Status: kimg {cur_nimg / 1e3:<9.1f} loss {tick['loss']:<8.4f} "
                       f"time {format_time(now - start_time):<12s} "
                       f"sec/tick {tick_time:<8.2f} "
                       f"gnorm {tick['grad_norm']:<10.4f} lr {tick['learning_rate']:<10.3e}",
                       flush=True)
                if not debug and dist.get_rank() == 0:
                    if stats_jsonl is None:
                        stats_jsonl = open(os.path.join(run_dir, "stats.jsonl"), "at")
                    items = {name: v.mean for name, v in snap.items()}
                    items["timestamp"] = time.time()
                    stats_jsonl.write(json.dumps(items) + "\n")
                    stats_jsonl.flush()
                    if wandb_run is not None:
                        wandb_run.log({k.replace("/", "_"): v for k, v in items.items()},
                                      step=cur_nimg)
                pending = []
                cumulative_training_time = 0.0
                prev_status_nimg = cur_nimg
                tick_start = now
                dist.update_progress(cur_nimg // 1000, stop_at_nimg // 1000)
                if stop_at_nimg <= cur_nimg < total_nimg:
                    dist.request_suspend()   # the end of a slice
                # A SIGTERM on any rank suspends every rank here, together.
                if dist.should_stop() or dist.sync_suspend():
                    done = True
                    # The exact point of a suspend is checkpointed, unless
                    # checkpoints are off.
                    suspend_save = checkpoint_nimg is not None
                    print0(f"Suspending at {cur_nimg} nimg"
                           + (" with a checkpoint" if suspend_save else ""), flush=True)

            if cur_nimg != start_nimg:
                if grids and interval_hit(samples_nimg, cur_nimg, prev_nimg):
                    generate_sample_grid(cur_nimg)
                if metrics_fn is not None and interval_hit(metrics_nimg, cur_nimg, prev_nimg):
                    metrics_tick(cur_nimg)
                if interval_hit(snapshot_nimg, cur_nimg, prev_nimg):
                    save_snapshots(cur_nimg)
                if interval_hit(checkpoint_nimg, cur_nimg, prev_nimg) or suspend_save:
                    fname = os.path.join(run_dir, f"training-state-{cur_nimg // 1000:07d}.pt")
                    ckpt.save(fname, async_=True)   # every rank gathers; rank 0 writes
                    print0(f"Saving {fname} (written while training goes on)")
                    if world > 1:
                        check_param_consistency(dict(zip(state.names, state.params)),
                                                "net params")
                    dist.barrier("checkpoint")
            if done:
                break

            batch_start = time.time()
            batch = fetch_batch()
            # One stream per step and rank, a function of (seed, nimg, rank) alone.
            generator.manual_seed(fold_in(seed, cur_nimg) if world == 1
                                  else fold_in(fold_in(seed, cur_nimg), rank))
            pending.append(step_fn(state, batch, generator))
            steps_done += 1
            cumulative_training_time += time.time() - batch_start
            if pbar is not None:
                pbar.update(nimg_per_step)
    finally:
        ckpt.wait()
        for closing in (pbar, loader, single_loader, test_loader, stats_jsonl):
            if closing is not None:
                closing.close()
        if wandb_run is not None:
            wandb_run.finish()
    dist.barrier("done")   # no rank returns before rank 0's last file is written
    print0("Training done.")
    return EasyDict(state=state, ticks=ticks)
