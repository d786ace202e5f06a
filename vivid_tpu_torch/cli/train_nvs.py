"""Training CLI of the PyTorch port: the presets and flag names of the JAX
package's.

    python -m vivid_tpu_torch.cli.train_nvs --preset=vivid-base \\
        --data=scenes/ --outdir=runs/
    python -m vivid_tpu_torch.cli.train_nvs --preset=vivid-sr \\
        --data=scenes256/ --outdir=runs_sr/

`vivid-sr` trains the 256px super-resolution model (single source);
`--vanilla-mode` with a 64px preset trains the single-source base model. It
trains on the first CUDA card unless `--device cpu` is given. Under
`torchrun --nproc_per_node=N -m vivid_tpu_torch.cli.train_nvs ...` each
process trains on its card (cuda:LOCAL_RANK, NCCL; gloo with `--device
cpu`) with batch / N rows a step, data parallel, or with `--fsdp` the
parameters, gradients, Adam moments and EMAs sharded over the processes. Running the
same command again resumes from the latest training-state checkpoint in
`<outdir>/experiments`; `--slice` stops each run after that many images, at
a checkpoint. `--deterministic` makes a killed and resumed run end with the
bits of one that was never killed; on a CUDA card it needs
CUBLAS_WORKSPACE_CONFIG=:4096:8 in the environment. `--depth-model
small|base|large` (DepthAnythingV2 weights from $VIVID_DEPTH_DIR) conditions
the model on predicted depth: `--depth-input` feeds it to the encoder,
`--warp-depth-coor` feeds Fourier features of the pixel grid and of its
depth-warped form (not both). `--debug-nans` raises FloatingPointError at
the first module of the net whose output holds a NaN, with autograd's
anomaly mode on (slow; the JAX package's `jax_debug_nans`).
"""

import json
import os

import click

from vivid_tpu_torch.core import dist
from vivid_tpu_torch.core.easydict import EasyDict

config_presets = {
    "vivid-base": EasyDict(duration=500000, batch=1024, channels=128, lr=0.0120,
                           decay=35000, dropout=0.00, P_mean=-0.8, P_std=1.6,
                           extra_attn=1),
    "vivid-uncond": EasyDict(duration=1024 << 19, batch=1024, channels=128,
                             lr=0.0120, decay=35000, dropout=0.00, P_mean=-0.8,
                             P_std=1.6, extra_attn=1, uncond=True),
    # The shipped super-resolution model: single source, labels 20/20.
    "vivid-sr": EasyDict(duration=256 << 20, batch=128, channels=64, lr=0.0200,
                         decay=35000, dropout=0.00, P_mean=-0.8, P_std=1.6,
                         noisy_sr=0.25, sr_training=True, extra_attn=1,
                         vanilla_mode=True),
}

def parse_nimg(s):
    """Integer with optional power-of-two suffix: Ki=2^10, Mi=2^20, Gi=2^30."""
    if isinstance(s, int):
        return s
    for suffix, shift in (("Ki", 10), ("Mi", 20), ("Gi", 30)):
        if s.endswith(suffix):
            return int(s[:-2]) << shift
    return int(s)


def _parse_remat(value):
    if isinstance(value, str):
        low = value.lower()
        if low in ("true", "1", "yes"):
            return True
        if low in ("false", "0", "no"):
            return False
        if low == "save_dots":
            return "save_dots"
        raise click.ClickException(f"invalid --remat value {value!r}")
    return bool(value)


def setup_training_config(preset="vivid-base", **opts):
    """CLI options -> the keyword arguments of `training_loop`."""
    opts = EasyDict(opts)
    if preset not in config_presets:
        raise click.ClickException(f'Invalid configuration preset "{preset}"')
    for key, value in config_presets[preset].items():
        given = opts.get(key, None)
        if given is None or given is False:   # an explicit 0 is a value, not an absence
            opts[key] = value

    c = EasyDict()
    c.dataset_kwargs = EasyDict(path=opts.data)
    c.test_dataset_path = opts.get("test_data_path") or None
    c.vanilla_mode = bool(opts.get("vanilla_mode"))
    c.plain_mse = bool(opts.get("plain_mse"))
    num_sources = 1 if c.vanilla_mode else 2
    c.update(total_nimg=opts.duration, batch_size=opts.batch)
    c.network_kwargs = EasyDict(
        model_channels=opts.channels,
        dropout=opts.get("dropout", 0.0),
        extra_attn=opts.get("extra_attn"),
        epipolar_attention_bias=bool(opts.get("epipolar_attn_bias")),
        super_res=bool(opts.get("sr_training")),
        no_time_enc=bool(opts.get("no_time_enc")),
        depth_input=bool(opts.get("depth_input")),
        warp_depth_coor=bool(opts.get("warp_depth_coor")),
        uncond=bool(opts.get("uncond")),
        noisy_sr=0.25 if opts.get("noisy_sr") is None else opts["noisy_sr"],
        num_sources=num_sources,
        source_label_dim=20,
        target_label_dim=20 * num_sources,
        use_bf16=bool(opts.get("bf16", True)),
        force_wn=bool(opts.get("force_wn", False)),
        remat=_parse_remat(opts.get("remat", True)),
    )
    c.loss_kwargs = EasyDict(P_mean=opts.P_mean, P_std=opts.P_std)
    c.lr_kwargs = EasyDict(ref_lr=opts.lr, ref_batches=opts.decay)
    c.loss_scaling = opts.get("ls", 1)
    c.batch_gpu = opts.get("batch_gpu") or None
    c.sr_training = bool(opts.get("sr_training"))
    c.status_nimg = opts.get("status") or None
    c.samples_nimg = opts.get("samples") or None
    c.metrics_nimg = opts.get("metrics") or None
    c.metrics_list = [m for m in (opts.get("metrics_list") or "").split(",") if m] or None
    c.snapshot_nimg = opts.get("snapshot") or None
    c.checkpoint_nimg = opts.get("checkpoint") or None
    c.seed = opts.get("seed", 0)
    c.sr_model = opts.get("sr_model") or None
    c.depth_model = opts.get("depth_model") or None
    c.single_image_mix = opts.get("single_image_mix") or None
    c.single_image_mix_path = opts.get("single_image_path") or None
    c.slice_nimg = opts.get("slice") or None
    c.deterministic = bool(opts.get("deterministic"))
    c.fsdp = bool(opts.get("fsdp"))
    if opts.get("debug_nans"):   # only when asked: in the JAX package it is a JAX flag
        c.debug_nans = True
    c.max_steps = opts.get("max_steps") or None
    c.device = opts.get("device") or None
    return c


def print_training_config(run_dir, c):
    dist.print0()
    dist.print0("Training config:")
    dist.print0(json.dumps(c, indent=2))
    dist.print0()
    dist.print0(f"Output directory:        {run_dir}")
    dist.print0(f"Number of processes:     {dist.get_world_size()}")
    dist.print0(f"CUDA cards on this host: {dist.num_devices()}")
    dist.print0(f"Batch size:              {c.batch_size}")
    dist.print0()


def save_code_snapshot(run_dir):
    """The run's provenance in `<run_dir>/code/`: provenance.json (argv,
    launch time, Python and torch versions, the git revision and whether the
    tree was dirty, where there is a git checkout) and source.tar.gz, the
    `vivid_tpu_torch` package as it ran."""
    import subprocess
    import sys
    import tarfile
    import time

    import torch
    code_dir = os.path.join(run_dir, "code")
    os.makedirs(code_dir, exist_ok=True)
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prov = {"argv": list(sys.argv), "launch_time": time.time(),
            "python": sys.version.split()[0], "torch_version": torch.__version__}
    try:
        git = ["git", "-C", os.path.dirname(pkg_dir)]
        rev = subprocess.run(git + ["rev-parse", "HEAD"], capture_output=True, text=True,
                             timeout=10)
        if rev.returncode == 0:
            prov["git_rev"] = rev.stdout.strip()
            dirty = subprocess.run(git + ["status", "--porcelain"], capture_output=True,
                                   text=True, timeout=10)
            prov["git_dirty"] = bool(dirty.stdout.strip())
    except (OSError, subprocess.SubprocessError):
        pass
    with open(os.path.join(code_dir, "provenance.json"), "wt") as f:
        json.dump(prov, f, indent=2)

    def keep(info):
        return None if "__pycache__" in info.name or info.name.endswith((".pyc", ".so")) \
            else info

    with tarfile.open(os.path.join(code_dir, "source.tar.gz"), "w:gz") as tar:
        tar.add(pkg_dir, arcname="vivid_tpu_torch", filter=keep)


def launch_training(run_dir, c):
    """Rank 0 writes the options and the code snapshot; every rank then
    trains (`training_loop` starts the process group if there is none)."""
    dist.init(device=c.get("device"))
    if dist.get_rank() == 0:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "training_options.json"), "wt") as f:
            json.dump(c, f, indent=2)
        save_code_snapshot(run_dir)
    dist.barrier("launch")
    from vivid_tpu_torch.train.loop import training_loop
    return training_loop(run_dir=run_dir, **c)


@click.command()
# Main options.
@click.option("--outdir", help="Where to save the results", metavar="DIR", type=str, default="output_nonvanilla/")
@click.option("--data", help="Path to scene dataset (.npz dir)", metavar="DIR", type=str, required=True)
@click.option("--preset", help="Configuration preset", metavar="STR", type=str, default="vivid-base", show_default=True)
@click.option("--sr-training", help="Toggles training of SR model", is_flag=True)
# Hyperparameters.
@click.option("--duration", help="Training duration", metavar="NIMG", type=parse_nimg, default=None)
@click.option("--batch", help="Total batch size", metavar="NIMG", type=parse_nimg, default=None)
@click.option("--channels", help="Channel multiplier", metavar="INT", type=click.IntRange(min=16), default=None)
@click.option("--dropout", help="Dropout probability", metavar="FLOAT", type=click.FloatRange(min=0, max=1), default=None)
@click.option("--P_mean", "P_mean", help="Noise level mean", metavar="FLOAT", type=float, default=None)
@click.option("--P_std", "P_std", help="Noise level standard deviation", metavar="FLOAT", type=click.FloatRange(min=0, min_open=True), default=None)
@click.option("--lr", help="Learning rate max. (alpha_ref)", metavar="FLOAT", type=click.FloatRange(min=0, min_open=True), default=None)
@click.option("--decay", help="Learning rate decay (t_ref)", metavar="BATCHES", type=click.FloatRange(min=0), default=None)
@click.option("--extra-attn", help="Force attention on block k per level", metavar="INT", type=int, default=None)
# NVS params.
@click.option("--epipolar-attn-bias", help="Use epipolar attn bias", is_flag=True)
@click.option("--no-time-enc", help="Nullify time input in Encoder model", is_flag=True)
@click.option("--depth-model", help="Depth model type (weights from $VIVID_DEPTH_DIR)", metavar="small|base|large", type=str, default=None)
@click.option("--depth-input", help="Adds depth in input", is_flag=True)
@click.option("--warp-depth-coor", help="Add coordinates and warped coordinates as input", is_flag=True)
@click.option("--single-image-mix", help="Use single image augmentations, percent of batch", type=float, default=None)
@click.option("--single-image-path", help="Directory of single images for the mix  [default: --data]", metavar="DIR", type=str, default=None)
@click.option("--uncond", help="Regular (unconditional) diffusion", is_flag=True)
@click.option("--noisy-sr", help="Adds noise to low-res image", type=float, default=None)
@click.option("--sr-model", help="Path to SR model to use for evaluation", metavar="STR", type=str, required=False)
@click.option("--test-data-path", help="Path to the test dataset (sample grids)", metavar="DIR", type=str, default=None)
@click.option("--vanilla-mode", help="Single-source conditioning", is_flag=True)
@click.option("--plain-mse", help="Plain MSE loss instead of learned variance", is_flag=True)
# Performance-related options.
@click.option("--batch-gpu", help="Limit the microbatch size (gradient accumulation)", metavar="NIMG", type=parse_nimg, default=None)
@click.option("--fsdp", help="Shard the train state over the processes (FSDP2)", is_flag=True)
@click.option("--deterministic", help="Bit-reproducible kill and resume: the resumed loaders replay the consumed rows; deterministic algorithms on the card (needs CUBLAS_WORKSPACE_CONFIG=:4096:8)", is_flag=True)
@click.option("--bf16", help="Enable bfloat16 compute", metavar="BOOL", type=bool, default=True, show_default=True)
@click.option("--force-wn", help="Forced weight normalization (EDM2 Eq. 66)", metavar="BOOL", type=bool, default=False, show_default=True)
@click.option("--remat", help="Recompute blocks in backward: true, false, or save_dots (keep what the JAX package names mpconv_out and attn_out: MPConv products and attention outputs, the convolutions above VIVID_REMAT_HIRES_AREA excepted; wnorm too under VIVID_SAVE_WNORM; recompute the rest)", metavar="BOOL|save_dots", type=str, default="true", show_default=True)
@click.option("--ls", help="Loss scaling", metavar="FLOAT", type=click.FloatRange(min=0, min_open=True), default=1, show_default=True)
@click.option("--device", help="Device to train on  [default: cuda]", metavar="STR", type=str, default=None)
# I/O-related options.
@click.option("--status", help="Interval of status prints", metavar="NIMG", type=parse_nimg, default="960", show_default=True)
@click.option("--samples", help="Interval of sample generation", metavar="NIMG", type=parse_nimg, default="9600", show_default=True)
@click.option("--metrics", help="Interval of metrics ticks (needs --test-data-path)", metavar="NIMG", type=parse_nimg, default=None)
@click.option("--metrics-list", help="Comma-separated metrics for in-training evals (default: fid,fd_dinov2,joint_fid,joint_fd_dinov2,psnr)", metavar="LIST", type=str, default="")
@click.option("--snapshot", help="Interval of network snapshots", metavar="NIMG", type=parse_nimg, default="10000", show_default=True)
@click.option("--checkpoint", help="Interval of training checkpoints", metavar="NIMG", type=parse_nimg, default="10000", show_default=True)
@click.option("--slice", help="Train in slices of this many nimg", metavar="NIMG", type=parse_nimg, default=None)
@click.option("--max-steps", help="Stop after this many optimizer steps", metavar="INT", type=click.IntRange(min=1), default=None)
@click.option("--seed", help="Random seed", metavar="INT", type=int, default=0, show_default=True)
@click.option("--debug-nans", help="Raise at the first module whose output holds a NaN, with autograd's anomaly mode (slow)", is_flag=True)
@click.option("--dry-run", help="Print training options and exit", is_flag=True)
def cmdline(outdir, dry_run, **opts):
    """Train a VIVID NVS diffusion model.

    Examples:

    \\b
    python -m vivid_tpu_torch.cli.train_nvs --preset=vivid-base --data=/path/to/scenes --outdir=runs/
    """
    c = setup_training_config(**opts)
    dist.init(device=c.device)
    run_dir = os.path.join(outdir, "experiments")
    print_training_config(run_dir, c)
    if dry_run:
        dist.print0("Dry run; exiting.")
        return None
    return launch_training(run_dir=run_dir, c=c)


if __name__ == "__main__":
    cmdline()
