"""Generation CLI of the PyTorch port: the same flags as the JAX package's.

    python -m vivid_tpu_torch.cli.generate_images --net=base.pkl \\
        --gnet=uncond.pkl --guidance=1.5 --sr-model=sr.pkl --data=scenes/ --outdir=out

`--sr-model` takes the 64px samples through the 256px super-resolution
model; `--net` may also be a 256px model itself (its conditioning is then
the target view taken down and up again). Runs on the first CUDA card and
fails without one; `--device cpu` asks for the CPU.
"""

import re

import click
import tqdm

from vivid_tpu_torch.core.easydict import EasyDict
from vivid_tpu_torch.generate import config_presets, generate_images_nvs


def parse_int_list(s):
    """'1,2,5-10' -> [1, 2, 5, 6, 7, 8, 9, 10]."""
    if isinstance(s, list):
        return s
    ranges = []
    range_re = re.compile(r"^(\d+)-(\d+)$")
    for p in s.split(","):
        m = range_re.match(p)
        if m:
            ranges.extend(range(int(m.group(1)), int(m.group(2)) + 1))
        else:
            ranges.append(int(p))
    return ranges


@click.command()
@click.option("--preset", help="Configuration preset", metavar="STR", type=str, default=None)
@click.option("--net", help="Network snapshot filename", metavar="PATH", type=str, default=None)
@click.option("--data", "data_path", help="Path to scene dataset for conditioning", metavar="DIR", type=str, required=True)
@click.option("--outdir", help="Where to save the output images", metavar="DIR", type=str, required=True)
@click.option("--subdirs", help="Create subdirectory for every 1000 seeds", is_flag=True)
@click.option("--seeds", help="List of random seeds (e.g. 1,2,5-10)", metavar="LIST", type=parse_int_list, default="16-19", show_default=True)
@click.option("--class", "class_idx", help="Class label  [default: random]", metavar="INT", type=click.IntRange(min=0), default=None)
@click.option("--batch", "max_batch_size", help="Maximum batch size", metavar="INT", type=click.IntRange(min=1), default=32, show_default=True)
@click.option("--steps", "num_steps", help="Number of sampling steps", metavar="INT", type=click.IntRange(min=1), default=32, show_default=True)
@click.option("--sigma_min", help="Lowest noise level", metavar="FLOAT", type=click.FloatRange(min=0, min_open=True), default=0.002, show_default=True)
@click.option("--sigma_max", help="Highest noise level", metavar="FLOAT", type=click.FloatRange(min=0, min_open=True), default=80, show_default=True)
@click.option("--rho", help="Time step exponent", metavar="FLOAT", type=click.FloatRange(min=0, min_open=True), default=7, show_default=True)
@click.option("--guidance", help="Guidance strength  [default: 1; no guidance]", metavar="FLOAT", type=float, default=None)
@click.option("--S_churn", "S_churn", help="Stochasticity strength", metavar="FLOAT", type=click.FloatRange(min=0), default=0, show_default=True)
@click.option("--S_min", "S_min", help="Stoch. min noise level", metavar="FLOAT", type=click.FloatRange(min=0), default=0, show_default=True)
@click.option("--S_max", "S_max", help="Stoch. max noise level", metavar="FLOAT", type=click.FloatRange(min=0), default="inf", show_default=True)
@click.option("--S_noise", "S_noise", help="Stoch. noise inflation", metavar="FLOAT", type=float, default=1, show_default=True)
@click.option("--sr-model", help="Path to SR model snapshot", metavar="STR", type=str, default=None, show_default=True)
@click.option("--gnet", help="Reference network for guidance", metavar="PATH", type=str, default=None)
@click.option("--range-selection", help="Range selection", metavar="MID,LONG", type=str, default=None, show_default=True)
@click.option("--depth-model", help="Depth model to use for evaluation (small|base|large, weights from $VIVID_DEPTH_DIR)", metavar="STR", type=str, default=None, show_default=True)
@click.option("--vanilla-mode", help="Single-source conditioning", is_flag=True)
@click.option("--device", help="Device to sample on  [default: cuda; fails without a card]", metavar="STR", type=str, default=None)
@click.option("--tp", help="Tensor-parallel ways over the local devices (latency lever)", metavar="INT", type=click.IntRange(min=0), default=0)
def cmdline(preset, data_path, **opts):
    """Generate novel views using the given model.

    Examples:

    \b
    python -m vivid_tpu_torch.cli.generate_images --net=network-snapshot.pkl --data=scenes/ --outdir=out
    """
    opts = EasyDict(opts)
    if preset is not None:
        if preset not in config_presets:
            raise click.ClickException(f'Invalid configuration preset "{preset}"')
        for key, value in config_presets[preset].items():
            if opts.get(key) is None:
                opts[key] = value
    if opts.net is None:
        raise click.ClickException("Please specify either --preset or --net")
    if opts.guidance is None or opts.guidance == 1:
        opts.guidance = 1
        opts.gnet = None
    elif opts.gnet is None:
        raise click.ClickException("Please specify --gnet when using guidance")
    opts["datakwargs"] = {"path": data_path}
    for _r in tqdm.tqdm(generate_images_nvs(**opts), unit="batch"):
        pass


if __name__ == "__main__":
    cmdline()
