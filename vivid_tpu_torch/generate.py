"""Image generation: load snapshots, sample novel views, write PNGs.

Counterpart of vivid_tpu/generate.py `generate_images_nvs` for the guided
base path on one process: a lazy iterable that yields EasyDict(images,
latents, src, tgt, seeds, ...) per batch and writes
src_/tgt_/sample_{seed:06d}.png when `outdir` is set. Per-seed noise comes from per-seed generators, so a sample
depends on its seed and its conditioning only. The SR cascade, depth
conditioning, single-source mode and tensor parallelism are not ported yet
and raise.
"""

import os
from typing import Optional

import numpy as np
import PIL.Image
import torch

from vivid_tpu_torch.core.easydict import EasyDict
from vivid_tpu_torch.core.rngs import seeded_normal
from vivid_tpu_torch.data.collate import BatchLoader, DualSourceCollate
from vivid_tpu_torch.data.encoders import StandardRGBEncoder
from vivid_tpu_torch.data.scenes import SceneDataset
from vivid_tpu_torch.diffusion.sampler import edm_sampler, make_denoiser
from vivid_tpu_torch.train.snapshots import load_snapshot

config_presets = {
    "vivid": EasyDict(net="vivid-base.pkl", sr_model="vivid-sr.pkl",
                      gnet="vivid-uncond.pkl", guidance=1.5,
                      range_selection="mid"),
}


def resolve_model(model, device):
    """Snapshot path -> loaded EasyDict(net, cfg, ...); EasyDict/None pass."""
    if isinstance(model, str):
        return load_snapshot(model, device=device)
    return model


def open_scene_dataset(path: str, seed: int = 0):
    if os.path.basename(os.path.normpath(path)) == "RealEstate10K" or \
            os.path.isdir(os.path.join(path, "RealEstate10K")):
        raise NotImplementedError("the RealEstate10K txt+png reader is not ported; "
                                  "use a directory of scene .npz files")
    return SceneDataset(path, seed=seed)


def generate_images_nvs(
    net,                                  # snapshot path or loaded EasyDict
    gnet=None,                            # guidance net (autoguidance reference)
    encoder=None,
    outdir: Optional[str] = None,
    subdirs: bool = False,
    seeds=range(16, 24),
    class_idx=None,                       # accepted for CLI parity; unused
    max_batch_size: int = 32,
    verbose: bool = True,
    datakwargs: Optional[dict] = None,
    range_selection=None,                 # RealEstate10K only; unused here
    sr_model=None,
    depth_model=None,
    vanilla_mode: bool = False,
    guidance: float = 1.0,
    rng_seed: int = 0,
    tp: int = 0,
    device=None,
    **sampler_kwargs,
):
    for name, value in (("sr_model", sr_model), ("depth_model", depth_model),
                        ("vanilla_mode", vanilla_mode), ("tp", tp)):
        if value:
            raise NotImplementedError(f"{name} is not ported to vivid_tpu_torch yet")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    net = resolve_model(net, device)
    gnet = resolve_model(gnet, device)
    if encoder is None:
        encoder = StandardRGBEncoder()
    cfg = net.cfg
    if cfg.img_resolution == 256:
        raise NotImplementedError("super-resolution models are not ported yet")
    imsize = cfg.img_resolution
    seeds = list(seeds)
    num_batches = max((len(seeds) - 1) // max_batch_size + 1, 1)
    batches = np.array_split(np.arange(len(seeds)), num_batches)

    datakwargs = dict(datakwargs or {})
    dataset = open_scene_dataset(datakwargs["path"], seed=rng_seed)
    use_gnet = gnet is not None and guidance != 1
    if verbose:
        print(f"Generating {len(seeds)} images on {device}...")

    class ImageIterable:
        def __len__(self):
            return len(batches)

        def __iter__(self):
            loader = BatchLoader(iter(dataset), DualSourceCollate(imsize, seed=rng_seed),
                                 batch_size=max_batch_size)
            try:
                for batch_idx, indices in enumerate(batches):
                    yield self._batch(loader, batch_idx, indices)
            finally:
                loader.close()

        def _batch(self, loader, batch_idx, indices):
            r = EasyDict(images=None, latents=None, src=None, tgt=None, batch_idx=batch_idx,
                         num_batches=len(batches), indices=indices,
                         seeds=[seeds[int(i)] for i in indices])
            if not r.seeds:
                return r
            raw = next(loader)
            n = min(len(r.seeds), int(raw["valid"].sum()))
            r.seeds = r.seeds[:n]
            src_raw = raw["src_image"][:n]
            tgt_raw = raw["tgt_image"][:n]
            geometry = torch.as_tensor(raw["geometry"][:n], device=device)
            src = encoder.encode_latents(src_raw, device=device)
            noise = seeded_normal(r.seeds, (imsize, imsize, cfg.img_channels), device)
            with torch.no_grad():
                denoise = make_denoiser(net.net, src, geometry)
                gden = None
                if use_gnet:
                    # An unconditional gnet gets neither sources nor geometry.
                    g_uncond = gnet.cfg.uncond
                    gden = make_denoiser(gnet.net, None if g_uncond else src,
                                         None if g_uncond else geometry)
                latents = edm_sampler(denoise, noise, gnet_denoise=gden,
                                      guidance=guidance, seeds=r.seeds, **sampler_kwargs)
            r.latents = latents
            r.images = encoder.decode(latents)
            r.src = src_raw[:, 0]
            r.tgt = tgt_raw
            if outdir is not None:
                for seed, _src, _tgt, image in zip(
                        r.seeds, np.clip(r.src, 0, 255).astype(np.uint8),
                        np.clip(r.tgt, 0, 255).astype(np.uint8), r.images):
                    image_dir = (os.path.join(outdir, f"{seed // 1000 * 1000:06d}")
                                 if subdirs else outdir)
                    os.makedirs(image_dir, exist_ok=True)
                    PIL.Image.fromarray(_src, "RGB").save(
                        os.path.join(image_dir, f"src_{seed:06d}.png"))
                    PIL.Image.fromarray(_tgt, "RGB").save(
                        os.path.join(image_dir, f"tgt_{seed:06d}.png"))
                    PIL.Image.fromarray(image, "RGB").save(
                        os.path.join(image_dir, f"sample_{seed:06d}.png"))
            return r

    return ImageIterable()
