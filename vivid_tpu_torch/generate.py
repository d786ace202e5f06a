"""Image generation: load snapshots, sample novel views, optionally take
them through the 256px super-resolution stage, write PNGs.

Counterpart of vivid_tpu/generate.py `generate_images_nvs`: a
lazy iterable that yields EasyDict(images, latents, src, tgt, seeds, ...) per
batch and writes src_/tgt_/sample_{seed:06d}.png when `outdir` is set.
Per-seed noise comes from per-seed generators, so a sample depends on its
seed and its conditioning only. Three modes:

  * base: `net` is a 64px model, optionally guided by `gnet`;
  * cascade: with `sr_model`, the base sample is upsampled bilinearly to the
    SR model's resolution and conditions its sampling (no guidance there);
    the SR images replace the base images in the result and the PNGs;
  * SR only: `net` itself is a super-resolution model (`cfg.super_res`; the
    JAX package keys this on a resolution of 256, which the shipped model
    has); its conditioning image is the target view taken down by 4 and up
    again.

`datakwargs` open the scene dataset (data/re10k_scenes.py
`open_scene_dataset`: a RealEstate10K tree or a directory of scene .npz
files); `range_selection` ('mid', 'long') joins them, and an .npz directory
drops it. A RealEstate10K tree is read at its test split unless `datakwargs`
names another (the reference's generator reads its test loader; the JAX
package reads the train split). The noise on an SR model's conditioning
image (`noisy_sr`) is one draw per batch from a generator seeded by
(`rng_seed`, batch index). With `depth_model` (a callable, or 'small' |
'base' | 'large' from $VIVID_DEPTH_DIR: geometry/depth.py) each source view
gets its predicted depth as a fourth channel, inverse-normalised for a
`depth_input` model. Runs on this process's card (cuda:LOCAL_RANK); the
CPU only when `device="cpu"` asks for it.

Over several processes the seeds are split into batches dealt out to the
ranks, and each rank reads its own share of the scenes (`process_index`,
`process_count`), as the JAX package does; each writes its own seeds' PNGs.
With `tp` > 1 the ranks form tensor-parallel groups of `tp` consecutive
ranks (`core/sharding.py`): the seeds and scenes are split over the groups,
every rank of a group samples the same rows with the same generators, and
each block's channels and heads are split over the group's ranks (the nets
passed in stay split). Only the first rank of a group writes PNGs and hands
images on; the others yield rows without images, as a rank without seeds
does.

PNGs are written on one writer thread a call, so that a batch's PNGs are
written while the card samples the next batch. At most one batch is in
the writer's hands: a batch is yielded only once the PNGs of the batch
before it are on disk, and the iteration's end, `close()` or an exception
waits for the last batch's. A writer's error is raised on the sampling
thread, at the next batch or at the end; where sampling failed too, the
sampling error is raised and the writer's is chained to it.

Each batch is a root span `generate.batch` (`core/trace.py`; attributes
`batch_idx`, `rows`, `num_steps` and `call`, the id of this call) over the
spans of its parts on the sampling thread: `loader.wait`, `generate.prepare`
(inputs encoded, noise, conditioning, the denoisers bound), `generate.sample`
(the sampler's host time; `generate.sr` for the cascade's SR stage),
`generate.decode` (its copy to the host waits for the card),
`generate.png_wait` (the wait for the batch before's PNGs; with `outdir`)
and `generate.barrier`. The writer thread's `generate.png` (`files`,
`batch_idx`) is under the same root and ends after it.
"""

import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import PIL.Image
import torch
import torch.nn.functional as F

from vivid_tpu_torch.core import dist
from vivid_tpu_torch.core.easydict import EasyDict
from vivid_tpu_torch.core.rngs import fold_in, seeded_normal
from vivid_tpu_torch.core.trace import span
from vivid_tpu_torch.data.collate import BatchLoader, DualSourceCollate, VanillaCollate
from vivid_tpu_torch.data.encoders import StandardRGBEncoder
from vivid_tpu_torch.data.re10k_scenes import open_scene_dataset
from vivid_tpu_torch.diffusion.loss import down_up_resize
from vivid_tpu_torch.diffusion.sampler import NUM_STEPS, edm_sampler, make_denoiser
from vivid_tpu_torch.geometry.depth import add_depth, resolve_depth_model
from vivid_tpu_torch.train.snapshots import load_snapshot

_calls = itertools.count()   # ids of `generate_images_nvs` calls, on their batches' spans

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
    range_selection=None,                 # 'mid' / 'long'; RealEstate10K trees only
    sr_model=None,
    depth_model=None,
    vanilla_mode: bool = False,
    guidance: float = 1.0,
    rng_seed: int = 0,
    tp: int = 0,
    device=None,
    **sampler_kwargs,
):
    device = torch.device(device) if device is not None else dist.default_device()
    rank, world = dist.get_rank(), dist.get_world_size()
    tp_group, tp_index, data_index, data_count = None, 0, rank, world
    if tp and tp > 1:
        if world == 1:
            raise ValueError(f"tp={tp} splits the model over the ranks of a process group: "
                             "start the processes with torchrun (or VIVID_COORDINATOR)")
        from vivid_tpu_torch.core.sharding import tp_groups
        tp_group, tp_index, data_index, data_count = tp_groups(tp)
    # Rank 0 loads first, the others after it (the reference's order).
    if rank != 0:
        dist.barrier("load-net")
    net = resolve_model(net, device)
    gnet = resolve_model(gnet, device)
    sr_model = resolve_model(sr_model, device)
    if rank == 0:
        dist.barrier("load-net")
    if tp_group is not None:
        from vivid_tpu_torch.core.sharding import tensor_parallel
        for model in (net, gnet, sr_model):
            if model is not None:
                tensor_parallel(model.net, tp_group)
    depth_model = resolve_depth_model(depth_model, device=device)
    if (net.cfg.depth_input or net.cfg.warp_depth_coor) and depth_model is None:
        raise ValueError("a depth_input or warp_depth_coor model needs a depth_model")
    if encoder is None:
        encoder = StandardRGBEncoder()
    cfg = net.cfg
    imsize = cfg.img_resolution
    super_res = cfg.super_res
    if super_res and sr_model is not None:
        raise ValueError("net is itself an SR model; give sr_model only with a base net")
    # With an SR model in play a row's SR fields come at its size, the base fields at 64.
    sr_cfg = sr_model.cfg if sr_model is not None else (cfg if super_res else None)
    sr_size = sr_cfg.img_resolution if sr_cfg is not None else None
    collate_cls = VanillaCollate if vanilla_mode else DualSourceCollate
    base_size = 64 if sr_cfg is not None else imsize
    seeds = list(seeds)
    # Seed sharding over the data groups (one a rank without tp).
    num_batches = max((len(seeds) - 1) // (max_batch_size * data_count) + 1, 1) * data_count
    batches = np.array_split(np.arange(len(seeds)), num_batches)[data_index::data_count]

    datakwargs = dict(datakwargs or {})
    datakwargs.setdefault("split", "test")   # a RealEstate10K tree's; an .npz tree drops it
    if range_selection is not None:
        datakwargs.setdefault("range_selection", range_selection)
    dataset = open_scene_dataset(
        datakwargs["path"], seed=rng_seed, process_index=data_index, process_count=data_count,
        **{k: v for k, v in datakwargs.items() if k not in ("path", "class_name")})
    use_gnet = gnet is not None and guidance != 1
    num_steps = sampler_kwargs.get("num_steps", NUM_STEPS)
    evaluations = 2 * num_steps - 1     # the sampler's calls of a net (and its guide) a batch
    call = next(_calls)
    if verbose:
        dist.print0(f"Generating {len(seeds)} images on {world} process(es)"
                    + (f" in tensor-parallel groups of {tp}" if tp_group is not None else "")
                    + f"; rank 0 on {device}...")

    class ImageIterable:
        def __len__(self):
            return len(batches)

        def __iter__(self):
            loader = BatchLoader(
                iter(dataset), collate_cls(base_size, sr_size=sr_size, seed=rng_seed),
                batch_size=max_batch_size, prefetch=2, num_threads=2)
            writer = (ThreadPoolExecutor(max_workers=1, thread_name_prefix="vivid-png")
                      if outdir is not None and tp_index == 0 else None)
            written = None          # the writer's future of the last batch handed to it
            failure = None
            try:
                for batch_idx, indices in enumerate(batches):
                    with span("generate.batch", batch_idx=batch_idx, rows=len(indices),
                              num_steps=num_steps, call=call) as root:
                        r, pngs = self._batch(loader, batch_idx, indices)
                        if writer is not None:
                            with span("generate.png_wait"):
                                done, written = written, None
                                if done is not None:
                                    done.result()
                            if pngs is not None:
                                written = writer.submit(self._write, root, batch_idx, *pngs)
                        with span("generate.barrier"):
                            dist.barrier("gen-batch")
                    yield r
            except BaseException as e:
                failure = e
                raise
            finally:
                loader.close()
                if writer is not None:
                    try:
                        if written is not None:
                            written.result()
                    except Exception as write_error:
                        if failure is None or isinstance(failure, GeneratorExit):
                            raise
                        failure.__context__ = failure.__context__ or write_error
                        failure.add_note(f"The PNG writer failed too: {write_error!r}")
                    finally:
                        writer.shutdown()

        def _batch(self, loader, batch_idx, indices):
            r = EasyDict(images=None, latents=None, src=None, tgt=None, labels=None,
                         noise=None, batch_idx=batch_idx,
                         num_batches=len(batches), indices=indices,
                         seeds=[seeds[int(i)] for i in indices])
            if not r.seeds:
                return r, None
            raw = next(loader)
            with span("generate.prepare"):
                n = min(len(r.seeds), int(raw["valid"].sum()))
                r.seeds = r.seeds[:n]
                prefix = "sr_" if super_res else ""
                src_raw = raw[prefix + "src_image"][:n]
                tgt_raw = raw[prefix + "tgt_image"][:n]
                geometry = torch.as_tensor(raw[prefix + "geometry"][:n], device=device)
                src = encoder.encode_latents(src_raw, device=device)
                if depth_model is not None:
                    # Depth of each source view, from its pixels.
                    flat_raw = torch.as_tensor(src_raw, device=device).flatten(0, 1)
                    flat = add_depth(depth_model, flat_raw, src.flatten(0, 1),
                                     inv_norm=cfg.depth_input)
                    src = flat.reshape(src.shape[:2] + flat.shape[1:])
                noise = seeded_normal(r.seeds, (imsize, imsize, cfg.img_channels), device)
                # One stream per batch for the conditioning noise of an SR model.
                gen = torch.Generator(device=device).manual_seed(fold_in(rng_seed, batch_idx))
                with torch.no_grad():
                    cond = None
                    if super_res:
                        cond = down_up_resize(encoder.encode_latents(tgt_raw, device=device), 4)
                    denoise = make_denoiser(net.net, src, geometry, conditioning_image=cond,
                                            generator=gen)
                    gden = None
                    if use_gnet:
                        # An unconditional gnet gets neither sources nor geometry.
                        g_uncond = gnet.cfg.uncond
                        gden = make_denoiser(gnet.net, None if g_uncond else src,
                                             None if g_uncond else geometry)
            with torch.no_grad():
                with span("generate.sample", evaluations=evaluations):
                    latents = edm_sampler(denoise, noise, gnet_denoise=gden,
                                          guidance=guidance, seeds=r.seeds, **sampler_kwargs)
                r.src, r.tgt = src_raw[:, 0], tgt_raw
                if sr_model is not None:
                    with span("generate.sr", evaluations=evaluations):
                        latents = self._sr_stage(raw, n, r, latents, gen)
            if tp_index != 0:   # the first rank of the group hands the images on
                r.src = r.tgt = None
                return r, None
            r.latents = latents
            with span("generate.decode"):
                r.images = encoder.decode(latents)
            if outdir is None:
                return r, None
            # The writer's own arrays: a caller that changes the yielded ones
            # cannot change the files.
            return r, (list(r.seeds), np.clip(r.src, 0, 255).astype(np.uint8),
                       np.clip(r.tgt, 0, 255).astype(np.uint8), np.array(r.images))

        def _write(self, root, batch_idx, seeds, src, tgt, images):
            """A batch's PNGs, on the writer thread, under the batch's root span."""
            with span("generate.png", parent=root, files=3 * len(seeds), batch_idx=batch_idx):
                for seed, _src, _tgt, image in zip(seeds, src, tgt, images):
                    image_dir = (os.path.join(outdir, f"{seed // 1000 * 1000:06d}")
                                 if subdirs else outdir)
                    os.makedirs(image_dir, exist_ok=True)
                    PIL.Image.fromarray(_src, "RGB").save(
                        os.path.join(image_dir, f"src_{seed:06d}.png"))
                    PIL.Image.fromarray(_tgt, "RGB").save(
                        os.path.join(image_dir, f"tgt_{seed:06d}.png"))
                    PIL.Image.fromarray(image, "RGB").save(
                        os.path.join(image_dir, f"sample_{seed:06d}.png"))

        def _sr_stage(self, raw, n, r, latents, gen):
            """Sample the SR model on the base latents upsampled to its
            resolution; sets r.src / r.tgt to the SR-size views."""
            res = sr_model.cfg.img_resolution
            sr_noise = seeded_normal(r.seeds, (res, res, sr_model.cfg.img_channels), device)
            r.src, r.tgt = raw["sr_src_image"][:n, 0], raw["sr_tgt_image"][:n]
            return sr_cascade(sr_model, encoder, latents, raw["sr_src_image"][:n],
                              raw["sr_geometry"][:n], sr_noise, gen, seeds=r.seeds,
                              **sampler_kwargs)

    return ImageIterable()


def sr_cascade(sr_model, encoder, latents, sr_src_raw, sr_geometry, sr_noise, generator,
               **sampler_kwargs):
    """Sample `sr_model` (a loaded EasyDict) conditioned on the base latents
    [B, h, w, C] upsampled to its resolution, on the SR-size source views
    `sr_src_raw` [B, S, H, W, 3] (pixels) and their geometry [B, S, 20],
    from the unit noise `sr_noise`. The rows carry the base model's source
    count; an SR model with fewer sources is conditioned on the first views,
    and its target label narrows with them (per-source geometry, 20 values
    each). `generator` draws the noise on the conditioning image."""
    scfg = sr_model.cfg
    device = latents.device
    if sr_src_raw.shape[1] < scfg.num_sources:
        raise ValueError(f"SR model wants {scfg.num_sources} source views but the "
                         f"collate provides {sr_src_raw.shape[1]}")
    sr_src = encoder.encode_latents(sr_src_raw[:, :scfg.num_sources], device=device)
    sr_geometry = torch.as_tensor(sr_geometry[:, :scfg.num_sources], device=device)
    res = scfg.img_resolution
    # Half-pixel bilinear, no antialiasing: jax.image.resize's upscale.
    low_res = F.interpolate(latents.permute(0, 3, 1, 2), size=(res, res),
                            mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    denoise = make_denoiser(sr_model.net, sr_src, sr_geometry,
                            conditioning_image=low_res, generator=generator)
    return edm_sampler(denoise, sr_noise, **sampler_kwargs)
