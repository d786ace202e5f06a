"""EDM2 U-Net family: UNet, XAttnUNet and UNetEncoder.

Counterpart of vivid_tpu/nn/unet.py: the same static plan (an ordered list
of named block configs built once from the config), as `nn.Module`s whose
parameter names are the reference's module paths
(`enc.64x64_block0.conv_res0.weight`), so a JAX parameter tree loads with
`load_state_dict(strict=True)` after compat/from_jax.py.

Kinds:
  * 'unet'    — plain EDM2 U-Net.
  * 'xattn'   — attention blocks are cross-attention blocks fed a list of
    encoder features, one per attention block; output is 3 channels.
  * 'encoder' — trimmed after the decoder's last attention block, no
    out_conv; forward returns the activation of every attention block.
  * 'sr'      — the 256px super-resolution denoiser: 'xattn' with 32
    channels per head whatever the config says, and a first conv widened to
    take the low-resolution conditioning image concatenated to the input.

`remat` trades memory for recompute in the backward pass, on the decoder's
blocks and on every block of an encoder, as the JAX package places it:
False keeps every activation; True wraps each such block in
`torch.utils.checkpoint`; "save_dots" does the same under a selective
policy that keeps the outputs of convolutions and matrix products and
recomputes the elementwise chains between them. On a CUDA tensor the
attention kernel is no operator the policy can see, so "save_dots"
launches the forward attention kernel again in the backward pass. All
three give the same gradients.
"""

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from vivid_tpu_torch.nn.blocks import Block, BlockConfig
from vivid_tpu_torch.nn.mp import MPConv, MPFourier, mp_cat, mp_silu, mp_sum

LABEL_BALANCE = 0.5    # mp_sum weight of the geometry embedding
CONCAT_BALANCE = 0.5   # mp_cat weight of the skip connection


@dataclass(frozen=True)
class UNetConfig:
    img_resolution: int
    img_channels: int
    label_dim: int
    kind: str = "unet"                    # 'unet' | 'xattn' | 'encoder' | 'sr'
    model_channels: int = 192
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    channel_mult_noise: Optional[int] = None
    channel_mult_emb: Optional[int] = None
    num_blocks: int = 3
    attn_resolutions: Tuple[int, ...] = (16, 8)
    extra_attn: Optional[int] = None      # attention on block k of each level > 0
    epipolar_attention_bias: bool = False
    num_cross_sources: int = 2
    channels_per_head: int = 64
    dropout: float = 0.0
    remat: object = False                 # False | True | "save_dots"

    @property
    def cblock(self):
        return [self.model_channels * m for m in self.channel_mult]

    @property
    def cnoise(self):
        return (self.model_channels * self.channel_mult_noise
                if self.channel_mult_noise is not None else self.cblock[0])

    @property
    def cemb(self):
        return (self.model_channels * self.channel_mult_emb
                if self.channel_mult_emb is not None else max(self.cblock))

    @property
    def out_channels(self):
        return 3 if self.kind in ("xattn", "sr") else self.img_channels


@dataclass(frozen=True)
class PlanEntry:
    name: str        # "enc/64x64_block0"
    kind: str        # 'conv' | 'block'
    res: int
    in_channels: int
    out_channels: int
    block: Optional[BlockConfig] = None


def _is_attn(cfg: UNetConfig, res: int, idx: int, level: int, dec: bool) -> bool:
    if res in cfg.attn_resolutions:
        return True
    if cfg.extra_attn is None or level == 0:
        return False
    return cfg.extra_attn == ((cfg.num_blocks - idx) if dec else idx)


def _block(cfg: UNetConfig, cin, cout, flavor, attention=False,
           resample_mode="keep", xattn=False) -> BlockConfig:
    return BlockConfig(
        in_channels=cin, out_channels=cout, emb_channels=cfg.cemb, flavor=flavor,
        resample_mode=resample_mode, attention=attention, xattn=xattn,
        num_cross_sources=cfg.num_cross_sources,
        channels_per_head=32 if cfg.kind == "sr" else cfg.channels_per_head,
        epipolar_attention_bias=cfg.epipolar_attention_bias,
        imsize=cfg.img_resolution, dropout=cfg.dropout)


def build_plan(cfg: UNetConfig) -> Tuple[List[PlanEntry], List[PlanEntry]]:
    """(enc_plan, dec_plan) in the reference block layout, with the
    extra_attn placement rule and the encoder's trim."""
    if cfg.kind not in ("unet", "xattn", "encoder", "sr"):
        raise ValueError(f"unknown UNet kind {cfg.kind!r}")
    xattn_kind = cfg.kind in ("xattn", "sr")
    enc: List[PlanEntry] = []
    cout = cfg.img_channels + 1  # constant ones channel appended to the input
    for level, channels in enumerate(cfg.cblock):
        res = cfg.img_resolution >> level
        if level == 0:
            cin, cout = cout, channels
            # 'sr': x and the conditioning image, plus the ones channel.
            conv_cin = 2 * (cin - 1) + 1 if cfg.kind == "sr" else cin
            enc.append(PlanEntry(f"enc/{res}x{res}_conv", "conv", res, conv_cin, cout))
        else:
            enc.append(PlanEntry(f"enc/{res}x{res}_down", "block", res, cout, cout,
                                 _block(cfg, cout, cout, "enc", resample_mode="down")))
        for idx in range(cfg.num_blocks):
            cin, cout = cout, channels
            attn = _is_attn(cfg, res, idx, level, dec=False)
            enc.append(PlanEntry(f"enc/{res}x{res}_block{idx}", "block", res, cin, cout,
                                 _block(cfg, cin, cout, "enc", attention=attn,
                                        xattn=xattn_kind and attn)))

    dec: List[PlanEntry] = []
    skips = [e.out_channels for e in enc]
    for level, channels in reversed(list(enumerate(cfg.cblock))):
        res = cfg.img_resolution >> level
        if level == len(cfg.cblock) - 1:
            dec.append(PlanEntry(f"dec/{res}x{res}_in0", "block", res, cout, cout,
                                 _block(cfg, cout, cout, "dec", attention=True,
                                        xattn=xattn_kind)))
            dec.append(PlanEntry(f"dec/{res}x{res}_in1", "block", res, cout, cout,
                                 _block(cfg, cout, cout, "dec")))
        else:
            dec.append(PlanEntry(f"dec/{res}x{res}_up", "block", res, cout, cout,
                                 _block(cfg, cout, cout, "dec", resample_mode="up")))
        for idx in range(cfg.num_blocks + 1):
            cin = cout + skips.pop()
            cout = channels
            attn = _is_attn(cfg, res, idx, level, dec=True)
            dec.append(PlanEntry(f"dec/{res}x{res}_block{idx}", "block", res, cin, cout,
                                 _block(cfg, cin, cout, "dec", attention=attn,
                                        xattn=xattn_kind and attn)))

    if cfg.kind == "encoder":
        last_attn = max((i for i, e in enumerate(dec)
                         if e.block is not None and e.block.num_heads > 0), default=-1)
        dec = dec[: last_attn + 1]
    return enc, dec


def attention_feature_spec(cfg: UNetConfig) -> List[Tuple[str, int, int]]:
    """(name, out_channels, res) of every attention block in network order:
    the cross-feature contract between UNetEncoder and XAttnUNet."""
    enc, dec = build_plan(cfg)
    return [(e.name, e.out_channels, e.res) for e in enc + dec
            if e.block is not None and e.block.num_heads > 0]


def _save_dots_policy(ctx, op, *args, **kwargs):
    """Keep what a convolution or a matrix product puts out; recompute the rest."""
    aten = torch.ops.aten
    dots = (aten.convolution.default, aten.mm.default, aten.addmm.default,
            aten.bmm.default)
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in dots
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_call(remat, fn, *args):
    """fn(*args) under the recompute mode `remat` (see the module docstring)."""
    if remat == "save_dots":
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(ckpt.create_selective_checkpoint_contexts,
                                         _save_dots_policy))
    if remat is True:
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    raise ValueError(f'remat must be False, True or "save_dots", got {remat!r}')


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.enc_plan, self.dec_plan = build_plan(cfg)
        self.emb_fourier = MPFourier(cfg.cnoise, device)
        self.emb_noise = MPConv(cfg.cnoise, cfg.cemb, (), device)
        self.emb_label = (MPConv(cfg.label_dim, cfg.cemb, (), device)
                          if cfg.label_dim else None)
        self.enc = nn.ModuleDict()
        self.dec = nn.ModuleDict()
        for e in self.enc_plan + self.dec_plan:
            group, key = e.name.split("/")
            getattr(self, group)[key] = (
                MPConv(e.in_channels, e.out_channels, (3, 3), device)
                if e.kind == "conv" else Block(e.block, device))
        if cfg.kind != "encoder":
            self.out_gain = nn.Parameter(torch.empty((), device=device))
            self.out_conv = MPConv(self.dec_plan[-1].out_channels, cfg.out_channels,
                                   (3, 3), device)

    def reset_parameters(self, gen: torch.Generator):
        """Weights ~ N(0, 1), gains 0, Fourier features from `gen`."""
        for module in self.children():
            if isinstance(module, nn.ModuleDict):
                for sub in module.values():
                    sub.reset_parameters(gen)
            else:
                module.reset_parameters(gen)
        if self.cfg.kind != "encoder":
            nn.init.zeros_(self.out_gain)

    def forward(self, x, noise_labels, geometry, features=None, generator=None,
                src_geometries=None):
        """x [B, H, W, C] (already preconditioned); noise_labels [B];
        geometry [B, label_dim] or None; features (xattn): "zeros" or a list
        of [B, n_src, h, w, c], one per attention block; generator: the
        source of the dropout masks in training mode; src_geometries (xattn
        with the epipolar bias): one [B, 20] per cross source. Returns
        [B, H, W, out_channels], or the feature list for kind='encoder'."""
        cfg = self.cfg
        emb = self.emb_noise(self.emb_fourier(noise_labels))
        if self.emb_label is not None and geometry is not None:
            emb = mp_sum(emb, self.emb_label(geometry.to(emb.dtype)), t=LABEL_BALANCE)
        emb = mp_silu(emb)

        zeros_mode = isinstance(features, str) and features == "zeros"
        feat_iter = iter(features) if features is not None and not zeros_mode else None
        collected = []

        def run(e: PlanEntry, h):
            group, key = e.name.split("/")
            module = getattr(self, group)[key]
            if e.kind == "conv":
                return module(h)
            feats = None
            # Only blocks that attend consume a cross feature.
            if e.block.xattn and e.block.num_heads > 0:
                if zeros_mode:
                    feats = "zeros"
                else:
                    f = next(feat_iter)  # [B, n_src, h, w, c]
                    feats = [f[:, i] for i in range(cfg.num_cross_sources)]
            mask = module.dropout_mask(h, generator)
            if (cfg.remat and torch.is_grad_enabled()
                    and (group == "dec" or cfg.kind == "encoder")):
                h = _remat_call(cfg.remat, module, h, emb, feats, mask, src_geometries)
            else:
                h = module(h, emb, feats, mask, src_geometries)
            if cfg.kind == "encoder" and e.block.num_heads > 0:
                collected.append(h)
            return h

        h = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
        skips = []
        for e in self.enc_plan:
            h = run(e, h)
            skips.append(h)
        for e in self.dec_plan:
            if "_block" in e.name:
                h = mp_cat(h, skips.pop(), dim=-1, t=CONCAT_BALANCE)
            h = run(e, h)
        if cfg.kind == "encoder":
            return collected
        return self.out_conv(h, gain=self.out_gain)
