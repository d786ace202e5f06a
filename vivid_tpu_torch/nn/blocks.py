"""EDM2 U-Net block with optional self- or cross-attention.

Counterpart of the packed path of vivid_tpu/nn/blocks.py `block_apply`
(the default `_attn_dot` form): the 1x1 attention projections run as
linears over the flattened [B, S, C] tokens, and attention reads q/k/v
straight from the packed projection outputs (kernels/attention.py), whose
entries are differentiable: a backward pass through a block runs the
backward attention kernels.

Weight storage keeps the reference order: attn_qkv output channels are
(head, d, {q,k,v}) innermost-last and x_attn_kv (head, d, {k,v}). The
forward permutes the normalised weight's output channels to the kernels'
part-major (part, head, d) order (`_qkv_perm`) — a relabelling, so imported
weights drop in unchanged.
"""

from dataclasses import dataclass

import torch
from torch import nn
import torch.nn.functional as F

from vivid_tpu_torch.geometry.epipolar import get_epipolar_attn, get_epipolar_dist
from vivid_tpu_torch.kernels import attention
from vivid_tpu_torch.kernels.mp_fused import mp_sum_clip, norm_silu, scale_silu
from vivid_tpu_torch.nn.mp import MPConv, mp_silu, remat_name, resample

RES_BALANCE = 0.3      # mp_sum weight of the residual branch
ATTN_BALANCE = 0.3     # mp_sum weight of the attention branch
CLIP_ACT = 256.0       # activations are clipped to +-CLIP_ACT after each block


@dataclass(frozen=True)
class BlockConfig:
    in_channels: int
    out_channels: int
    emb_channels: int
    flavor: str = "enc"              # 'enc' | 'dec'
    resample_mode: str = "keep"      # 'keep' | 'up' | 'down'
    attention: bool = False
    xattn: bool = False              # cross-attention variant
    num_cross_sources: int = 2
    channels_per_head: int = 64
    epipolar_attention_bias: bool = False
    imsize: int = 64                 # full image resolution (epipolar bias)
    dropout: float = 0.0             # on the residual branch, in training mode

    @property
    def num_heads(self) -> int:
        return self.out_channels // self.channels_per_head if self.attention else 0


def _packed_linear(conv: MPConv, x, num_heads: int, parts: int, heads=None):
    """The 1x1 projection as a linear on [B, S, C], its output channels
    permuted from the reference packing c = head*(D*parts) + d*parts + part
    to the part-major c = part*(heads*D) + head*D + d (`_qkv_perm`). `heads`
    (a slice) keeps those heads' rows (tensor parallelism). The product is
    "mpconv_out"."""
    w = conv.normalized_weight(x.dtype).flatten(1)          # [out, in]
    w = w.view(num_heads, -1, parts, w.shape[1])
    if heads is not None:
        w = w[heads]
    w = w.permute(2, 0, 1, 3).reshape(-1, w.shape[-1])
    with remat_name("mpconv_out"):
        return F.linear(x, w)


def attention_with_zero_sink(q, k, v, num_zero_cols: int):
    """Attention over [k | zeros(num_zero_cols)] and [v | zeros] in closed
    form, [B, H, S, D] in and out: every zero column has logit 0 and value 0,
    a sink of mass num_zero_cols * exp(-m) in the denominator. The plain
    composite that `kernels.attention.attention_from_raw` differentiates when
    it is given a sink (the blocks themselves go through the packed kernels)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / q.shape[-1] ** 0.5
    m = logits.amax(-1, keepdim=True).clamp(min=0.0)
    e = torch.exp(logits - m)
    probs = e / (e.sum(-1, keepdim=True) + num_zero_cols * torch.exp(-m))
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


class Block(nn.Module):
    def __init__(self, cfg: BlockConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.tp = None   # this rank's part under tensor parallelism (core/sharding.py)
        cin, cout = cfg.in_channels, cfg.out_channels
        self.emb_gain = nn.Parameter(torch.empty((), device=device))
        self.conv_res0 = MPConv(cout if cfg.flavor == "enc" else cin, cout, (3, 3), device)
        self.emb_linear = MPConv(cfg.emb_channels, cout, (), device)
        self.conv_res1 = MPConv(cout, cout, (3, 3), device)
        self.conv_skip = MPConv(cin, cout, (1, 1), device) if cin != cout else None
        if cfg.num_heads:
            self.attn_qkv = MPConv(cout, cout * 3, (1, 1), device)
            self.attn_proj = MPConv(cout, cout, (1, 1), device)
            if cfg.xattn:
                self.x_attn_kv = MPConv(cout, cout * 2, (1, 1), device)
                if cfg.epipolar_attention_bias:
                    # (mixing, log-temperature, cutoff offset, bias) per head
                    self.epipolar_mixing = nn.Parameter(
                        torch.empty((4, cfg.num_heads), device=device))

    def reset_parameters(self, gen: torch.Generator):
        nn.init.zeros_(self.emb_gain)
        if hasattr(self, "epipolar_mixing"):
            nn.init.zeros_(self.epipolar_mixing)
        for conv in self.children():
            conv.reset_parameters(gen)

    def dropout_mask(self, x, generator=None):
        """The residual branch's dropout mask for the input x [B, H, W, Cin]:
        0 or 1/(1 - p) per element of the branch, drawn from `generator`; None
        outside training mode or at p = 0. The caller draws it, so that a
        recomputed forward (nn/unet.py `remat`) reuses the same mask."""
        p = self.cfg.dropout
        if not self.training or p <= 0:
            return None
        scale = {"keep": 1.0, "down": 0.5, "up": 2.0}[self.cfg.resample_mode]
        shape = (x.shape[0], int(x.shape[1] * scale), int(x.shape[2] * scale),
                 self.cfg.out_channels)
        keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
        return keep.to(x.dtype) / (1.0 - p)

    def forward(self, x, emb, features=None, dropout_mask=None, src_geometries=None,
                x_silu=None):
        """x [B, H, W, Cin]; emb [B, Cemb]; features (xattn blocks): the
        string "zeros" (unconditional model) or a list of cross sources
        [B, h, w, Cout]; dropout_mask from `dropout_mask`; src_geometries
        (epipolar bias): one [B, 20] per cross source; x_silu: mp_silu(x)
        where the caller has it (a decoder block that resamples nothing,
        after `cat_silu`). Under tensor parallelism (`self.tp`) each branch
        computes this rank's channels and heads, and one all-reduce sums the
        branch's partial products. The elementwise chains go through
        kernels/mp_fused.py's entries: fused kernels on a card with autograd
        off, the composites otherwise."""
        cfg, tp = self.cfg, self.tp
        if tp is not None and self.training:
            raise RuntimeError("tensor parallelism is for evaluation only; training "
                               "runs data parallel or with fsdp")
        x = resample(x, cfg.resample_mode)
        if cfg.flavor == "enc":
            if self.conv_skip is not None:
                x = self.conv_skip(x)
            x, x_silu = norm_silu(x)
        elif x_silu is None:
            x_silu = mp_silu(x)

        part = tp.local_channels if tp is not None else None
        y = self.conv_res0(x_silu, rows=part)
        c = self.emb_linear(emb, gain=self.emb_gain, rows=part) + 1.0
        y = scale_silu(y, c)
        if dropout_mask is not None:
            y = y * dropout_mask
        y = self.conv_res1(y, cols=part)
        if tp is not None:
            y = tp.all_reduce(y)
        if cfg.flavor == "dec" and self.conv_skip is not None:
            x = self.conv_skip(x)
        heads = cfg.num_heads
        x = mp_sum_clip(x, y, RES_BALANCE, None if heads else CLIP_ACT)

        if heads:
            b, h, w, ch = x.shape
            mine = None   # this rank's heads
            if tp is not None:
                mine, heads = tp.local_heads, heads // tp.size
            qkv = _packed_linear(self.attn_qkv, x.reshape(b, h * w, ch), cfg.num_heads, 3,
                                 mine)
            if not cfg.xattn or features == "zeros":
                sink = cfg.num_cross_sources * h * w if cfg.xattn else 0
                y = attention.self_attention_from_packed(qkv, heads, zero_sink=sink)
            else:
                if features is None or len(features) != cfg.num_cross_sources:
                    raise ValueError(f"xattn block needs {cfg.num_cross_sources} "
                                     "cross sources")
                kvs = [_packed_linear(self.x_attn_kv,
                                      f.to(x.dtype).reshape(b, f.shape[1] * f.shape[2], -1),
                                      cfg.num_heads, 2, mine)
                       for f in features]
                biases = ()
                if cfg.epipolar_attention_bias and src_geometries is not None:
                    patch = cfg.imsize // h
                    mixing = self.epipolar_mixing if mine is None else self.epipolar_mixing[:, mine]
                    biases = [get_epipolar_attn(get_epipolar_dist(geo, cfg.imsize, patch),
                                                mixing, patch_size=patch)
                              for geo in src_geometries]
                y = attention.xattn_from_packed(qkv, kvs, heads, biases=biases)
            d = cfg.channels_per_head
            cols = None if mine is None else slice(mine.start * d, mine.stop * d)
            w_proj = self.attn_proj.normalized_weight(y.dtype, cols=cols).flatten(1)
            with remat_name("mpconv_out"):
                y = F.linear(y, w_proj)
            if tp is not None:
                y = tp.all_reduce(y)
            x = mp_sum_clip(x, y.reshape(b, h, w, ch), ATTN_BALANCE, CLIP_ACT)
        return x
