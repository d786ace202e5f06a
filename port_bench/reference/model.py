"""Plain float32 VIVID networks: the EDM2 magnitude-preserving U-Nets, the
source encoder and NVPrecond (arXiv:2411.07765; EDM2, arXiv:2312.02696).

Written from the published equations with plain torch operations, and
nothing of the program under test: every convolution is `F.conv2d`, every
linear `F.linear`, attention two explicit matrix products around a softmax.
The parameter names are the published checkpoints' module paths
(`unet.enc.64x64_block0.conv_res0.weight`), so one state dict loads into
this model and into the program alike.

Activations are channel-last [B, H, W, C]; weights keep torch layouts (conv
OIHW, linear [out, in]). `quant` (set with `set_quant`) rounds the inputs of
every product (activations, normalised weights, q, k, v and the attention
probabilities) before it is taken: `None` computes in float32, and the
benchmark's lower-precision control passes an fp8 rounding.

Departures from the published model, none of which a benchmarked
configuration uses: no depth input, no warped-coordinate features, no
epipolar attention bias, no dropout.
"""

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

RES_BALANCE = 0.3
ATTN_BALANCE = 0.3
LABEL_BALANCE = 0.5
CONCAT_BALANCE = 0.5
CLIP_ACT = 256.0
NORM_EPS = 1e-4
LOGITS_PER_CHUNK = 1 << 27   # float32 logits an attention chunk holds (512 MiB)


def normalize(x, dim=None, eps: float = NORM_EPS):
    """x / (eps + ||x|| / sqrt(N)) over `dim` (default: all but the first)."""
    if dim is None:
        dim = tuple(range(1, x.ndim))
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / (eps + math.sqrt(norm.numel() / x.numel()) * norm)


def mp_silu(x):
    return F.silu(x) / 0.596


def mp_sum(a, b, t=0.5):
    return a.lerp(b, t) / math.sqrt((1 - t) ** 2 + t ** 2)


def mp_cat(a, b, t=0.5):
    na, nb = a.shape[-1], b.shape[-1]
    c = math.sqrt((na + nb) / ((1 - t) ** 2 + t ** 2))
    return torch.cat([(c / math.sqrt(na) * (1 - t)) * a, (c / math.sqrt(nb) * t) * b], -1)


def resample(x, mode):
    if mode == "keep":
        return x
    b, h, w, c = x.shape
    if mode == "down":
        return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class Fourier(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.register_buffer("freqs", torch.empty(channels))
        self.register_buffer("phases", torch.empty(channels))

    def forward(self, x):
        return torch.cos(x[..., None] * self.freqs + self.phases) * math.sqrt(2.0)


class Conv(nn.Module):
    """Magnitude-preserving convolution (kernel (kh, kw)) or linear
    (kernel ()): each output filter normalised to unit norm, then scaled by
    gain / sqrt(fan-in)."""

    def __init__(self, cin, cout, kernel=()):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.quant: Optional[Callable] = None

    def unit_weight(self, gain=1.0):
        w = normalize(self.weight)
        return w * (gain / math.sqrt(w[0].numel()))

    def _q(self, t):
        return t if self.quant is None else self.quant(t)

    def forward(self, x, gain=1.0):
        """A linear on [..., in], or a same-padded convolution on [B, H, W, in]
        as one product a tap: the shifted input [B*H*W, in] by the tap's
        [in, out] weight, summed (cuBLAS's fp32 GEMM; cuDNN's fp32
        convolutions without TF32 fall back to FFT algorithms that launch
        thousands of kernels a call)."""
        w = self._q(self.unit_weight(gain))
        x = self._q(x)
        if w.ndim == 2:
            return F.linear(x, w)
        kh, kw = w.shape[2:]
        if (kh, kw) == (1, 1):
            return F.linear(x, w[:, :, 0, 0])
        b, h, wd, _ = x.shape
        xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
        y = None
        for i in range(kh):
            for j in range(kw):
                term = F.linear(xp[:, i:i + h, j:j + wd], w[:, :, i, j])
                y = term if y is None else y + term
        return y


@dataclass(frozen=True)
class BlockSpec:
    cin: int
    cout: int
    cemb: int
    flavor: str                 # 'enc' | 'dec'
    resample: str = "keep"      # 'keep' | 'down' | 'up'
    heads: int = 0
    xattn: bool = False
    sources: int = 2


class Block(nn.Module):
    def __init__(self, spec: BlockSpec):
        super().__init__()
        self.spec = spec
        self.quant: Optional[Callable] = None
        s = spec
        self.emb_gain = nn.Parameter(torch.empty(()))
        self.conv_res0 = Conv(s.cout if s.flavor == "enc" else s.cin, s.cout, (3, 3))
        self.emb_linear = Conv(s.cemb, s.cout)
        self.conv_res1 = Conv(s.cout, s.cout, (3, 3))
        self.conv_skip = Conv(s.cin, s.cout, (1, 1)) if s.cin != s.cout else None
        if s.heads:
            self.attn_qkv = Conv(s.cout, 3 * s.cout, (1, 1))
            self.attn_proj = Conv(s.cout, s.cout, (1, 1))
            if s.xattn:
                self.x_attn_kv = Conv(s.cout, 2 * s.cout, (1, 1))

    def _q(self, t):
        return t if self.quant is None else self.quant(t)

    def attention(self, q, k, v, sink: int):
        """q [B, H, S, D], k, v [B, H, Sk, D], pixel-normalised; `sink`
        all-zero key columns (logit 0, value 0) in closed form. Queries go
        in chunks of at most LOGITS_PER_CHUNK logits."""
        q, k, v = self._q(q), self._q(k), self._q(v)
        b, h, sq, d = q.shape
        step = max(1, LOGITS_PER_CHUNK // (b * h * k.shape[2]))

        def chunk(qc, k, v):
            logits = qc @ k.transpose(-1, -2) / math.sqrt(d)
            m = logits.amax(-1, keepdim=True)
            if sink:
                m = m.clamp(min=0.0)
            e = torch.exp(logits - m)
            den = e.sum(-1, keepdim=True)
            if sink:
                den = den + sink * torch.exp(-m)
            return self._q(e / den) @ v

        outs = []
        for a in range(0, sq, step):
            qc = q[:, :, a:a + step]
            if torch.is_grad_enabled():   # each chunk's logits are recomputed for its gradient
                outs.append(checkpoint(chunk, qc, k, v, use_reentrant=False))
            else:
                outs.append(chunk(qc, k, v))
        return torch.cat(outs, 2)

    def forward(self, x, emb, features=None):
        """features: None (self-attention), "zeros" (unconditional
        cross-attention) or a list of [B, h, w, C], one per source."""
        s = self.spec
        x = resample(x, s.resample)
        if s.flavor == "enc":
            if self.conv_skip is not None:
                x = self.conv_skip(x)
            x = normalize(x, dim=-1)
        y = self.conv_res0(mp_silu(x))
        c = self.emb_linear(emb, gain=self.emb_gain) + 1
        y = mp_silu(y * c[:, None, None, :])
        y = self.conv_res1(y)
        if s.flavor == "dec" and self.conv_skip is not None:
            x = self.conv_skip(x)
        x = mp_sum(x, y, RES_BALANCE)
        if s.heads:
            b, h, w, ch = x.shape
            d = ch // s.heads
            qkv = self.attn_qkv(x).reshape(b, h * w, s.heads, d, 3)
            qkv = normalize(qkv, dim=3)
            q, k, v = (qkv[..., i].transpose(1, 2) for i in range(3))
            sink = 0
            if s.xattn and features == "zeros":
                sink = s.sources * h * w
            elif s.xattn:
                ks, vs = [k], [v]
                for f in features:
                    kv = self.x_attn_kv(f).reshape(b, -1, s.heads, d, 2)
                    kv = normalize(kv, dim=3)
                    ks.append(kv[..., 0].transpose(1, 2))
                    vs.append(kv[..., 1].transpose(1, 2))
                k, v = torch.cat(ks, 2), torch.cat(vs, 2)
            y = self.attention(q, k, v, sink)
            y = self.attn_proj(y.transpose(1, 2).reshape(b, h, w, ch))
            x = mp_sum(x, y, ATTN_BALANCE)
        return x.clamp(-CLIP_ACT, CLIP_ACT)


@dataclass(frozen=True)
class UNetSpec:
    resolution: int
    cin: int
    label_dim: int
    kind: str                        # 'xattn' | 'sr' | 'encoder'
    channels: int
    channel_mult: Tuple[int, ...]
    num_blocks: int
    attn_resolutions: Tuple[int, ...]
    extra_attn: Optional[int]
    channels_per_head: int
    sources: int

    @property
    def cblock(self):
        return [self.channels * m for m in self.channel_mult]

    @property
    def cemb(self):
        return max(self.cblock)


@dataclass(frozen=True)
class PlanEntry:
    group: str       # 'enc' | 'dec'
    key: str         # '64x64_block0'
    res: int
    conv: Optional[Tuple[int, int]] = None     # (cin, cout) of the first conv
    block: Optional[BlockSpec] = None


def _attends(u: UNetSpec, res, idx, level, dec):
    if res in u.attn_resolutions:
        return True
    if u.extra_attn is None or level == 0:
        return False
    return u.extra_attn == ((u.num_blocks - idx) if dec else idx)


def build_plan(u: UNetSpec) -> List[PlanEntry]:
    """The blocks in network order: encoder levels, then decoder levels,
    an encoder's plan cut after its last attention block."""
    xattn = u.kind in ("xattn", "sr")
    cph = 32 if u.kind == "sr" else u.channels_per_head

    def blk(cin, cout, flavor, attn=False, res_mode="keep", x=False):
        return BlockSpec(cin, cout, u.cemb, flavor, res_mode,
                         cout // cph if attn else 0, x and attn, u.sources)

    plan, skips = [], []
    cout = u.cin + 1
    for level, ch in enumerate(u.cblock):
        res = u.resolution >> level
        if level == 0:
            conv_cin = 2 * u.cin + 1 if u.kind == "sr" else cout
            plan.append(PlanEntry("enc", f"{res}x{res}_conv", res, conv=(conv_cin, ch)))
            cout = ch
        else:
            plan.append(PlanEntry("enc", f"{res}x{res}_down", res,
                                  block=blk(cout, cout, "enc", res_mode="down")))
        skips.append(cout)
        for idx in range(u.num_blocks):
            attn = _attends(u, res, idx, level, False)
            plan.append(PlanEntry("enc", f"{res}x{res}_block{idx}", res,
                                  block=blk(cout, ch, "enc", attn, x=xattn)))
            cout = ch
            skips.append(cout)
    for level, ch in reversed(list(enumerate(u.cblock))):
        res = u.resolution >> level
        if level == len(u.cblock) - 1:
            plan.append(PlanEntry("dec", f"{res}x{res}_in0", res,
                                  block=blk(cout, cout, "dec", True, x=xattn)))
            plan.append(PlanEntry("dec", f"{res}x{res}_in1", res, block=blk(cout, cout, "dec")))
        else:
            plan.append(PlanEntry("dec", f"{res}x{res}_up", res,
                                  block=blk(cout, cout, "dec", res_mode="up")))
        for idx in range(u.num_blocks + 1):
            cin = cout + skips.pop()
            attn = _attends(u, res, idx, level, True)
            plan.append(PlanEntry("dec", f"{res}x{res}_block{idx}", res,
                                  block=blk(cin, ch, "dec", attn, x=xattn)))
            cout = ch
    if u.kind == "encoder":
        last = max(i for i, e in enumerate(plan) if e.block is not None and e.block.heads)
        plan = plan[:last + 1]
    return plan


class UNet(nn.Module):
    def __init__(self, u: UNetSpec):
        super().__init__()
        self.spec = u
        self.plan = build_plan(u)
        self.emb_fourier = Fourier(u.cblock[0])
        self.emb_noise = Conv(u.cblock[0], u.cemb)
        self.emb_label = Conv(u.label_dim, u.cemb)
        self.enc = nn.ModuleDict()
        self.dec = nn.ModuleDict()
        for e in self.plan:
            getattr(self, e.group)[e.key] = (Conv(*e.conv, (3, 3)) if e.conv
                                             else Block(e.block))
        if u.kind != "encoder":
            self.out_gain = nn.Parameter(torch.empty(()))
            self.out_conv = Conv(u.cblock[0], 3, (3, 3))

    def forward(self, x, noise_labels, labels, features=None):
        """features: per attention block of the denoiser, a [B, n_src, h, w, C]
        stack, or "zeros"; an encoder returns its attention blocks' outputs."""
        u = self.spec
        emb = self.emb_noise(self.emb_fourier(noise_labels))
        emb = mp_silu(mp_sum(emb, self.emb_label(labels), LABEL_BALANCE))
        feats = iter(features) if isinstance(features, list) else None
        out, skips = [], []
        h = torch.cat([x, torch.ones_like(x[..., :1])], -1)
        for e in self.plan:
            module = getattr(self, e.group)[e.key]
            if e.group == "dec" and "_block" in e.key:
                h = mp_cat(h, skips.pop(), CONCAT_BALANCE)
            if e.conv:
                h = module(h)
            else:
                f = None
                if e.block.xattn:
                    f = "zeros" if features == "zeros" else list(next(feats).unbind(1))
                h = module(h, emb, f)
                if u.kind == "encoder" and e.block.heads:
                    out.append(h)
            if e.group == "enc":
                skips.append(h)
        if u.kind == "encoder":
            return out
        return self.out_conv(h, gain=self.out_gain)


@dataclass(frozen=True)
class NetSpec:
    """A configuration file's `net` (or `guide`) object."""
    resolution: int
    channels: int
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    num_blocks: int = 3
    attn_resolutions: Tuple[int, ...] = (16, 8)
    extra_attn: Optional[int] = None
    channels_per_head: int = 64
    num_sources: int = 2
    source_label_dim: int = 20
    target_label_dim: int = 40
    super_res: bool = False
    uncond: bool = False
    noisy_sr: float = 0.0
    sigma_data: float = 0.5
    logvar_channels: int = 128
    img_channels: int = 3
    use_bf16: bool = True
    remat: object = True

    @classmethod
    def from_json(cls, d: dict) -> "NetSpec":
        known = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        for k in ("channel_mult", "attn_resolutions"):
            if k in known:
                known[k] = tuple(known[k])
        return cls(**known)

    def unet(self, kind):
        return UNetSpec(self.resolution, self.img_channels,
                        self.source_label_dim if kind == "encoder" else self.target_label_dim,
                        kind, self.channels, self.channel_mult, self.num_blocks,
                        self.attn_resolutions, self.extra_attn, self.channels_per_head,
                        self.num_sources)

    @property
    def denoiser_kind(self):
        return "sr" if self.super_res else "xattn"


class Precond(nn.Module):
    """EDM preconditioning around the source encoder and the denoiser."""

    def __init__(self, spec: NetSpec):
        super().__init__()
        self.spec = spec
        self.unet = UNet(spec.unet(spec.denoiser_kind))
        self.logvar_fourier = Fourier(spec.logvar_channels)
        self.logvar_linear = Conv(spec.logvar_channels, 1)
        self.encoder = None if spec.uncond else UNet(spec.unet("encoder"))

    def forward(self, src, x, sigma, geometry, cond_image=None, cond_noise=None,
                return_logvar=False):
        """src [B, n_src, H, W, 3]; x [B, H, W, 3]; sigma [B]; geometry
        [B, n_src, 20]; a super-resolution net takes its low-resolution image
        and the unit noise on it. Returns D_x (and the log-variance)."""
        s = self.spec
        b = x.shape[0]
        sig = sigma.reshape(b, 1, 1, 1)
        sd = s.sigma_data
        c_skip = sd ** 2 / (sig ** 2 + sd ** 2)
        c_out = sig * sd / torch.sqrt(sig ** 2 + sd ** 2)
        c_in = 1 / torch.sqrt(sd ** 2 + sig ** 2)
        c_noise = torch.log(sigma) / 4
        if s.uncond:
            geometry = torch.zeros(b, s.num_sources, s.source_label_dim, device=x.device)
            features = "zeros"
        else:
            n = src.shape[1]
            feats = self.encoder(src.flatten(0, 1), c_noise.repeat_interleave(n),
                                 geometry.flatten(0, 1))
            features = [f.reshape((b, n) + f.shape[1:]) for f in feats]
        x_in = c_in * x
        if s.super_res:
            x_in = torch.cat([x_in, cond_image + s.noisy_sr * cond_noise], -1)
        F_x = self.unet(x_in, c_noise, geometry.reshape(b, -1), features)
        D_x = c_skip * x + c_out * F_x
        if return_logvar:
            return D_x, self.logvar_linear(self.logvar_fourier(c_noise)).reshape(b, 1, 1, 1)
        return D_x


def set_quant(model: nn.Module, quant: Optional[Callable]):
    """Round every product's inputs with `quant` (None: float32 throughout)."""
    for m in model.modules():
        if isinstance(m, (Conv, Block)):
            m.quant = quant


def bf16_round(x):
    """Rounding to bfloat16 and back, the configurations' compute precision;
    the gradient passes through as it came."""
    return x + (x.detach().to(torch.bfloat16).to(torch.float32) - x.detach())


def fp8_round(x):
    """Per-tensor scaled float8 (e4m3) rounding, the usual fp8 recipe: the
    tensor scaled so that its largest magnitude maps to 448, rounded, and
    scaled back, in float32. The gradient passes through as it came (the
    products' backward runs on the rounded values)."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    rounded = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (rounded - x.detach())
