"""The EDM2 block's elementwise chains as fused kernels: their wrappers, their
plain versions and the entries the blocks call.

The kernels are csrc/mp_fused.cu's, on channel-last activations
[B, H, W, C] in bf16 or fp32:
  * `norm_silu(x)`: (normalize(x, dim=-1), mp_silu of it), an encoder
    block's residual and the input of its first convolution;
  * `scale_silu(y, c)`: mp_silu(y * c[:, None, None, :]), the emb scale of
    the residual branch (c [B, C], the emb linear plus 1);
  * `mp_sum_clip(a, b, t, clip)`: mp_sum(a, b, t), clamped to +-clip unless
    clip is None, the residual and attention sums and the block's clip;
  * `cat_silu(a, b, t)`: (mp_cat(a, b, t), mp_silu of it), a decoder block's
    skip concatenation and the input of its first convolution.
Each composite of nn/mp.py runs one kernel an operator, a pass over the
activation each; a fused kernel reads its inputs once and writes its outputs
once. The kernels round where the composites round, so three of them give
the composites' bits on the card; the pixel norm keeps its denominator in
fp32 and lies within one bf16 ulp of the composite (csrc/mp_fused.cu says
why).

The entries launch a kernel only where `fused` holds, on a card with
autograd off (sampling, the cascade, tensor-parallel serving, the metrics'
generation, the trainer's sample grids); elsewhere they run the plain
version, which is the composite itself, so with autograd on every training
step, its recompute and remat="save_dots" run the composites as before. The
kernels have no gradient. A guided evaluation makes hundreds of these calls
and the host paces it, so an entry calls its wrapper straight, with no
operator dispatch, and the wrapper takes the raw stream. Each launch adds
one to its entry of `flash.launches`.
"""

import ctypes
import math

import torch

from vivid_tpu_torch.kernels import build, flash
from vivid_tpu_torch.nn.mp import cat_weights, mp_cat, mp_silu, mp_sum, normalize

NORM_EPS = 1e-4   # nn/mp.py `normalize`'s
_FP32 = {torch.bfloat16: 0, torch.float32: 1}   # the kernels' types, as their flag


def fused(x) -> bool:
    """Whether the blocks take the kernels for x: on a card, with autograd off."""
    return x.is_cuda and not torch.is_grad_enabled()


# -- plain versions: the composites ----------------------------------------------

def norm_silu_ref(x, eps: float = NORM_EPS):
    xn = normalize(x, dim=-1, eps=eps)
    return xn, mp_silu(xn)


def scale_silu_ref(y, c):
    return mp_silu(y * c[:, None, None, :].to(y.dtype))


def mp_sum_clip_ref(a, b, t: float, clip=None):
    x = mp_sum(a, b, t=t)
    return x if clip is None else x.clamp(-clip, clip)


def cat_silu_ref(a, b, t: float):
    x = mp_cat(a, b, dim=-1, t=t)
    return x, mp_silu(x)


# -- the wrappers ------------------------------------------------------------------

def _rows(t, name):
    """t as the kernels read it: bf16 or fp32, its channels a whole number of
    16-byte vectors, contiguous and 16-byte aligned (a copy where it is not)."""
    if t.dtype not in _FP32:
        raise ValueError(f"{name} must be bfloat16 or float32, got {t.dtype}")
    if t.dim() < 1 or t.numel() == 0 or (t.shape[-1] * t.element_size()) % 16:
        raise ValueError(f"{name} {tuple(t.shape)}: its channels must fill whole 16-byte vectors")
    if not t.is_contiguous() or t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _launch(name, fn, t, *args):
    """fn(*args, stream) on t's device and its current stream; count the
    launch. The raw stream and a device check, in place of `torch.cuda.device`
    and a Stream object: 0.7 against 7.5 us of host time a call (H100 host)."""
    dev = t.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if dev == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    flash.launched(name)


def _norm_silu_cuda(x, eps):
    x = _rows(x, "x")
    xn, xs = torch.empty_like(x), torch.empty_like(x)
    c = x.shape[-1]
    _launch("mp_norm_silu", build.library().vivid_mp_norm_silu, x, x.data_ptr(), xn.data_ptr(),
            xs.data_ptr(), x.numel() // c, c, _FP32[x.dtype], eps)
    return xn, xs


def _scale_silu_cuda(y, c):
    y = _rows(y, "y")
    if c.shape != (y.shape[0], y.shape[-1]) or c.device != y.device:
        raise ValueError(f"c must be [B, C] = {(y.shape[0], y.shape[-1])} on {y.device}, "
                         f"got {tuple(c.shape)} on {c.device}")
    c = c.float().contiguous()
    out = torch.empty_like(y)
    ch = y.shape[-1]
    rows = y.numel() // ch
    _launch("mp_scale_silu", build.library().vivid_mp_scale_silu, y, y.data_ptr(), c.data_ptr(),
            out.data_ptr(), rows, rows // y.shape[0], ch, _FP32[y.dtype])
    return out


def _sum_clip_cuda(a, b, t, clip):
    a, b = _rows(a, "a"), _rows(b, "b")
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"a {tuple(a.shape)} {a.dtype} and b {tuple(b.shape)} {b.dtype} "
                         "must match, on one device")
    if clip is not None and not clip > 0:
        raise ValueError(f"clip must be positive, got {clip}")
    out = torch.empty_like(a)
    _launch("mp_sum_clip", build.library().vivid_mp_sum_clip, a, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), a.numel(), _FP32[a.dtype], t, math.sqrt((1 - t) ** 2 + t ** 2),
            0.0 if clip is None else clip)
    return out


def _cat_silu_cuda(a, b, t):
    a, b = _rows(a, "a"), _rows(b, "b")
    if a.shape[:-1] != b.shape[:-1] or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"a {tuple(a.shape)} {a.dtype} and b {tuple(b.shape)} {b.dtype} "
                         "must match but for their channels, on one device")
    na, nb = a.shape[-1], b.shape[-1]
    cat = a.new_empty(*a.shape[:-1], na + nb)
    xs = torch.empty_like(cat)
    _launch("mp_cat_silu", build.library().vivid_mp_cat_silu, a, a.data_ptr(), b.data_ptr(),
            cat.data_ptr(), xs.data_ptr(), a.numel() // na, na, nb, _FP32[a.dtype],
            *cat_weights(na, nb, t))
    return cat, xs


# -- the entries ---------------------------------------------------------------------

def norm_silu(x, eps: float = NORM_EPS):
    """(normalize(x, dim=-1), mp_silu of it): the kernel where `fused(x)`,
    the composite otherwise."""
    return _norm_silu_cuda(x, eps) if fused(x) else norm_silu_ref(x, eps)


def scale_silu(y, c):
    """mp_silu(y * c[:, None, None, :]) for y [B, H, W, C], c [B, C]: the
    kernel where `fused(y)`, the composite otherwise."""
    return _scale_silu_cuda(y, c) if fused(y) else scale_silu_ref(y, c)


def mp_sum_clip(a, b, t: float, clip=None):
    """mp_sum(a, b, t), clamped to [-clip, clip] unless clip is None: the
    kernel where `fused(a)`, the composite otherwise."""
    return _sum_clip_cuda(a, b, t, clip) if fused(a) else mp_sum_clip_ref(a, b, t, clip)


def cat_silu(a, b, t: float):
    """(mp_cat(a, b, dim=-1, t), mp_silu of it) from the kernel where
    `fused(a)`; otherwise (mp_cat(a, b, dim=-1, t), None): under autograd the
    decoder block computes its mp_silu itself, inside its recompute."""
    return _cat_silu_cuda(a, b, t) if fused(a) else (mp_cat(a, b, dim=-1, t=t), None)


def info(kernel: str, dtype=torch.bfloat16, channels: int = 64):
    """What a kernel ("norm_silu", "scale_silu", "sum_clip" or "cat_silu") was
    built with, from the loaded library, so only where there is a card:
    dict(regs, local_bytes (spills), threads); for the norm, the instance that
    rows of `channels` take."""
    kernels = ("norm_silu", "scale_silu", "sum_clip", "cat_silu")
    if not torch.cuda.is_available():
        raise RuntimeError("mp_fused.info reads the built kernels: it needs a CUDA card")
    out = (ctypes.c_int * 3)()
    rc = build.library().vivid_mp_fused_info(kernels.index(kernel), _FP32[dtype], channels,
                                             ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"mp_fused.info({kernel!r}) failed: CUDA error {rc}")
    return dict(zip(("regs", "local_bytes", "threads"), out))
