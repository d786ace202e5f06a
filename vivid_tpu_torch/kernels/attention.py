"""Attention entry points: the blocks', over packed projection outputs, and
the [B, H, S, D] entries.

Counterpart of vivid_tpu/kernels/attention.py. The TPU
package gated its Pallas kernels on the platform, on sequence alignment and
on a VMEM budget; here one thing decides, the query length. Below
NOMAX_MIN_SQ, and whenever there is a zero sink, the packed kernels take
the projection outputs as they are (any sequence length) and both entries
are differentiable: their backward is the backward kernel. From
NOMAX_MIN_SQ on (the 256px model's attention at 128x128 and 64x64) the
rows are split, pixel-normalised in fp32, rounded to the compute dtype and
laid out [B, H, S, D] in plain PyTorch, and `flash.nomax_attention` runs on
the concatenated self and cross segments: the no-max kernel forward, and
under autograd the big-S flash attention kernels backward (forward again for
the row statistics, then dk/dv and dq/dbias). The split, norm, relayout and
bias concatenation around it differentiate by autograd, as XLA differentiates
them in the JAX package's composites; the bias gradient flows back through
the concatenation to each source's bias. A CUDA tensor always reaches a
kernel (or the call raises), a CPU tensor the kernel's plain version.

VIVID_NOMAX_PACKED=1 in the environment, read at every call, swaps the
forward of every unbiased packed attention below NOMAX_MIN_SQ for the no-max
packed kernel (`flash.flash_nomax_packed`); the backward kernels stay, and a
biased cross-attention keeps the kernel with a running max, since a learned
bias breaks the logit bound the no-max form rests on. Off by default, as in
the JAX package.

The [B, H, S, D] entries (`reference_attention`, `fused_attention` on
normalised rows, `attention_from_raw` on raw ones) have no sharding branch:
the port has no mesh code yet. `fused_attention` picks by length alone:
Sq >= NOMAX_MIN_SQ the no-max kernel (big-S flash backward), from
FLASH_MIN_S queries and keys on the big-S flash attention kernels forward
and backward, shorter the plain einsum composite. The blocks' entries reach
the kernels through `torch.library` operators (kernels/flash.py), which
remat="save_dots" keeps by name; `attention_from_raw` (K5), on no model
path, stays an autograd function.
"""

import os

import torch
from torch.autograd.function import once_differentiable

from vivid_tpu_torch.kernels import flash

NOMAX_MIN_SQ = 4096   # query length from which the no-max kernel takes over
FLASH_MIN_S = 256     # `fused_attention`: shorter queries or keys take the einsum composite


def nomax_packed_on() -> bool:
    """Whether VIVID_NOMAX_PACKED=1 asks for the no-max packed forward."""
    return os.environ.get("VIVID_NOMAX_PACKED", "0") == "1"


def reference_attention(q, k, v, bias=None):
    """softmax(q k^T / sqrt(D) + bias) v by two einsums, [B, H, S, D]: fp32
    logits and softmax, the probabilities rounded to v's dtype."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / q.shape[-1] ** 0.5
    if bias is not None:
        logits = logits + bias.float()
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1).to(v.dtype), v)


def fused_attention(q, k, v, bias=None):
    """Attention on pixel-normalised q [B, H, Sq, D] and k, v [B, H, Sk, D]
    with an optional unscaled fp32 bias [B, H, Sq, Sk]; differentiable. The
    no-max kernel's exactness rests on the rows being normalised."""
    sq, sk = q.shape[2], k.shape[2]
    if sq >= NOMAX_MIN_SQ:
        return flash.nomax_attention(q, k, v, bias)
    if sq >= FLASH_MIN_S and sk >= FLASH_MIN_S:
        return flash.stock_attention(q, k, v, bias)
    return reference_attention(q, k, v, bias)


def _composite_from_raw(q, k, v, bias, zero_sink: int, eps: float):
    """The unfused form of `attention_from_raw`: plain pixel norm, then
    `fused_attention`, or with a sink the plain closed form."""
    from vivid_tpu_torch.nn.blocks import attention_with_zero_sink
    from vivid_tpu_torch.nn.mp import normalize
    q, k, v = (normalize(t, dim=-1, eps=eps) for t in (q, k, v))
    if zero_sink:
        return attention_with_zero_sink(q, k, v, zero_sink)
    return fused_attention(q, k, v, bias)


class _AttentionFromRaw(torch.autograd.Function):
    """Forward: the fused kernel with its norm pre-pass. Backward: the gradient
    of the unfused composite, recomputed from the inputs."""

    @staticmethod
    def forward(ctx, q, k, v, bias, zero_sink, eps):
        ctx.save_for_backward(q, k, v, bias)
        ctx.args = (zero_sink, eps)
        return flash.flash_fused(q, k, v, bias, norm_eps=eps, zero_sink=zero_sink)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        leaves = [None if t is None else t.detach().requires_grad_()
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _composite_from_raw(*leaves, *ctx.args)
        given = [t for t in leaves if t is not None]
        grads = iter(torch.autograd.grad(out, given, g.to(out.dtype)))
        return (*(None if t is None else next(grads) for t in leaves), None, None)


def attention_from_raw(q, k, v, bias=None, zero_sink: int = 0, eps: float = 1e-4):
    """Attention over raw (not yet normalised) q [B, H, Sq, D] and k, v
    [B, H, Sk, D]: each D-vector is pixel-normalised with `eps`, then softmax attention
    with an optional unscaled bias or `zero_sink` all-zero key columns. The
    two exclude each other: the composite that gives the gradient has no
    biased form with a sink."""
    if bias is not None and zero_sink:
        raise ValueError("bias and zero_sink are mutually exclusive")
    return _AttentionFromRaw.apply(q, k, v, bias, zero_sink, eps)


def _nomax_from_packed(qkv, feats, num_heads: int, biases, eps: float):
    """Split the packed rows, normalise, run `flash.nomax_attention` over the
    self segment followed by every cross source (the self segment's bias is
    zeros), and re-pack to [B, S, H*D]. With biases the kernel reads one
    fp32 [B, H, S, S + sum(Sf)] block, built here from a zero block and the
    sources' biases: 4*B*H*S*Sk bytes twice over while it is concatenated
    (0.8 GB a copy at B = 1, H = 6, S = 4096, Sk = 8192; 68.7 GB at B = 8,
    H = 4, S = 16384, Sk = 32768), so a biased model at these lengths runs
    out of device memory at a large batch rather than changing kernels
    (training adds the bias gradient, as large again)."""
    b, s, c3 = qkv.shape
    h = num_heads
    d = c3 // (3 * h)
    y = qkv.view(b, s, 3, h, d)
    q, ks, vs = y[:, :, 0], [y[:, :, 1]], [y[:, :, 2]]
    for f in feats:
        z = f.view(b, f.shape[1], 2, h, d)
        ks.append(z[:, :, 0])
        vs.append(z[:, :, 1])
    q, k, v = (flash._rms_norm(t, eps).transpose(1, 2).contiguous()
               for t in (q, torch.cat(ks, 1), torch.cat(vs, 1)))
    bias = None
    if biases:
        zero = torch.zeros(b, h, s, s, dtype=torch.float32, device=qkv.device)
        bias = torch.cat([zero] + [bi.float() for bi in biases], -1)
    out = flash.nomax_attention(q, k, v, bias)
    return out.transpose(1, 2).reshape(b, s, h * d)


def self_attention_from_packed(qkv, num_heads: int, zero_sink: int = 0, eps: float = 1e-4):
    """qkv [B, S, 3*H*D] part-major -> [B, S, H*D]; `zero_sink` all-zero KV
    columns (the unconditional model's cross features) in closed form; `eps`
    is the pixel norm's."""
    if qkv.shape[1] >= NOMAX_MIN_SQ and not zero_sink:
        return _nomax_from_packed(qkv, (), num_heads, (), eps)
    return flash.packed_self_attention(qkv, num_heads, zero_sink=zero_sink,
                                       nomax=nomax_packed_on(), eps=eps)


def xattn_from_packed(qkv, feats, num_heads: int, biases=(), eps: float = 1e-4):
    """Joint softmax over the self segment of qkv and every cross source
    feats[i] [B, Sf, 2*H*D]; biases: () or one unscaled [B, H, S, Sf] each;
    `eps` is the pixel norm's."""
    if qkv.shape[1] >= NOMAX_MIN_SQ:
        return _nomax_from_packed(qkv, tuple(feats), num_heads, tuple(biases), eps)
    biases = tuple(biases)
    return flash.packed_xattn(qkv, tuple(feats), num_heads, biases=biases,
                              nomax=nomax_packed_on() and not biases, eps=eps)
