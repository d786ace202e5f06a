"""Attention entry points of the blocks, over packed projection outputs.

Counterpart of vivid_tpu/kernels/attention.py's packed entries. The TPU
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
"""

import torch

from vivid_tpu_torch.kernels import flash

NOMAX_MIN_SQ = 4096   # query length from which the no-max kernel takes over


def _nomax_from_packed(qkv, feats, num_heads: int, biases):
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
    q, k, v = (flash._rms_norm(t).transpose(1, 2).contiguous()
               for t in (q, torch.cat(ks, 1), torch.cat(vs, 1)))
    bias = None
    if biases:
        zero = torch.zeros(b, h, s, s, dtype=torch.float32, device=qkv.device)
        bias = torch.cat([zero] + [bi.float() for bi in biases], -1)
    out = flash.nomax_attention(q, k, v, bias)
    return out.transpose(1, 2).reshape(b, s, h * d)


def self_attention_from_packed(qkv, num_heads: int, zero_sink: int = 0):
    """qkv [B, S, 3*H*D] part-major -> [B, S, H*D]; `zero_sink` all-zero KV
    columns (the unconditional model's cross features) in closed form."""
    if qkv.shape[1] >= NOMAX_MIN_SQ and not zero_sink:
        return _nomax_from_packed(qkv, (), num_heads, ())
    return flash.packed_self_attention(qkv, num_heads, zero_sink=zero_sink)


def xattn_from_packed(qkv, feats, num_heads: int, biases=()):
    """Joint softmax over the self segment of qkv and every cross source
    feats[i] [B, Sf, 2*H*D]; biases: () or one unscaled [B, H, S, Sf] each."""
    if qkv.shape[1] >= NOMAX_MIN_SQ:
        return _nomax_from_packed(qkv, tuple(feats), num_heads, tuple(biases))
    return flash.packed_xattn(qkv, tuple(feats), num_heads, biases=tuple(biases))
