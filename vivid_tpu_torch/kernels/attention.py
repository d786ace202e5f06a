"""Attention entry points of the blocks, over packed projection outputs.

Counterpart of vivid_tpu/kernels/attention.py's packed entries. The TPU
package gated its Pallas kernels on the platform, on sequence alignment and
on a VMEM budget; here there is no gate: the CUDA kernel takes any sequence
length, so a CUDA tensor always goes to it (or the call raises) and a CPU
tensor always goes to the plain version. Both entries are differentiable:
their backward is the backward kernel (or its plain version on the CPU).
"""

from vivid_tpu_torch.kernels import flash


def self_attention_from_packed(qkv, num_heads: int, zero_sink: int = 0):
    """qkv [B, S, 3*H*D] part-major -> [B, S, H*D]; `zero_sink` all-zero KV
    columns (the unconditional model's cross features) in closed form."""
    return flash.packed_self_attention(qkv, num_heads, zero_sink=zero_sink)


def xattn_from_packed(qkv, feats, num_heads: int, biases=()):
    """Joint softmax over the self segment of qkv and every cross source
    feats[i] [B, Sf, 2*H*D]; biases: () or one unscaled [B, H, S, Sf] each."""
    return flash.packed_xattn(qkv, tuple(feats), num_heads, biases=tuple(biases))
