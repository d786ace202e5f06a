"""Operations and bytes of each kind of operation, from its shapes alone.

The same work is counted whatever implements it: a convolution is
2 * rows * H * W * Cin * Cout * kh * kw operations whether cuDNN, a
hand-written kernel or a recomputation runs it, and an attention call is
4 B H Sq Sk D forward and 8 B H Sq Sk D backward. Bytes count each input
read once and each output written once.

PEAKS: one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet, dense rates
at the full 700 W power limit.
"""

PEAKS = {
    "bf16_flops": 989e12,        # tensor cores, bf16 / fp16 dense
    "hbm_bytes_per_s": 3.35e12,
}


def conv_flops(rows, h, w, cin, cout, kh=3, kw=3):
    """A same-padded convolution over [rows, h, w, cin]."""
    return 2 * rows * h * w * cin * cout * kh * kw


def linear_flops(rows, cin, cout):
    """A linear map of `rows` vectors of `cin` values."""
    return 2 * rows * cin * cout


def attn_fwd_flops(b, h, sq, sk, d):
    """softmax(q k^T) v: two products of 2 B H Sq Sk D each."""
    return 4 * b * h * sq * sk * d


def attn_bwd_flops(b, h, sq, sk, d):
    """dq, dk, dv and dP: four products, twice the forward."""
    return 8 * b * h * sq * sk * d


def attn_fwd_bytes(b, h, sq, sk, d, elem=2):
    """q and the output [B, H, Sq, D], k and v [B, H, Sk, D]."""
    return (2 * sq + 2 * sk) * b * h * d * elem


def attn_bwd_bytes(b, h, sq, sk, d, elem=2):
    """Inputs q, o, dO [B, H, Sq, D], k, v [B, H, Sk, D] and the fp32 row
    statistics [B, H, Sq]; outputs dq [B, H, Sq, D], dk, dv [B, H, Sk, D]."""
    return (4 * sq + 4 * sk) * b * h * d * elem + 4 * b * h * sq


def elementwise_bytes(numel, reads=1, writes=1, elem=4):
    """An elementwise pass over `numel` values: `reads` inputs, `writes` outputs."""
    return numel * (reads + writes) * elem


def roofline_seconds(flops, nbytes, peaks=PEAKS):
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])
