"""Fused attention: the CUDA kernels' wrappers and their plain PyTorch
versions.

Counterparts of `flash_fused_packed` (self-attention, optional zero sink)
and `flash_fused_packed_xattn` (self segment plus cross sources, one joint
softmax, optional per-source logit bias) in vivid_tpu/kernels/flash.py, and
of their backward kernels `flash_fused_packed_bwd` and
`flash_fused_packed_xattn_bwd`. The forward wrappers launch the two kernels
of csrc/flash_packed.cu (a norm pre-pass into scratch allocated here, then
the forward on wgmma and TMA, whose grid `packed_fwd_plan` gives), the
backward wrappers the three of csrc/flash_packed_bwd.cu (the same pre-pass,
then the dq and the dk/dv kernels on wgmma and TMA, whose grids
`packed_bwd_plan` gives). `packed_self_attention` and `packed_xattn` are the
differentiable entries: autograd functions whose forward and backward are
those wrappers. `flash_nomax` is the big-S forward kernel of the 256px model
(csrc/flash_nomax.cu, counterpart of `flash_nomax` there), on q, k, v
[B, H, S, D] that the caller has already pixel-normalised. `flash_attention`
and `flash_attention_bwd` (csrc/flash_bwd.cu) are the counterpart of JAX's
`pallas.ops.tpu.flash_attention` as vivid_tpu/kernels/attention.py
`_stock_flash` calls it: the forward with a running max that also returns the
row log-sum-exp, and the backward kernels for dk/dv and for dq and the bias.
`nomax_attention` is the differentiable big-S entry: forward `flash_nomax`,
backward `flash_attention` again for the output and the statistics, then
`flash_attention_bwd`, which is the JAX package's own schedule
(`jax.vjp(_stock_flash)` behind the no-max forward). `flash_fused`
(csrc/flash_fused.cu, counterpart of `flash_fused` there) is the forward on
[B, H, S, D] with a running max that normalises its rows itself, in a
pre-pass (`flash_fused_norm` launches it alone), and takes a bias and a zero
sink. `flash_nomax_packed` (csrc/flash_nomax_packed.cu,
counterpart of `flash_nomax_packed`) computes what the unbiased packed
forwards compute by the no-max schedule, in K1/K2's two launches (the
pre-pass with q's scale folded into its rounding, then the no-max branch of
the same wgmma body); `packed_self_attention` and
`packed_xattn` take it as their forward when asked (`nomax=True`), with the
same backward kernels.

Layouts (packed kernels): qkv [B, S, 3*H*D] part-major (part, head, d); feats [B, Sf, 2*H*D]
(k, v part-major); biases [B, H, S, Sf] unscaled fp32; output [B, S, H*D]
in (head, d) order. q, k and v rows are pixel-normalised inside, so callers
pass the raw projection outputs.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Each wrapper adds one to its entry of `launches` where it launches
its kernel, and nowhere else. Between forward and backward only the inputs
are kept: the backward recomputes the softmax from them.
"""

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from vivid_tpu_torch.kernels import build

NORM_EPS = 1e-4  # the pixel norm's eps, as in the TPU kernels
launches = {"flash_fused_packed": 0, "flash_fused_packed_xattn": 0,
            "flash_fused_packed_bwd": 0, "flash_fused_packed_xattn_bwd": 0,
            "flash_nomax": 0, "flash_attention": 0, "flash_attention_bwd": 0,
            "flash_fused": 0, "flash_fused_norm": 0, "flash_nomax_packed": 0,
            # the kernels of vivid_tpu_torch/tools, counted here with the rest
            "conv3x3_silu": 0, "nomax_lab_attention": 0}
REF_CHUNK_ELEMS = 1 << 28   # fp32 logits a big-S plain version holds at a time (1 GiB)
BWD_ROWS = 64   # csrc/flash_bwd.cu and the packed kernels' pre-pass pad rows to 64-row tiles


def _rms_norm(x, eps=NORM_EPS):
    """Pixel norm of the last axis in fp32, result in x's dtype. The norm's
    gradient at a zero row is 0 (vector_norm's), as the kernels guard r = 0."""
    x32 = x.float()
    den = eps + torch.linalg.vector_norm(x32, dim=-1, keepdim=True) / math.sqrt(x.shape[-1])
    return (x32 / den).to(x.dtype)


def _attention_ref(qkv, feats, num_heads, biases, zero_sink, eps):
    b, s, c3 = qkv.shape
    h = num_heads
    d = c3 // (3 * h)
    y = qkv.view(b, s, 3, h, d)
    q = y[:, :, 0]
    ks, vs = [y[:, :, 1]], [y[:, :, 2]]
    for f in feats:
        z = f.view(b, f.shape[1], 2, h, d)
        ks.append(z[:, :, 0])
        vs.append(z[:, :, 1])
    q = _rms_norm(q, eps).transpose(1, 2).float()                  # [B,H,S,D]
    k = _rms_norm(torch.cat(ks, 1), eps).transpose(1, 2).float()   # [B,H,Sk,D]
    v = _rms_norm(torch.cat(vs, 1), eps).transpose(1, 2).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
    if biases:
        zero = torch.zeros(b, h, s, s, dtype=torch.float32, device=qkv.device)
        logits = logits + torch.cat([zero] + [bi.float() for bi in biases], -1)
    m = logits.amax(-1, keepdim=True)
    if zero_sink:
        m = m.clamp(min=0.0)
    e = torch.exp(logits - m)
    den = e.sum(-1, keepdim=True)
    if zero_sink:
        den = den + zero_sink * torch.exp(-m)
    out = torch.einsum("bhqk,bhkd->bhqd", e / den, v)
    return out.transpose(1, 2).reshape(b, s, h * d).to(qkv.dtype)


def flash_fused_packed_ref(qkv, num_heads: int, zero_sink: int = 0, eps: float = NORM_EPS):
    """Plain version of K1: normalise in fp32 (the norm's `eps`), fp32
    softmax with the sink's mass zero_sink * exp(-max(m, 0)) in the
    denominator."""
    return _attention_ref(qkv, (), num_heads, (), zero_sink, eps)


def flash_fused_packed_xattn_ref(qkv, feats, num_heads: int, biases=(), eps: float = NORM_EPS):
    """Plain version of K2: concatenate the self and cross KV segments and
    run one fp32 softmax (the self segment carries no bias)."""
    return _attention_ref(qkv, tuple(feats), num_heads, tuple(biases), 0, eps)


def _attention_bwd_ref(qkv, feats, g, num_heads, biases, zero_sink, eps):
    """Autograd through `_attention_ref` on fp32 copies of the inputs;
    gradients come back in the inputs' dtypes."""
    inputs = (qkv, *feats, *biases)
    leaves = [t.detach().float().requires_grad_() for t in inputs]
    n = len(feats)
    with torch.enable_grad():
        out = _attention_ref(leaves[0], tuple(leaves[1:1 + n]), num_heads,
                             tuple(leaves[1 + n:]), zero_sink, eps)
        grads = torch.autograd.grad(out, leaves, g.float())
    grads = [dx.to(t.dtype) for dx, t in zip(grads, inputs)]
    return grads[0], tuple(grads[1:1 + n]), tuple(grads[1 + n:])


def flash_fused_packed_bwd_ref(qkv, g, num_heads: int, zero_sink: int = 0,
                               eps: float = NORM_EPS):
    """Plain version of K3: the gradient of `flash_fused_packed_ref` in fp32."""
    return _attention_bwd_ref(qkv, (), g, num_heads, (), zero_sink, eps)[0]


def flash_fused_packed_xattn_bwd_ref(qkv, feats, g, num_heads: int, biases=(),
                                     eps: float = NORM_EPS):
    """Plain version of K4: (dqkv, dfeats, dbiases) of
    `flash_fused_packed_xattn_ref` in fp32."""
    return _attention_bwd_ref(qkv, tuple(feats), g, num_heads, tuple(biases), 0, eps)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _check(t, name, dtype, shape, device, on_card=True):
    if (on_card and not t.is_cuda) or t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _checked(qkv, feats, biases, num_heads, zero_sink, eps):
    """Raise on anything the kernels do not take; -> (b, s, h, d, srcs) with
    srcs two (feats, sf, bias) triples, absent sources as (None, 0, None)."""
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [B, S, 3*H*D], got {tuple(qkv.shape)}")
    b, s, c3 = qkv.shape
    h = num_heads
    d = c3 // (3 * h) if h > 0 else 0
    if h < 1 or c3 != 3 * h * d or d not in (32, 64):
        raise ValueError(f"packed width {c3} with {h} heads: head dim must be 32 or 64")
    if s < 1 or b < 1:
        raise ValueError(f"empty qkv {tuple(qkv.shape)}")
    if len(feats) > 2:
        raise ValueError(f"at most 2 cross sources, got {len(feats)}")
    if biases and len(biases) != len(feats):
        raise ValueError("give one bias per cross source, or none")
    if zero_sink < 0 or not eps > 0:
        raise ValueError(f"zero_sink {zero_sink} must be >= 0 and eps {eps} > 0")
    dev = qkv.device
    _check(qkv, "qkv", torch.bfloat16, (b, s, c3), dev)
    srcs = []
    for i, f in enumerate(feats):
        if f.dim() != 3 or f.shape[1] < 1:
            raise ValueError(f"feats[{i}] must be [B, Sf >= 1, 2*H*D], got {tuple(f.shape)}")
        sf = f.shape[1]
        _check(f, f"feats[{i}]", torch.bfloat16, (b, sf, 2 * h * d), dev)
        bias = biases[i] if biases else None
        if bias is not None:
            _check(bias, f"biases[{i}]", torch.float32, (b, h, s, sf), dev)
        srcs.append((f, sf, bias))
    srcs += [(None, 0, None)] * (2 - len(srcs))
    return b, s, h, d, srcs


def _launch(qkv, feats, biases, num_heads, zero_sink, eps, nomax=False):
    """The two launches of a packed forward: K1/K2's, or with `nomax` K7's
    (no bias)."""
    b, s, h, d, srcs = _checked(qkv, feats, biases, num_heads, zero_sink, eps)
    dev = qkv.device
    out = torch.empty(b, s, h * d, dtype=torch.bfloat16, device=dev)
    # Scratch of the norm pre-pass, one allocation: q's rows [B, H, S, d],
    # then k's and v's [B, H, keys, d] with every segment padded to whole tiles.
    rows = torch.empty(packed_fwd_rows(b, s, h, d, [sf for _, sf, _ in srcs]),
                       dtype=torch.bfloat16, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        tail = (ctypes.c_float(eps), ctypes.c_float(zero_sink), stream)
        if nomax:
            rc = lib.vivid_flash_nomax_packed_fwd(
                _ptr(qkv), _ptr(out), _ptr(rows), b, s, h, d, len(feats),
                _ptr(srcs[0][0]), srcs[0][1], _ptr(srcs[1][0]), srcs[1][1], *tail)
        else:
            rc = lib.vivid_flash_packed_fwd(
                _ptr(qkv), _ptr(out), _ptr(rows), b, s, h, d, len(feats),
                _ptr(srcs[0][0]), srcs[0][1], _ptr(srcs[0][2]),
                _ptr(srcs[1][0]), srcs[1][1], _ptr(srcs[1][2]), *tail)
    if rc != 0:
        name = "flash_nomax_packed" if nomax else "flash_packed"
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out


def _tiles(n):
    return -(-n // BWD_ROWS)


def _key_rows(s, srcs):
    """Rows of the pre-pass's k' (and of its v'): the self segment and every
    source, each padded to whole tiles (an absent source has length 0)."""
    return sum(_tiles(n) for n in (s, *(sf for _, sf, _ in srcs))) * BWD_ROWS


def packed_fwd_rows(b: int, s: int, h: int, d: int, lens=()) -> int:
    """bf16 elements of the scratch a packed forward (K1/K2, K7) allocates
    for its norm pre-pass: q's rows [B, H, S, d], then k's and v's
    [B, H, keys, d], keys the self segment's S and each source's length
    `lens[i]`, each padded to whole 64-row tiles."""
    return b * h * (s + 2 * _key_rows(s, [(None, n, None) for n in lens])) * d


def packed_fwd_plan(b: int, s: int, h: int, sms: int = 132):
    """The grid of K1/K2's wgmma kernel at a shape, and of K7's (the same
    body): a block for each 64-row query tile of each (b, h), each block one
    consumer warpgroup, two blocks on each of `sms` streaming
    multiprocessors. -> {"fwd": dict(blocks, waves)}; the sources set no
    block's count, only its walk."""
    blocks = _tiles(s) * b * h
    return {"fwd": dict(blocks=blocks, waves=round(blocks / (2 * sms), 3))}


def packed_bwd_plan(b: int, s: int, h: int, lens=(), sms: int = 132):
    """The grids of K3/K4's two wgmma kernels at a shape: the dq kernel takes a
    block for each 64-row query tile, the dk/dv kernel one for each 64-row
    key tile (every segment, self and each source of length `lens[i]`,
    padded to whole tiles), each block one consumer warpgroup, two blocks on
    each of `sms` streaming multiprocessors. -> {"dq" | "dkv": dict(blocks,
    waves)}."""
    plan = {}
    for kernel, tiles in (("dq", _tiles(s)), ("dkv", sum(_tiles(n) for n in (s, *lens)))):
        blocks = tiles * b * h
        plan[kernel] = dict(blocks=blocks, waves=round(blocks / (2 * sms), 3))
    return plan


def _launch_bwd(qkv, feats, biases, g, num_heads, zero_sink, eps):
    b, s, h, d, srcs = _checked(qkv, feats, biases, num_heads, zero_sink, eps)
    dev = qkv.device
    g = g.contiguous()   # autograd may hand over a strided cotangent
    _check(g, "g", torch.bfloat16, (b, s, h * d), dev)
    dqkv = torch.empty_like(qkv)
    # Scratch, one allocation: the row statistics (lse * log2(e), then
    # delta) padded to whole 64-row tiles, fp32; then the normalised rows,
    # q's [B, H, S, d] and k's and v's [B, H, keys, d] with every segment
    # padded to whole tiles, bf16.
    stat_bytes = 2 * b * h * _tiles(s) * BWD_ROWS * 4
    keys = _key_rows(s, srcs)
    scratch = torch.empty(stat_bytes + b * h * (s + 2 * keys) * d * 2, dtype=torch.uint8,
                          device=dev)
    base = scratch.data_ptr()
    grads = [(None if f is None else torch.empty_like(f),
              None if bias is None else torch.empty_like(bias)) for f, _, bias in srcs]
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vivid_flash_packed_bwd(
            _ptr(qkv), _ptr(g), _ptr(dqkv), ctypes.c_void_p(base),
            ctypes.c_void_p(base + stat_bytes // 2), ctypes.c_void_p(base + stat_bytes),
            b, s, h, d, len(feats),
            _ptr(srcs[0][0]), _ptr(grads[0][0]), srcs[0][1], _ptr(srcs[0][2]), _ptr(grads[0][1]),
            _ptr(srcs[1][0]), _ptr(grads[1][0]), srcs[1][1], _ptr(srcs[1][2]), _ptr(grads[1][1]),
            ctypes.c_float(eps), ctypes.c_float(zero_sink), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"flash_packed_bwd kernel launch failed: CUDA error {rc}")
    n = len(feats)
    return (dqkv, tuple(df for df, _ in grads[:n]),
            tuple(db for _, db in grads[:n] if db is not None))


def flash_fused_packed(qkv, num_heads: int, zero_sink: int = 0, eps: float = NORM_EPS):
    """K1: qkv [B, S, 3*H*D] -> [B, S, H*D], with `zero_sink` all-zero KV
    columns in closed form (the unconditional model's cross features); `eps`
    is the pixel norm's."""
    if qkv.device.type == "cpu":
        return flash_fused_packed_ref(qkv, num_heads, zero_sink, eps)
    out = _launch(qkv, (), (), num_heads, zero_sink, eps)
    launches["flash_fused_packed"] += 1
    return out


def flash_fused_packed_xattn(qkv, feats, num_heads: int, biases=(), eps: float = NORM_EPS):
    """K2: qkv [B, S, 3*H*D] plus cross sources feats [B, Sf, 2*H*D] ->
    [B, S, H*D]; optional unscaled per-source biases [B, H, S, Sf]."""
    if qkv.device.type == "cpu":
        return flash_fused_packed_xattn_ref(qkv, feats, num_heads, biases, eps)
    out = _launch(qkv, tuple(feats), tuple(biases), num_heads, 0, eps)
    launches["flash_fused_packed_xattn"] += 1
    return out


def flash_fused_packed_bwd(qkv, g, num_heads: int, zero_sink: int = 0, eps: float = NORM_EPS):
    """K3, backward of K1: qkv [B, S, 3*H*D], cotangent g [B, S, H*D] ->
    dqkv [B, S, 3*H*D]."""
    if qkv.device.type == "cpu":
        return flash_fused_packed_bwd_ref(qkv, g, num_heads, zero_sink, eps)
    dqkv = _launch_bwd(qkv, (), (), g, num_heads, zero_sink, eps)[0]
    launches["flash_fused_packed_bwd"] += 1
    return dqkv


def flash_fused_packed_xattn_bwd(qkv, feats, g, num_heads: int, biases=(),
                                 eps: float = NORM_EPS):
    """K4, backward of K2 -> (dqkv, dfeats, dbiases): one [B, Sf, 2*H*D]
    per source and one fp32 [B, H, S, Sf] per bias."""
    if qkv.device.type == "cpu":
        return flash_fused_packed_xattn_bwd_ref(qkv, feats, g, num_heads, biases, eps)
    grads = _launch_bwd(qkv, tuple(feats), tuple(biases), g, num_heads, 0, eps)
    launches["flash_fused_packed_xattn_bwd"] += 1
    return grads

def flash_nomax_packed_ref(qkv, feats=(), num_heads: int = 1, zero_sink: int = 0,
                           eps: float = NORM_EPS):
    """Plain version of K7, the kernel's arithmetic step for step: k and v
    rows normalised in fp32 and rounded to the input's dtype; q rows times
    (1 / sqrt(D)) / (eps + ||q|| / sqrt(D)) in fp32 and rounded once; fp32
    logits over the self segment and every source; p = exp(s) with no maximum
    (|s| <= sqrt(D) after the norm); fp32 row sums of the unrounded p plus
    `zero_sink` (exp(0) a column); p rounded to the dtype for the second
    product; one division."""
    b, s, c3 = qkv.shape
    h = num_heads
    d = c3 // (3 * h)
    y = qkv.view(b, s, 3, h, d)
    ks, vs = [y[:, :, 1]], [y[:, :, 2]]
    for f in feats:
        z = f.view(b, f.shape[1], 2, h, d)
        ks.append(z[:, :, 0])
        vs.append(z[:, :, 1])
    q32 = y[:, :, 0].float()
    den = eps + torch.linalg.vector_norm(q32, dim=-1, keepdim=True) / math.sqrt(d)
    q = (q32 * ((1.0 / math.sqrt(d)) / den)).to(qkv.dtype).transpose(1, 2).float()
    k = _rms_norm(torch.cat(ks, 1), eps).transpose(1, 2).float()      # [B,H,Sk,D]
    v = _rms_norm(torch.cat(vs, 1), eps).transpose(1, 2)
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", q, k))
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(qkv.dtype).float(), v.float())
    out = acc / (p.sum(-1, keepdim=True) + zero_sink)
    return out.transpose(1, 2).reshape(b, s, h * d).to(qkv.dtype)


def flash_nomax_packed(qkv, feats=(), num_heads: int = 1, zero_sink: int = 0,
                       eps: float = NORM_EPS):
    """K7: what K1 (`feats` empty, optional `zero_sink`) and the unbiased K2
    compute, by the no-max schedule: qkv [B, S, 3*H*D] and cross sources
    [B, Sf, 2*H*D] -> [B, S, H*D]. Takes what K1/K2 take (any S and Sf, D 32
    or 64 on the card), but no bias: a learned bias breaks the logit bound
    that makes a maximum unnecessary. The forward alone: `packed_self_attention`
    and `packed_xattn` with `nomax=True` are the entries with a gradient."""
    feats = tuple(feats)
    if qkv.device.type == "cpu":
        return flash_nomax_packed_ref(qkv, feats, num_heads, zero_sink, eps)
    out = _launch(qkv, feats, (), num_heads, zero_sink, eps, nomax=True)
    launches["flash_nomax_packed"] += 1
    return out


def flash_nomax_packed_info(d: int):
    """What K7's wgmma kernel for head dim `d` (32 or 64) was built with,
    from the loaded library, so only where there is a card: the keys of
    `flash_nomax_info`. K7 takes no bias, so it has one instance a head dim."""
    return _forward_info("flash_nomax_packed_info", d, False)


class _PackedSelfAttention(torch.autograd.Function):
    """K1 (with `nomax` K7) forward, K3 backward; keeps qkv only."""

    @staticmethod
    def forward(ctx, qkv, num_heads, zero_sink, nomax, eps):
        ctx.save_for_backward(qkv)
        ctx.args = (num_heads, zero_sink, eps)
        if nomax:
            return flash_nomax_packed(qkv, (), num_heads, zero_sink, eps)
        return flash_fused_packed(qkv, num_heads, zero_sink, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return flash_fused_packed_bwd(qkv, g, *ctx.args), None, None, None, None


class _PackedXAttn(torch.autograd.Function):
    """K2 (with `nomax` K7) forward, K4 backward; keeps qkv, the sources and
    the biases."""

    @staticmethod
    def forward(ctx, num_heads, n_src, nomax, eps, qkv, *rest):
        ctx.save_for_backward(qkv, *rest)
        ctx.args = (num_heads, n_src, eps)
        if nomax:
            return flash_nomax_packed(qkv, rest, num_heads, 0, eps)
        return flash_fused_packed_xattn(qkv, rest[:n_src], num_heads, rest[n_src:], eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        num_heads, n_src, eps = ctx.args
        qkv, *rest = ctx.saved_tensors
        dqkv, dfeats, dbiases = flash_fused_packed_xattn_bwd(
            qkv, rest[:n_src], g, num_heads, rest[n_src:], eps)
        return None, None, None, None, dqkv, *dfeats, *dbiases


def packed_self_attention(qkv, num_heads: int, zero_sink: int = 0, nomax: bool = False,
                          eps: float = NORM_EPS):
    """Differentiable K1: its gradient is K3. `nomax` swaps the forward for
    K7; K3 recomputes the softmax from qkv alone, so the backward is the same.
    `eps` is the pixel norm's, in both directions."""
    return _PackedSelfAttention.apply(qkv, num_heads, zero_sink, nomax, eps)


def packed_xattn(qkv, feats, num_heads: int, biases=(), nomax: bool = False,
                 eps: float = NORM_EPS):
    """Differentiable K2: its gradients are K4's. `nomax` swaps the forward
    for K7, which takes no bias."""
    feats = tuple(feats)
    if nomax and len(biases):
        raise ValueError("the no-max packed forward takes no bias")
    return _PackedXAttn.apply(num_heads, len(feats), nomax, eps, qkv, *feats, *biases)


def _nomax_shift(bias, d):
    """sqrt(D) + max(bias) as a one-element fp32 tensor on bias's device: above
    every biased logit of pixel-normalised rows. Stays on the device."""
    return (math.sqrt(d) + bias.amax()).reshape(1)


def _ref_chunks(b, h, sq, sk):
    """Slices of the query rows that keep b * h * rows * sk logits within
    REF_CHUNK_ELEMS (the softmax is per row, so the walk is exact)."""
    rows = max(1, min(sq, REF_CHUNK_ELEMS // (b * h * sk)))
    return [slice(i, i + rows) for i in range(0, sq, rows)]


def _checked_bhsd(q, k, v, bias, on_card=True):
    """Raise on anything the big-S kernels do not take -> (b, h, sq, sk, d):
    D other than 32 or 64, a tensor that is not contiguous or whose base is not
    16-byte aligned (the tensor maps and the vector loads want both), a wrong
    shape or dtype, a tensor off q's device. `on_card=False` lets tensors that
    are not on a card through, so the checks run where there is none."""
    if q.dim() != 4 or q.shape[-1] not in (32, 64):
        raise ValueError(f"q must be [B, H, Sq, D] with D 32 or 64, got {tuple(q.shape)}")
    b, h, sq, d = q.shape
    if k.dim() != 4 or k.shape[2] < 1 or sq < 1:
        raise ValueError(f"k must be [B, H, Sk >= 1, D], got {tuple(k.shape)}")
    sk = k.shape[2]
    dev = q.device
    _check(q, "q", torch.bfloat16, (b, h, sq, d), dev, on_card)
    _check(k, "k", torch.bfloat16, (b, h, sk, d), dev, on_card)
    _check(v, "v", torch.bfloat16, (b, h, sk, d), dev, on_card)
    if bias is not None:
        _check(bias, "bias", torch.float32, (b, h, sq, sk), dev, on_card)
    return b, h, sq, sk, d


def flash_nomax_ref(q, k, v, bias=None):
    """Plain version of K6, the kernel's arithmetic step for step: q scaled
    by 1/sqrt(D) in fp32 and rounded to its dtype, fp32 logits, p = exp(s)
    or exp(s + bias - shift) with shift = sqrt(D) + max(bias), fp32 row sums
    of the unrounded p, p rounded to v's dtype for the second product, one
    division. Walks the query rows in chunks (the softmax is per row), so
    the logits never exceed REF_CHUNK_ELEMS values."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    qs = (q.float() * (1.0 / math.sqrt(d))).to(q.dtype).float()
    k32, v32 = k.float(), v.float()
    # Softmax does not depend on the shift: it carries no gradient.
    shift = None if bias is None else _nomax_shift(bias.detach().float(), d)
    outs = []
    for cut in _ref_chunks(b, h, sq, sk):
        s = torch.einsum("bhqd,bhkd->bhqk", qs[:, :, cut], k32)
        if bias is not None:
            s = s + bias[:, :, cut].float() - shift
        p = torch.exp(s)
        acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v32)
        outs.append((acc / p.sum(-1, keepdim=True)).to(v.dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 2)


def flash_nomax(q, k, v, bias=None):
    """K6: attention with no running max. q [B, H, Sq, D], k, v [B, H, Sk, D]
    (bf16 on the card, D 32 or 64, any Sq and Sk), optional unscaled fp32 bias
    [B, H, Sq, Sk] -> [B, H, Sq, D]. The forward alone: `nomax_attention`
    is the entry with a gradient.

    The contract is the caller's: q and k rows are pixel-normalised (row norm
    <= sqrt(D)), so every scaled logit lies below sqrt(D) and exp of it stays
    below e^5.66 (D = 32) or e^8 (D = 64). Unnormalised input overflows, as in
    the TPU kernel; nothing here guards it. With a bias the shift
    sqrt(D) + max(bias) keeps every exponent at or below 0; a row whose every
    biased logit lies ~88 below that shift sums to 0 and comes out NaN."""
    if q.device.type == "cpu":
        return flash_nomax_ref(q, k, v, bias)
    b, h, sq, sk, d = _checked_bhsd(q, k, v, bias)
    dev = q.device
    shift = None if bias is None else _nomax_shift(bias, d)
    out = torch.empty_like(q)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vivid_flash_nomax_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(shift), _ptr(out),
            b, h, sq, sk, d, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"flash_nomax kernel launch failed: CUDA error {rc}")
    launches["flash_nomax"] += 1
    return out


# What a big-S kernel was built with, in the order its C info entry fills them.
_INFO_KEYS = ("regs_at_launch", "local_bytes", "smem_bytes", "block_rows", "stage_rows",
              "stages", "consumer_regs", "producer_regs", "threads")


def _forward_info(name, d, biased):
    """_INFO_KEYS of the forward kernel whose C info entry is vivid_<name>."""
    if d not in (32, 64):
        raise ValueError(f"d must be 32 or 64, got {d}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name} reads the built kernel: it needs a CUDA card")
    info = (ctypes.c_int * len(_INFO_KEYS))()
    rc = getattr(build.library(), f"vivid_{name}")(d, int(biased),
                                                   ctypes.cast(info, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")
    return dict(zip(_INFO_KEYS, info))


def flash_nomax_info(d: int, biased: bool = False):
    """What K6's kernel for head dim `d` (32 or 64) was built with, from the
    loaded library, so only where there is a card: dict(regs_at_launch,
    local_bytes (spills), smem_bytes (dynamic shared memory), block_rows
    (query rows one block owns), stage_rows (keys in one stage of the ring),
    stages, consumer_regs and producer_regs (a thread's registers after the
    warpgroups have traded them), threads)."""
    return _forward_info("flash_nomax_info", d, biased)


def flash_fused_ref(q, k, v, bias=None, norm_eps=None, zero_sink: int = 0):
    """Plain version of K5, the kernel's arithmetic step for step: with
    `norm_eps` the q, k and v rows are pixel-normalised in fp32 and rounded to
    their dtype; fp32 logits times 1/sqrt(D) plus the bias; softmax about the
    row maximum (raised to 0 with a sink) with fp32 row sums of the unrounded
    p plus zero_sink * exp(-max); p rounded to v's dtype for the second
    product; one division. Walks the query rows in chunks of at most
    REF_CHUNK_ELEMS logits."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if norm_eps is not None:
        def norm(x):
            x32 = x.float()
            den = norm_eps + torch.linalg.vector_norm(x32, dim=-1, keepdim=True) / math.sqrt(d)
            return (x32 / den).to(x.dtype)
        q, k, v = norm(q), norm(k), norm(v)
    q32, k32, v32 = q.float(), k.float(), v.float()
    outs = []
    for cut in _ref_chunks(b, h, sq, sk):
        s = torch.einsum("bhqd,bhkd->bhqk", q32[:, :, cut], k32) * (1.0 / math.sqrt(d))
        if bias is not None:
            s = s + bias[:, :, cut].float()
        m = s.amax(-1, keepdim=True)
        if zero_sink:
            m = m.clamp(min=0.0)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        if zero_sink:
            l = l + zero_sink * torch.exp(-m)
        acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v32)
        outs.append((acc / l).to(v.dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 2)


def flash_fused(q, k, v, bias=None, norm_eps=None, zero_sink: int = 0):
    """K5: softmax(q k^T / sqrt(D) + bias) v with a running max, on q
    [B, H, Sq, D] and k, v [B, H, Sk, D] (bf16 on the card, D 32 or 64, any Sq
    and Sk), optional unscaled fp32 bias [B, H, Sq, Sk] -> [B, H, Sq, D]. With
    `norm_eps` the q, k and v rows are pixel-normalised first (raw
    projection outputs in), by a pre-pass into scratch allocated here; with
    None they are taken as normalised. `zero_sink` all-zero key columns join
    the softmax in closed form. The forward alone:
    `kernels.attention.attention_from_raw` is the entry with a gradient."""
    if q.device.type == "cpu":
        return flash_fused_ref(q, k, v, bias, norm_eps, zero_sink)
    b, h, sq, sk, d = _checked_bhsd(q, k, v, bias)
    if zero_sink < 0 or (norm_eps is not None and norm_eps <= 0):
        raise ValueError(f"zero_sink {zero_sink} must be >= 0 and norm_eps {norm_eps} > 0 or None")
    out = torch.empty_like(q)
    scratch = (None,) * 3 if norm_eps is None else tuple(torch.empty_like(t) for t in (q, k, v))
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vivid_flash_fused_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(out), *map(_ptr, scratch),
            b, h, sq, sk, d, int(norm_eps is not None), ctypes.c_float(norm_eps or 0.0),
            ctypes.c_float(zero_sink), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"flash_fused kernel launch failed: CUDA error {rc}")
    launches["flash_fused"] += 1
    return out


def flash_fused_norm(q, k, v, norm_eps: float = NORM_EPS):
    """K5's pre-pass alone: the pixel-normalised rows of q [B, H, Sq, D] and
    k, v [B, H, Sk, D] (bf16 on the card, D 32 or 64) -> (qn, kn, vn), what
    `flash_fused` with `norm_eps` multiplies. Its plain version is
    `_rms_norm`."""
    if q.device.type == "cpu":
        return tuple(_rms_norm(t, norm_eps) for t in (q, k, v))
    b, h, sq, sk, d = _checked_bhsd(q, k, v, None)
    if not norm_eps > 0:
        raise ValueError(f"norm_eps must be > 0, got {norm_eps}")
    outs = tuple(torch.empty_like(t) for t in (q, k, v))
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vivid_flash_fused_norm(
            _ptr(q), _ptr(k), _ptr(v), *map(_ptr, outs), b, h, sq, sk, d,
            ctypes.c_float(norm_eps), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"flash_fused_norm kernel launch failed: CUDA error {rc}")
    launches["flash_fused_norm"] += 1
    return outs


def flash_fused_info(d: int, biased: bool = False):
    """What K5's forward kernel for head dim `d` (32 or 64) was built with,
    from the loaded library, so only where there is a card: the keys of
    `flash_nomax_info`."""
    return _forward_info("flash_fused_info", d, biased)


def flash_attention_ref(q, k, v, bias=None):
    """Plain version of K8's forward -> (out, lse): q scaled by 1/sqrt(D) in
    fp32 and rounded to its dtype, fp32 logits (+ bias), softmax about the row
    maximum with fp32 row sums, p rounded to v's dtype for the second product;
    lse = max + log(sum) in fp32 [B, H, Sq]. Exact for any logits. Walks the
    query rows in chunks of at most REF_CHUNK_ELEMS logits."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    qs = (q.float() * (1.0 / math.sqrt(d))).to(q.dtype).float()
    k32, v32 = k.float(), v.float()
    out = torch.empty(b, h, sq, d, dtype=v.dtype, device=q.device)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    for cut in _ref_chunks(b, h, sq, sk):
        s = torch.einsum("bhqd,bhkd->bhqk", qs[:, :, cut], k32)
        if bias is not None:
            s = s + bias[:, :, cut].float()
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v32)
        out[:, :, cut] = (acc / l).to(v.dtype)
        lse[:, :, cut] = (m + torch.log(l)).squeeze(-1)
    return out, lse


def flash_attention_bwd_ref(q, k, v, bias, out, lse, g):
    """Plain version of K8's backward -> (dq, dk, dv, dbias or None), the
    kernels' arithmetic: P = exp(s - lse) from the recomputed logits,
    delta = rowsum(g * out), dv = P^T g, dS = P * (g v^T - delta),
    dq = dS k / sqrt(D), dk = dS^T (q / sqrt(D)), dbias = dS in fp32. P and dS
    are rounded to the inputs' dtype for the products. Walks the query rows in
    chunks, adding up dk and dv in fp32."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qs = (q.float() * scale).to(q.dtype).float()
    k32, v32, g32 = k.float(), v.float(), g.float()
    delta = (g32 * out.float()).sum(-1, keepdim=True)
    dq = torch.empty_like(q)
    dk = torch.zeros(b, h, sk, d, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dbias = None if bias is None else torch.empty(b, h, sq, sk, dtype=torch.float32,
                                                  device=q.device)
    for cut in _ref_chunks(b, h, sq, sk):
        s = torch.einsum("bhqd,bhkd->bhqk", qs[:, :, cut], k32)
        if bias is not None:
            s = s + bias[:, :, cut].float()
        p = torch.exp(s - lse[:, :, cut, None])
        dv += torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).float(), g32[:, :, cut])
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", g32[:, :, cut], v32) - delta[:, :, cut])
        if dbias is not None:
            dbias[:, :, cut] = ds
        ds = ds.to(q.dtype).float()
        dq[:, :, cut] = (torch.einsum("bhqk,bhkd->bhqd", ds, k32) * scale).to(q.dtype)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qs[:, :, cut])
    return dq, dk.to(k.dtype), dv.to(v.dtype), dbias


def flash_attention(q, k, v, bias=None):
    """K8 forward: softmax(q k^T / sqrt(D) + bias) v with a running max, for
    any logits. q [B, H, Sq, D], k, v [B, H, Sk, D] (bf16 on the card, D 32
    or 64, any Sq and Sk), optional unscaled fp32 bias [B, H, Sq, Sk] ->
    (out [B, H, Sq, D], lse fp32 [B, H, Sq]), what `flash_attention_bwd` needs."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, bias)
    b, h, sq, sk, d = _checked_bhsd(q, k, v, bias)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vivid_flash_attn_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(out), _ptr(lse),
            b, h, sq, sk, d, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd kernel launch failed: CUDA error {rc}")
    launches["flash_attention"] += 1
    return out, lse


def flash_attention_bwd(q, k, v, bias, out, lse, g):
    """K8 backward: the gradients of `flash_attention` for the cotangent g
    [B, H, Sq, D], from the output and row statistics that forward returned ->
    (dq, dk, dv, dbias): dbias fp32 [B, H, Sq, Sk], None without a bias. Two
    kernels (dk/dv per key block, dq and dbias per query block) after a small
    pass that writes, into scratch allocated here, delta = rowsum(g * out) and
    lse * log2(e) (rows padded to 64) and q / sqrt(D) rounded to bf16 once; no
    atomics, so two runs give the same bits."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, bias, out, lse, g)
    b, h, sq, sk, d = _checked_bhsd(q, k, v, bias)
    dev = q.device
    g = g.contiguous()   # autograd may hand over a strided cotangent
    _check(g, "g", torch.bfloat16, (b, h, sq, d), dev)
    _check(out, "out", torch.bfloat16, (b, h, sq, d), dev)
    _check(lse, "lse", torch.float32, (b, h, sq), dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    qs = torch.empty_like(q)
    stats = torch.empty(2, b * h, -(-sq // BWD_ROWS) * BWD_ROWS, dtype=torch.float32, device=dev)
    dbias = None if bias is None else torch.empty_like(bias)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vivid_flash_attn_bwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(out), _ptr(lse), _ptr(g),
            _ptr(qs), _ptr(stats), _ptr(dq), _ptr(dk), _ptr(dv), _ptr(dbias),
            b, h, sq, sk, d, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd kernel launch failed: CUDA error {rc}")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv, dbias


def flash_attention_info(d: int, biased: bool = False):
    """What K8's three kernels were built with, from the loaded library (so
    only where there is a card): {"fwd" | "dkv" | "dq": dict(regs_at_launch,
    local_bytes (spills), smem_bytes (dynamic shared memory), block_rows (rows
    of the outputs one block owns), stage_rows (keys, or for dk/dv query rows,
    in one stage of the ring), stages, consumer_regs and producer_regs (a
    thread's registers after the warpgroups have traded them), threads)}."""
    lib = build.library()
    out = {}
    for i, kernel in enumerate(("fwd", "dkv", "dq")):
        info = (ctypes.c_int * len(_INFO_KEYS))()
        rc = lib.vivid_flash_attn_info(i, d, int(biased), ctypes.cast(info, ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"flash_attn_info failed: CUDA error {rc}")
        out[kernel] = dict(zip(_INFO_KEYS, info))
    return out


def flash_packed_info(d: int, biased: bool = False):
    """What K1/K2's wgmma kernel for head dim `d` (32 or 64) was built with,
    from the loaded library, so only where there is a card: the keys of
    `flash_nomax_info`; `biased` the instance a launch with a bias takes."""
    return _forward_info("flash_packed_info", d, biased)


def flash_packed_bwd_info(d: int, biased: bool = False):
    """What K3/K4's two wgmma kernels for head dim `d` (32 or 64) were built
    with, from the loaded library, so only where there is a card: {"dq" |
    "dkv": the keys of `flash_nomax_info`}; `biased` the instances a launch
    with a bias takes."""
    if d not in (32, 64):
        raise ValueError(f"d must be 32 or 64, got {d}")
    if not torch.cuda.is_available():
        raise RuntimeError("flash_packed_bwd_info reads the built kernel: it needs a CUDA card")
    lib = build.library()
    out = {}
    for i, kernel in enumerate(("dq", "dkv")):
        info = (ctypes.c_int * len(_INFO_KEYS))()
        rc = lib.vivid_flash_packed_bwd_info(i, d, int(biased), ctypes.cast(info, ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"flash_packed_bwd_info failed: CUDA error {rc}")
        out[kernel] = dict(zip(_INFO_KEYS, info))
    return out


class _FlashAttention(torch.autograd.Function):
    """K8 forward, K8 backward; keeps the inputs, the output and the row
    statistics."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        out, lse = flash_attention(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return flash_attention_bwd(*ctx.saved_tensors, g)


def stock_attention(q, k, v, bias=None):
    """Differentiable K8: `flash_attention`'s output, its gradients by
    `flash_attention_bwd` (the role of `_stock_flash` in the JAX package). A
    CPU tensor takes the plain version under ordinary autograd."""
    if q.device.type == "cpu":
        return flash_attention(q, k, v, bias)[0]
    return _FlashAttention.apply(q, k, v, bias)


class _NomaxAttention(torch.autograd.Function):
    """K6 forward, K8 backward; keeps the inputs only. The backward runs K8's
    forward for the output and the row statistics and feeds K8's own output
    (not K6's, which may differ in the last bit) to delta, so the backward
    pair is consistent in itself."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return flash_nomax(q, k, v, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        out, lse = flash_attention(q, k, v, bias)
        return flash_attention_bwd(q, k, v, bias, out, lse, g)


def nomax_attention(q, k, v, bias=None):
    """Differentiable K6: `flash_nomax` whose gradients are K8's. A CPU
    tensor takes the plain version under ordinary autograd."""
    if q.device.type == "cpu":
        return flash_nomax(q, k, v, bias)
    return _NomaxAttention.apply(q, k, v, bias)
