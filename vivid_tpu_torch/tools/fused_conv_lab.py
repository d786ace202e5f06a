"""Lab for the 3x3 convolution of the 256px model's first level (64 channels
at 256 x 256) with the SiLU fused into it.

Counterpart of tools/fused_conv_lab.py. Every residual branch computes
conv3x3(silu(x) / 0.596); as two library calls the activated tensor makes a
round trip through device memory. The lab's kernel (csrc/conv3x3_silu.cu)
applies the SiLU to each input tile once, in shared memory, on its way into
the product (an implicit GEMM on wgmma fed by a ring of TMA loads). Variants
timed:

  cudnn         F.conv2d alone (channels_last bf16)
  cudnn-silu    F.silu(x) / 0.596, then F.conv2d: what the blocks run
  kernel        the fused kernel
  kernel-nosilu the kernel's convolution alone

Both forms of the kernel are first held against the plain version; a
disagreement raises. Each variant is timed as one call (the host's launch
included, as a caller of one convolution sees it) and as 20 calls back to back
(the card's time). FLOPs count the convolution's products only.

    python -m vivid_tpu_torch.tools.fused_conv_lab [--batch 16] [--res 256]
"""

import argparse
import ctypes
import functools

import torch
import torch.nn.functional as F

from vivid_tpu_torch.kernels import build, flash
from vivid_tpu_torch.tools import cuda_ms, tool_device, rel_l2

CHANNELS = 64          # the kernel's only width, in and out
PARITY_REL_L2 = 3e-2   # the TPU lab's limit; two bf16 roundings give ~3e-3
BACK_TO_BACK = 20      # calls a timed interval holds in the second time of each variant


def conv3x3_silu_ref(x, w, fuse_silu=True):
    """Plain version: silu(x) / 0.596 in fp32 rounded to x's dtype (or x as it
    is), a 3x3 'same' convolution without bias accumulated in fp32, the result
    rounded to x's dtype; channels_last like the input."""
    h = (F.silu(x.float()) / 0.596).to(x.dtype) if fuse_silu else x
    y = F.conv2d(h.float(), w.float(), padding=1).to(x.dtype)
    return y.contiguous(memory_format=torch.channels_last)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv3x3_silu(x, w, fuse_silu=True):
    """conv3x3_same(silu(x) / 0.596) (`fuse_silu`) or the convolution alone.
    x [B, 64, H, W] in channels_last memory (NHWC), w [64, 64, 3, 3] (OIHW) ->
    [B, 64, H, W] channels_last. On the card: bf16, any H and W. A CPU tensor
    takes the plain version."""
    if x.dim() != 4 or x.shape[1] != CHANNELS or tuple(w.shape) != (CHANNELS, CHANNELS, 3, 3):
        raise ValueError(f"x must be [B, {CHANNELS}, H, W] and w [{CHANNELS}, {CHANNELS}, 3, 3], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv3x3_silu_ref(x, w, fuse_silu)
    for t, name in ((x, "x"), (w, "w")):
        if not t.is_cuda or t.device != x.device or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bf16 on {x.device}, got {t.dtype} on {t.device}")
    if not x.is_contiguous(memory_format=torch.channels_last) or x.data_ptr() % 16:
        raise ValueError("x must be contiguous in channels_last memory and 16-byte aligned")
    w = w.contiguous()                             # OIHW: the kernel lays out its taps itself
    if w.data_ptr() % 16:
        raise ValueError("w must be 16-byte aligned")
    b, _, h, wd = x.shape
    y = torch.empty_like(x)                        # channels_last too
    blocks = _sm_count(x.device.index)   # persistent: one block per SM
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.vivid_conv3x3_silu_fwd(flash._ptr(x), flash._ptr(w), flash._ptr(y),
                                        b, h, wd, int(fuse_silu), blocks,
                                        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"conv3x3_silu kernel launch failed: CUDA error {rc}")
    flash.launched("conv3x3_silu", 2 * b * h * wd * 9 * CHANNELS * CHANNELS)
    return y


# What the kernel was built with, in the order its C info entry fills them.
_INFO_KEYS = ("regs_at_launch", "local_bytes", "smem_bytes", "tile_rows", "tile_pixels",
              "stages", "consumer_regs", "producer_regs", "threads")


def conv3x3_silu_info(fuse_silu=True):
    """What the kernel with (`fuse_silu`) or without the SiLU was built with,
    from the loaded library, so only where there is a card: dict(regs_at_launch,
    local_bytes (spills), smem_bytes (dynamic shared memory), tile_rows and
    tile_pixels (the output tile a block takes at a time), stages (of the
    input ring), consumer_regs and producer_regs (a thread's registers after
    the warpgroups have traded them), threads)."""
    if not torch.cuda.is_available():
        raise RuntimeError("conv3x3_silu_info reads the built kernel: it needs a CUDA card")
    info = (ctypes.c_int * len(_INFO_KEYS))()
    rc = build.library().vivid_conv3x3_silu_info(int(fuse_silu),
                                                 ctypes.cast(info, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"conv3x3_silu_info failed: CUDA error {rc}")
    return dict(zip(_INFO_KEYS, info))


def main(argv=None):
    """Parity of both forms, then (on the card) the four times. Returns the
    printed results as a list of dicts."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--device", default=None, help="cpu: the parity checks alone")
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print("device:", torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
          flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    b, res, c = args.batch, args.res, CHANNELS
    x = torch.randn(b, res, res, c, generator=gen, device=device).to(dtype).permute(0, 3, 1, 2)
    w = (torch.randn(c, c, 3, 3, generator=gen, device=device) / (9 * c) ** 0.5).to(dtype)

    results = []
    for fuse, name in ((True, "silu+conv"), (False, "conv-only")):
        err = rel_l2(conv3x3_silu(x, w, fuse), conv3x3_silu_ref(x.float(), w.float(), fuse))
        print(f"parity {name} rel L2: {err:.2e}", flush=True)
        if not err <= PARITY_REL_L2:
            raise AssertionError(f"parity {name}: rel L2 {err} > {PARITY_REL_L2}")
        results.append(dict(check="parity", variant=name, rel_l2=err))
    if device.type == "cpu":
        return results

    flops = 2 * b * res * res * 9 * c * c
    for name, fn in (
            ("cudnn", lambda: F.conv2d(x, w, padding=1)),
            ("cudnn-silu", lambda: F.conv2d(F.silu(x) / 0.596, w, padding=1)),
            ("kernel", lambda: conv3x3_silu(x, w, True)),
            ("kernel-nosilu", lambda: conv3x3_silu(x, w, False))):
        ms, ms_b2b = cuda_ms(fn), cuda_ms(fn, calls=BACK_TO_BACK)
        print(f"{name:13s}: {ms:7.4f} ms  {flops / ms / 1e9:6.1f} TFLOP/s; {BACK_TO_BACK} calls "
              f"back to back {ms_b2b:7.4f} ms a call  {flops / ms_b2b / 1e9:6.1f} TFLOP/s",
              flush=True)
        results.append(dict(check="time", variant=name, ms=ms, tflops=flops / ms / 1e9,
                            ms_back_to_back=ms_b2b))
    return results


if __name__ == "__main__":
    main()
