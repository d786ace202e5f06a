"""Big-S attention lab: the 256px model's denoiser attends at S = 16384
(H = 4) and S = 4096 (H = 6) with 32 channels a head, its encoder at the
same lengths with 64 (H = 2 and 3).

Counterpart of tools/bigs_attn_lab.py. The default mode times the dispatch
the model uses, `fused_attention` (the no-max kernel from S = 4096 on, the
flash attention kernel with a running max below), against the plain einsum
composite `reference_attention` at the model's shapes, plus the 64px
model's cross-attention shape for scale. `--sweep` times the forwards
against each other at the SR model's four big shapes (its denoiser's
cross-attention and its encoder's self-attention at 128x128 and 64x64):
the no-max kernel `flash.flash_nomax`, and the two with a running max,
`flash.flash_attention` (it also writes the row statistics) and
`flash.flash_fused` on normalised rows (`norm_eps=None`) and on raw ones
(`norm_eps=1e-4`, its norm pre-pass included). The TPU lab swept block
sizes, which these kernels do not have. Parity comes first: the dispatch is
held against the composite at one shape of each kernel, and a disagreement
raises.

    python -m vivid_tpu_torch.tools.bigs_attn_lab [--batch 8] [--cases sr128,sr64,base32] [--sweep]
"""

import argparse

import torch

from vivid_tpu_torch.kernels import flash
from vivid_tpu_torch.kernels.attention import fused_attention, reference_attention
from vivid_tpu_torch.tools import cuda_ms, tool_device, normalize_rows, rel_l2

PARITY_REL_L2 = 1e-2   # a bf16 output against the fp32-softmax composite gives ~3e-3
PARITY_SHAPES = [(1, 2, 512, 1024, 32), (1, 1, 4096, 2048, 32)]   # B, H, Sq, Sk, D
SHAPES = {             # name -> (label, Sq, Sk, H, D); the SR model's KV is self + 1 source
    "sr128": ("SR 128x128 xattn", 16384, 32768, 4, 32),
    "sr64": ("SR 64x64 xattn", 4096, 8192, 6, 32),
    "sr32": ("SR 32x32 xattn", 1024, 2048, 8, 32),
    "enc128": ("SR encoder 128x128 self", 16384, 16384, 2, 64),   # the encoder: 64 a head
    "enc64": ("SR encoder 64x64 self", 4096, 4096, 3, 64),
    "base32": ("base 32x32 xattn (d=64, for scale)", 1024, 3072, 2, 64),
}
EINSUM_MAX_LOGITS = 4096 * 8192   # per (b, h): above this the composite's logits do not fit


def _raw(b, h, sq, sk, d, device, gen):
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    return tuple(torch.randn(b, h, s, d, generator=gen, device=device).to(dtype)
                 for s in (sq, sk, sk))


def main(argv=None):
    """Parity, then (on the card) the times. Returns the printed results as
    a list of dicts."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--cases", default="sr128,sr64,base32")
    ap.add_argument("--sweep", action="store_true",
                    help="flash_nomax, flash_attention and flash_fused at the SR model's four shapes")
    ap.add_argument("--device", default=None, help="cpu: the parity checks alone")
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    print("device:", torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
          flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    b = args.batch

    results = []
    for shape in PARITY_SHAPES:
        q, k, v = _raw(*shape, device, gen)
        q, k = normalize_rows(q), normalize_rows(k)
        rel = rel_l2(fused_attention(q, k, v), reference_attention(q, k, v))
        print(f"parity fused_attention {list(shape)}: rel L2 {rel:.3e}", flush=True)
        if not rel <= PARITY_REL_L2:
            raise AssertionError(f"parity at {shape}: rel L2 {rel} > {PARITY_REL_L2}")
        results.append(dict(check="parity", shape=shape, rel_l2=rel))
    if device.type == "cpu":
        return results

    for case in ("sr128", "sr64", "enc128", "enc64") if args.sweep else args.cases.split(","):
        label, sq, sk, h, d = SHAPES[case]
        q, k, v = _raw(b, h, sq, sk, d, device, gen)
        qn, kn = normalize_rows(q), normalize_rows(k)
        if args.sweep:
            fns = {"flash_nomax": lambda: flash.flash_nomax(qn, kn, v),
                   "flash_attention": lambda: flash.flash_attention(qn, kn, v),
                   "flash_fused(normalised)": lambda: flash.flash_fused(qn, kn, v),
                   "flash_fused(raw rows)": lambda: flash.flash_fused(q, k, v, norm_eps=1e-4)}
        else:
            fns = {"fused_attention": lambda: fused_attention(qn, kn, v)}
            if sq * sk <= EINSUM_MAX_LOGITS:
                fns["einsum"] = lambda: reference_attention(qn, kn, v)
            else:
                print(f"{label} einsum: skipped (fp32 logits of "
                      f"{b * h * sq * sk * 4 / 2 ** 30:.0f} GiB)", flush=True)
        flops = 4 * b * h * sq * sk * d
        for name, fn in fns.items():
            ms = cuda_ms(fn, reps=5)
            print(f"{label} [{b},{h},{sq},{sk},{d}] {name}: {ms:8.3f} ms  "
                  f"{flops / ms / 1e9:6.1f} TFLOP/s", flush=True)
            results.append(dict(check="time", case=case, variant=name, ms=ms,
                                tflops=flops / ms / 1e9))
    return results


if __name__ == "__main__":
    main()
