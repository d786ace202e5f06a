"""No-max attention lab for the big-S shapes of the 256px model.

Counterpart of tools/nomax_attn_lab.py. The model pixel-normalises q and k
before attention, so every scaled logit lies below sqrt(D) and softmax needs
no running max: exp(s - sqrt(D)) <= 1 cannot overflow. The lab times the
ways to spend what that saves, each a variant of one CUDA kernel
(csrc/flash_nomax_lab.cu: compile-time switches of K6's wgmma + TMA body in
csrc/flash_fwd.cuh), against the forward with a running max:

  v0  `flash.flash_fused` on the normalised rows (online max)
  v1  no max, fp32 row sums
  v2  v1 with the row sums folded into the P V product (`fold_l`)
  v3  v2 with two independent chains over halves of a key tile
  v4  v2 with four chains
  v5  v1 with two chains
  v6  v5 with the softmax scale folded into q (`prescale`)

and beside them K6 itself, `flash.flash_nomax` (csrc/flash_nomax.cu: the
same body with every switch at its default and no shift), the kernel the
model runs.

(The TPU lab's v3b and v7 differ from v3 and v6 by block sizes only, which
this kernel does not have.) Every variant is first held against
`reference_attention` at a small shape; a variant that disagrees raises.

    python -m vivid_tpu_torch.tools.nomax_attn_lab [--batch 8] [--cases sr128,sr64]
"""

import argparse
import ctypes

import torch

from vivid_tpu_torch.kernels import build, flash
from vivid_tpu_torch.kernels.attention import reference_attention
from vivid_tpu_torch.tools import cuda_ms, lab_device, normalize_rows, rel_l2

PARITY_REL_L2 = 1e-2   # a bf16 output against the fp32-softmax composite gives ~3e-3
VARIANTS = {           # name -> (fold_l, chains, prescale)
    "v1 nomax": (False, 1, False),
    "v2 fold_l": (True, 1, False),
    "v3 fold_l chains2": (True, 2, False),
    "v4 fold_l chains4": (True, 4, False),
    "v5 chains2": (False, 2, False),
    "v6 chains2 prescale": (False, 2, True),
}
SHAPES = {             # name -> (label, Sq, Sk, H, D)
    "sr128": ("SR 128x128 xattn", 16384, 32768, 4, 32),
    "sr64": ("SR 64x64 xattn", 4096, 8192, 6, 32),
    "sr128d64": ("SR 128x128 d64 xattn", 16384, 32768, 2, 64),
}
PARITY_SHAPE = (2, 2, 1024, 2048, 32)   # B, H, Sq, Sk, D


def nomax_attention_ref(q, k, v, fold_l=False, chains=1, prescale=False):
    """Plain version of the lab kernel, its arithmetic step for step: the
    shift is sqrt(D); with `prescale` q / sqrt(D) is rounded to q's dtype and
    p = exp(q k^T - shift), else p = exp(q k^T / sqrt(D) - shift); p is
    rounded to v's dtype for the second product; the denominator is the fp32
    sum of the rounded p with `fold_l` (the product sums it), of the
    unrounded p without. `chains` only reorders the sums. Walks the query
    rows in chunks of at most flash.REF_CHUNK_ELEMS logits."""
    b, h, sq, d = q.shape
    scale, shift = 1.0 / d ** 0.5, d ** 0.5
    q32 = (q.float() * scale).to(q.dtype).float() if prescale else q.float()
    k32, v32 = k.float(), v.float()
    outs = []
    for cut in flash._ref_chunks(b, h, sq, k.shape[2]):
        s = torch.einsum("bhqd,bhkd->bhqk", q32[:, :, cut], k32)
        p = torch.exp(s - shift) if prescale else torch.exp(s * scale - shift)
        pb = p.to(v.dtype).float()
        den = (pb if fold_l else p).sum(-1, keepdim=True)
        outs.append((torch.einsum("bhqk,bhkd->bhqd", pb, v32) / den).to(v.dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 2)


def nomax_attention(q, k, v, fold_l=False, chains=1, prescale=False):
    """The lab kernel: q [B, H, Sq, D] with pixel-normalised rows (the
    caller's contract, as for `flash.flash_nomax`), k, v [B, H, Sk, D] ->
    [B, H, Sq, D]; bf16 on the card, D 32 or 64, chains 1, 2 or 4. A CPU
    tensor takes the plain version."""
    if chains not in (1, 2, 4):
        raise ValueError(f"chains must be 1, 2 or 4, got {chains}")
    if q.device.type == "cpu":
        return nomax_attention_ref(q, k, v, fold_l, chains, prescale)
    b, h, sq, sk, d = flash._checked_bhsd(q, k, v, None)
    out = torch.empty_like(q)
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vivid_flash_nomax_lab_fwd(
            flash._ptr(q), flash._ptr(k), flash._ptr(v), flash._ptr(out), b, h, sq, sk, d,
            int(fold_l), chains, int(prescale), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"flash_nomax_lab kernel launch failed: CUDA error {rc}")
    flash.launches["nomax_lab_attention"] += 1
    return out


def nomax_attention_info(d: int, fold_l=False, chains=1, prescale=False):
    """What the lab kernel's instance for (d, fold_l, chains, prescale) was
    built with, from the loaded library, so only where there is a card: the
    keys of `flash.flash_nomax_info`."""
    if d not in (32, 64) or chains not in (1, 2, 4):
        raise ValueError(f"d must be 32 or 64 and chains 1, 2 or 4, got {d}, {chains}")
    if not torch.cuda.is_available():
        raise RuntimeError("nomax_attention_info reads the built kernel: it needs a CUDA card")
    info = (ctypes.c_int * len(flash._INFO_KEYS))()
    rc = build.library().vivid_flash_nomax_lab_info(d, int(fold_l), chains, int(prescale),
                                                     ctypes.cast(info, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"flash_nomax_lab_info failed: CUDA error {rc}")
    return dict(zip(flash._INFO_KEYS, info))


def nomax_attention_plan(b: int, h: int, sq: int, sms: int = 132):
    """The lab kernel's grid, K6's: a block for each 192 query rows (three
    consumer warpgroups of 64) of each (b, h), one block an SM (its 512
    threads take all 65,536 registers), on `sms` streaming multiprocessors.
    -> dict(grid (x, y, z), blocks, waves)."""
    grid = (-(-sq // 192), h, b)
    blocks = grid[0] * h * b
    return dict(grid=grid, blocks=blocks, waves=round(blocks / sms, 3))


def _inputs(b, h, sq, sk, d, device, gen):
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=device).to(dtype)
               for s in (sq, sk, sk))
    return normalize_rows(q), normalize_rows(k), v


def main(argv=None):
    """Parity of every variant, then (on the card) its time at each case.
    Returns the printed results as a list of dicts."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--cases", default="sr128,sr64")
    ap.add_argument("--parity-only", action="store_true")
    ap.add_argument("--device", default=None, help="cpu: the parity checks alone")
    args = ap.parse_args(argv)
    device = lab_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    print("device:", torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
          flush=True)

    results = []
    q, k, v = _inputs(*PARITY_SHAPE, device, gen)
    ref = reference_attention(q, k, v)
    for name, (fold_l, chains, prescale) in VARIANTS.items():
        out = nomax_attention(q, k, v, fold_l, chains, prescale)
        err = (out.float() - ref.float()).abs().max().item()
        rel = rel_l2(out, ref)
        print(f"parity {name}: max abs {err:.3e} rel L2 {rel:.3e}", flush=True)
        if not rel <= PARITY_REL_L2:
            raise AssertionError(f"parity {name}: rel L2 {rel} > {PARITY_REL_L2}")
        results.append(dict(check="parity", variant=name, max_abs=err, rel_l2=rel))
    if args.parity_only or device.type == "cpu":
        return results

    for case in args.cases.split(","):
        label, sq, sk, h, d = SHAPES[case]
        q, k, v = _inputs(args.batch, h, sq, sk, d, device, gen)
        flops = 4 * args.batch * h * sq * sk * d
        fns = {"v0 flash_fused": lambda: flash.flash_fused(q, k, v),
               "K6 flash_nomax": lambda: flash.flash_nomax(q, k, v)}
        fns.update({name: (lambda t=t: nomax_attention(q, k, v, *t))
                    for name, t in VARIANTS.items()})
        for name, fn in fns.items():
            ms = cuda_ms(fn)
            print(f"{label} [{args.batch},{h},{sq},{sk},{d}] {name}: {ms:8.3f} ms  "
                  f"{flops / ms / 1e9:6.1f} TFLOP/s", flush=True)
            results.append(dict(check="time", case=case, variant=name, ms=ms,
                                tflops=flops / ms / 1e9))
    return results


if __name__ == "__main__":
    main()
