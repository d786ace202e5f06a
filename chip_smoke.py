#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

It runs every phase, in this order, each printing its results on lines of
its own:
  device   the card's name and power limit; TF32 off for the fp32 references
  build    compiles csrc/ with nvcc (route: shared library + ctypes); every
           kernel on the tensor cores (the big-S attention kernels K8's
           three, K6 and K5, the packed attention forward K1/K2 and
           backward's two K3/K4, the no-max packed forward K7, the fused
           SiLU + 3x3 convolution K9 and the no-max lab's K10) must hold
           wgmma and TMA instructions and no mma.sync
  kernels  each of the CUDA kernels (packed attention and cross attention,
           forward and backward; the big-S no-max attention of the 256px
           model; the big-S flash attention forward with row statistics and
           its backward; the [B, H, S, D] forward with the norm and the sink,
           and its norm pre-pass alone; the no-max packed forward; the fused
           SiLU + 3x3 convolution; the lab variants of the no-max attention)
           against its plain PyTorch version at every shape the paths give
           it, with times (CUDA events); a kernel run twice must give the same
           bits; two faults of a TMA ring, planted in the inputs, must fail
           the gates (K8, K6, K5, K1, K2, K3, K4, K7; K2 and K7 also with a
           source's padding rows unmasked), and so must three faults of K9 (the image
           boundary lost, the taps transposed, the SiLU applied twice)
  model    full-width vivid-base / vivid-uncond / vivid-sr from a seed:
           parameter counts, and one NVPrecond call through the kernels vs
           the plain versions, held against a one-ulp noise control; planted
           faults (a cross source skipped, the zero sink dropped, the cross
           keys of the no-max attention skipped) must fail it; then the three
           models again with VIVID_NOMAX_PACKED=1 (the no-max packed forward
           in place of the packed ones), faults planted in that kernel
  slice    snapshots -> synthetic scenes -> generate_images_nvs (guided,
           32 Heun steps, 8 seeds): PNGs, finite images, kernel launch
           counts; then the same through the base -> SR cascade (256px PNGs,
           launch counts per SR evaluation), and the SR model alone; the
           64px run warm, then it and a short cascade again with
           VIVID_NOMAX_PACKED=1 (no warm cascade: a cut to the smoke's time)
  metrics  a synthetic RealEstate10K tree (640x360 PNG frames): the reader's
           rows/s with one thread and with the default count (windows of
           48 rows, 96 before: a cut for time), which must
           give the same batches; the full-width InceptionV3 (bf16) and ViT-L/14 (bf16
           autocast) against themselves in fp32, with three planted faults
           (half-pixel resize, average pools counting padding, the position
           grid not interpolated) that must fail the gate; `calculate_metrics
           gen` (five metrics, 16 guided images of vivid-base + vivid-uncond,
           K1/K2 launches against the plan) and `calc` of its PNGs against
           its own statistics; a `--metrics` tick of a 3-step vivid-base run
           (metrics.jsonl, stats.jsonl, log.txt); random detector weights
  compat   the slice phase's vivid-base and vivid-uncond exported to
           reference-format fp16 pickles through a stand-in reference
           checkout and to v1 snapshots, loaded back on the card (load
           times; the same config fields and weights), and 8 guided images
           from each pair, which must be bitwise equal (K1/K2 launches)
  depth    DepthAnythingV2 small and large from random original-naming
           checkpoints: the card's fp32 forward against the CPU's, with two
           planted faults (the head's resizes off align_corners, the input
           resize without antialiasing) that must fail the gate, and ms per
           16 views at 518 px; full-width vivid-base with depth_input and
           with warp_depth_coor through the model phase's gate; 8 guided
           images with depth from 'small' (K1/K2 launches); 2 training steps
           of each depth flag through the trainer's entry point (K3/K4
           launches)
  train    full-width vivid-base, batch 8 (the preset's global batch is
           1024; only the batch is cut): the whole gradient of one loss
           through the kernels vs the plain versions, held against a one-ulp
           noise control, with planted faults (one source's dfeats zeroed,
           the norm VJP's projection skipped) that must fail it; the
           recompute modes false, true and save_dots, each held to the
           plan's launches (save_dots: the forward attention kernels once a
           block) and to the gate, with the bytes held after the forward,
           the peak, event ms and device busy ms of a loss and its
           backward; then 4
           steps of vivid-base and 2 of vivid-uncond through the trainer's
           entry point (launch counts, ms per step, peak memory), and the
           snapshots it wrote sampled by generate_images_nvs. Then the same
           for full-width vivid-sr at 256px, batch 8 (the preset's global
           batch is 128; only the batch is cut): the whole gradient of one
           SRNVLoss with a planted fault (dk of the cross keys zeroed), the
           recompute modes as above (K6 8 launches under save_dots, 14
           under true), 3 steps of the vivid-sr preset through the
           trainer's entry point with the preset's recompute and 3 without,
           and the snapshot sampled as the SR model alone
  shell    in a process of its own, with cuBLAS's deterministic workspace:
           the trainer shell at full width (vivid-base, batch 8 of 1024),
           deterministic, through the trainer's entry point: 4 steps
           straight with checkpoints, snapshots and a sample grid through
           the vivid-sr snapshot of the train phase (K1/K2 and K6 launches
           per evaluation against the plan); the same as a 2-step slice and
           a resume, which must end with the straight run's bits (params,
           both Adam moments, both EMAs), and two planted faults in the
           resume (the loader not fast-forwarded, adam_v zeroed) that must
           break that; a suspend at a status tick that must checkpoint the
           96-nimg state; the post-hoc EMA at std 0.075, evaluated through
           the kernels; ms per step with and without the deterministic
           mode, the checkpoint's size and its copy and write seconds
  labs     the [B, H, S, D] entries (attention_from_raw and fused_attention,
           outputs and gradients against the plain composite) and the three
           kernel labs of vivid_tpu_torch/tools, each at one timing case; a
           failed parity check raises
  entry    the four root wrappers (--help each, and a dry run of
           train_nvs_torch.py with --debug-nans, each a process of its own);
           examples/quickstart_torch.py at its defaults (K1-K4 launches);
           --debug-nans at full width (vivid-base, batch 8) through the
           trainer's entry point: a NaN planted in one conv weight must raise
           FloatingPointError naming that module, a clean run must pass; ms
           per step with and without the flag
  overfit  the convergence proof (vivid_tpu_torch/tools/overfit_smoke.py) at
           its widths for OVERFIT_STEPS of its 2000 steps: both gates must
           pass, the loss gate the corrected one; in a process of its own,
           run beside the dist phase (its lines printed after dist's)
  trace    one guided 64px evaluation in a span under core/trace.py's
           trace: the trace file must hold the span's range, the hot path's
           ranges (sampler.step, sampler.eval:net, sampler.eval:guide,
           net.encoder, net.denoiser) and K1/K2's kernels; the host's cost of
           one span outside a trace and inside it, and the spans' cost a
           guided evaluation; flops_analysis of one
           full-width vivid-base step (batch 8) through the kernels and
           through the plain versions must give the same count
  profile  torch.profiler over 3 guided evaluations, over 3 SR evaluations,
           over 2 training steps at 64px and over 2 at 256px: device busy
           time, device operations, idle share, time by kind, the top kernels
  mem      tools/mem_report of full-width vivid-sr at batch 8 under remat
           true, save_dots at area 4096, at the default, with every conv
           kept, and false: the bytes held after the forward pass must rise
           strictly, the peak must not fall; vivid-base at batch 8 beside the
           train phase's peak; tools/guided_mem at ch 128, batches 32 and 64
  dist     torch.distributed on the one card, each job in spawned processes
           of its own: NCCL at world size 1 (all_reduce_sum and the stats
           collector on the card, a host tensor refused; full-width
           vivid-base, batch 8, 2 deterministic steps through the trainer's
           entry point with --fsdp against the same without, bit for bit or
           within the CPU tests' hold, and a --fsdp checkpoint resumed
           without it); NCCL's answer to two ranks on one card; two ranks
           on the card over gloo with CUDA tensors (NCCL, had it taken
           them): the data-parallel gradient of 2 x 4 rows against one rank
           at 8 under the train phase's gate, with a planted per-rank clamp
           (an outlier row on rank 1) that must fail it, 2 steps against one
           rank, the consistency check and a one-ulp nudge it must catch;
           tp 2 against tp 1 for one NVPrecond call of vivid-base,
           vivid-uncond and vivid-sr (batch 4) under the model phase's gate
           with a control of one ulp on every product and attention output,
           and a planted self-normalised slice that must fail it; guided
           sampling at tp 2 (8 seeds, 2 Heun steps) bitwise equal on both
           ranks, K1/K2 at 34 / 17 an evaluation, within the gate of tp 1;
           seed sharding (8 seeds over 2 ranks, each PNG written once). Its
           times are no speed: two ranks share one card and gloo stages
           every collective through the host

A line `[time] phase=... seconds=...` follows each phase. Any failed check
raises, so the script exits non-zero. Without a CUDA card
it exits non-zero before printing any result. The line before the last is
the kernel table as JSON; the last is {"ok": true, "device": {...}}.
"""

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

TOL_KERNEL = 2e-2      # max |kernel - fp32 plain| on bf16 inputs (forward kernels)
TOL_KERNEL_L2 = 1e-2   # ... and relative to the output, which at a long key axis is a
TOL_KERNEL_MAX = 1e-1  # near-uniform average far below 1: relative L2, and max error
                       # over the plain output's RMS. A bf16 output alone gives about
                       # 3e-3 and 2e-2 to 6e-2; an eighth of the keys dropped, above 0.3
TOL_GRAD_L2 = 2e-2     # relative L2 of a backward kernel's gradient vs the fp32 plain version
TOL_GRAD_MAX = 5e-2    # ... and, over every D-vector of it (every row of a dbias),
                       # max ||err|| / (||reference vector|| + RMS * sqrt(len)): the
                       # norm's VJP scales a whole vector by 1 / its input's norm, so
                       # an error is held to its own vector as well as to the whole
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, for the bounds
BF16_FLOPS = 989e12         # dense bf16 tensor-core peak, same sheet
EXPS_PER_S = 3.9e12         # 16 ex2 a clock and SM (NVIDIA's CUDA C++ programming manual,
                            # table of arithmetic throughput, compute capability 9.0) x
                            # 132 SMs x 1.83 GHz: an attention kernel pays one a logit
TOL_MODEL = 1e-2       # relative L2 of D_x, kernels vs plain (emb gains at 0)
TOL_CONTROL = 1.2      # ... and at most this multiple of the ulp-noise control
TOL_GRAD_CONTROL = 1.2 # whole-model gradient, kernels vs plain: at most this multiple
                       # of the control's relative L2 (one ulp on every attention
                       # output and every attention gradient)
SHAPES = [(1024, 4, 64), (256, 6, 64), (64, 8, 64)]   # (S, H, d) on the path
EXTRA_SHAPES = [(100, 4, 64), (256, 8, 32)]           # ragged, d = 32
SR_XATTN_SHAPE = (1024, 8, 32)   # K2 in the 256px denoiser at 32x32, one source of 1024
# The no-max kernel on the 256px model's path, (Sq, Sk, H, d), at 128x128 and
# 64x64: the denoiser's cross-attention with one source (Sk = 2 Sq; kind
# 'sr' has 32 channels a head) and the encoder's self-attention (Sk = Sq; the
# encoder keeps the config's 64 channels a head, so half the heads).
NOMAX_SHAPES = [(16384, 32768, 4, 32), (16384, 16384, 2, 64),
                (4096, 8192, 6, 32), (4096, 4096, 3, 64)]
# The attention shapes tensor parallelism gives the kernels (`_tp_cases`):
# (S, local heads, d, cross sources) of K1/K2, (Sq, Sk, local heads, d) of K6.
TP_PACKED_SHAPES = [(1024, 1, 64, 2), (1024, 2, 64, 2), (1024, 3, 64, 2), (256, 3, 64, 2),
                    (64, 2, 64, 2), (1024, 4, 32, 1)]
TP_NOMAX_SHAPES = [(16384, 32768, 2, 32), (16384, 16384, 1, 64), (4096, 8192, 3, 32)]
SR_PER_EVAL = {"flash_nomax": 8, "flash_fused_packed": 3, "flash_fused_packed_xattn": 3}
SR_PER_EVAL_NOMAX = {"flash_nomax": 8, "flash_nomax_packed": 6}   # VIVID_NOMAX_PACKED=1
# The blocks' fused elementwise kernels (kernels/mp_fused.py), held to their
# plain versions in `_check_mp_fused` at these [B, H, W, C]: the 256px
# model's four levels at 32 rows, then a 64px one's widest level.
MP_SHAPES = [(32, 256, 256, 64), (32, 128, 128, 128), (32, 64, 64, 192), (32, 32, 32, 256),
             (32, 8, 8, 512)]
SHELL_CUBLAS_WORKSPACE = ":4096:8"   # cuBLAS's deterministic workspace, for the shell phase
BATCH = 8
TICK_IMAGES = 25   # the metrics tick's images in the smoke (the trainer's 100, cut for time)
READER_WINDOWS = 2   # the reader's timing windows a thread count (cut for time)
READER_WINDOW_ROWS = 48   # rows a window (cut for time from 96)
SAME_FUNCTION = "the_same_function"             # what a case's library call computes
CORE_ONLY = "the_attention_core_only"
# The [B, H, S, D] forward on raw rows, (H, Sq, Sk) at d = 64: the 64px
# model's cross-attention (self + 2 sources) at its three resolutions.
FUSED_SHAPES = [(4, 1024, 3072), (6, 256, 768), (8, 64, 192)]
TOL_INCEPTION = 8e-3   # relative L2 of the 2048-d features, bf16 channels-last vs fp32
TOL_VIT = 3e-2         # ... of the ViT-L/14's class tokens, bf16 autocast vs fp32
TOL_DEPTH = 1e-4       # relative L2 of a DepthAnythingV2 depth map, fp32 on the card vs the CPU


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _mp_per_eval(*cfgs):
    """Launches of the blocks' fused elementwise kernels in one evaluation,
    autograd off, of each NVPrecond config (its denoiser and its encoder):
    a norm an encoder block, a concatenation a decoder block after a skip, a
    scale a block, a sum a block and one more a block that attends."""
    from vivid_tpu_torch.nn.unet import build_plan
    out = {}
    for cfg in cfgs:
        for ucfg in (cfg.unet_cfg, cfg.encoder_cfg):
            enc, dec = build_plan(ucfg) if ucfg is not None else ((), ())
            for e in [e for e in (*enc, *dec) if e.block is not None]:
                for name, n in (("mp_norm_silu", e.block.flavor == "enc"),
                                ("mp_cat_silu", e.name.startswith("dec/") and "_block" in e.name),
                                ("mp_scale_silu", 1),
                                ("mp_sum_clip", 1 + (e.block.num_heads > 0))):
                    if n:
                        out[name] = out.get(name, 0) + int(n)
    return out


def _cat_widths(ucfg):
    """(resolution, Ca, Cb) of each concatenation before a decoder block of
    the U-Net `ucfg`: the running activation's channels and the skip's."""
    from vivid_tpu_torch.nn.unet import build_plan
    enc, dec = build_plan(ucfg)
    out, prev = [], enc[-1].out_channels
    for e in dec:
        if "_block" in e.name:
            out.append((e.res, prev, e.in_channels - prev))
        prev = e.out_channels
    return out


def _sr_per_eval(nomax=False):
    """Kernel launches of one full-width vivid-sr evaluation, autograd off."""
    return {**(SR_PER_EVAL_NOMAX if nomax else SR_PER_EVAL), **_mp_per_eval(_sr_config())}


def say(tag, **kw):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


@contextlib.contextmanager
def nomax_packed(on=True):
    """VIVID_NOMAX_PACKED set (or cleared) in the environment for the block,
    then put back: the port reads it at every call."""
    old = os.environ.pop("VIVID_NOMAX_PACKED", None)
    if on:
        os.environ["VIVID_NOMAX_PACKED"] = "1"
    try:
        yield
    finally:
        os.environ.pop("VIVID_NOMAX_PACKED", None)
        if old is not None:
            os.environ["VIVID_NOMAX_PACKED"] = old


def cuda_ms(fn, reps=20):
    """Median of `reps` single-call times, CUDA events, after one warm-up."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    return card


def phase_build():
    from vivid_tpu_torch.kernels import build
    info = build.build()
    build.library()
    say("build", seconds=f"{info['seconds']:.2f}", cached=info["cached"],
        path=os.path.relpath(info["path"]))
    for line in info["log"].splitlines():
        if "Compiling entry function" in line:   # the mangled name carries the template arguments
            print("  ptxas:", line.split("'")[1][:150], flush=True)
        elif "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip(), flush=True)
    _check_wgmma_machine_code(build, info["path"])


# The kernels on wgmma + TMA, with their template instances in the library:
# the attention kernels (d 32, 64) x (bias, none), K7 (d 32, 64; no bias),
# K9 with and without the SiLU, K10 (d 32, 64) x fold_l x chains 1, 2, 4 x
# prescale. The packed kernels' norm pre-passes (packed_fwd_norm_kernel,
# packed_bwd_norm_kernel, nomax_packed_norm_kernel) are no wgmma kernels.
# Names match by substring.
WGMMA_KERNELS = {"flash_fwd_kernel": 4, "flash_bwd_dkv_kernel": 4, "flash_bwd_dq_kernel": 4,  # K8
                 "flash_nomax_kernel": 4,                                                   # K6
                 "flash_fused_kernel": 4,                                                   # K5
                 "packed_fwd_kernel": 4,                                                    # K1/K2
                 "packed_bwd_dq_kernel": 4, "packed_bwd_dkv_kernel": 4,                     # K3/K4
                 "nomax_packed_kernel": 2,                                                  # K7
                 "conv3x3_silu_kernel": 2,                                                  # K9
                 "flash_nomax_lab_kernel": 24}                                              # K10


def _check_wgmma_machine_code(build, lib_path):
    """The kernels on wgmma in the built library (K8's three, K6, K5, K1/K2's,
    K3/K4's two, K7, K9, K10), read with the toolkit's cuobjdump: each has
    its expected number of
    instances, and every instance multiplies on wgmma (HGMMA), gets its tiles
    by TMA (UTMALDG) and holds no mma.sync product (HMMA)."""
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    dump = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, timeout=300)
    check(dump.returncode == 0, f"cuobjdump failed: {dump.stderr[-2000:]}")
    counts, current = {}, None
    for line in dump.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kernel = next((k for k in WGMMA_KERNELS if k in name), None)
            current = counts.setdefault(name, dict(kernel=kernel, HGMMA=0, UTMALDG=0, HMMA=0)) \
                if kernel else None
        elif current is not None:
            for op in ("HGMMA", "UTMALDG", "HMMA"):
                current[op] += f" {op}." in line or f" {op} " in line
    for name, c in counts.items():
        check(c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0, f"{name}: {c}")
    for kernel, instances in WGMMA_KERNELS.items():
        mine = [c for c in counts.values() if c["kernel"] == kernel]
        check(len(mine) == instances, f"{kernel}: {len(mine)} instances, expected {instances}")
        say("build", kernel=kernel, instances=len(mine),
            wgmma_instructions=[c["HGMMA"] for c in mine],
            tma_loads=[c["UTMALDG"] for c in mine], mma_sync_instructions=0)


def _sdpa_inputs(torch, qkv, feats, h):
    """Pre-normalised [B, H, S, D] q and concatenated k, v for the library
    yardstick (the attention core only: no in-kernel norm, packed layout,
    sink or bias)."""
    from vivid_tpu_torch.kernels.flash import _rms_norm
    b, s, _ = qkv.shape
    d = qkv.shape[2] // (3 * h)
    y = qkv.view(b, s, 3, h, d)
    ks, vs = [y[:, :, 1]], [y[:, :, 2]]
    for f in feats:
        z = f.view(b, f.shape[1], 2, h, d)
        ks.append(z[:, :, 0])
        vs.append(z[:, :, 1])
    return tuple(_rms_norm(t).transpose(1, 2).contiguous()
                 for t in (y[:, :, 0], torch.cat(ks, 1), torch.cat(vs, 1)))


def _kernel_cases(torch, gen, plans=True):
    """One dict per case of K1-K4 and K7 at every shape: `kernel` and `plain32`
    (the plain version on fp32 copies) return tuples of tensors to compare,
    `plain` is the plain version as a CPU-less path would run it, `library`
    (headline cases, K2 at the SR denoiser's shape and K7 wherever it has no
    sink) the PyTorch attention call timed beside them. K7 runs on the
    inputs of every K1 case and every unbiased K2 case, and its output is
    also held to theirs (`against`).
    `plans=False` leaves out K1/K2's grids (`plan`), which a port from before
    the wgmma forward cannot give."""
    import torch.nn.functional as F
    from vivid_tpu_torch.kernels import flash
    dev = "cuda"
    cases = []

    def rows(s, parts, h, d):
        # Each d-vector scaled by exp(N(0, 1)), so the in-kernel norm matters.
        x = torch.randn(BATCH, s, parts * h, d, generator=gen, device=dev)
        x = x * torch.exp(torch.randn(BATCH, s, parts * h, 1, generator=gen, device=dev))
        return x.reshape(BATCH, s, parts * h * d).bfloat16()

    def tup(fn):
        def run():
            out = fn()
            if isinstance(out, torch.Tensor):
                return (out,)
            return (out[0], *out[1], *out[2])
        return run

    def fwd_plan(s, h):
        return {"plan": flash.packed_fwd_plan(BATCH, s, h)} if plans else {}

    for s, h, d in SHAPES + EXTRA_SHAPES:
        qkv = rows(s, 3, h, d)
        feats = [rows(s, 2, h, d) for _ in range(2)]
        bias = [torch.randn(BATCH, h, s, s, generator=gen, device=dev) for _ in range(2)]
        g = torch.randn(BATCH, s, h * d, generator=gen, device=dev).bfloat16()
        f32 = [f.float() for f in feats]
        main_shape = (s, h, d) == SHAPES[0]
        io_self = 2 * (qkv.numel() + g.numel())           # bytes of qkv and out / g
        io_x = io_self + 2 * sum(f.numel() for f in feats)
        q, k, v = _sdpa_inputs(torch, qkv, (), h)
        core_self = lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v)
        for sink in (0, 2 * s):
            head = main_shape and sink == 0
            lib = lib_bwd = None
            if head:
                lib = core_self
                lib_bwd = _sdpa_backward(torch, q, k, v, g, h)
            cases.append(dict(
                name="flash_fused_packed", d=d, label=f"S={s} H={h} d={d} sink={sink}",
                kernel=tup(lambda qkv=qkv, h=h, sink=sink: flash.flash_fused_packed(qkv, h, zero_sink=sink)),
                plain32=tup(lambda qkv=qkv, h=h, sink=sink: flash.flash_fused_packed_ref(qkv.float(), h, sink)),
                plain=lambda qkv=qkv, h=h, sink=sink: flash.flash_fused_packed_ref(qkv, h, sink),
                headline=head, library=lib, bytes=io_self,
                flops=4 * BATCH * h * s * s * d, exps=BATCH * h * s * s, **fwd_plan(s, h)))
            cases.append(dict(
                name="flash_nomax_packed", d=d, label=f"S={s} H={h} d={d} sink={sink}",
                kernel=tup(lambda qkv=qkv, h=h, sink=sink: flash.flash_nomax_packed(qkv, (), h, sink)),
                plain32=tup(lambda qkv=qkv, h=h, sink=sink: flash.flash_nomax_packed_ref(qkv.float(), (), h, sink)),
                plain=lambda qkv=qkv, h=h, sink=sink: flash.flash_nomax_packed_ref(qkv, (), h, sink),
                against=("k1", tup(lambda qkv=qkv, h=h, sink=sink: flash.flash_fused_packed(qkv, h, zero_sink=sink))),
                headline=False, library=None if sink else core_self, library_is=CORE_ONLY,
                bytes=io_self,
                flops=4 * BATCH * h * s * s * d, exps=BATCH * h * s * s, **fwd_plan(s, h)))
            cases.append(dict(
                name="flash_fused_packed_bwd", d=d, label=f"S={s} H={h} d={d} sink={sink}",
                kernel=tup(lambda qkv=qkv, g=g, h=h, sink=sink: flash.flash_fused_packed_bwd(qkv, g, h, sink)),
                plain32=tup(lambda qkv=qkv, g=g, h=h, sink=sink: flash.flash_fused_packed_bwd_ref(qkv.float(), g.float(), h, sink)),
                plain=lambda qkv=qkv, g=g, h=h, sink=sink: flash.flash_fused_packed_bwd_ref(qkv, g, h, sink),
                headline=head, library=lib_bwd, bytes=io_self + 2 * qkv.numel(),
                flops=10 * BATCH * h * s * s * d, exps=BATCH * h * s * s,
                plan=flash.packed_bwd_plan(BATCH, s, h)))
        q, k, v = _sdpa_inputs(torch, qkv, feats, h)
        core_x = lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v)
        for biased in (False, True):
            bs = bias if biased else ()
            head = main_shape and not biased
            lib = lib_bwd = None
            if head:
                lib = core_x
                lib_bwd = _sdpa_backward(torch, q, k, v, g, h)
            io_b = 4 * sum(x.numel() for x in bs)
            cases.append(dict(
                name="flash_fused_packed_xattn", d=d, label=f"S={s} H={h} d={d} n_src=2 bias={biased}",
                kernel=tup(lambda qkv=qkv, h=h, bs=bs, feats=feats: flash.flash_fused_packed_xattn(qkv, feats, h, biases=bs)),
                plain32=tup(lambda qkv=qkv, h=h, bs=bs, f32=f32: flash.flash_fused_packed_xattn_ref(qkv.float(), f32, h, bs)),
                plain=lambda qkv=qkv, h=h, bs=bs, feats=feats: flash.flash_fused_packed_xattn_ref(qkv, feats, h, bs),
                headline=head, library=lib, bytes=io_x + io_b,
                flops=4 * BATCH * h * s * 3 * s * d, exps=BATCH * h * s * 3 * s, **fwd_plan(s, h)))
            if not biased:   # the table's row of K7: the 64px model's cross-attention
                cases.append(dict(
                    name="flash_nomax_packed", d=d, label=f"S={s} H={h} d={d} n_src=2",
                    kernel=tup(lambda qkv=qkv, h=h, feats=feats: flash.flash_nomax_packed(qkv, feats, h)),
                    plain32=tup(lambda qkv=qkv, h=h, f32=f32: flash.flash_nomax_packed_ref(qkv.float(), f32, h)),
                    plain=lambda qkv=qkv, h=h, feats=feats: flash.flash_nomax_packed_ref(qkv, feats, h),
                    against=("k2", tup(lambda qkv=qkv, h=h, feats=feats: flash.flash_fused_packed_xattn(qkv, feats, h))),
                    headline=head, library=core_x, library_is=CORE_ONLY, bytes=io_x,
                    flops=4 * BATCH * h * s * 3 * s * d, exps=BATCH * h * s * 3 * s,
                    **fwd_plan(s, h)))
            cases.append(dict(
                name="flash_fused_packed_xattn_bwd", d=d, label=f"S={s} H={h} d={d} n_src=2 bias={biased}",
                kernel=tup(lambda qkv=qkv, g=g, h=h, bs=bs, feats=feats: flash.flash_fused_packed_xattn_bwd(qkv, feats, g, h, bs)),
                plain32=tup(lambda qkv=qkv, g=g, h=h, bs=bs, f32=f32: flash.flash_fused_packed_xattn_bwd_ref(qkv.float(), f32, g.float(), h, bs)),
                plain=lambda qkv=qkv, g=g, h=h, bs=bs, feats=feats: flash.flash_fused_packed_xattn_bwd_ref(qkv, feats, g, h, bs),
                headline=head, library=lib_bwd,
                bytes=io_x + 2 * (qkv.numel() + sum(f.numel() for f in feats)) + 2 * io_b,
                flops=10 * BATCH * h * s * 3 * s * d, exps=BATCH * h * s * 3 * s,
                plan=flash.packed_bwd_plan(BATCH, s, h, (s, s))))
    # K2 at the SR denoiser's shape (32x32 tokens, 32 channels a head: 8 heads
    # of its 256 channels, one source of the encoder's 1024 features), timed
    # beside SDPA's core.
    s, h, d = SR_XATTN_SHAPE
    qkv, feats = rows(s, 3, h, d), [rows(s, 2, h, d)]
    f32 = [feats[0].float()]
    q, k, v = _sdpa_inputs(torch, qkv, feats, h)
    cases.append(dict(
        name="flash_fused_packed_xattn", d=d, label=f"S={s} H={h} d={d} n_src=1 bias=False sr_denoiser",
        kernel=tup(lambda qkv=qkv, feats=feats, h=h: flash.flash_fused_packed_xattn(qkv, feats, h)),
        plain32=tup(lambda qkv=qkv, f32=f32, h=h: flash.flash_fused_packed_xattn_ref(qkv.float(), f32, h)),
        plain=lambda qkv=qkv, feats=feats, h=h: flash.flash_fused_packed_xattn_ref(qkv, feats, h),
        headline=False, library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v),
        bytes=2 * (qkv.numel() + feats[0].numel() + BATCH * s * h * d),
        flops=4 * BATCH * h * s * 2 * s * d, exps=BATCH * h * s * 2 * s, **fwd_plan(s, h)))
    # K1-K4 with another norm eps than the default, against the plain
    # versions with the same eps.
    s, h, d = EXTRA_SHAPES[0]
    eps = 1e-3
    qkv, feats = rows(s, 3, h, d), [rows(s, 2, h, d)]
    bias = [torch.randn(BATCH, h, s, s, generator=gen, device=dev)]
    g = torch.randn(BATCH, s, h * d, generator=gen, device=dev).bfloat16()
    f32 = [feats[0].float()]
    cases.append(dict(
        name="flash_fused_packed", d=d, label=f"S={s} H={h} d={d} sink={s} eps={eps}",
        kernel=tup(lambda: flash.flash_fused_packed(qkv, h, s, eps)),
        plain32=tup(lambda: flash.flash_fused_packed_ref(qkv.float(), h, s, eps)),
        plain=lambda: flash.flash_fused_packed_ref(qkv, h, s, eps),
        headline=False, library=None, bytes=2 * (qkv.numel() + g.numel()),
        flops=4 * BATCH * h * s * s * d, exps=BATCH * h * s * s, **fwd_plan(s, h)))
    cases.append(dict(
        name="flash_fused_packed_xattn", d=d, label=f"S={s} H={h} d={d} n_src=1 bias=True eps={eps}",
        kernel=tup(lambda: flash.flash_fused_packed_xattn(qkv, feats, h, bias, eps)),
        plain32=tup(lambda: flash.flash_fused_packed_xattn_ref(qkv.float(), f32, h, bias, eps)),
        plain=lambda: flash.flash_fused_packed_xattn_ref(qkv, feats, h, bias, eps),
        headline=False, library=None,
        bytes=2 * (qkv.numel() + feats[0].numel() + g.numel()) + 4 * bias[0].numel(),
        flops=4 * BATCH * h * s * 2 * s * d, exps=BATCH * h * s * 2 * s, **fwd_plan(s, h)))
    cases.append(dict(
        name="flash_fused_packed_bwd", d=d, label=f"S={s} H={h} d={d} sink={s} eps={eps}",
        kernel=tup(lambda: flash.flash_fused_packed_bwd(qkv, g, h, s, eps)),
        plain32=tup(lambda: flash.flash_fused_packed_bwd_ref(qkv.float(), g.float(), h, s, eps)),
        plain=lambda: flash.flash_fused_packed_bwd_ref(qkv, g, h, s, eps),
        headline=False, library=None, bytes=2 * (2 * qkv.numel() + g.numel()),
        flops=10 * BATCH * h * s * s * d, exps=BATCH * h * s * s,
        plan=flash.packed_bwd_plan(BATCH, s, h)))
    cases.append(dict(
        name="flash_fused_packed_xattn_bwd", d=d, label=f"S={s} H={h} d={d} n_src=1 bias=True eps={eps}",
        kernel=tup(lambda: flash.flash_fused_packed_xattn_bwd(qkv, feats, g, h, bias, eps)),
        plain32=tup(lambda: flash.flash_fused_packed_xattn_bwd_ref(qkv.float(), f32, g.float(), h, bias, eps)),
        plain=lambda: flash.flash_fused_packed_xattn_bwd_ref(qkv, feats, g, h, bias, eps),
        headline=False, library=None,
        bytes=2 * (2 * qkv.numel() + 2 * feats[0].numel() + g.numel()) + 8 * bias[0].numel(),
        flops=10 * BATCH * h * s * 2 * s * d, exps=BATCH * h * s * 2 * s,
        plan=flash.packed_bwd_plan(BATCH, s, h, (s,))))
    return cases


def _big_s_cases(torch, gen):
    """Cases of K6 `flash_nomax` and of K8 `flash_attention` /
    `flash_attention_bwd` on the same inputs, same keys as `_kernel_cases`.
    Unbiased at the four path shapes at batch 8 (the plain versions walk the
    query rows in chunks, so they fit at the full batch and head count even
    where the logits alone would take 68.7 GB), a ragged shape and a small
    d = 64 one; biased (std-1 bias, fp32) at 4096/8192 at batch 1 (its dbias
    alone is 0.8 GB) and at the two small shapes; with and without a bias at
    1000/1500 (ragged against K8's tiles) and at 64/8192 (one query tile, many
    stages of keys), d = 64, and at the edges of the forward tiles (Sq 191
    and 193 against 192 rows a block, Sk 127 and 129 against 128 keys a
    stage), d = 32 and 64. Rows are scaled by
    exp(N(0, 1)) before the pixel norm the caller applies. K8's backward gets
    the output and statistics of K8's forward. The library call is
    F.scaled_dot_product_attention (its backward for the backward) on the
    same normalised inputs, with the bias as its mask: the same function."""
    import torch.nn.functional as F
    from vivid_tpu_torch.kernels import flash
    dev = "cuda"

    def rows(b, h, s, d):
        x = torch.randn(b, h, s, d, generator=gen, device=dev)
        x = x * torch.exp(torch.randn(b, h, s, 1, generator=gen, device=dev))
        return flash._rms_norm(x.bfloat16())

    def flat(fn):
        return lambda: tuple(t for t in fn() if t is not None)

    shapes = [(BATCH, h, sq, sk, d, False, True) for sq, sk, h, d in NOMAX_SHAPES]
    shapes += [(2, 3, 200, 333, 32, False, False), (2, 2, 256, 512, 64, False, False),
               (1, 6, 4096, 8192, 32, True, False), (2, 3, 200, 333, 32, True, False),
               (2, 2, 256, 512, 64, True, False)]
    # K8's tiles: lengths that are no multiple of a block's rows or a stage's
    # keys, and one query tile against many stages of keys.
    shapes += [(2, 2, 1000, 1500, 64, biased, False) for biased in (False, True)]
    shapes += [(1, 2, 64, 8192, 64, biased, False) for biased in (False, True)]
    # The edges of K6's and K8's forward tiles (192 query rows a block, 128
    # keys a stage): Sq one short of and one past a block's rows, Sk one
    # short of and one past a stage.
    shapes += [(2, 2, sq, sk, d, biased, False)
               for sq, sk, d in ((191, 127, 32), (193, 129, 32), (191, 129, 64), (193, 127, 64))
               for biased in (False, True)]
    cases = []
    for b, h, sq, sk, d, biased, on_path in shapes:
        q, k, v = rows(b, h, sq, d), rows(b, h, sk, d), rows(b, h, sk, d)
        g = torch.randn(b, h, sq, d, generator=gen, device=dev).bfloat16()
        bias = torch.randn(b, h, sq, sk, generator=gen, device=dev) if biased else None
        mask = None if bias is None else bias.to(q.dtype)   # SDPA wants q's dtype
        out, lse = flash.flash_attention(q, k, v, bias)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        common = dict(
            d=d, plain_reps=3 if sq >= 4096 else 20, library_is=SAME_FUNCTION,
            label=f"B={b} H={h} Sq={sq} Sk={sk} d={d} bias={biased}" + (" on_path" if on_path else ""),
            headline=(sq, sk, h, d) == NOMAX_SHAPES[0])
        io = 2 * (2 * q.numel() + k.numel() + v.numel()) + (4 * bias.numel() if biased else 0)
        fwd_lib = lambda q=q, k=k, v=v, mask=mask: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask)
        cases.append(dict(
            common, name="flash_nomax",
            kernel=lambda q=q, k=k, v=v, bias=bias: (flash.flash_nomax(q, k, v, bias),),
            plain32=lambda q=q, k=k, v=v, bias=bias: (
                flash.flash_nomax_ref(q.float(), k.float(), v.float(), bias),),
            plain=lambda q=q, k=k, v=v, bias=bias: flash.flash_nomax_ref(q, k, v, bias),
            library=fwd_lib, bytes=io, flops=4 * b * h * sq * sk * d, exps=b * h * sq * sk))
        cases.append(dict(
            common, name="flash_attention",
            kernel=lambda q=q, k=k, v=v, bias=bias: flash.flash_attention(q, k, v, bias),
            plain32=lambda q=q, k=k, v=v, bias=bias: flash.flash_attention_ref(
                q.float(), k.float(), v.float(), bias),
            plain=lambda q=q, k=k, v=v, bias=bias: flash.flash_attention_ref(q, k, v, bias),
            against=("k6", lambda q=q, k=k, v=v, bias=bias: (flash.flash_nomax(q, k, v, bias),)),
            library=fwd_lib, bytes=io + 4 * lse.numel(), flops=4 * b * h * sq * sk * d,
            exps=b * h * sq * sk))
        args = (q, k, v, bias, out, lse, g)
        cases.append(dict(
            common, name="flash_attention_bwd",
            kernel=flat(lambda args=args: flash.flash_attention_bwd(*args)),
            plain32=flat(lambda args=args: flash.flash_attention_bwd_ref(
                *(t.float() if t is not None and t.dtype == torch.bfloat16 else t for t in args))),
            plain=lambda args=args: flash.flash_attention_bwd_ref(*args),
            library=lambda lib_out=lib_out, leaves=leaves, g=g: torch.autograd.grad(
                lib_out, leaves, g, retain_graph=True),
            # q, k, v, out, g read; dq, dk, dv written; lse; bias read, dbias written
            bytes=2 * (5 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
            + (8 * bias.numel() if biased else 0),
            flops=10 * b * h * sq * sk * d, exps=b * h * sq * sk))
    return cases


def _tp_cases(torch, gen):
    """K1/K2 and K6 at the head counts `--tp` gives them (phase `dist`): a
    block split over 2 ranks runs its attention at H / 2 heads, over 4 at
    H / 4. vivid-base at tp 2: H 2 at S 1024, 3 at 256, 4 at 64; at tp 4:
    H 1 at 1024 and 2 at 64 (its 6-head blocks stay whole); K1 with the
    unconditional model's zero sink too; the SR denoiser's K2 at S 1024,
    H 4, d 32 (one source); K6 at the SR model's halved heads (H 2 / 1 / 3;
    its 3-head encoder blocks at 4096 stay whole). Same keys as
    `_kernel_cases`; no headline, no library call."""
    from vivid_tpu_torch.kernels import flash
    dev = "cuda"

    def rows(shape):
        x = torch.randn(*shape, generator=gen, device=dev)
        return x * torch.exp(torch.randn(*shape[:-1], 1, generator=gen, device=dev))

    def packed(s, parts, h, d):
        return rows((BATCH, s, parts * h, d)).reshape(BATCH, s, parts * h * d).bfloat16()

    cases = []
    for s, h, d, n_src in TP_PACKED_SHAPES:
        qkv = packed(s, 3, h, d)
        feats = [packed(s, 2, h, d) for _ in range(n_src)]
        f32 = [f.float() for f in feats]
        io = 2 * (qkv.numel() + BATCH * s * h * d)
        common = dict(d=d, headline=False, library=None,
                      plan=flash.packed_fwd_plan(BATCH, s, h))
        sinks = (0, 2 * s) if n_src == 2 else ()
        for sink in sinks:
            cases.append(dict(
                common, name="flash_fused_packed", label=f"tp S={s} H={h} d={d} sink={sink}",
                kernel=lambda qkv=qkv, h=h, sink=sink: (flash.flash_fused_packed(qkv, h, sink),),
                plain32=lambda qkv=qkv, h=h, sink=sink: (flash.flash_fused_packed_ref(qkv.float(), h, sink),),
                plain=lambda qkv=qkv, h=h, sink=sink: flash.flash_fused_packed_ref(qkv, h, sink),
                bytes=io, flops=4 * BATCH * h * s * s * d, exps=BATCH * h * s * s))
        sk = s * (1 + n_src)
        cases.append(dict(
            common, name="flash_fused_packed_xattn", label=f"tp S={s} H={h} d={d} n_src={n_src}",
            kernel=lambda qkv=qkv, feats=feats, h=h: (flash.flash_fused_packed_xattn(qkv, feats, h),),
            plain32=lambda qkv=qkv, f32=f32, h=h: (flash.flash_fused_packed_xattn_ref(qkv.float(), f32, h),),
            plain=lambda qkv=qkv, feats=feats, h=h: flash.flash_fused_packed_xattn_ref(qkv, feats, h),
            bytes=io + 2 * sum(f.numel() for f in feats), flops=4 * BATCH * h * s * sk * d,
            exps=BATCH * h * s * sk))
    for sq, sk, h, d in TP_NOMAX_SHAPES:
        q, k, v = (flash._rms_norm(rows((BATCH, h, n, d)).bfloat16()) for n in (sq, sk, sk))
        cases.append(dict(
            name="flash_nomax", d=d, label=f"tp B={BATCH} H={h} Sq={sq} Sk={sk} d={d}",
            headline=False, library=None, plain_reps=3,
            kernel=lambda q=q, k=k, v=v: (flash.flash_nomax(q, k, v),),
            plain32=lambda q=q, k=k, v=v: (flash.flash_nomax_ref(q.float(), k.float(), v.float()),),
            plain=lambda q=q, k=k, v=v: flash.flash_nomax_ref(q, k, v),
            bytes=2 * (2 * q.numel() + k.numel() + v.numel()), flops=4 * BATCH * h * sq * sk * d,
            exps=BATCH * h * sq * sk))
    return cases


def _fused_lab_conv_cases(torch, gen):
    """Cases of K5 `flash_fused`, K10 (the no-max lab's `nomax_attention`) and
    K9 (the conv lab's `conv3x3_silu`), same keys as `_kernel_cases`.

    K5 at the 64px model's three cross-attention shapes in [B, H, S, D] at
    batch 8, raw rows with the norm (its pre-pass): alone, with a std-1 bias,
    and at 1024/1024 with the unconditional model's sink of 2048; at the two
    big d = 32 shapes on normalised rows (`norm_eps=None`), at one ragged
    shape with norm, bias and sink together, and at the edges of its forward
    tiles (Sq 191 and 193 against 192 rows a block, Sk 127 and 129 against
    128 keys a stage; d 32 and 64, raw and normalised rows, with and without
    a bias; one with a sink). Its library call is SDPA on the normalised
    rows: the same function without the norm, the core only with.
    K10: every variant of the lab at the lab's parity shape, every one of its
    24 instances (d 32 and 64, fold_l, chains 1, 2 and 4, prescale) at a
    ragged shape, and two chains with prescale at the lab's three timing
    shapes (16384/32768 H 4 d 32 the headline, 4096/8192 H 6 d 32,
    16384/32768 H 2 d 64); SDPA computes the same function. K9 at [8, 64, 256, 256], at a ragged
    30 x 50 and at the edges of its output tiles (sized from
    `conv3x3_silu_info`: rows one short of, at and one past a tile, pixels
    likewise, 1 x 1, one pixel wide, a batch of 3), each with and without the
    SiLU, against F.silu / 0.596 and F.conv2d, two library calls timed
    together. Its weights are drawn at half the
    magnitude-preserving scale: the output then has RMS 0.5 and stays below 4,
    where one bf16 rounding is at most 7.8e-3, so the absolute limit the
    attention outputs are held to can hold a convolution's too."""
    import torch.nn.functional as F
    from vivid_tpu_torch.kernels import flash
    from vivid_tpu_torch.tools import fused_conv_lab, nomax_attn_lab
    dev = "cuda"
    cases = []

    def raw(b, h, s, d):
        x = torch.randn(b, h, s, d, generator=gen, device=dev)
        return (x * torch.exp(torch.randn(b, h, s, 1, generator=gen, device=dev))).bfloat16()

    def one(fn):
        return lambda: (fn(),)

    def fused_case(q, k, v, bias, eps, sink, headline=False, plain_reps=20):
        b, h, sq, d = q.shape
        sk = k.shape[2]
        qn, kn, vn = (q, k, v) if eps is None else (flash._rms_norm(t) for t in (q, k, v))
        mask = None if bias is None else bias.to(q.dtype)
        return dict(
            name="flash_fused", d=d, headline=headline, plain_reps=plain_reps,
            label=f"B={b} H={h} Sq={sq} Sk={sk} d={d} norm={eps is not None} "
                  f"bias={bias is not None} sink={sink}",
            kernel=one(lambda: flash.flash_fused(q, k, v, bias, eps, sink)),
            plain32=one(lambda: flash.flash_fused_ref(q.float(), k.float(), v.float(), bias,
                                                      eps, sink)),
            plain=lambda: flash.flash_fused_ref(q, k, v, bias, eps, sink),
            library=None if sink else (lambda: F.scaled_dot_product_attention(
                qn, kn, vn, attn_mask=mask)),
            library_is=SAME_FUNCTION if eps is None else CORE_ONLY,
            bytes=2 * (2 * q.numel() + k.numel() + v.numel())
            + (4 * bias.numel() if bias is not None else 0),
            flops=4 * b * h * sq * sk * d, exps=b * h * sq * sk)

    for i, (h, sq, sk) in enumerate(FUSED_SHAPES):
        q, k, v = raw(BATCH, h, sq, 64), raw(BATCH, h, sk, 64), raw(BATCH, h, sk, 64)
        bias = torch.randn(BATCH, h, sq, sk, generator=gen, device=dev)
        cases.append(fused_case(q, k, v, None, 1e-4, 0, headline=i == 0))
        cases.append(fused_case(q, k, v, bias, 1e-4, 0))
    h, s = FUSED_SHAPES[0][:2]
    cases.append(fused_case(raw(BATCH, h, s, 64), raw(BATCH, h, s, 64), raw(BATCH, h, s, 64),
                            None, 1e-4, 2 * s))
    cases.append(fused_case(raw(2, 3, 100, 32), raw(2, 3, 333, 32), raw(2, 3, 333, 32),
                            torch.randn(2, 3, 100, 333, generator=gen, device=dev), 1e-4, 7))
    for sq, sk, h, d in (NOMAX_SHAPES[0], NOMAX_SHAPES[2]):
        q, k, v = (flash._rms_norm(raw(BATCH, h, n, d)) for n in (sq, sk, sk))
        cases.append(fused_case(q, k, v, None, None, 0, plain_reps=3))
    for sq, sk, d in ((191, 127, 32), (193, 129, 32), (191, 129, 64), (193, 127, 64)):
        for eps in (None, 1e-4):
            for biased in (False, True):
                q, k, v = raw(2, 2, sq, d), raw(2, 2, sk, d), raw(2, 2, sk, d)
                if eps is None:
                    q, k, v = (flash._rms_norm(t) for t in (q, k, v))
                bias = torch.randn(2, 2, sq, sk, generator=gen, device=dev) if biased else None
                cases.append(fused_case(q, k, v, bias, eps, 0))
    cases.append(fused_case(raw(2, 2, 193, 64), raw(2, 2, 129, 64), raw(2, 2, 129, 64),
                            None, 1e-4, 50))

    def lab_case(q, k, v, variant, triple, headline=False, plain_reps=20):
        b, h, sq, d = q.shape
        sk = k.shape[2]
        return dict(
            name="nomax_lab_attention", d=d, headline=headline, plain_reps=plain_reps,
            label=f"B={b} H={h} Sq={sq} Sk={sk} d={d} '{variant}'", variant=triple,
            plan={"k10": nomax_attn_lab.nomax_attention_plan(b, h, sq)},
            kernel=one(lambda: nomax_attn_lab.nomax_attention(q, k, v, *triple)),
            plain32=one(lambda: nomax_attn_lab.nomax_attention_ref(
                q.float(), k.float(), v.float(), *triple)),
            plain=lambda: nomax_attn_lab.nomax_attention_ref(q, k, v, *triple),
            library=lambda: F.scaled_dot_product_attention(q, k, v),
            library_is=SAME_FUNCTION,
            bytes=2 * (2 * q.numel() + k.numel() + v.numel()), flops=4 * b * h * sq * sk * d,
            exps=b * h * sq * sk)

    b, h, sq, sk, d = nomax_attn_lab.PARITY_SHAPE
    q, k, v = (flash._rms_norm(raw(b, h, n, d)) for n in (sq, sk, sk))
    for variant, triple in nomax_attn_lab.VARIANTS.items():
        cases.append(lab_case(q, k, v, variant, triple))
    for d in (32, 64):   # every instance, keys and query rows ragged against the tiles
        q, k, v = (flash._rms_norm(raw(2, 2, n, d)) for n in (193, 333, 333))
        for triple in [(f, c, p) for f in (False, True) for c in (1, 2, 4) for p in (False, True)]:
            cases.append(lab_case(q, k, v, "fold_l={} chains={} prescale={}".format(*triple),
                                  triple))
    variant = "v6 chains2 prescale"
    for name in ("sr128", "sr64", "sr128d64"):
        sq, sk, h, d = nomax_attn_lab.SHAPES[name][1:]
        q, k, v = (flash._rms_norm(raw(BATCH, h, n, d)) for n in (sq, sk, sk))
        cases.append(lab_case(q, k, v, variant, nomax_attn_lab.VARIANTS[variant],
                              headline=name == "sr128", plain_reps=3))

    c = fused_conv_lab.CHANNELS
    tr, tp = (fused_conv_lab.conv3x3_silu_info()[k] for k in ("tile_rows", "tile_pixels"))

    def conv_case(b, hh, ww, fuse):
        x = torch.randn(b, hh, ww, c, generator=gen, device=dev).bfloat16().permute(0, 3, 1, 2)
        w = (0.5 / math.sqrt(9 * c) * torch.randn(c, c, 3, 3, generator=gen, device=dev)).bfloat16()

        def nhwc(fn):   # [B, H, W, C], the memory's order: a pixel's channels are one vector
            return lambda: (fn().permute(0, 2, 3, 1),)

        return dict(
            name="conv3x3_silu", d=c, headline=(b, hh, fuse) == (BATCH, 256, True),
            label=f"B={b} {hh}x{ww} C={c} silu={fuse}",
            kernel=nhwc(lambda: fused_conv_lab.conv3x3_silu(x, w, fuse)),
            plain32=nhwc(lambda: fused_conv_lab.conv3x3_silu_ref(x.float(), w.float(), fuse)),
            plain=lambda: fused_conv_lab.conv3x3_silu_ref(x, w, fuse),
            library=lambda: F.conv2d(F.silu(x) / 0.596 if fuse else x, w, padding=1),
            library_is=SAME_FUNCTION,
            bytes=2 * (2 * x.numel() + w.numel()), flops=2 * b * hh * ww * 9 * c * c,
            exps=x.numel() if fuse else 0)   # the SiLU's

    # The headline shape, a ragged one, and the edges of the kernel's tiles:
    # rows one short of, at and one past a tile, pixels likewise, a 1 x 1
    # image, images one pixel wide, a batch of 3 with both edges ragged.
    shapes = [(BATCH, 256, 256), (2, 30, 50)] + [(2, tr + e, tp) for e in (-1, 0, 1)] + [
        (2, tr, tp - 1), (2, tr, tp + 1), (1, 1, 1), (2, 2 * tr + 3, 1), (3, 3 * tr - 2, 2 * tp + 5)]
    for b, hh, ww in shapes:
        for fuse in (True, False):
            cases.append(conv_case(b, hh, ww, fuse))
    return cases


def _sdpa_backward(torch, q, k, v, g, h):
    """The backward of one scaled_dot_product_attention call, graph kept."""
    import torch.nn.functional as F
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves)
    go = g.view(g.shape[0], g.shape[1], h, -1).transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, leaves, go, retain_graph=True)


def _check_zero_rows(torch, gen):
    """All-zero q, k and v rows (r = 0 in the norm and its VJP) must give
    finite gradients and finite forward outputs (K2, K1 with a sink, and K7
    in both forms) that agree with the plain versions."""
    from vivid_tpu_torch.kernels import flash
    s, h, d = 100, 4, 64
    qkv = torch.randn(2, s, 3 * h * d, generator=gen, device="cuda").bfloat16()
    feats = [torch.randn(2, s, 2 * h * d, generator=gen, device="cuda").bfloat16()]
    g = torch.randn(2, s, h * d, generator=gen, device="cuda").bfloat16()
    qkv[:, 3] = 0            # q, k and v of one position
    qkv[:, 70, h * d:] = 0   # k and v of another
    feats[0][:, 5] = 0
    got = flash.flash_fused_packed_xattn_bwd(qkv, feats, g, h)
    want = flash.flash_fused_packed_xattn_bwd_ref(qkv.float(), [feats[0].float()], g.float(), h)
    errs = []
    for a, w in zip((got[0], *got[1]), (want[0], *want[1])):
        check(bool(torch.isfinite(a).all()), "zero rows: non-finite gradient")
        errs.append(_rel_l2(a, w))
    check(max(errs) <= TOL_GRAD_L2, f"zero rows: rel L2 {errs} (limit {TOL_GRAD_L2})")
    say("kernel", name="flash_fused_packed_xattn_bwd", case="'zero rows, S=100 H=4 d=64 n_src=1'",
        finite=True, rel_l2=f"{max(errs):.3e}",
        dqkv_absmax=f"{got[0].float().abs().max().item():.3e}")
    for name, got, want, label in (
            ("flash_fused_packed_xattn", flash.flash_fused_packed_xattn(qkv, feats, h),
             flash.flash_fused_packed_xattn_ref(qkv.float(), [feats[0].float()], h), "n_src=1"),
            ("flash_fused_packed", flash.flash_fused_packed(qkv, h, 2 * s),
             flash.flash_fused_packed_ref(qkv.float(), h, 2 * s), f"sink={2 * s}"),
            ("flash_nomax_packed", flash.flash_nomax_packed(qkv, feats, h),
             flash.flash_nomax_packed_ref(qkv.float(), [feats[0].float()], h), "n_src=1"),
            ("flash_nomax_packed", flash.flash_nomax_packed(qkv, (), h, 2 * s),
             flash.flash_nomax_packed_ref(qkv.float(), (), h, 2 * s), f"sink={2 * s}")):
        fails, shown = _fwd_fails(got, want)
        check(bool(torch.isfinite(got).all()) and not fails, f"zero rows: {name} {shown}")
        say("kernel", name=name, case=f"'zero rows, S={s} H={h} d={d} {label}'", finite=True,
            **shown)


def _check_nomax_gate(torch, gen):
    """A planted fault must fail the forward gate where the absolute limit
    alone is too wide to see it: K6 at the longest path shape with the last
    eighth of the keys left out, against the plain version over all of them."""
    from vivid_tpu_torch.kernels import flash
    sq, sk, h, d = NOMAX_SHAPES[0]
    q, k, v = (flash._rms_norm(torch.randn(1, h, s, d, generator=gen, device="cuda").bfloat16())
               for s in (sq, sk, sk))
    keep = sk - sk // 8
    got = flash.flash_nomax(q, k[:, :, :keep].contiguous(), v[:, :, :keep].contiguous()).float()
    want = flash.flash_nomax_ref(q.float(), k.float(), v.float())
    err = (got - want).abs().max().item()
    rel_max = err / want.square().mean().sqrt().item()
    rel_l2 = _rel_l2(got, want)
    check(rel_l2 > TOL_KERNEL_L2 and rel_max > TOL_KERNEL_MAX,
          f"flash_nomax without an eighth of its keys passes the gate: rel L2 {rel_l2}, "
          f"max err over RMS {rel_max}")
    say("kernel", name="flash_nomax", fault=f"'last {sk // 8} of {sk} keys dropped, Sq={sq} H={h} d={d}'",
        max_abs_err=f"{err:.3e}", abs_limit_alone_sees_it=err > TOL_KERNEL,
        max_err_over_rms=f"{rel_max:.3e}", rel_l2=f"{rel_l2:.3e}", fails_gate=True)


def _bf16_ulps(a, b):
    """Elementwise distance of two bf16 tensors in units in the last place
    (their bit patterns on one ordered integer line; +0 and -0 are one)."""
    import torch

    def line(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i >= 0, i, -(i + 32768))
    return (line(a) - line(b)).abs()


def _check_fused_norm(torch, gen):
    """K5's norm pre-pass alone (`flash_fused_norm`) against its plain
    version `flash._rms_norm` on the card, on raw rows (every D-vector scaled
    by exp(N(0, 1))) at the shapes the path and the lab give K5: the 64px
    model's cross-attention (H 4, 1024/3072, d 64) and the SR model's
    (H 4, 16384/32768, d 32), batch 8, and one ragged shape. Every element
    within one bf16 ulp (the sum of squares is added up in another order);
    the share off by one is printed; two runs give the same bits. Bound:
    its bytes, each row read once and written once."""
    from vivid_tpu_torch.kernels import flash

    def raw(b, h, s, d):
        x = torch.randn(b, h, s, d, generator=gen, device="cuda")
        return (x * torch.exp(torch.randn(b, h, s, 1, generator=gen, device="cuda"))).bfloat16()

    h, sq, sk = FUSED_SHAPES[0]
    sq2, sk2, h2, d2 = NOMAX_SHAPES[0]
    for b, h, sq, sk, d in ((BATCH, h, sq, sk, 64), (BATCH, h2, sq2, sk2, d2), (2, 3, 100, 333, 32)):
        q, k, v = raw(b, h, sq, d), raw(b, h, sk, d), raw(b, h, sk, d)
        got = flash.flash_fused_norm(q, k, v)
        again = flash.flash_fused_norm(q, k, v)
        want = tuple(flash._rms_norm(t) for t in (q, k, v))
        ulps = [_bf16_ulps(a, w) for a, w in zip(got, want)]
        n = sum(u.numel() for u in ulps)
        max_ulp = max(u.max().item() for u in ulps)
        off_by_one = sum((u == 1).sum().item() for u in ulps) / n
        same = all(torch.equal(a, a2) for a, a2 in zip(got, again))
        check(max_ulp <= 1 and same, f"flash_fused_norm at B={b} H={h} Sq={sq} Sk={sk} d={d}: "
              f"max {max_ulp} bf16 ulps from _rms_norm (limit 1), two runs equal: {same}")
        del got, again, want, ulps
        ms = cuda_ms(lambda: flash.flash_fused_norm(q, k, v))
        plain_ms = cuda_ms(lambda: tuple(flash._rms_norm(t) for t in (q, k, v)))
        nbytes = 2 * 2 * (q.numel() + k.numel() + v.numel())
        say("kernel", name="flash_fused_norm", case=f"'B={b} H={h} Sq={sq} Sk={sk} d={d}'",
            max_ulp=max_ulp, share_off_by_one=f"{off_by_one:.3e}", same_bits=same,
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f}", bound_by="bytes")
        del q, k, v


def _check_mp_fused(torch, gen):
    """The blocks' fused elementwise kernels (kernels/mp_fused.py, through
    their entries with autograd off) against their plain versions, the
    composites, on the card at MP_SHAPES in bf16 and once in fp32. Every
    bf16 output within one ulp (`_bf16_ulps`) of the plain version's: the
    norm's xn of `normalize`'s (its denominator stays fp32, the composite
    rounds it), its mp_silu of `mp_silu` of the kernel's own xn (a SiLU
    magnifies a one-ulp difference of its input several times: the gap to
    the whole composite is printed beside); the other three round where the
    composites round. fp32 outputs within 1e-6 of the largest plain value.
    Two runs give the same bits; one launch a call. No instance spills to
    local memory (plain SIMT kernels: no wgmma or TMA to look for). Times,
    the kernel against the composite: one call by CUDA events (the host's
    dispatch included, which the small shapes show) and the card's own time
    (torch.profiler), from which the achieved rate; bound: the kernel's
    bytes (each input read once, each output written once) over the memory
    rate, printed only where those bytes exceed the L2 cache (a smaller
    case stays in L2 across the repeated calls, and no HBM bound holds it);
    `plain_bytes` counts the composite's passes, operator by operator.
    Then the concatenation at every (Ca, Cb) that the decoders of vivid-sr,
    vivid-base and vivid-uncond join (`_cat_widths`), at BATCH rows: parts
    of unequal widths take their own branch of the kernel's indexing."""
    from vivid_tpu_torch.kernels import flash, mp_fused
    from vivid_tpu_torch.nn.mp import mp_silu
    l2_bytes = torch.cuda.get_device_properties(0).L2_cache_size

    kinds = ("norm_silu", "scale_silu", "sum_clip", "cat_silu")
    for dtype in (torch.bfloat16, torch.float32):
        for kind in kinds:
            for ch in (64, 128, 192, 256, 320, 384, 448, 512, 1024):
                if kind != "norm_silu" and ch > 64 or dtype == torch.float32 and ch > 512:
                    continue
                built = mp_fused.info(kind, dtype, ch)
                check(built["local_bytes"] == 0, f"mp_{kind} {dtype} C={ch} spills: {built}")
                say("kernel", name=f"mp_{kind}", dtype=str(dtype).split(".")[-1], channels=ch,
                    **built)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    cases = [(shape, torch.bfloat16) for shape in MP_SHAPES] + [((32, 64, 64, 128), torch.float32)]
    for (b, h, w, c), dtype in cases:
        n, size = b * h * w * c, torch.finfo(dtype).bits // 8
        x = (rand(b, h, w, c) * torch.exp(rand(b, h, w, 1))).to(dtype)
        y, cvec = rand(b, h, w, c, scale=3.0).to(dtype), 1 + rand(b, c)
        a, b2 = (rand(b, h, w, c, scale=100.0).to(dtype) for _ in range(2))
        calls = {   # kind: (kernel, plain, kernel bytes, composite bytes)
            "norm_silu": (lambda: mp_fused.norm_silu(x), lambda: mp_fused.norm_silu_ref(x),
                          3 * n * size, 30 * n if size == 2 else 36 * n),
            "scale_silu": (lambda: mp_fused.scale_silu(y, cvec),
                           lambda: mp_fused.scale_silu_ref(y, cvec), 2 * n * size + 4 * b * c,
                           6 * n * size),
            "sum_clip": (lambda: mp_fused.mp_sum_clip(a, b2, 0.3, 256.0),
                         lambda: mp_fused.mp_sum_clip_ref(a, b2, 0.3, 256.0), 3 * n * size,
                         12 * n * size),
            "cat_silu": (lambda: mp_fused.cat_silu(x, y, 0.5),
                         lambda: mp_fused.cat_silu_ref(x, y, 0.5), 6 * n * size,
                         16 * n * size),
        }
        label = f"'[{b}, {h}, {w}, {c}] {str(dtype).split('.')[-1]}'"
        for kind, (kernel, plain, nbytes, plain_bytes) in calls.items():
            with torch.no_grad():
                before = dict(flash.launches)
                got = kernel()
                launched = {k: v - before[k] for k, v in flash.launches.items() if v != before[k]}
                again = kernel()
                want = plain()
            got, again, want = ((t,) if torch.is_tensor(t) else t for t in (got, again, want))
            torch.cuda.synchronize()
            check(launched == {f"mp_{kind}": 1}, f"mp_{kind} {label}: launched {launched}")
            check(all(torch.equal(g, a2) for g, a2 in zip(got, again)),
                  f"mp_{kind} {label}: two runs differ")
            if kind == "norm_silu":
                with torch.no_grad():
                    composite = want[1]
                    want = (want[0], mp_silu(got[0]))
            extra = {}
            if dtype == torch.bfloat16:
                gaps = [_bf16_ulps(g, w_).max().item() for g, w_ in zip(got, want)]
                check(max(gaps) <= 1, f"mp_{kind} {label}: {gaps} bf16 ulps from the plain "
                      "version (limit 1)")
                extra["max_ulp"] = gaps
                extra["share_off_by_one"] = [f"{(_bf16_ulps(g, w_) == 1).float().mean().item():.3e}"
                                             for g, w_ in zip(got, want)]
                if kind == "norm_silu":
                    u = _bf16_ulps(got[1], composite)
                    extra.update(silu_vs_composite_max_ulp=u.max().item(),
                                 silu_vs_composite_over_1=f"{(u > 1).float().mean().item():.3e}")
            else:
                rel = max(((g - w_).abs().max() / w_.abs().max()).item()
                          for g, w_ in zip(got, want))
                check(rel <= 1e-6, f"mp_{kind} {label}: max error {rel} of the largest value")
                extra["max_err_over_max"] = f"{rel:.3e}"
            del got, again, want
            with torch.no_grad():
                ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
                dev_ms, plain_dev_ms = (
                    sum(float(v) for v in _device_ms_by_kernel(torch, fn, key).values())
                    for fn, key in ((kernel, "mp_"), (plain, "")))
            if nbytes > l2_bytes:
                extra.update(bound_ms=f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f}", bound_by="bytes",
                             share_of_hbm=f"{nbytes / dev_ms / 1e9 / (HBM_BYTES_PER_S / 1e12):.3f}")
            else:
                extra["l2_resident"] = True
            say("kernel", name=f"mp_{kind}", case=label, **extra, ms=f"{ms:.4f}",
                plain_ms=f"{plain_ms:.4f}", device_ms=f"{dev_ms:.4f}",
                plain_device_ms=f"{plain_dev_ms:.4f}", bytes=nbytes, plain_bytes=plain_bytes,
                tb_per_s=f"{nbytes / dev_ms / 1e9:.3f}",
                plain_tb_per_s=f"{plain_bytes / plain_dev_ms / 1e9:.3f}")
        del x, y, cvec, a, b2
        torch.cuda.empty_cache()

    widths = sorted({w for cfg in (_sr_config(), _full_width_config(False),
                                   _full_width_config(True))
                     for ucfg in (cfg.unet_cfg, cfg.encoder_cfg) if ucfg is not None
                     for w in _cat_widths(ucfg)})
    for res, ca, cb in widths:
        a = rand(BATCH, res, res, ca).to(torch.bfloat16)
        b2 = rand(BATCH, res, res, cb, scale=3.0).to(torch.bfloat16)
        with torch.no_grad():
            before = dict(flash.launches)
            got = mp_fused.cat_silu(a, b2, 0.5)
            launched = {k: v - before[k] for k, v in flash.launches.items() if v != before[k]}
            want = mp_fused.cat_silu_ref(a, b2, 0.5)
        label = f"'[{BATCH}, {res}, {res}, {ca}+{cb}] bfloat16'"
        gaps = [_bf16_ulps(g, w_).max().item() for g, w_ in zip(got, want)]
        check(launched == {"mp_cat_silu": 1}, f"mp_cat_silu {label}: launched {launched}")
        check(max(gaps) <= 1, f"mp_cat_silu {label}: {gaps} bf16 ulps from the plain version "
              "(limit 1)")
        say("kernel", name="mp_cat_silu", case=label, max_ulp=gaps,
            bitwise=all(torch.equal(g, w_) for g, w_ in zip(got, want)))
        del a, b2, got, want


def phase_mp_fused():
    """`_check_mp_fused` alone."""
    import torch
    _check_mp_fused(torch, torch.Generator(device="cuda").manual_seed(12))


def phase_launches(card):
    """What the card runs in one evaluation with autograd off, full-width
    vivid-sr and vivid-base guided by vivid-uncond (64px), batch 8: device
    kernels counted by torch.profiler (memory copies and sets apart), their
    busy ms, and the port's own launches (`flash.launches`). It reads
    nothing that a port without the fused kernels lacks, so
    `smoke_phase.py launches --port DIR` gives another checkout's counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vivid_tpu_torch.kernels import flash
    gen = torch.Generator(device="cuda").manual_seed(13)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    sr, base, gnet = _full_width_sr(), _full_width(False), _full_width(True)
    sigma = torch.ones(BATCH, device="cuda")
    sr_args = (rand(BATCH, 1, 256, 256, 3).clamp(-1, 1), rand(BATCH, 256, 256, 3), sigma,
               rand(BATCH, 1, 20))
    sr_kw = dict(conditioning_image=rand(BATCH, 256, 256, 3).clamp(-1, 1),
                 cond_noise=rand(BATCH, 256, 256, 3))
    base_args = (rand(BATCH, 2, 64, 64, 3).clamp(-1, 1), rand(BATCH, 64, 64, 3), sigma,
                 rand(BATCH, 2, 20))
    evaluations = {"vivid-sr": lambda: sr(*sr_args, **sr_kw),
                   "vivid-base_guided": lambda: (base(*base_args), gnet(*base_args))}
    for label, evaluation in evaluations.items():
        with torch.no_grad():
            evaluation()
            torch.cuda.synchronize()
            before = dict(flash.launches)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                evaluation()
                torch.cuda.synchronize()
        port = {k: n - before[k] for k, n in flash.launches.items() if n != before[k]}
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset"))]
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        check(kernels, f"{label}: the profiler saw no kernel")
        say("launches", evaluation=label, batch=BATCH, device_kernels=len(kernels),
            device_busy_ms=f"{busy_ms:.3f}", port_launches=port, card=f"'{card}'")
    del sr, base, gnet
    torch.cuda.empty_cache()


def _built(name, case):
    """What K8's, K6's, K5's, K1/K2's, K3/K4's, K7's, K9's and K10's kernels
    were built with, for their `kernel` lines: registers a thread at launch
    and after the warpgroups have traded them, bytes of local memory a thread
    (spills), dynamic shared memory; for K1-K4 and K7 also each launch's grid
    in blocks and in waves on 132 SMs."""
    from vivid_tpu_torch.kernels import flash
    from vivid_tpu_torch.tools import fused_conv_lab, nomax_attn_lab
    biased = "bias=True" in case["label"]
    if name == "conv3x3_silu":
        info = {"k9": fused_conv_lab.conv3x3_silu_info("silu=True" in case["label"])}
    elif name == "flash_nomax":
        info = {"k6": flash.flash_nomax_info(case["d"], biased)}
    elif name == "flash_fused":
        info = {"k5": flash.flash_fused_info(case["d"], biased)}
    elif name in ("flash_attention", "flash_attention_bwd"):
        info = flash.flash_attention_info(case["d"], biased)
    elif name in ("flash_fused_packed", "flash_fused_packed_xattn"):
        info = {"fwd": flash.flash_packed_info(case["d"], biased)}
    elif name == "flash_nomax_packed":
        info = {"fwd": flash.flash_nomax_packed_info(case["d"])}
    elif name == "nomax_lab_attention":
        info = {"k10": nomax_attn_lab.nomax_attention_info(case["d"], *case["variant"])}
    elif name in ("flash_fused_packed_bwd", "flash_fused_packed_xattn_bwd"):
        info = flash.flash_packed_bwd_info(case["d"], biased)
    else:
        return {}
    out = {}
    for k, p in case.get("plan", {}).items():
        out[f"{k}_grid"] = f"{p['blocks']}_blocks_{p['waves']}_waves"
    for kernel in {"flash_nomax": ("k6",), "flash_fused": ("k5",), "conv3x3_silu": ("k9",),
                   "flash_attention": ("fwd",), "flash_fused_packed": ("fwd",),
                   "flash_fused_packed_xattn": ("fwd",), "flash_nomax_packed": ("fwd",),
                   "nomax_lab_attention": ("k10",)}.get(name, ("dkv", "dq")):
        k = info[kernel]
        out.update({f"{kernel}_regs": f"{k['regs_at_launch']}/{k['consumer_regs']}/{k['producer_regs']}",
                    f"{kernel}_spill_bytes": k["local_bytes"], f"{kernel}_smem": k["smem_bytes"]})
    return out


def _fwd_fails(got, want):
    """(fails, shown): whether a forward output misses one of the forward
    limits against the plain version on fp32 inputs, and the three numbers."""
    err = (got.float() - want).abs().max().item()
    rel_max = err / want.square().mean().sqrt().item()
    rel_l2 = _rel_l2(got.float(), want)
    return (not (err <= TOL_KERNEL and rel_l2 <= TOL_KERNEL_L2 and rel_max <= TOL_KERNEL_MAX),
            dict(max_abs_err=f"{err:.3e}", max_err_over_rms=f"{rel_max:.3e}",
                 rel_l2=f"{rel_l2:.3e}"))


def _bwd_fails(got, want, d):
    """(fails, rel_l2, max_vector_err): whether outputs miss the backward
    limits against the plain version on fp32 inputs, by the largest over the
    outputs of the relative L2 and of the error of every vector over its own
    norm plus the RMS: a D-vector of a packed [B, S, parts*H*D] output, else
    a row of the last axis (a dbias row)."""
    rel_l2 = scaled = 0.0
    for a, w in zip(got, want):
        a, w = a.float(), w.float()
        rms = w.square().mean().sqrt().item()
        rel_l2 = max(rel_l2, _rel_l2(a, w))
        n = d if a.dim() == 3 and a.shape[-1] % d == 0 else a.shape[-1]
        vec = (a - w).reshape(-1, n).norm(dim=1) / (w.reshape(-1, n).norm(dim=1)
                                                    + rms * math.sqrt(n))
        scaled = max(scaled, vec.max().item())
    return not (rel_l2 <= TOL_GRAD_L2 and scaled <= TOL_GRAD_MAX), rel_l2, scaled


def _check_ring_faults(torch, gen):
    """Two faults of a ring of TMA stages must fail the gates of K8 (forward
    and backward), of K6, of K5 (with its norm pre-pass), of K1, K2 and K7
    (the forward gate; K2 and K7 also with the padding rows of a source of
    100 keys unmasked) and of K3 and K4
    (the backward gate; the stale stage in both rings: the dq kernel's of k'
    and v', the dk/dv kernel's of c q', dO and the statistics). The kernels have
    no switch to break them, so each fault is planted in the inputs, as the
    tensors a broken kernel would see, sized by what each kernel was built
    with: (1) the ring's last stage
    never refreshed: every later K tile that lands in that stage is the stale
    first one; (2) the key mask at the ragged edge dropped: the zero rows TMA
    fills in past the end join the softmax (k and v padded with zero rows to
    a whole stage). The kernels run on the faulty tensors and are held to
    the plain versions on the true ones."""
    from vivid_tpu_torch.kernels import flash
    rings = {"flash_attention": flash.flash_attention_info(64, False)["fwd"],
             "flash_nomax": flash.flash_nomax_info(64, False),
             "flash_fused": flash.flash_fused_info(64, False)}

    def rows(b, h, s, d):
        x = torch.randn(b, h, s, d, generator=gen, device="cuda")
        return flash._rms_norm((x * torch.exp(torch.randn(b, h, s, 1, generator=gen,
                                                          device="cuda"))).bfloat16())

    def gates(name, q, k, v, g, fk, fv, label):
        sk = k.shape[2]
        if name == "flash_nomax":
            fails, shown = _fwd_fails(flash.flash_nomax(q, fk, fv),
                                     flash.flash_nomax_ref(q.float(), k.float(), v.float()))
        elif name == "flash_fused":
            eps = flash.NORM_EPS
            fails, shown = _fwd_fails(flash.flash_fused(q, fk, fv, None, eps),
                                     flash.flash_fused_ref(q.float(), k.float(), v.float(), None, eps))
        else:
            out, lse = flash.flash_attention(q, fk, fv)
            grads = flash.flash_attention_bwd(q, fk, fv, None, out, lse, g)
            want, want_lse = flash.flash_attention_ref(q.float(), k.float(), v.float())
            want_grads = flash.flash_attention_bwd_ref(q.float(), k.float(), v.float(), None,
                                                       want, want_lse, g.float())
            fails, shown = _fwd_fails(out, want)
            bwd_fails, grad_l2, _ = _bwd_fails([a[:, :, :w.shape[2]] for a, w in
                                                zip(grads[:3], want_grads[:3])],
                                               want_grads[:3], q.shape[-1])
            fails = fails and bwd_fails
            shown["bwd_rel_l2"] = f"{grad_l2:.3e}"
        check(fails, f"{name} with {label} passes a gate: {shown}")
        say("kernel", name=name, fault=f"'{label}, Sq={q.shape[2]} Sk={sk}'", **shown,
            fails_gate=True)

    for name, ring in rings.items():
        keys, stages = ring["stage_rows"], ring["stages"]
        b, h, sq, d = 1, 2, 256, 64
        sk = 4 * stages * keys
        q, k, v = rows(b, h, sq, d), rows(b, h, sk, d), rows(b, h, sk, d)
        g = torch.randn(b, h, sq, d, generator=gen, device="cuda").bfloat16()
        stale = k.clone().view(b, h, sk // keys, keys, d)
        stale[:, :, stages - 1::stages] = stale[:, :, stages - 1:stages]
        gates(name, q, k, v, g, stale.view(b, h, sk, d), v,
              f"stage {stages - 1} of {stages} never refreshed ({keys} keys a stage)")
        sq, sk, d = 200, 333, 32
        q, k, v = rows(b, h, sq, d), rows(b, h, sk, d), rows(b, h, sk, d)
        g = torch.randn(b, h, sq, d, generator=gen, device="cuda").bfloat16()
        pad = torch.zeros(b, h, -sk % keys, d, dtype=k.dtype, device="cuda")
        gates(name, q, k, v, g, torch.cat([k, pad], 2), torch.cat([v, pad], 2),
              "the key mask at the ragged edge dropped")

    # K3 and K4 on packed rows: the stale stage of the dq kernel's ring in
    # the k part of the self segment (K3) or of a source (K4), of the dk/dv
    # kernel's ring in the q part and in dO (both); the ragged edge of the
    # self segment (K3: qkv and g padded with zero rows) or of a source (K4).
    info = flash.flash_packed_bwd_info(64, False)
    keys, stages = info["dq"]["stage_rows"], info["dq"]["stages"]
    check(info["dkv"]["stage_rows"] == keys, f"the two rings' stages differ: {info}")
    h, d = 2, 64

    def packed(s, parts):
        x = torch.randn(1, s, parts * h, d, generator=gen, device="cuda")
        x = x * torch.exp(torch.randn(1, s, parts * h, 1, generator=gen, device="cuda"))
        return x.reshape(1, s, parts * h * d).bfloat16()

    def stale(x, parts, part, n=stages):   # rows of `part` of a packed row, n stages a ring
        y = x.clone().view(1, x.shape[1] // keys, keys, parts, h * d)
        y[:, n - 1::n, :, part] = y[:, n - 1:n, :, part]
        return y.view(x.shape)

    def zero_rows(x, n):
        return torch.cat([x, x.new_zeros(1, n, x.shape[2])], 1)

    def packed_gate(name, got, want, label):
        flat = [(o,) if isinstance(o, torch.Tensor) else (o[0], *o[1], *o[2]) for o in (got, want)]
        fails, rel_l2, scaled = _bwd_fails(*flat, d)
        shown = dict(rel_l2=f"{rel_l2:.3e}", max_vector_err=f"{scaled:.3e}")
        check(fails, f"{name} with {label} passes the backward gate: {shown}")
        say("kernel", name=name, fault=f"'{label}, S={qkv.shape[1]} H={h} d={d}'", **shown,
            fails_gate=True)

    s = 4 * stages * keys
    qkv, src, g = packed(s, 3), packed(s, 2), packed(s, 1)
    label = f"stage {stages - 1} of {stages} never refreshed ({keys} keys a stage)"
    packed_gate("flash_fused_packed_bwd", flash.flash_fused_packed_bwd(stale(qkv, 3, 1), g, h),
                flash.flash_fused_packed_bwd_ref(qkv.float(), g.float(), h), label)
    packed_gate("flash_fused_packed_xattn_bwd",
                flash.flash_fused_packed_xattn_bwd(qkv, [stale(src, 2, 0)], g, h),
                flash.flash_fused_packed_xattn_bwd_ref(qkv.float(), [src.float()], g.float(), h),
                label + " in a source")
    q_stages = info["dkv"]["stages"]
    label = (f"query stage {q_stages - 1} of {q_stages} never refreshed "
             f"({keys} rows of c q' and dO a stage)")
    fq, fg = stale(qkv, 3, 0, q_stages), stale(g, 1, 0, q_stages)
    packed_gate("flash_fused_packed_bwd", flash.flash_fused_packed_bwd(fq, fg, h),
                flash.flash_fused_packed_bwd_ref(qkv.float(), g.float(), h), label)
    packed_gate("flash_fused_packed_xattn_bwd", flash.flash_fused_packed_xattn_bwd(fq, [src], fg, h),
                flash.flash_fused_packed_xattn_bwd_ref(qkv.float(), [src.float()], g.float(), h),
                label)
    s, sf = 200, 333
    qkv, src, g = packed(s, 3), packed(sf, 2), packed(s, 1)
    label = "the key mask at the ragged edge dropped"
    got = flash.flash_fused_packed_bwd(zero_rows(qkv, -s % keys), zero_rows(g, -s % keys), h)
    packed_gate("flash_fused_packed_bwd", got[:, :s].contiguous(),
                flash.flash_fused_packed_bwd_ref(qkv.float(), g.float(), h), label)
    dqkv, dfeats, _ = flash.flash_fused_packed_xattn_bwd(qkv, [zero_rows(src, -sf % keys)], g, h)
    packed_gate("flash_fused_packed_xattn_bwd", (dqkv, (dfeats[0][:, :sf].contiguous(),), ()),
                flash.flash_fused_packed_xattn_bwd_ref(qkv.float(), [src.float()], g.float(), h),
                label + f" (a source of {sf})")

    # K1, K2 and K7 on packed rows, held by the forward gate: the stale stage
    # of the forward's ring of k' and v' in the self segment (K1, K7) or a
    # source (K2, K7); the ragged edge of the self segment (qkv padded with
    # zero rows, the output cut back to S); the padding rows of a source of
    # 100 keys.
    fwd = flash.flash_packed_info(64, False)
    check(fwd["stage_rows"] == keys, f"the forward's stages differ from the backward's: {fwd}")
    k7 = flash.flash_nomax_packed_info(64)
    check((k7["stage_rows"], k7["stages"]) == (keys, fwd["stages"]),
          f"K7's ring differs from K1/K2's: {k7}")

    def fwd_gate(name, got, want, label, s):
        fails, shown = _fwd_fails(got, want)
        check(fails, f"{name} with {label} passes the forward gate: {shown}")
        say("kernel", name=name, fault=f"'{label}, S={s} H={h} d={d}'", **shown, fails_gate=True)

    k1, k1_ref = flash.flash_fused_packed, flash.flash_fused_packed_ref
    k2, k2_ref = flash.flash_fused_packed_xattn, flash.flash_fused_packed_xattn_ref
    k7, k7_ref = flash.flash_nomax_packed, flash.flash_nomax_packed_ref
    s, n = 4 * fwd["stages"] * keys, fwd["stages"]
    qkv, src = packed(s, 3), packed(s, 2)
    label = f"stage {n - 1} of {n} never refreshed ({keys} keys a stage)"
    stale_self, stale_src = stale(stale(qkv, 3, 1, n), 3, 2, n), stale(stale(src, 2, 0, n), 2, 1, n)
    fwd_gate("flash_fused_packed", k1(stale_self, h), k1_ref(qkv.float(), h), label, s)
    fwd_gate("flash_nomax_packed", k7(stale_self, (), h), k7_ref(qkv.float(), (), h), label, s)
    fwd_gate("flash_fused_packed_xattn", k2(qkv, [stale_src], h),
             k2_ref(qkv.float(), [src.float()], h), label + " in a source", s)
    fwd_gate("flash_nomax_packed", k7(qkv, [stale_src], h),
             k7_ref(qkv.float(), [src.float()], h), label + " in a source", s)
    s, sf = 200, 100
    qkv, src = packed(s, 3), packed(sf, 2)
    label = "the key mask at the ragged edge dropped"
    padded, padded_src = zero_rows(qkv, -s % keys), zero_rows(src, -sf % keys)
    fwd_gate("flash_fused_packed", k1(padded, h)[:, :s], k1_ref(qkv.float(), h), label, s)
    fwd_gate("flash_nomax_packed", k7(padded, (), h)[:, :s], k7_ref(qkv.float(), (), h), label, s)
    fwd_gate("flash_fused_packed_xattn", k2(padded, [src], h)[:, :s],
             k2_ref(qkv.float(), [src.float()], h), label, s)
    fwd_gate("flash_nomax_packed", k7(padded, [src], h)[:, :s],
             k7_ref(qkv.float(), [src.float()], h), label, s)
    label = f"the padding rows of a source of {sf} unmasked"
    fwd_gate("flash_fused_packed_xattn", k2(qkv, [padded_src], h),
             k2_ref(qkv.float(), [src.float()], h), label, s)
    fwd_gate("flash_nomax_packed", k7(qkv, [padded_src], h),
             k7_ref(qkv.float(), [src.float()], h), label, s)


def _check_conv_faults(torch, gen):
    """Three faults of K9 must fail its gate. The kernel has no switch to
    break it, so each is planted in the inputs, as the tensors a broken kernel
    would see, sized by the tile it was built with, and the kernel runs on
    them held to the plain version on the true ones: (1) the image boundary
    lost (halos reaching into the next image): two images of 2 tile rows + 3
    stacked into one of twice the height, so the seam falls inside a tile;
    (2) the taps transposed (ky and kx swapped: B read in the wrong
    orientation); (3) the SiLU applied twice (a stage passed through it
    again)."""
    from vivid_tpu_torch.tools import fused_conv_lab as lab
    info = lab.conv3x3_silu_info(True)
    c, hh, ww = lab.CHANNELS, 2 * info["tile_rows"] + 3, 2 * info["tile_pixels"]
    x = torch.randn(2, hh, ww, c, generator=gen, device="cuda").bfloat16().permute(0, 3, 1, 2)
    w = (0.5 / math.sqrt(9 * c) * torch.randn(c, c, 3, 3, generator=gen, device="cuda")).bfloat16()
    want = lab.conv3x3_silu_ref(x.float(), w.float(), True)
    stacked = x.permute(0, 2, 3, 1).reshape(1, 2 * hh, ww, c).permute(0, 3, 1, 2)
    silu_x = (torch.nn.functional.silu(x.float()) / 0.596).bfloat16()
    for label, got in (
            ("the image boundary lost", lab.conv3x3_silu(stacked, w, True).permute(0, 2, 3, 1)
             .reshape(2, hh, ww, c).permute(0, 3, 1, 2)),
            ("the taps transposed", lab.conv3x3_silu(x, w.transpose(2, 3), True)),
            ("the SiLU applied twice", lab.conv3x3_silu(silu_x, w, True))):
        fails, shown = _fwd_fails(got, want)
        check(fails, f"conv3x3_silu with {label} passes the gate: {shown}")
        say("kernel", name="conv3x3_silu", fault=f"'{label}, B=2 {hh}x{ww}'", **shown,
            fails_gate=True)


def phase_kernels(table):
    """Every kernel against its plain version at every path shape. A forward
    kernel (K6 `flash_nomax` and K8's forward `flash_attention`, output and
    row statistics, among them) is held to TOL_KERNEL (max abs
    against the plain version on fp32 copies of the bf16 inputs) and, since
    that is above a typical output value once thousands of keys share the
    weight, to TOL_KERNEL_L2 (relative L2) and TOL_KERNEL_MAX (max error over
    the plain output's RMS, printed as out_rms); a backward
    kernel's every gradient to TOL_GRAD_L2 (relative L2) and TOL_GRAD_MAX
    (the same per D-vector), and two runs on the same inputs must be bitwise
    equal. Every case prints its bound: the larger of its bytes (each input
    read once, each output written once) over the memory rate and its
    operations over the bf16 peak. The headline case of each kernel fills
    its row of the table and adds the library yardstick. The bound counts a
    third term for every kernel with a softmax, its exponentials (one for
    every logit) over EXPS_PER_S. K8's, K6's, K5's and K1-K4's lines carry what was built:
    registers a thread, spilled bytes and dynamic shared memory. K8's forward output
    is also held, by the forward limits, to K6's on the same inputs: the two
    differ by their rounding only."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    _check_zero_rows(torch, torch.Generator(device="cuda").manual_seed(7))
    _check_nomax_gate(torch, torch.Generator(device="cuda").manual_seed(8))
    _check_ring_faults(torch, torch.Generator(device="cuda").manual_seed(9))
    _check_fused_norm(torch, torch.Generator(device="cuda").manual_seed(10))
    _check_conv_faults(torch, torch.Generator(device="cuda").manual_seed(11))
    _check_mp_fused(torch, torch.Generator(device="cuda").manual_seed(12))
    for case in (_kernel_cases(torch, gen) + _big_s_cases(torch, gen)
                 + _fused_lab_conv_cases(torch, gen) + _tp_cases(torch, gen)):
        name, label = case["name"], case["label"]
        got = [t.float() for t in case["kernel"]()]
        again = case["kernel"]()
        want = [t.float() for t in case["plain32"]()]
        torch.cuda.synchronize()
        check(len(got) == len(want), f"{name} {label}: {len(got)} outputs, want {len(want)}")
        n_out = len(got)
        backward = name.endswith("_bwd")
        err = rel_max = out_rms = 0.0
        for i, (a, b, w) in enumerate(zip(got, again, want)):
            check(a.shape == w.shape, f"{name} {label}: output {i} has shape {tuple(a.shape)}")
            check(torch.equal(a, b.float()), f"{name} {label}: output {i} differs between two runs")
            e = (a - w).abs().max().item()
            rms = w.square().mean().sqrt().item()
            err, rel_max, out_rms = max(err, e), max(rel_max, e / rms), max(out_rms, rms)
        bwd_fails, rel_l2, scaled = _bwd_fails(got, want, case["d"])
        check(math.isfinite(err), f"{name} {label}: non-finite error")
        if backward:
            check(not bwd_fails,
                  f"{name} {label}: rel L2 {rel_l2} (limit {TOL_GRAD_L2}), max per-vector "
                  f"err {scaled} (limit {TOL_GRAD_MAX}), max err over RMS {rel_max}")
        else:
            check(err <= TOL_KERNEL and rel_l2 <= TOL_KERNEL_L2 and rel_max <= TOL_KERNEL_MAX,
                  f"{name} {label}: max |kernel - plain| = {err} (limit {TOL_KERNEL}), rel L2 "
                  f"{rel_l2} (limit {TOL_KERNEL_L2}), max err over RMS {rel_max} (limit "
                  f"{TOL_KERNEL_MAX}; output RMS {out_rms})")
        vs_other = {}
        if "against" in case:
            tag, other = case["against"]
            other = other()[0].float()
            vs_other = {f"{tag}_rel_l2": _rel_l2(got[0], other), f"{tag}_max_err_over_rms": (
                (got[0] - other).abs().max() / other.square().mean().sqrt()).item()}
            check(vs_other[f"{tag}_rel_l2"] <= TOL_KERNEL_L2
                  and vs_other[f"{tag}_max_err_over_rms"] <= TOL_KERNEL_MAX,
                  f"{name} {label}: output against the other kernel's: {vs_other}")
            del other
        del got, again, want
        ms = cuda_ms(case["kernel"])
        plain_ms = cuda_ms(case["plain"], case.get("plain_reps", 20))
        library_ms = cuda_ms(case["library"]) if case["library"] else None
        by = {"bytes": case["bytes"] / HBM_BYTES_PER_S * 1e3,
              "operations": case["flops"] / BF16_FLOPS * 1e3,
              "exponentials": case["exps"] / EXPS_PER_S * 1e3}
        bound_by = max(by, key=by.get)
        bound_ms = by[bound_by]
        say("kernel", name=name, case=f"'{label}'", outputs=n_out,
            max_abs_err=f"{err:.3e}", max_err_over_rms=f"{rel_max:.3e}",
            out_rms=f"{out_rms:.3e}", rel_l2=f"{rel_l2:.3e}", max_vector_err=f"{scaled:.3e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
            **({} if library_ms is None else {"library_ms": f"{library_ms:.4f}"}),
            **{k: f"{x:.3e}" for k, x in vs_other.items()}, **_built(name, case))
        row = table[name]
        row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
        if case["headline"]:
            # The table's bound_by knows bytes and operations: an exponential
            # is an operation, of the kind that operation_kind names.
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by="bytes" if bound_by == "bytes" else "operations",
                       operation_kind={"operations": "bf16 tensor core",
                                       "exponentials": "exponentials"}.get(bound_by),
                       library_ms=library_ms)
            say("kernel", name=name, headline=f"'{label}'", bytes=case["bytes"],
                flops=case["flops"], tflops=f"{case['flops'] / ms / 1e9:.1f}",
                library_ms=f"{library_ms:.4f}",
                library_computes=case.get("library_is", CORE_ONLY))
        if "plan" in case and case["label"].startswith(f"S={SHAPES[0][0]} "):
            key = "packed_bwd_" if backward else (
                "nomax_packed" if name == "flash_nomax_packed" else "packed_fwd_")
            say("kernel", name=name, split=f"'{label}'", **_device_ms_by_kernel(
                torch, case["kernel"], key))


def phase_packed_fwd():
    """K1, K2 and K7 alone at every case `_kernel_cases` gives them: one call
    through the wrapper (CUDA events, median of 20) and the card's time in
    each kernel (torch.profiler). It reads no grid and nothing of how the
    kernels were built, so it also runs on a port from before the wgmma
    forwards: `vivid_tpu_torch/tools/smoke_phase.py packed_fwd --port DIR`
    times that port's K1/K2 and K7 at this checkout's cases. Not part of
    `main`: phase `kernels` holds and times the same cases."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case in _kernel_cases(torch, gen, plans=False):
        if case["name"] in ("flash_fused_packed", "flash_fused_packed_xattn",
                            "flash_nomax_packed"):
            say("packed_fwd", name=case["name"], case=f"'{case['label']}'",
                ms=f"{cuda_ms(case['kernel']):.4f}",
                **_device_ms_by_kernel(torch, case["kernel"], "packed"))


def _device_ms_by_kernel(torch, fn, key, reps=10, tries=3):
    """Device ms a call of `fn` spends in each kernel whose name holds `key`
    (torch.profiler over `reps` calls after a warm-up), keyed
    `<kernel>_device_ms`: the card's own time, without the host's launch. A
    profile now and then comes back with no device events at all (seen once
    in nine splits of one run), so an empty one is taken again, up to
    `tries` in all."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and key in e.name:
                kernel = e.name.split("::", 1)[-1].split("<")[0]
                out[kernel] = out.get(kernel, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
        if out:
            break
    check(out, f"the profiler saw no kernel named *{key}* in {tries} profiles")
    return {f"{k}_device_ms": f"{v:.4f}" for k, v in sorted(out.items())}


def main():
    import torch
    import vivid_tpu_torch  # noqa: F401  (fails here, before any output, without the repo)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2

    table = {
        "flash_fused_packed": dict(
            name="flash_fused_packed", route="cuda",
            source="vivid_tpu_torch/csrc/flash_packed.cu",
            replaces="vivid_tpu/kernels/flash.py:295"),
        "flash_fused_packed_xattn": dict(
            name="flash_fused_packed_xattn", route="cuda",
            source="vivid_tpu_torch/csrc/flash_packed.cu",
            replaces="vivid_tpu/kernels/flash.py:427"),
        "flash_fused_packed_bwd": dict(
            name="flash_fused_packed_bwd", route="cuda",
            source="vivid_tpu_torch/csrc/flash_packed_bwd.cu",
            replaces="vivid_tpu/kernels/flash.py:655"),
        "flash_fused_packed_xattn_bwd": dict(
            name="flash_fused_packed_xattn_bwd", route="cuda",
            source="vivid_tpu_torch/csrc/flash_packed_bwd.cu",
            replaces="vivid_tpu/kernels/flash.py:733"),
        "flash_nomax": dict(
            name="flash_nomax", route="cuda",
            source="vivid_tpu_torch/csrc/flash_nomax.cu",
            replaces="vivid_tpu/kernels/flash.py:969"),
        "flash_attention": dict(
            name="flash_attention", route="cuda",
            source="vivid_tpu_torch/csrc/flash_bwd.cu",
            replaces="vivid_tpu/kernels/attention.py:588"),
        "flash_attention_bwd": dict(
            name="flash_attention_bwd", route="cuda",
            source="vivid_tpu_torch/csrc/flash_bwd.cu",
            replaces="vivid_tpu/kernels/attention.py:588"),
        "flash_fused": dict(
            name="flash_fused", route="cuda",
            source="vivid_tpu_torch/csrc/flash_fused.cu",
            replaces="vivid_tpu/kernels/flash.py:791"),
        "flash_nomax_packed": dict(
            name="flash_nomax_packed", route="cuda",
            source="vivid_tpu_torch/csrc/flash_nomax_packed.cu",
            replaces="vivid_tpu/kernels/flash.py:1155"),
        "conv3x3_silu": dict(
            name="conv3x3_silu", route="cuda",
            source="vivid_tpu_torch/csrc/conv3x3_silu.cu",
            replaces="tools/fused_conv_lab.py:134"),
        "nomax_lab_attention": dict(
            name="nomax_lab_attention", route="cuda",
            source="vivid_tpu_torch/csrc/flash_nomax_lab.cu",
            replaces="tools/nomax_attn_lab.py:123"),
    }
    card = phase_device()
    timed("build", phase_build)
    timed("kernels", phase_kernels, table)
    timed("launches", phase_launches, card)
    timed("model", phase_model)
    timed("model_sr", phase_model_sr)
    timed("model_nomax", phase_model, nomax=True)
    timed("model_sr_nomax", phase_model_sr, nomax=True)
    nets, launches, sr_launches, nomax_launches = timed("slice", phase_slice, card)
    timed("metrics", phase_metrics, card, nets[:2])
    timed("compat", phase_compat, card, nets[:2])
    timed("depth", phase_depth, card, nets[1])
    for name, n in launches.items():
        if n:   # K1, K2: the guided 64px sampling path's count
            table[name]["launches"] = n
    table["flash_nomax"]["launches"] = sr_launches["flash_nomax"]   # the cascade's
    # K7: the same 64px path under VIVID_NOMAX_PACKED=1
    table["flash_nomax_packed"]["launches"] = nomax_launches["flash_nomax_packed"]
    for name, n in timed("train", phase_train, card).items():
        if name.endswith("_bwd"):   # the packed backward kernels: the 64px training path's
            table[name]["launches"] = n
    with tempfile.TemporaryDirectory(prefix="vivid_chip_smoke_keep_") as keep:
        for name, n in timed("train_sr", phase_train_sr, card, keep_dir=keep).items():
            if name.startswith("flash_attention"):   # K8: the SR training path's
                table[name]["launches"] = n
        timed("shell", run_shell_phase, os.path.join(keep, "vivid-sr.pkl"))
    for name, n in timed("labs", phase_labs).items():
        if name in ("flash_fused", "conv3x3_silu", "nomax_lab_attention"):
            table[name]["launches"] = n   # K5, K9, K10: the entries' and the labs' count
    for row in table.values():
        check(row.get("launches", 0) > 0 and "ms" in row,
              f"{row['name']}: no launch on its path, or no headline case: {row}")
    timed("entry", phase_entry, card)
    timed("trace", phase_trace, card, *nets[:2])
    timed("profile", phase_profile, *nets[:2])
    timed("profile_nomax", phase_profile, *nets[:2], nomax=True)
    timed("profile_sr", phase_profile_sr, nets[2])
    del nets
    timed("profile_train", phase_profile_train)
    timed("profile_train_sr", phase_profile_train_sr)
    timed("mem", phase_mem, card)
    overfit, overfit_log = start_overfit_phase()
    try:
        timed("dist", phase_dist, card)
    except BaseException:
        overfit.kill()
        overfit.wait()
        raise
    timed("overfit_after_dist", finish_overfit_phase, overfit, overfit_log)
    print(json.dumps({"kernels": list(table.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def timed(name, fn, *args, **kwargs):
    """fn(*args, **kwargs), with a line giving its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    say("time", phase=name, seconds=f"{time.perf_counter() - t0:.1f}")
    return out


def _full_width_config(uncond, **flags):
    from vivid_tpu_torch.nn.precond import PrecondConfig
    return PrecondConfig(img_resolution=64, model_channels=128, extra_attn=1, uncond=uncond,
                         use_bf16=True, remat=False, **flags)


def _full_width(uncond, conditioned=True, train=False, **flags):
    """vivid-base / vivid-uncond at the published widths (64px, ch=128,
    extra_attn=1, bf16) with random weights from a seed. A fresh init has
    every gain at 0, which makes F_x vanish (out_gain) and switches off the
    sigma conditioning of every block (emb_gain: c = 1). So out_gain is set
    to 1, and with `conditioned` the emb gains too. `train` leaves the net in
    training mode with every parameter asking for its gradient. No block is
    recomputed in a backward pass (remat off), as in the smoke's trainer runs.
    `flags` are more PrecondConfig fields (depth_input, warp_depth_coor)."""
    import torch
    from vivid_tpu_torch.nn.precond import NVPrecond
    net = NVPrecond(_full_width_config(uncond, **flags), device="cuda", seed=1 if uncond else 0)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("out_gain") or conditioned and name.endswith("emb_gain"):
                p.fill_(1.0)
    return net.train() if train else net.eval().requires_grad_(False)


def _rel_l2(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def _ulp_noise(y, gen):
    """y (bf16) moved by exactly one bf16 ulp, up or down at random, in every
    nonzero element: the size of the kernel's own error against its plain
    version (at most one ulp of the output)."""
    import torch
    y32 = y.float()
    ulp = torch.exp2(torch.floor(torch.log2(y32.abs())) - 7)   # 8 significant bits
    sign = torch.randint(0, 2, y.shape, generator=gen, device=y.device) * 2 - 1
    return (y32 + sign * ulp).to(y.dtype)


def _plain_chains(stack, noise_gen=None):
    """Inside `stack`, the blocks' elementwise chains run their plain
    versions (the composites) where they would launch kernels/mp_fused.py's
    kernels. With `noise_gen`, the control of the one kernel that does not
    give the composite's bits (`_check_mp_fused`): the pixel norm's xn moved
    by one bf16 ulp (`_ulp_noise`), as the control moves the attention
    outputs, and its mp_silu taken of that xn, as the kernel takes it of
    its own."""
    from unittest import mock
    from vivid_tpu_torch.kernels import mp_fused
    from vivid_tpu_torch.nn.mp import mp_silu

    def noisy_norm_silu(x, eps):
        xn = _ulp_noise(mp_fused.norm_silu_ref(x, eps)[0], noise_gen)
        return xn, mp_silu(xn)

    for wrapper, plain in (("_norm_silu_cuda", mp_fused.norm_silu_ref),
                           ("_scale_silu_cuda", mp_fused.scale_silu_ref),
                           ("_sum_clip_cuda", mp_fused.mp_sum_clip_ref),
                           ("_cat_silu_cuda", mp_fused.cat_silu_ref)):
        if noise_gen is not None and wrapper == "_norm_silu_cuda":
            plain = noisy_norm_silu
        stack.enter_context(mock.patch.object(mp_fused, wrapper, plain))


def phase_model(nomax=False, flags=None):
    """D_x of one NVPrecond call through the kernels against the same call
    through the plain versions, the blocks' elementwise chains included
    (their composites in place of kernels/mp_fused.py's kernels). The
    network amplifies any rounding-level change of the attention outputs,
    so the reading is held against a control (the plain versions with one
    ulp of noise on every output, the pixel norm's too: `_plain_chains`) as
    well as against TOL_MODEL; planted faults must fail the same gate. With
    `nomax` the whole runs under VIVID_NOMAX_PACKED=1 (emb gains at 1 only):
    every attention goes through the no-max packed kernel, the plain version
    is that kernel's, and the faults are planted in it. With `flags`
    (depth_input or warp_depth_coor) only vivid-base runs, with emb gains at
    1, its sources carrying a depth channel and its geometry near the
    codec's mean (a plausible pose, so that the warp stays finite)."""
    import contextlib
    from unittest import mock
    import torch
    from vivid_tpu_torch.kernels import flash
    names = ("flash_fused_packed", "flash_fused_packed_xattn", "flash_nomax_packed")
    k1, k2, k7 = (getattr(flash, n) for n in names)
    k1_ref, k2_ref, k7_ref = (getattr(flash, n + "_ref") for n in names)
    gen = torch.Generator(device="cuda").manual_seed(1)
    src = torch.randn(BATCH, 2, 64, 64, 3, generator=gen, device="cuda").clamp(-1, 1)
    dst = torch.randn(BATCH, 64, 64, 3, generator=gen, device="cuda")
    geo = torch.randn(BATCH, 2, 20, generator=gen, device="cuda")
    sigma = torch.ones(BATCH, device="cuda")
    if flags:
        depth = 1 + 4 * torch.rand(BATCH, 2, 64, 64, 1, generator=gen, device="cuda")
        src, geo = torch.cat([src, depth], dim=-1), 0.1 * geo
    noise_gen = torch.Generator(device="cuda")
    variants = {
        "plain": (k1_ref, k2_ref, k7_ref),
        "control": tuple((lambda *a, fn=fn: _ulp_noise(fn(*a), noise_gen))
                         for fn in (k1_ref, k2_ref, k7_ref)),
        "fault_one_source": (k1, lambda qkv, feats, h, biases=(), *eps: k2(qkv, feats[:1], h, biases[:1], *eps),
                             lambda qkv, feats, h, zero_sink=0, *eps: k7(qkv, feats[:1], h, zero_sink, *eps)),
        "fault_no_sink": (lambda qkv, h, zero_sink=0, *eps: k1(qkv, h, 0, *eps), k2,
                          lambda qkv, feats, h, zero_sink=0, *eps: k7(qkv, feats, h, 0, *eps)),
    }

    def run(net, variant=None):
        with contextlib.ExitStack() as stack:
            stack.enter_context(nomax_packed(nomax))
            for name, fn in zip(names, variants.get(variant, ())):
                stack.enter_context(mock.patch.object(flash, name, fn))
            if variant in ("plain", "control"):
                _plain_chains(stack, noise_gen if variant == "control" else None)
            noise_gen.manual_seed(2)
            with torch.no_grad():
                return net(src, dst, sigma, geo)

    want_params = {False: 250.65, True: 131.27}
    for uncond in (False,) if flags else (False, True):
        label = "vivid-uncond" if uncond else "vivid-base"
        label += "".join(f"+{k}" for k in flags or ())
        # The base model has no sink to drop; the uncond model has no cross source.
        fault = "fault_no_sink" if uncond else "fault_one_source"
        for conditioned in (True,) if nomax or flags else (False, True):
            net = _full_width(uncond, conditioned, **(flags or {}))
            n_params = sum(t.numel() for t in net.state_dict().values())
            check(flags or round(n_params / 1e6, 2) == want_params[uncond],
                  f"{label}: {n_params} parameters, want {want_params[uncond]}M")
            before = dict(flash.launches)
            got = run(net)
            used = {k: n - before[k] for k, n in flash.launches.items() if n - before[k]}
            want = run(net, "plain")
            control = _rel_l2(run(net, "control"), want)
            faulty = _rel_l2(run(net, fault), want)
            torch.cuda.synchronize()
            on_path = names[2:] if nomax else (names[:1] if uncond else names[:2])
            on_path = set(on_path) | set(_mp_per_eval(net.cfg))
            check(set(used) == on_path, f"{label}: the forward launched {used}")
            check(bool(torch.isfinite(got).all()), f"{label}: non-finite D_x")
            err = _rel_l2(got, want)
            gate = TOL_CONTROL * control
            if not conditioned:
                gate = min(gate, TOL_MODEL)
            weights = "emb_gains_1" if conditioned else "emb_gains_0"
            say("model", net=label, nomax_packed=nomax, weights=weights, params=n_params,
                params_M=f"{n_params / 1e6:.2f}", kernel_launches=used,
                d_x_rel_l2=f"{err:.3e}", control_rel_l2=f"{control:.3e}",
                ratio=f"{err / control:.3f}", gate=f"{gate:.3e}",
                fault=fault, fault_rel_l2=f"{faulty:.3e}")
            check(err <= gate, f"{label} {weights}: D_x kernels vs plain rel L2 "
                  f"{err} > {gate} (control {control})")
            check(faulty > gate, f"{label} {weights}: planted fault {fault} gives "
                  f"{faulty}, which passes the gate {gate}")
            del net
            torch.cuda.empty_cache()


def _sr_config(remat=False):
    from vivid_tpu_torch.nn.precond import PrecondConfig
    return PrecondConfig(img_resolution=256, super_res=True, num_sources=1, model_channels=64,
                         extra_attn=1, source_label_dim=20, target_label_dim=20,
                         noisy_sr=0.25, use_bf16=True, remat=remat)


def _full_width_sr(train=False, remat=False):
    """vivid-sr as its preset builds it (256px, super_res, one source, ch=64,
    extra_attn=1, 20/20 labels, noisy_sr 0.25, bf16) with random weights from
    a seed; out_gain and the emb gains set to 1, as in `_full_width`. `train`
    leaves the net in training mode with every parameter asking for its
    gradient; `remat` is the recompute mode of its blocks."""
    import torch
    from vivid_tpu_torch.nn.precond import NVPrecond
    net = NVPrecond(_sr_config(remat), device="cuda", seed=2)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(("out_gain", "emb_gain")):
                p.fill_(1.0)
    return net.train() if train else net.eval().requires_grad_(False)


def phase_model_sr(nomax=False):
    """`phase_model` for the 256px model: 57,550,915 parameters, and D_x of
    one NVPrecond call at batch 8 through K6, K1, K2 and the fused
    elementwise chains against the same call through their plain versions,
    held to TOL_CONTROL times the one-ulp control. The planted fault: the cross segment's keys dropped from K6
    wherever it is given more keys than queries. With `nomax` the whole runs
    under VIVID_NOMAX_PACKED=1: K7 takes the place of K1 and K2 at S = 1024."""
    import contextlib
    from unittest import mock
    import torch
    from vivid_tpu_torch.kernels import flash
    names = ("flash_fused_packed", "flash_fused_packed_xattn", "flash_nomax",
             "flash_nomax_packed")
    k6 = flash.flash_nomax
    refs = tuple(getattr(flash, n + "_ref") for n in names)
    noise_gen = torch.Generator(device="cuda")

    def self_keys_only(q, k, v, bias=None):
        sq = q.shape[2]
        return k6(q, k[:, :, :sq].contiguous(), v[:, :, :sq].contiguous(), bias)

    variants = {
        "plain": refs,
        "control": tuple((lambda *a, fn=fn, **kw: _ulp_noise(fn(*a, **kw), noise_gen))
                         for fn in refs),
        "fault_no_cross_keys": (flash.flash_fused_packed, flash.flash_fused_packed_xattn,
                                self_keys_only, flash.flash_nomax_packed),
    }
    gen = torch.Generator(device="cuda").manual_seed(8)
    src = torch.randn(BATCH, 1, 256, 256, 3, generator=gen, device="cuda").clamp(-1, 1)
    dst = torch.randn(BATCH, 256, 256, 3, generator=gen, device="cuda")
    cond = torch.randn(BATCH, 256, 256, 3, generator=gen, device="cuda").clamp(-1, 1)
    cond_noise = torch.randn(BATCH, 256, 256, 3, generator=gen, device="cuda")
    geo = torch.randn(BATCH, 1, 20, generator=gen, device="cuda")
    sigma = torch.ones(BATCH, device="cuda")
    net = _full_width_sr()
    n_params = sum(p.numel() for p in net.parameters())
    n_values = sum(t.numel() for t in net.state_dict().values())
    check(n_params == 57_550_915 and n_values == n_params + 512,
          f"vivid-sr: {n_params} parameters, {n_values} values with the Fourier buffers")

    def run(variant=None):
        with contextlib.ExitStack() as stack:
            stack.enter_context(nomax_packed(nomax))
            for name, fn in zip(names, variants.get(variant, ())):
                stack.enter_context(mock.patch.object(flash, name, fn))
            if variant in ("plain", "control"):
                _plain_chains(stack, noise_gen if variant == "control" else None)
            noise_gen.manual_seed(2)
            with torch.no_grad():
                return net(src, dst, sigma, geo, conditioning_image=cond, cond_noise=cond_noise)

    before = dict(flash.launches)
    got = run()
    used = {k: n - before[k] for k, n in flash.launches.items() if n - before[k]}
    want = run("plain")
    control = _rel_l2(run("control"), want)
    faulty = _rel_l2(run("fault_no_cross_keys"), want)
    torch.cuda.synchronize()
    per_eval = _sr_per_eval(nomax)
    check(used == per_eval, f"vivid-sr: one forward launched {used}, want {per_eval}")
    check(bool(torch.isfinite(got).all()), "vivid-sr: non-finite D_x")
    err = _rel_l2(got, want)
    gate = TOL_CONTROL * control
    say("model", net="vivid-sr", nomax_packed=nomax, weights="emb_gains_1", params=n_params,
        params_M=f"{n_params / 1e6:.2f}", batch=BATCH, kernel_launches=used,
        d_x_rel_l2=f"{err:.3e}", control_rel_l2=f"{control:.3e}",
        ratio=f"{err / control:.3f}", gate=f"{gate:.3e}",
        fault="fault_no_cross_keys", fault_rel_l2=f"{faulty:.3e}")
    check(err <= gate, f"vivid-sr: D_x kernels vs plain rel L2 {err} > {gate} (control {control})")
    check(faulty > gate, f"vivid-sr: the planted fault gives {faulty}, which passes the gate {gate}")
    del net
    torch.cuda.empty_cache()


def phase_slice(card):
    import PIL.Image
    import torch
    from vivid_tpu_torch.data.scenes import make_synthetic_dataset
    from vivid_tpu_torch.generate import generate_images_nvs
    from vivid_tpu_torch.kernels import flash
    from vivid_tpu_torch.nn.unet import attention_feature_spec
    from vivid_tpu_torch.train.snapshots import load_snapshot, save_snapshot

    steps, seeds = 32, list(range(8))
    with tempfile.TemporaryDirectory(prefix="vivid_chip_smoke_") as tmp:
        paths = {}
        for uncond in (False, True):
            paths[uncond] = os.path.join(tmp, f"{'uncond' if uncond else 'base'}.pkl")
            net = _full_width(uncond)
            save_snapshot(paths[uncond], net)
            del net
        data = make_synthetic_dataset(os.path.join(tmp, "scenes"), num_scenes=8,
                                      num_views=8, imsize=64, seed=0)
        t0 = time.perf_counter()
        base = load_snapshot(paths[False], device="cuda")
        gnet = load_snapshot(paths[True], device="cuda")
        torch.cuda.synchronize()
        say("slice", load_s=f"{time.perf_counter() - t0:.2f}")
        # Per guided evaluation: the encoder's and the unconditional model's
        # self-attentions, the denoiser's cross-attentions; nothing else
        # (no_grad, 64px only). With VIVID_NOMAX_PACKED=1 K7 takes them all.
        n_self = (len(attention_feature_spec(base.cfg.encoder_cfg))
                  + len(attention_feature_spec(gnet.cfg.unet_cfg)))
        n_cross = len(attention_feature_spec(base.cfg.unet_cfg))
        mp = _mp_per_eval(base.cfg, gnet.cfg)
        per_eval_by_run = {
            False: {"flash_fused_packed": n_self, "flash_fused_packed_xattn": n_cross, **mp},
            True: {"flash_nomax_packed": n_self + n_cross, **mp}}
        evals = 2 * steps - 1
        for run in ("cold", "warm", "nomax_packed"):
            nomax = run == "nomax_packed"
            per_eval = per_eval_by_run[nomax]
            outdir = os.path.join(tmp, f"out_{run}")
            for name in flash.launches:
                flash.launches[name] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with nomax_packed(nomax):
                batches = list(generate_images_nvs(
                    net=base, gnet=gnet, guidance=1.5, seeds=seeds, max_batch_size=8,
                    num_steps=steps, outdir=outdir, datakwargs={"path": data},
                    device="cuda", verbose=False))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(flash.launches)
            if run == "cold":
                counted = dict(launches)
            elif nomax:
                nomax_counted = dict(launches)
            for name, n in launches.items():
                check(n == per_eval.get(name, 0) * evals,
                      f"{run}: {name}: {n} launches, want {per_eval.get(name, 0)} x {evals}")
            files = sorted(os.listdir(outdir))
            want_files = sorted(f"{p}_{s:06d}.png" for p in ("src", "tgt", "sample")
                                for s in seeds)
            check(files == want_files, f"PNGs written: {files}")
            images = [b.images for b in batches]
            check(len(batches) == 1 and images[0].shape == (8, 64, 64, 3),
                  f"image batches {[i.shape for i in images]}")
            lat = batches[0].latents
            check(bool(torch.isfinite(lat).all()), "non-finite latents")
            check(float(images[0].astype(float).std()) > 0, "constant images")
            say("slice", run=run, seconds=f"{seconds:.3f}",
                images_per_s=f"{len(seeds) / seconds:.3f}", pngs=len(files),
                launches={k: n for k, n in launches.items() if n}, per_eval=per_eval,
                evals=evals,
                latents_absmax=f"{lat.abs().max().item():.3f}", card=f"'{card}'")

        # The base -> SR cascade on 256px scenes, nothing cut: the same guided
        # 32-step base sampling, then 32 steps of full-width vivid-sr on the
        # upsampled samples; then the SR model alone with fewer steps.
        sr_path = os.path.join(tmp, "sr.pkl")
        save_snapshot(sr_path, _full_width_sr())
        sr = load_snapshot(sr_path, device="cuda")
        data256 = make_synthetic_dataset(os.path.join(tmp, "scenes256"), num_scenes=8,
                                         num_views=8, imsize=256, seed=0)
        want_files = sorted(f"{p}_{s:06d}.png" for p in ("src", "tgt", "sample") for s in seeds)
        sr_only_steps = 4
        cascade = dict(net=base, gnet=gnet, guidance=1.5, sr_model=sr)
        runs = [("cascade_cold", steps, cascade),   # no warm repeat, as above
                ("sr_only", sr_only_steps, dict(net=sr, vanilla_mode=True)),
                ("cascade_nomax_packed", sr_only_steps, cascade)]
        for run, n_steps, models in runs:
            nomax = run == "cascade_nomax_packed"
            outdir = os.path.join(tmp, f"out_{run}")
            n_evals = 2 * n_steps - 1
            per_sr_eval = _sr_per_eval(nomax)
            per_eval = per_eval_by_run[nomax]
            want = {name: per_sr_eval.get(name, 0) * n_evals for name in flash.launches}
            if run != "sr_only":
                want = {name: n + per_eval.get(name, 0) * n_evals for name, n in want.items()}
            for name in flash.launches:
                flash.launches[name] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with nomax_packed(nomax):
                batches = list(generate_images_nvs(
                    seeds=seeds, max_batch_size=8, num_steps=n_steps, outdir=outdir,
                    datakwargs={"path": data256}, device="cuda", verbose=False, **models))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(flash.launches)
            if run == "cascade_cold":
                sr_counted = dict(launches)
            check(launches == want, f"{run}: launches {launches}, want {want}")
            check(sorted(os.listdir(outdir)) == want_files, f"{run}: PNGs {os.listdir(outdir)}")
            sizes = {PIL.Image.open(os.path.join(outdir, f)).size for f in want_files}
            check(sizes == {(256, 256)}, f"{run}: PNG sizes {sizes}")
            b = batches[0]
            check(len(batches) == 1 and b.images.shape == (8, 256, 256, 3)
                  and b.src.shape == b.tgt.shape == (8, 256, 256, 3),
                  f"{run}: images {b.images.shape}, src {b.src.shape}, tgt {b.tgt.shape}")
            check(bool(torch.isfinite(b.latents).all()), f"{run}: non-finite latents")
            check(float(b.images.astype(float).std()) > 0, f"{run}: constant images")
            say("slice", run=run, steps=n_steps, seconds=f"{seconds:.3f}",
                images_per_s=f"{len(seeds) / seconds:.3f}", pngs=len(want_files),
                png_size="256x256", launches={k: n for k, n in launches.items() if n},
                per_sr_eval=per_sr_eval, sr_evals=n_evals,
                peak_memory_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
                latents_absmax=f"{b.latents.abs().max().item():.3f}", card=f"'{card}'")
    return (base.net, gnet.net, sr.net), counted, sr_counted, nomax_counted


def _write_re10k_tree(root, splits, num_frames=64, w=640, h=360, seed=0):
    """A seeded RealEstate10K-layout tree of `w` x `h` PNG frames: per
    split, sequences whose camera pans across a smooth texture, and their
    camera files (a URL line, then timestamp, normalised intrinsics, two
    zeros, a 3 x 4 world-to-camera pose a frame). Returns the frame count."""
    import concurrent.futures
    import numpy as np
    import PIL.Image
    rng = np.random.RandomState(seed)

    def smooth(cells_h, cells_w, hh, ww):
        grid = (rng.rand(cells_h, cells_w, 3) * 255).astype(np.uint8)
        return np.asarray(PIL.Image.fromarray(grid).resize((ww, hh), PIL.Image.BICUBIC),
                          np.float32)

    jobs = []
    for split, num_seqs in splits.items():
        os.makedirs(os.path.join(root, "RealEstate10K", split), exist_ok=True)
        for s in range(num_seqs):
            seq = f"{split}{s:03d}"
            os.makedirs(os.path.join(root, split, seq), exist_ok=True)
            big = np.clip(0.8 * smooth(6, 10, h + 2 * num_frames, w + 3 * num_frames)
                          + 0.2 * smooth(48, 80, h + 2 * num_frames, w + 3 * num_frames),
                          0, 255).astype(np.uint8)
            lines = ["https://example.com/video"]
            for f in range(num_frames):
                ts = str(100000 + 33367 * f)
                a = 0.004 * f + 0.3 * s
                c, si = math.cos(a), math.sin(a)
                pose = [c, 0, si, 0.02 * f, 0, 1, 0, 0.005 * f, -si, 0, c, 0.01 * f]
                lines.append(" ".join([ts, "0.92", "1.64", "0.5", "0.5", "0", "0"]
                                      + [f"{v:.6f}" for v in pose]))
                jobs.append((big[2 * f:2 * f + h, 3 * f:3 * f + w],
                             os.path.join(root, split, seq, ts + ".png")))
            with open(os.path.join(root, "RealEstate10K", split, seq + ".txt"), "w") as fh:
                fh.write("\n".join(lines))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: PIL.Image.fromarray(job[0]).save(job[1], compress_level=1),
                      jobs))
    return len(jobs)


@contextlib.contextmanager
def _environ(**values):
    """Environment variables set for the block, then put back."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _random_dinov2_checkpoint(path, seed=0):
    """An original-naming ViT-L/14 state dict with a 37 x 37 + 1 position
    grid (518 px, as the released checkpoint), seeded; saved at `path`."""
    import torch
    from vivid_tpu_torch.nn.dinov2 import VIT_SIZES, expected_vit_shapes
    cfg = VIT_SIZES["vitl"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sd = {}
    for name, shape in expected_vit_shapes(cfg, num_tokens=37 * 37 + 1).items():
        fan_in = shape[1] * (shape[2] * shape[3] if len(shape) == 4 else 1) \
            if len(shape) >= 2 and not name.endswith(("_token", "pos_embed")) else 1
        v = torch.randn(shape, generator=gen, device="cuda") / math.sqrt(fan_in)
        if name.endswith(("norm1.weight", "norm2.weight", "norm.weight")):
            v = 1.0 + 0.1 * v
        elif name.endswith("gamma"):
            v = 0.5 + 0.1 * v
        elif name.endswith("bias"):
            v = 0.02 * v
        sd[name] = v.cpu()
    sd["mask_token"] = torch.zeros(1, cfg.embed_dim)   # in the released file; unused
    torch.save(sd, path)
    return sd


def phase_metrics(card, nets=None):
    """The RealEstate10K reader and the metrics at full width: a seeded
    synthetic RealEstate10K tree of 640 x 360 PNG frames; the reader's rows/s
    through DualSourceCollate on the host; the full-width InceptionV3
    (bf16, channels-last) and ViT-L/14 (bf16 autocast) held to the same
    modules in fp32 on the card, with three planted faults (a half-pixel
    resize for TF1's, average pools counting their padding, the position
    grid cropped instead of interpolated) that must fail the gate; then
    `calculate_metrics gen` with the five metrics on `vivid-base` guided by
    `vivid-uncond` (the `slice` phase's full-width nets, or the same from
    their seeds), 16 images at batch 8, K1/K2 at the planned launches, and
    `calc` of its PNGs against its `--dest` statistics; then a `--metrics`
    tick of a 3-step full-width `vivid-base` run (the tick at 96 nimg, its
    `Metrics/` rows in the next status row of stats.jsonl). Detectors on
    seeded random weights: Inception under VIVID_ALLOW_RANDOM_DETECTOR=1,
    its convs He-scaled as the gate's so that its features see the input,
    the ViT from a random original-naming checkpoint in a temporary
    VIVID_DETECTOR_DIR."""
    import json as _json
    import numpy as np
    import torch
    from vivid_tpu_torch.cli import calculate_metrics, train_nvs
    from vivid_tpu_torch.data.collate import BatchLoader, DualSourceCollate, default_loader_threads
    from vivid_tpu_torch.data.re10k_scenes import open_scene_dataset
    from vivid_tpu_torch.kernels import flash
    from vivid_tpu_torch.metrics import api, detectors, frechet, inception
    from vivid_tpu_torch.metrics.dinov2 import dinov2_features
    from vivid_tpu_torch.nn.dinov2 import DinoViT
    from vivid_tpu_torch.nn.unet import attention_feature_spec
    from vivid_tpu_torch.train.snapshots import save_snapshot

    if nets is None:
        nets = (_full_width(uncond=False), _full_width(uncond=True))
    base, gnet = nets
    with tempfile.TemporaryDirectory(prefix="vivid_chip_smoke_metrics_") as tmp:
        tree = os.path.join(tmp, "re10k")
        t0 = time.perf_counter()
        n_frames = _write_re10k_tree(tree, {"train": 8, "test": 2})
        say("metrics", tree_frames=n_frames, frame="640x360", sequences="8_train_2_test",
            frames_per_sequence=64, write_s=f"{time.perf_counter() - t0:.2f}")

        # The reader: RealEstate10K scenes (whole or 'mid' frame range) ->
        # dual-source 64px rows (3 PNG decodes, crops and resizes a row), batch
        # 8, with one host thread and with the default thread count: windows
        # of READER_WINDOW_ROWS each, over the 8 train sequences; the median window's
        # rate and the spread. Both give the same batches.
        for rs in (None, "mid"):
            first = None
            for threads in (1, default_loader_threads()):
                loader = BatchLoader(iter(open_scene_dataset(tree, seed=0, range_selection=rs)),
                                     DualSourceCollate(64, seed=0), batch_size=BATCH,
                                     num_threads=threads)
                head = next(loader)
                if first is None:
                    first = head
                check(all(np.array_equal(head[k], first[k]) for k in first),
                      f"reader: {threads} threads give another first batch than 1")
                rates = []
                for _ in range(READER_WINDOWS):
                    t0 = time.perf_counter()
                    for _ in range(READER_WINDOW_ROWS // BATCH):
                        batch = next(loader)
                    rates.append(READER_WINDOW_ROWS / (time.perf_counter() - t0))
                    check(batch["src_image"].shape == (BATCH, 2, 64, 64, 3)
                          and np.isfinite(batch["geometry"]).all(), "reader: batch")
                loader.close()
                say("metrics", reader=f"range_{rs}", rows=READER_WINDOWS * READER_WINDOW_ROWS,
                    windows=READER_WINDOWS, batch=BATCH,
                    rows_per_s=f"{statistics.median(rates):.1f}",
                    rows_per_s_min_max=f"{min(rates):.1f}-{max(rates):.1f}", threads=threads,
                    host_cpus=os.cpu_count(), card=f"'{card}'")

        detector_dir = os.path.join(tmp, "detectors")
        ckpt = os.path.join(detector_dir, "torch_hub", "checkpoints", "dinov2_vitl14_pretrain.pth")
        os.makedirs(os.path.dirname(ckpt))
        sd = _random_dinov2_checkpoint(ckpt)
        with _environ(VIVID_DETECTOR_DIR=detector_dir, VIVID_ALLOW_RANDOM_DETECTOR="1"):
            detectors._detector_cache.clear()
            inc = detectors.get_detector("fid")
            vitd = detectors.get_detector("fd_dinov2")
            check(inc.model.use_bf16 and inc.device.type == "cuda", "InceptionV3 not bf16 on the card")
            gen = torch.Generator().manual_seed(11)
            imgs = torch.randint(0, 256, (BATCH, 64, 64, 3), generator=gen, dtype=torch.uint8)
            imgs_dev = imgs.cuda()

            # InceptionV3: bf16 channels-last vs the same weights in fp32. The
            # random mode's draw (init_params' scales) leaves pool3 almost
            # blind to its input (each ReLU layer halves the signal, the batch
            # norms' beta stays): the cached detector's draw gets every conv
            # scaled by sqrt(2) (He's gain) and the norms' mean and beta at 0,
            # so that the input reaches pool3, in the gate and in `gen` and
            # `calc` below, which use that detector.
            inc16 = inc.model
            with torch.no_grad():
                for conv in inc16.convs.values():
                    conv.weight.mul_(math.sqrt(2.0))
                    conv.mean.zero_()
                    conv.beta.zero_()
            inc32 = inception.InceptionV3(use_bf16=False, device="cuda").eval()
            inc32.load_state_dict(inc16.state_dict())
            want = inc32(imgs_dev)
            real_resize, real_pool = inception.tf1_resize_bilinear, inception.pool

            def half_pixel(x, h, w):
                return torch.nn.functional.interpolate(
                    x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                    align_corners=False).permute(0, 2, 3, 1)

            def pool_counting_padding(kind, x, k, stride, pad):
                if kind == "avg" and pad == "SAME":
                    return torch.nn.functional.avg_pool2d(
                        x.float(), k, stride, padding=(k[0] // 2, k[1] // 2),
                        count_include_pad=True).to(x.dtype)
                return real_pool(kind, x, k, stride, pad)

            errs = {"inception": _rel_l2(inc16(imgs_dev), want),
                    "inception_between_images": _rel_l2(want[1:], want[:-1])}
            try:
                inception.tf1_resize_bilinear = half_pixel
                errs["inception_fault_half_pixel_resize"] = _rel_l2(inc16(imgs_dev), want)
            finally:
                inception.tf1_resize_bilinear = real_resize
            try:
                inception.pool = pool_counting_padding
                errs["inception_fault_pools_count_padding"] = _rel_l2(inc16(imgs_dev), want)
            finally:
                inception.pool = real_pool
            check(inception.tf1_resize_bilinear is real_resize and inception.pool is real_pool,
                  "inception: a planted fault left in place")

            # ViT-L/14: bf16 autocast vs fp32, the checkpoint's 37 x 37 grid
            # interpolated to 16 x 16; the fault crops it instead.
            vit = vitd.model
            check(vit.pos_embed.shape == (1, 257, 1024) and len(vit.blocks) == 24,
                  f"ViT: pos_embed {tuple(vit.pos_embed.shape)}, {len(vit.blocks)} blocks")
            want_v = dinov2_features(vit, imgs_dev, use_bf16=False)
            errs["vit"] = _rel_l2(dinov2_features(vit, imgs_dev, use_bf16=True), want_v)
            cropped = DinoViT(vit.cfg, grid=16, device="cuda").eval().requires_grad_(False)
            cropped.load_state_dict(vit.state_dict())
            grid = sd["pos_embed"][0, 1:].reshape(37, 37, -1)[:16, :16].reshape(256, -1)
            with torch.no_grad():
                cropped.pos_embed[0, 1:].copy_(grid.cuda())
            errs["vit_fault_position_grid_not_interpolated"] = _rel_l2(
                dinov2_features(cropped, imgs_dev, use_bf16=True), want_v)
            del cropped, inc32
            say("metrics", gate_rel_l2=f"{{inception {TOL_INCEPTION}, vit {TOL_VIT}}}",
                **{k: f"{v:.3e}" for k, v in errs.items()})
            check(errs["inception"] <= TOL_INCEPTION, f"InceptionV3 bf16 vs fp32: {errs}")
            check(errs["vit"] <= TOL_VIT, f"ViT bf16 vs fp32: {errs}")
            for name, err in errs.items():
                if "fault" in name:
                    check(err > (TOL_INCEPTION if name.startswith("inception") else TOL_VIT),
                          f"planted fault {name} passed the gate: {err:.3e}")

            # Each detector on a batch of 8: the card's busy time (the sum of
            # its kernels, torch.profiler) and CUDA events around the module
            # on card tensors (launch gaps included), and wall time (numpy in,
            # numpy out).
            imgs_np = imgs.numpy()
            for name, det, device_fn in (
                    ("inception_bf16", inc, lambda: inc.model(imgs_dev)),
                    ("vit_l14_bf16", vitd, lambda: dinov2_features(vit, imgs_dev, True))):
                events_ms = cuda_ms(device_fn)
                busy = _device_ms_by_kernel(torch, device_fn, "")
                wall = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    f = det(imgs_np)
                    wall.append((time.perf_counter() - t0) * 1e3)
                check(f.shape == (BATCH, det.feature_dim) and np.isfinite(f).all(),
                      f"{name}: features {f.shape}")
                say("metrics", detector=name, batch=BATCH,
                    device_busy_ms=f"{sum(float(v) for v in busy.values()):.3f}",
                    kernels=len(busy), events_ms=f"{events_ms:.3f}",
                    wall_ms=f"{statistics.median(wall):.3f}", card=f"'{card}'")

            # calculate_metrics gen: guided full-width sampling on the tree,
            # the five metrics, PNGs and the generated images' statistics.
            snaps = []
            for name, net in (("base", base), ("uncond", gnet)):
                snaps.append(os.path.join(tmp, f"{name}.pkl"))
                save_snapshot(snaps[-1], net)
            outdir, dest = os.path.join(tmp, "gen"), os.path.join(tmp, "gen_stats.pkl")
            five = "fid,joint_fid,fd_dinov2,joint_fd_dinov2,psnr"
            n_images, n_batches, evals = 16, 2, 63
            n_self = (len(attention_feature_spec(base.cfg.encoder_cfg))
                      + len(attention_feature_spec(gnet.cfg.unet_cfg)))
            n_cross = len(attention_feature_spec(base.cfg.unet_cfg))
            want_l = {"flash_fused_packed": n_self * evals * n_batches,
                      "flash_fused_packed_xattn": n_cross * evals * n_batches,
                      **{k: n * evals * n_batches
                         for k, n in _mp_per_eval(base.cfg, gnet.cfg).items()}}
            frechet_s = []   # (dimension, seconds) of each Fréchet distance, host

            def timed_frechet(mu1, *args):
                t_f = time.perf_counter()
                value = real_frechet(mu1, *args)
                frechet_s.append((len(mu1), time.perf_counter() - t_f))
                return value

            real_frechet, frechet.frechet_distance = frechet.frechet_distance, timed_frechet
            for name in flash.launches:
                flash.launches[name] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = calculate_metrics.cmdline(
                ["gen", "--net", snaps[0], "--gnet", snaps[1], "--guidance", "1.5",
                 "--data", tree, "--metrics", five, "--num", str(n_images), "--batch",
                 str(BATCH), "--range-selection", "mid", "--outdir", outdir, "--dest", dest],
                standalone_mode=False)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            frechet.frechet_distance = real_frechet
            launches = {k: n for k, n in flash.launches.items() if n}
            check(launches == want_l, f"gen: launches {launches}, want {want_l}")
            check(sorted(results) == sorted(five.split(","))
                  and all(math.isfinite(v) for v in results.values()), f"gen: {results}")
            pngs = sorted(os.listdir(outdir))
            check(len(pngs) == 3 * n_images, f"gen: {len(pngs)} PNGs")
            fd_seconds = sum(t for _, t in frechet_s)
            say("metrics", run="gen", images=n_images, batch=BATCH, seconds=f"{seconds:.3f}",
                images_per_s=f"{n_images / seconds:.3f}",
                frechet_host_s=[f"{d}d:{t:.2f}" for d, t in frechet_s],
                images_per_s_without_frechet=f"{n_images / (seconds - fd_seconds):.3f}",
                launches=launches,
                results={k: f"{v:.6g}" for k, v in results.items()}, card=f"'{card}'")
            again = calculate_metrics.cmdline(
                ["calc", "--images", outdir, "--metrics", "fid,fd_dinov2", "--ref", dest,
                 "--batch", str(BATCH)], standalone_mode=False)
            for m in ("fid", "fd_dinov2"):
                check(abs(again[m]) * 100 <= results[m],
                      f"calc against gen's own statistics: {m} {again[m]} vs gen's {results[m]}")
            say("metrics", run="calc_vs_dest", **{m: f"{v:.6g}" for m, v in again.items()})

            # A metrics tick of the trainer: 3 steps of full-width vivid-base
            # (batch 8 of the preset's 1024) on the tree's train split, the
            # tick at 96 nimg over its test split (unguided samples of EMA 0
            # at batch 25: 25 of the trainer's 100, a cut to the smoke's
            # time), FID and PSNR.
            run_dir = os.path.join(tmp, "train")
            tick_launches = []

            def counted(*args, **kw):
                for name in flash.launches:
                    flash.launches[name] = 0
                out = real_get_metrics(*args, **dict(kw, num_images=TICK_IMAGES))
                tick_launches.append({k: n for k, n in flash.launches.items() if n})
                return out

            real_get_metrics, api.get_metrics = api.get_metrics, counted
            try:
                t0 = time.perf_counter()
                train_nvs.cmdline(
                    ["--preset", "vivid-base", "--data", tree, "--test-data-path", tree,
                     "--outdir", run_dir, "--batch", str(BATCH), "--max-steps", "3",
                     "--status", "48", "--metrics", "96", "--metrics-list", "fid,psnr",
                     "--snapshot", "0", "--checkpoint", "0", "--samples", "0"],
                    standalone_mode=False)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            finally:
                api.get_metrics = real_get_metrics
        exp = os.path.join(run_dir, "experiments")
        log = open(os.path.join(exp, "log.txt")).read()
        rows = [_json.loads(l) for l in open(os.path.join(exp, "metrics.jsonl"))]
        status = [_json.loads(l) for l in open(os.path.join(exp, "stats.jsonl"))]
        per_eval = {"flash_fused_packed": len(attention_feature_spec(base.cfg.encoder_cfg)),
                    "flash_fused_packed_xattn": n_cross, **_mp_per_eval(base.cfg)}
        want_t = {k: n * evals * (-(-TICK_IMAGES // 25)) for k, n in per_eval.items()}
        check(tick_launches == [want_t], f"tick: launches {tick_launches}, want [{want_t}]")
        check(log.count("Metrics: {") == 1 and len(rows) == 1 and rows[0]["nimg"] == 96
              and all(math.isfinite(rows[0][k]) for k in ("fid", "psnr")),
              f"tick: metrics.jsonl {rows}, log:\n{log[-3000:]}")
        check(len(status) == 4 and status[3].get("Metrics/fid") == rows[0]["fid"]
              and status[3].get("Metrics/psnr") == rows[0]["psnr"]
              and "Metrics/fid" not in status[2], f"tick: stats.jsonl {status}")
        say("metrics", run="train_tick", steps=3, tick_nimg=96, images=TICK_IMAGES,
            seconds=f"{seconds:.2f}",
            fid=f"{rows[0]['fid']:.6g}", psnr=f"{rows[0]['psnr']:.4f}",
            launches=tick_launches[0], card=f"'{card}'")
    detectors._detector_cache.clear()
    torch.cuda.empty_cache()


def phase_compat(card, nets=None):
    """Reference pickles at full width: `vivid-base` and `vivid-uncond` (the
    `slice` phase's nets, or the same from their seeds) exported to
    reference-format fp16 pickles through a stand-in reference checkout
    (vivid_tpu_torch/tools/ref_standin.py, written to a temporary
    directory), and as v1 snapshots; both loaded back on the card through
    `load_snapshot`, with their load times. The reference pickle's config
    (extract_config) must be the net's in every field the reference records,
    and its weights the v1 snapshot's bit for bit (both store fp16 and load
    fp32). Then 8 guided images, 8 steps, guidance 1.5, from the reference
    pickles and from the v1 snapshots: K1/K2 at the planned launches, and
    the images and latents bitwise equal. Returns the reference run's
    launch counts."""
    import numpy as np
    import torch
    from vivid_tpu_torch.compat.torch_export import config_to_init_kwargs, export_reference_pickle
    from vivid_tpu_torch.data.scenes import make_synthetic_dataset
    from vivid_tpu_torch.generate import generate_images_nvs
    from vivid_tpu_torch.kernels import flash
    from vivid_tpu_torch.nn.unet import attention_feature_spec
    from vivid_tpu_torch.tools.ref_standin import write_reference_standin
    from vivid_tpu_torch.train.snapshots import load_snapshot, save_snapshot

    if nets is None:
        nets = (_full_width(uncond=False), _full_width(uncond=True))
    steps, seeds = 8, list(range(8))   # of the sampler's 32 (a cut for time)
    recorded = [k for k in config_to_init_kwargs(nets[0].cfg) if k != "use_fp16"]
    with tempfile.TemporaryDirectory(prefix="vivid_chip_smoke_compat_") as tmp:
        root = write_reference_standin(os.path.join(tmp, "reference"))
        data = make_synthetic_dataset(os.path.join(tmp, "scenes"), num_scenes=8,
                                      num_views=8, imsize=64, seed=0)
        loaded = {"reference": [], "v1": []}
        for label, net in zip(("vivid-base", "vivid-uncond"), nets):
            v1, ref = (os.path.join(tmp, f"{label}.{kind}.pkl") for kind in ("v1", "ref"))
            t0 = time.perf_counter()
            save_snapshot(v1, net)
            v1_save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            export_reference_pickle(ref, net.state_dict(), net.cfg, reference_root=root,
                                    dataset_kwargs={"path": data})
            export_s = time.perf_counter() - t0
            times = {}
            # The reference pickle twice: the first read also runs its
            # embedded source; the second is timed as a warm load.
            for kind, path in (("reference", ref), ("v1", v1), ("reference_again", ref)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                snap = load_snapshot(path, device="cuda")
                torch.cuda.synchronize()
                times[kind] = time.perf_counter() - t0
                if kind in loaded:
                    loaded[kind].append(snap)
            del snap
            back, same = loaded["reference"][-1], loaded["v1"][-1]
            got = {k: getattr(back.cfg, k) for k in recorded}
            want = {k: getattr(net.cfg, k) for k in recorded}
            check(got == want, f"{label}: extract_config gives {got}, want {want}")
            a, b = back.net.state_dict(), same.net.state_dict()
            check(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
                  f"{label}: the reference pickle's weights are not the v1 snapshot's")
            check(back.dataset_kwargs == {"path": data}, f"{label}: {back.dataset_kwargs}")
            n_values = sum(t.numel() for t in a.values())
            say("compat", net=label, values=n_values, values_M=f"{n_values / 1e6:.2f}",
                export_s=f"{export_s:.2f}", v1_save_s=f"{v1_save_s:.2f}",
                pickle_GB=f"{os.path.getsize(ref) / 1e9:.3f}",
                v1_GB=f"{os.path.getsize(v1) / 1e9:.3f}",
                load_reference_s=f"{times['reference']:.2f}",
                load_reference_again_s=f"{times['reference_again']:.2f}",
                load_v1_s=f"{times['v1']:.2f}",
                same_config_fields=len(recorded), same_weights=True, card=f"'{card}'")

        base_cfg, gnet_cfg = nets[0].cfg, nets[1].cfg
        per_eval = {"flash_fused_packed": len(attention_feature_spec(base_cfg.encoder_cfg))
                    + len(attention_feature_spec(gnet_cfg.unet_cfg)),
                    "flash_fused_packed_xattn": len(attention_feature_spec(base_cfg.unet_cfg)),
                    **_mp_per_eval(base_cfg, gnet_cfg)}
        evals = 2 * steps - 1
        out = {}
        for kind in ("reference", "v1"):
            base, gnet = loaded[kind]
            for name in flash.launches:
                flash.launches[name] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (batch,) = generate_images_nvs(net=base, gnet=gnet, guidance=1.5, seeds=seeds,
                                           max_batch_size=8, num_steps=steps,
                                           datakwargs={"path": data}, device="cuda",
                                           verbose=False)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {k: n for k, n in flash.launches.items() if n}
            check(launches == {k: n * evals for k, n in per_eval.items()},
                  f"compat {kind}: launches {launches}, want {per_eval} x {evals}")
            check(bool(torch.isfinite(batch.latents).all())
                  and float(batch.images.astype(float).std()) > 0,
                  f"compat {kind}: non-finite latents or constant images")
            out[kind] = (batch, launches)
            say("compat", run=f"sample_from_{kind}", steps=steps, seconds=f"{seconds:.3f}",
                images_per_s=f"{len(seeds) / seconds:.3f}", launches=launches,
                per_eval=per_eval, evals=evals, card=f"'{card}'")
        (a, launches), (b, _) = out["reference"], out["v1"]
        check(np.array_equal(a.images, b.images) and torch.equal(a.latents, b.latents),
              "compat: the reference pickles' samples are not the v1 snapshots' bit for bit")
        say("compat", images_bitwise_equal=True, images=a.images.shape[0])
    return launches


def _random_depth_checkpoint(path, size, seed=0):
    """An original-naming DepthAnythingV2 `size` checkpoint with a 37 x 37 +
    1 position grid (518 px, as the released files), seeded; weights scaled
    by 1 / sqrt(fan-in) (so that the depth map depends on its input), norms
    near 1, layer scales near 0.5, biases small. Saved at `path`."""
    import torch
    from vivid_tpu_torch.geometry.depth_anything import SIZES, expected_state_dict_shapes
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sd = {}
    for name, shape in expected_state_dict_shapes(SIZES[size]).items():
        v = torch.randn(shape, generator=gen, device="cuda")
        if len(shape) >= 2 and not name.endswith(("_token", "pos_embed")):
            transposed = "resize_layers.0" in name or "resize_layers.1" in name
            v = v / math.sqrt(shape[0] if transposed else math.prod(shape[1:]))
        elif name.endswith(("norm1.weight", "norm2.weight", "norm.weight")):
            v = 1.0 + 0.1 * v
        elif name.endswith("gamma"):
            v = 0.5 + 0.1 * v
        else:
            v = 0.02 * v
        sd[name] = v.cpu()
    torch.save(sd, path)


def phase_depth(card, gnet=None):
    """Depth conditioning at full width. DepthAnythingV2 `small` and `large`
    from random original-naming checkpoints in a temporary VIVID_DEPTH_DIR,
    built by `resolve_depth_model`; each one's fp32 forward on the card at
    batch 2 (518 px, the prepared 64px views) held to the same module on the
    CPU by relative L2 (TOL_DEPTH; TF32 is off), with two planted faults
    that must fail it (the head's resizes off align_corners, the input's
    bicubic resize without antialiasing); its ms per batch of 16 views.
    Then full-width `vivid-base` with `depth_input` and with
    `warp_depth_coor` through `phase_model`'s D_x gate; 8 guided images, 8
    steps, of the depth_input net with depth_model='small' through
    generate_images_nvs (`gnet`: the `slice` phase's vivid-uncond, or the
    same from its seed), K1/K2 at the planned launches; 2 training steps at
    batch 8 of `--preset vivid-base --depth-model small --depth-input`, and
    2 with `--warp-depth-coor`, through the trainer's entry point, K3/K4 at
    the planned launches. Returns the launch counts of the sampling run and
    of the two training runs."""
    from unittest import mock
    import torch
    import torch.nn.functional as F
    from vivid_tpu_torch.core.easydict import EasyDict
    from vivid_tpu_torch.data.scenes import make_synthetic_dataset
    from vivid_tpu_torch.generate import generate_images_nvs
    from vivid_tpu_torch.geometry import depth, depth_anything
    from vivid_tpu_torch.kernels import flash
    from vivid_tpu_torch.nn.unet import attention_feature_spec

    faults = {
        "head_resize_half_pixel": mock.patch.object(
            depth_anything, "resize_ac", lambda x, size: F.interpolate(
                x, size=tuple(size), mode="bilinear", align_corners=False)),
        "prepare_without_antialias": mock.patch.object(
            depth, "_resize", lambda x, size, mode: F.interpolate(
                x.permute(0, 3, 1, 2), size=tuple(size), mode=mode,
                antialias=False).permute(0, 2, 3, 1)),
    }
    gen = torch.Generator(device="cuda").manual_seed(4)
    pixels = 255 * torch.rand(16, 64, 64, 3, generator=gen, device="cuda")
    launches = {}
    with tempfile.TemporaryDirectory(prefix="vivid_chip_smoke_depth_") as tmp, \
            _environ(VIVID_DEPTH_DIR=tmp):
        for size in ("small", "large"):
            name = depth_anything.ENCODER_NAMES[size]
            t0 = time.perf_counter()
            _random_depth_checkpoint(
                os.path.join(tmp, f"depth_anything_v2_metric_hypersim_{name}.pth"), size)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            model = depth.resolve_depth_model(size, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            cpu_model = depth.resolve_depth_model(size, device="cpu")
            with torch.no_grad():
                want = cpu_model(depth.depth_prepare(pixels[:2].cpu()))
                got = model(depth.depth_prepare(pixels[:2])).cpu()
                errs = {}
                for fault, patch in faults.items():
                    with patch:
                        errs[fault] = _rel_l2(model(depth.depth_prepare(pixels[:2])).cpu(), want)
                x16 = depth.depth_prepare(pixels)
                ms = cuda_ms(lambda: model(x16), reps=5)
                add_ms = cuda_ms(lambda: depth.add_depth(model, pixels, pixels / 127.5 - 1),
                                 reps=5)
            err = _rel_l2(got, want)
            n_params = sum(p.numel() for p in model.parameters())
            say("depth", model=size, params=n_params, write_s=f"{write_s:.2f}",
                load_s=f"{load_s:.2f}", depth_range=f"{float(got.min()):.3f}-{float(got.max()):.3f}",
                card_vs_cpu_rel_l2=f"{err:.3e}", gate=TOL_DEPTH,
                **{f"fault_{k}_rel_l2": f"{v:.3e}" for k, v in errs.items()},
                ms_per_16_views_518px=f"{ms:.3f}", add_depth_ms_16_views=f"{add_ms:.3f}",
                card=f"'{card}'")
            check(bool(torch.isfinite(got).all()) and float(got.std()) > 0,
                  f"depth {size}: non-finite or constant depth")
            check(err <= TOL_DEPTH, f"depth {size}: card vs CPU rel L2 {err} > {TOL_DEPTH}")
            for fault, e in errs.items():
                check(e > TOL_DEPTH, f"depth {size}: planted fault {fault} gives {e}, "
                      f"which passes the gate {TOL_DEPTH}")
            del model, cpu_model
            torch.cuda.empty_cache()

        for flag in ("depth_input", "warp_depth_coor"):
            phase_model(flags={flag: True})

        # Guided sampling of the depth_input net, depth from 'small' by name.
        if gnet is None:
            gnet = _full_width(uncond=True)
        base = _full_width(uncond=False, depth_input=True)
        data = make_synthetic_dataset(os.path.join(tmp, "scenes"), num_scenes=8, num_views=8,
                                      imsize=64, seed=0)
        steps, seeds = 8, list(range(8))   # of the sampler's 32 (a cut for time)
        per_eval = {"flash_fused_packed": len(attention_feature_spec(base.cfg.encoder_cfg))
                    + len(attention_feature_spec(gnet.cfg.unet_cfg)),
                    "flash_fused_packed_xattn": len(attention_feature_spec(base.cfg.unet_cfg)),
                    **_mp_per_eval(base.cfg, gnet.cfg)}
        evals = 2 * steps - 1
        for name in flash.launches:
            flash.launches[name] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (batch,) = generate_images_nvs(
            net=EasyDict(net=base, cfg=base.cfg), gnet=EasyDict(net=gnet, cfg=gnet.cfg),
            guidance=1.5, seeds=seeds, max_batch_size=8, num_steps=steps, depth_model="small",
            datakwargs={"path": data}, device="cuda", verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches["sample"] = {k: n for k, n in flash.launches.items() if n}
        check(launches["sample"] == {k: n * evals for k, n in per_eval.items()},
              f"depth sampling: launches {launches['sample']}, want {per_eval} x {evals}")
        check(bool(torch.isfinite(batch.latents).all())
              and float(batch.images.astype(float).std()) > 0,
              "depth sampling: non-finite latents or constant images")
        say("depth", run="sample_depth_input", depth_model="small", steps=steps,
            seconds=f"{seconds:.3f}", images_per_s=f"{len(seeds) / seconds:.3f}",
            launches=launches["sample"], per_eval=per_eval, evals=evals, card=f"'{card}'")
        del base
        torch.cuda.empty_cache()

        for flag in ("depth_input", "warp_depth_coor"):
            _, launches[flag] = _run_trainer(card, os.path.join(tmp, f"train_{flag}"), data,
                                             "vivid-base", 2, "false", 1024,
                                             depth_model="small", **{flag: True})
    return launches


def phase_train(card):
    """The training step at full width, batch 8 of the preset's 1024.

    First the whole gradient of one `vivid-base` loss (same sigma and noise)
    through the four kernels against the same through the plain versions,
    held against a control (plain versions with one bf16 ulp on every
    attention output and every attention gradient); two planted faults must
    fail the gate. The same gradient with VIVID_NOMAX_PACKED=1 (K7 forward,
    K3/K4 backward) is held to its own plain version and control. Then the
    trainer's entry point takes 4 steps of
    `vivid-base` and 2 of `vivid-uncond` with no learning-rate ramp-up, and
    the snapshots it wrote are sampled. Returns the kernels' launch counts
    of the `vivid-base` run."""
    import contextlib
    from unittest import mock
    import torch
    from vivid_tpu_torch.data.scenes import make_synthetic_dataset
    from vivid_tpu_torch.diffusion.loss import NVLoss, clamp_loss
    from vivid_tpu_torch.generate import generate_images_nvs
    from vivid_tpu_torch.kernels import flash
    from vivid_tpu_torch.train.snapshots import load_snapshot

    names = ("flash_fused_packed", "flash_fused_packed_xattn",
             "flash_fused_packed_bwd", "flash_fused_packed_xattn_bwd", "flash_nomax_packed")
    k1, k2, k3, k4, k7 = (getattr(flash, n) for n in names)
    refs = tuple(getattr(flash, n + "_ref") for n in names)
    noise_gen = torch.Generator(device="cuda")

    def noisy(fn):
        def run(*args):
            out = fn(*args)
            if isinstance(out, torch.Tensor):
                return _ulp_noise(out, noise_gen)
            return (_ulp_noise(out[0], noise_gen),
                    tuple(_ulp_noise(t, noise_gen) for t in out[1]), out[2])
        return run

    def k4_one_source_dropped(*args):
        dqkv, dfeats, dbiases = k4(*args)
        return dqkv, (dfeats[0], torch.zeros_like(dfeats[1])), dbiases

    def rms_norm_without_projection(x, eps=flash.NORM_EPS):
        # The pixel norm with its denominator held constant: its VJP loses
        # the term -x <x, dy> / (D r (eps + r)^2).
        x32 = x.float()
        den = eps + torch.linalg.vector_norm(
            x32, dim=-1, keepdim=True).detach() / math.sqrt(x.shape[-1])
        return (x32 / den).to(x.dtype)

    variants = {
        "plain": (refs, None),
        "control": (tuple(noisy(fn) for fn in refs), None),
        "fault_dfeats_zeroed": ((k1, k2, k3, k4_one_source_dropped, k7), None),
        "fault_norm_vjp": ((k1, k2, refs[2], refs[3], k7), rms_norm_without_projection),
    }

    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = dict(
        src=torch.randn(BATCH, 2, 64, 64, 3, generator=gen, device="cuda").clamp(-1, 1),
        tgt=torch.randn(BATCH, 64, 64, 3, generator=gen, device="cuda").clamp(-1, 1),
        geometry=torch.randn(BATCH, 2, 20, generator=gen, device="cuda"))
    loss_fn = NVLoss(P_mean=-0.8, P_std=1.6)
    sigma = loss_fn.sample_sigma(gen, BATCH, "cuda")
    eps = torch.randn(batch["tgt"].shape, generator=gen, device="cuda")
    net = _full_width(uncond=False, train=True)
    params = list(net.parameters())

    def gradient(variant=None):
        with contextlib.ExitStack() as stack:
            if variant:
                fns, norm = variants[variant]
                for name, fn in zip(names, fns):
                    stack.enter_context(mock.patch.object(flash, name, fn))
                if norm:
                    stack.enter_context(mock.patch.object(flash, "_rms_norm", norm))
            noise_gen.manual_seed(5)
            for p in params:
                p.grad = None
            loss = clamp_loss(loss_fn(net, batch["src"], batch["tgt"], batch["geometry"],
                                      sigma=sigma, eps=eps))
            scalar = loss.sum() / BATCH
            scalar.backward()
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                          .float().reshape(-1) for p in params])
        return scalar.item(), flat

    def measured(variant=None):
        before = dict(flash.launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, flat = gradient(variant)
        torch.cuda.synchronize()
        return (loss, flat, {k: n - before[k] for k, n in flash.launches.items()},
                torch.cuda.max_memory_allocated() / 1e9)

    with _packed_bwd_shapes() as shapes:
        loss_k, got, used, _ = measured()
    say("train", check="packed_bwd_launches_by_shape", net="vivid-base", **shapes)
    loss_p, want = gradient("plain")
    control = _rel_l2(gradient("control")[1], want)
    faults = {name: _rel_l2(gradient(name)[1], want) for name in variants
              if name.startswith("fault")}
    torch.cuda.synchronize()
    check(all(used[n] for n in names[:4]) and not used[names[4]],
          f"train: the loss and its backward launched {used}")
    check(bool(torch.isfinite(got).all()) and math.isfinite(loss_k), "train: non-finite gradient")
    err = _rel_l2(got, want)
    gate = TOL_GRAD_CONTROL * control
    say("train", check="gradient", net="vivid-base", weights="emb_gains_1", batch=BATCH,
        values=got.numel(), loss_kernels=f"{loss_k:.6f}", loss_plain=f"{loss_p:.6f}",
        grad_norm_kernels=f"{got.norm().item():.6f}", grad_norm_plain=f"{want.norm().item():.6f}",
        grad_rel_l2=f"{err:.3e}", control_rel_l2=f"{control:.3e}",
        ratio=f"{err / control:.3f}", gate=f"{gate:.3e}", kernel_launches=used,
        **{k: f"{v:.3e}" for k, v in faults.items()})
    check(err <= gate, f"train: gradient kernels vs plain rel L2 {err} > {gate} "
          f"(control {control})")
    check(abs(loss_k - loss_p) <= 5e-2 * abs(loss_p),
          f"train: loss {loss_k} through the kernels, {loss_p} through the plain versions")
    for name, faulty in faults.items():
        check(faulty > gate, f"train: planted {name} gives {faulty}, which passes the gate {gate}")
    del want

    # The same loss with VIVID_NOMAX_PACKED=1: K7 forward, K3/K4 backward,
    # against K7's plain version forward and through the same control gate.
    with nomax_packed():
        loss_n, got_n, used_n, _ = measured()
        loss_np, want_n = gradient("plain")
        control_n = _rel_l2(gradient("control")[1], want_n)
    torch.cuda.synchronize()
    err_n = _rel_l2(got_n, want_n)
    say("train", check="gradient", nomax_packed=True, net="vivid-base", batch=BATCH,
        loss_kernels=f"{loss_n:.6f}", loss_plain=f"{loss_np:.6f}", grad_rel_l2=f"{err_n:.3e}",
        control_rel_l2=f"{control_n:.3e}", ratio=f"{err_n / control_n:.3f}",
        gate=f"{TOL_GRAD_CONTROL * control_n:.3e}",
        vs_switch_off_rel_l2=f"{_rel_l2(got_n, got):.3e}", kernel_launches=used_n)
    check(used_n["flash_nomax_packed"] == used["flash_fused_packed"] + used["flash_fused_packed_xattn"]
          and not used_n["flash_fused_packed"] and not used_n["flash_fused_packed_xattn"]
          and used_n["flash_fused_packed_bwd"] == used["flash_fused_packed_bwd"]
          and used_n["flash_fused_packed_xattn_bwd"] == used["flash_fused_packed_xattn_bwd"],
          f"train: with the no-max packed forward the loss and its backward launched {used_n}")
    check(bool(torch.isfinite(got_n).all()) and err_n <= TOL_GRAD_CONTROL * control_n,
          f"train: no-max packed forward: gradient kernels vs plain rel L2 {err_n} > "
          f"{TOL_GRAD_CONTROL * control_n} (control {control_n})")
    del got_n, want_n

    # Recompute in the backward pass: each mode gives the gradient of the
    # mode that keeps every activation, no further from it than the gate.
    check(used == _train_launches(net.cfg),
          f"train: one loss and its backward launched {used}, want {_train_launches(net.cfg)}")
    _remat_modes("train", card, net, params, got, gate, lambda: clamp_loss(loss_fn(
        net, batch["src"], batch["tgt"], batch["geometry"], sigma=sigma, eps=eps)).sum() / BATCH)
    del net, params, got
    torch.cuda.empty_cache()

    # The trainer's entry point, as the CLI drives it.
    runs = {}
    with tempfile.TemporaryDirectory(prefix="vivid_chip_smoke_train_") as tmp:
        data = make_synthetic_dataset(os.path.join(tmp, "scenes"), num_scenes=16,
                                      num_views=8, imsize=64, seed=0)
        for preset, steps in (("vivid-base", 4), ("vivid-uncond", 2)):
            runs[preset] = _run_trainer(card, os.path.join(tmp, preset), data, preset, steps,
                                        remat="false", preset_batch=1024)

        base = load_snapshot(runs["vivid-base"][0], device="cuda")
        gnet = load_snapshot(runs["vivid-uncond"][0], device="cuda")
        seeds = [0, 1]
        batches = list(generate_images_nvs(
            net=base, gnet=gnet, guidance=1.5, seeds=seeds, max_batch_size=2, num_steps=8,
            outdir=os.path.join(tmp, "out"), datakwargs={"path": data}, device="cuda",
            verbose=False))
        torch.cuda.synchronize()
        lat = torch.cat([b.latents for b in batches])
        check(lat.shape == (2, 64, 64, 3) and bool(torch.isfinite(lat).all()),
              f"train: sampling the trained snapshots gave latents {tuple(lat.shape)}")
        say("train", sampled_seeds=seeds, snapshot=os.path.basename(runs["vivid-base"][0]),
            latents_absmax=f"{lat.abs().max().item():.3f}",
            pngs=len(os.listdir(os.path.join(tmp, "out"))))
    return runs["vivid-base"][1]


def _remat_modes(tag, card, net, params, want, gate, loss_of, reps=3, plan=True):
    """Each recompute mode (False, True, "save_dots") on `net`, one loss
    (`loss_of()`, a scalar) and its backward: the kernels' launches against
    the model's plan (`_train_launches`; `plan=False` prints them alone), the
    gradient against `want` (remat off's; None: this run's remat off) within
    `gate` (None: printed alone), and what the mode costs: the bytes held
    after the forward pass (allocated after it minus before), the
    allocator's peak, the ms of a loss and its backward between CUDA events
    (median of `reps` runs, the first of them the one counted; the host's
    gaps between launches count), and under torch.profiler the device's busy
    ms of one and the ms of its forward attention kernels (K1/K2, K6, K7; a
    profile that comes back without device events is taken again, up to
    three in all)."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vivid_tpu_torch.kernels import flash
    forward_kernels = ("packed_fwd_", "flash_nomax_kernel", "nomax_packed_")

    def backward():
        for p in params:
            p.grad = None
        loss_of().backward()

    for mode in (False, True, "save_dots"):
        for owner in (net, net.unet, net.encoder):
            if owner is not None:
                owner.cfg = dataclasses.replace(owner.cfg, remat=mode)
        times = []
        for i in range(reps):   # the first also counts launches, bytes and the gradient
            for p in params:
                p.grad = None
            torch.cuda.synchronize()
            if i == 0:
                torch.cuda.reset_peak_memory_stats()
                before, base = dict(flash.launches), torch.cuda.memory_allocated()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss = loss_of()
            if i == 0:
                held = torch.cuda.memory_allocated() - base
            loss.backward()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            if i == 0:
                peak = torch.cuda.max_memory_allocated()
                used = {k: n - before[k] for k, n in flash.launches.items()}
                grad = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                                  .float().reshape(-1) for p in params])
                if want is None:
                    want = grad
                err = _rel_l2(grad, want)
                del grad
        ms = statistics.median(times)
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                backward()
                torch.cuda.synchronize()
            dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            if dev:
                break
        check(dev, f"{tag}: the profiler saw no device event in three profiles")
        fwd_ms = sum(e.time_range.elapsed_us() for e in dev
                     if any(k in e.name for k in forward_kernels)) / 1e3
        say(tag, check="remat", mode=mode, batch=BATCH, held_after_forward_GB=f"{held / 1e9:.3f}",
            peak_allocated_GB=f"{peak / 1e9:.3f}", loss_and_backward_event_ms=f"{ms:.3f}",
            reps=reps, device_busy_ms=f"{_busy_ms(dev):.3f}",
            attention_forward_device_ms=f"{fwd_ms:.3f}",
            grad_rel_l2_vs_no_remat=f"{err:.3e}", loss=f"{loss.item():.6f}",
            kernel_launches={k: n for k, n in used.items() if n}, card=f"'{card}'")
        check((gate is None or err <= gate) and (not plan or used == _train_launches(net.cfg)),
              f"{tag}: remat={mode!r}: gradient rel L2 {err} (gate {gate}), launches {used}, "
              f"want {_train_launches(net.cfg)}")
    for p in params:
        p.grad = None


def phase_remat_cost(card):
    """What each recompute mode costs at full width, batch 8: `_remat_modes`
    on `vivid-base` and on `vivid-sr` (one loss and its backward, seeded
    inputs), the launches printed but not held to this checkout's plan, so
    that `vivid_tpu_torch/tools/smoke_phase.py remat_cost --port DIR` times
    another checkout's port at the same cases."""
    import torch
    from vivid_tpu_torch.diffusion.loss import NVLoss, SRNVLoss, clamp_loss
    for tag, sr in (("remat_cost_base", False), ("remat_cost_sr", True)):
        gen = torch.Generator(device="cuda").manual_seed(12)
        res, srcs = (256, 1) if sr else (64, 2)
        src = torch.randn(BATCH, srcs, res, res, 3, generator=gen, device="cuda").clamp(-1, 1)
        tgt = torch.randn(BATCH, res, res, 3, generator=gen, device="cuda").clamp(-1, 1)
        geometry = torch.randn(BATCH, srcs, 20, generator=gen, device="cuda")
        eps = torch.randn(tgt.shape, generator=gen, device="cuda")
        loss_fn = SRNVLoss(P_mean=-0.8, P_std=1.6) if sr else NVLoss(P_mean=-0.8, P_std=1.6)
        sigma = loss_fn.sample_sigma(gen, BATCH, "cuda")
        extra = dict(cond_noise=torch.randn(tgt.shape, generator=gen, device="cuda")) if sr else {}
        net = _full_width_sr(train=True) if sr else _full_width(uncond=False, train=True)
        _remat_modes(tag, card, net, list(net.parameters()), None, None, lambda: clamp_loss(
            loss_fn(net, src, tgt, geometry, sigma=sigma, eps=eps, **extra)).sum() / BATCH,
            plan=False)
        del net
        torch.cuda.empty_cache()


@contextlib.contextmanager
def _packed_bwd_shapes():
    """While the block runs, the calls of K3 and K4 by sequence length and
    head dim, {"<kernel>_S<len>_d<d>": n}: a path's launches split by shape.
    The kernels run as they are."""
    from unittest import mock
    from vivid_tpu_torch.kernels import flash
    seen = {}

    def recorder(name, heads_at):
        fn = getattr(flash, name)

        def run(qkv, *args):
            key = f"{name}_S{qkv.shape[1]}_d{qkv.shape[2] // (3 * args[heads_at])}"
            seen[key] = seen.get(key, 0) + 1
            return fn(qkv, *args)
        return run

    with mock.patch.object(flash, "flash_fused_packed_bwd", recorder("flash_fused_packed_bwd", 1)), \
            mock.patch.object(flash, "flash_fused_packed_xattn_bwd",
                              recorder("flash_fused_packed_xattn_bwd", 2)):
        yield seen


def _train_launches(cfg):
    """Kernel launches of one loss and its backward, from the model's plan:
    every attention block launches its forward kernel once, and once more
    where `remat=True` recomputes its block in the backward pass (the
    decoder's blocks and every block of an encoder); "save_dots" keeps the
    attention outputs, so its forward kernels launch once a block, as
    without remat. S >= 4096 without a zero sink goes to K6 forward and K8
    forward + backward, the rest to the packed kernels and their backward."""
    from vivid_tpu_torch.kernels import flash
    from vivid_tpu_torch.kernels.attention import NOMAX_MIN_SQ
    from vivid_tpu_torch.nn.unet import attention_feature_spec
    want = dict.fromkeys(flash.launches, 0)
    nets = [(cfg.unet_cfg, "flash_fused_packed" if cfg.uncond else "flash_fused_packed_xattn")]
    if not cfg.uncond:
        nets.append((cfg.encoder_cfg, "flash_fused_packed"))
    for ucfg, packed in nets:
        for name, _, res in attention_feature_spec(ucfg):
            forwards = 2 if ucfg.remat is True and (name.startswith("dec/")
                                                    or ucfg.kind == "encoder") else 1
            if res * res >= NOMAX_MIN_SQ and not cfg.uncond:
                want["flash_nomax"] += forwards
                want["flash_attention"] += 1
                want["flash_attention_bwd"] += 1
            else:
                want[packed] += forwards
                want[packed + "_bwd"] += 1
    return want


def _run_trainer(card, run_dir, data, preset, steps, remat, preset_batch, **opts):
    """`steps` optimizer steps of `preset` at global batch 8 through
    `cli.train_nvs.launch_training`, from a fresh seeded init with no
    learning-rate ramp-up; `opts` are more CLI options (depth_model, ...).
    Checks the launch counts against the model's plan, the ticks, the log,
    that every parameter and EMA moved, and the snapshots. Returns (a
    snapshot's path, the launch counts)."""
    import torch
    from vivid_tpu_torch.cli.train_nvs import launch_training, setup_training_config
    from vivid_tpu_torch.kernels import flash
    from vivid_tpu_torch.nn.precond import NVPrecond
    c = setup_training_config(preset=preset, data=data, batch=BATCH, max_steps=steps,
                              remat=remat, seed=0, device="cuda", **opts)
    nimg_mult = 1 if c.vanilla_mode else 6   # the dual-source collate counts 6 images a pair
    nimg_step = BATCH * nimg_mult
    c.update(status_nimg=nimg_step, snapshot_nimg=nimg_step * steps)
    c.lr_kwargs.rampup_Mimg = 0.0   # the preset's ramp-up starts at LR 0
    for name in flash.launches:
        flash.launches[name] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9   # earlier phases' models
    t0 = time.perf_counter()
    result = launch_training(run_dir, c)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(flash.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    TRAINER_PEAK_GB[(preset, str(remat).lower())] = peak_gb
    state, ticks = result.state, result.ticks[1:]   # the first tick precedes step 1
    cfg = state.net.cfg
    per_step = _train_launches(cfg)
    for name, n in launches.items():
        check(n == per_step[name] * steps,
              f"{preset}: {name} launched {n} times, want {per_step[name]} x {steps}")
    check(len(ticks) == steps and state.adam_step == steps
          and state.cur_nimg == nimg_step * steps,
          f"{preset}: {len(ticks)} ticks, {state.adam_step} steps, nimg {state.cur_nimg}")
    for t in ticks:
        check(all(math.isfinite(t[k]) for k in ("loss", "loss_std", "grad_norm"))
              and t["learning_rate"] > 0 and t["grad_norm"] > 0,
              f"{preset}: tick {t}")
    fresh = list(NVPrecond(cfg, device="cuda", seed=0).parameters())
    # A fresh init has out_gain and every emb_gain at 0: step 1 moves
    # out_gain alone, step 2 everything but what feeds an emb_gain, and
    # from step 3 on every parameter has a gradient.
    # The unconditional model's cross features are zeros, so its
    # x_attn_kv projections never get one.
    no_gradient = (() if steps >= 3 else
                   ("emb_linear.weight", "emb_noise.weight", "emb_label.weight"))
    if cfg.uncond:
        no_gradient += ("x_attn_kv.weight",)
    moved = [not torch.equal(p, q) for p, q in zip(state.params, fresh)]
    still = [n for n, m in zip(state.names, moved)
             if not m and not n.endswith(no_gradient)]
    check(not still, f"{preset}: parameters that did not move: {still[:8]}")
    for std, ema in zip((0.050, 0.100), state.emas):   # the trainer's default stds
        stuck = [n for n, m, e, p, q in zip(state.names, moved, ema, state.params, fresh)
                 if m and (torch.equal(e, q) or torch.equal(e, p))]
        check(not stuck, f"{preset}: EMA {std} did not follow {stuck[:8]}")
    del fresh
    log = open(os.path.join(run_dir, "log.txt")).read()
    check(log.count("Status:") == steps + 1, f"{preset}: log.txt:\n{log}")
    step_ms = [t["seconds"] * 1e3 for t in ticks]
    warm_ms = statistics.median(step_ms[1:])
    say("train", run=preset, options=opts or None, steps=steps,
        global_batch=f"{BATCH}_of_the_preset's_{preset_batch}",
        remat=cfg.remat, nimg_mult=nimg_mult,
        loss=[round(t["loss"], 4) for t in ticks],
        grad_norm=[round(t["grad_norm"], 4) for t in ticks],
        step_ms=[round(x, 1) for x in step_ms], warm_step_ms=f"{warm_ms:.1f}",
        pairs_per_s=f"{BATCH / warm_ms * 1e3:.2f}",
        nimg_per_s=f"{nimg_step / warm_ms * 1e3:.1f}",
        parameters_moved=f"{sum(moved)}_of_{len(moved)}",
        peak_memory_GB=f"{peak_gb:.2f}", resident_before_GB=f"{resident_gb:.2f}",
        total_s=f"{seconds:.2f}", launches=launches, per_step=per_step, card=f"'{card}'")
    snaps = sorted(f for f in os.listdir(run_dir) if f.endswith(".pkl"))
    check(len(snaps) == 2, f"{preset}: snapshots {snaps}")
    del result, state
    torch.cuda.empty_cache()
    return os.path.join(run_dir, snaps[0]), launches


def phase_train_sr(card, keep_dir=None):
    """The 256px training step at full width, batch 8 of the preset's 128.

    First the whole gradient of one `vivid-sr` `SRNVLoss` (same sigma, noise
    and conditioning noise) through the kernels (K6 forward, K8 forward and
    backward at S >= 4096, K1-K4 at S = 1024) against the same through the
    plain versions, held against a control (plain versions with one bf16 ulp
    on every attention output and every attention gradient); a planted fault
    (dk of the cross keys zeroed in K8's backward) must fail the gate, and the
    distance is split by kernel family. Then the recompute modes, then the trainer's entry point takes 3 steps of the
    `vivid-sr` preset with the preset's recompute and 3 without, and the
    snapshot it wrote is sampled as the SR model alone, and copied into
    `keep_dir` (as vivid-sr.pkl) when one is given. Returns the kernels'
    launch counts of the preset's run."""
    import contextlib
    from unittest import mock
    import torch
    from vivid_tpu_torch.data.scenes import make_synthetic_dataset
    from vivid_tpu_torch.diffusion.loss import SRNVLoss, clamp_loss
    from vivid_tpu_torch.generate import generate_images_nvs
    from vivid_tpu_torch.kernels import flash
    from vivid_tpu_torch.train.snapshots import load_snapshot

    names = ("flash_fused_packed", "flash_fused_packed_xattn", "flash_fused_packed_bwd",
             "flash_fused_packed_xattn_bwd", "flash_nomax", "flash_attention",
             "flash_attention_bwd")
    kernels = tuple(getattr(flash, n) for n in names)
    refs = tuple(getattr(flash, n + "_ref") for n in names)
    noise_gen = torch.Generator(device="cuda")

    def noisy(fn):
        # One ulp on every bf16 tensor the function returns, whatever its
        # nesting; fp32 statistics and bias gradients pass.
        def ulp(out):
            if isinstance(out, torch.Tensor):
                return _ulp_noise(out, noise_gen) if out.dtype == torch.bfloat16 else out
            return out if out is None else tuple(ulp(t) for t in out)
        return lambda *args: ulp(fn(*args))

    def k8_bwd_without_cross_dk(q, k, v, bias, out, lse, g):
        dq, dk, dv, dbias = kernels[6](q, k, v, bias, out, lse, g)
        dk[:, :, q.shape[2]:] = 0   # the keys after the self segment
        return dq, dk, dv, dbias

    variants = {
        "plain": refs,
        "control": tuple(noisy(fn) for fn in refs),
        "fault_cross_dk_zeroed": kernels[:6] + (k8_bwd_without_cross_dk,),
    }
    gen = torch.Generator(device="cuda").manual_seed(10)
    batch = dict(
        src=torch.randn(BATCH, 1, 256, 256, 3, generator=gen, device="cuda").clamp(-1, 1),
        tgt=torch.randn(BATCH, 256, 256, 3, generator=gen, device="cuda").clamp(-1, 1),
        geometry=torch.randn(BATCH, 1, 20, generator=gen, device="cuda"))
    loss_fn = SRNVLoss(P_mean=-0.8, P_std=1.6)
    sigma = loss_fn.sample_sigma(gen, BATCH, "cuda")
    eps = torch.randn(batch["tgt"].shape, generator=gen, device="cuda")
    cond_noise = torch.randn(batch["tgt"].shape, generator=gen, device="cuda")
    net = _full_width_sr(train=True)
    params = list(net.parameters())

    def gradient(variant=None, noise_seed=5):
        with contextlib.ExitStack() as stack:
            for name, fn in zip(names, variants.get(variant, ())):
                stack.enter_context(mock.patch.object(flash, name, fn))
            noise_gen.manual_seed(noise_seed)
            for p in params:
                p.grad = None
            loss = clamp_loss(loss_fn(net, batch["src"], batch["tgt"], batch["geometry"],
                                      sigma=sigma, eps=eps, cond_noise=cond_noise))
            scalar = loss.sum() / BATCH
            scalar.backward()
        flat = torch.cat([p.grad.float().reshape(-1) for p in params])
        return scalar.item(), flat

    def measured(variant=None):
        before = dict(flash.launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, flat = gradient(variant)
        torch.cuda.synchronize()
        return (loss, flat, {k: n - before[k] for k, n in flash.launches.items()},
                torch.cuda.max_memory_allocated() / 1e9)

    resident_gb = torch.cuda.memory_allocated() / 1e9   # the net, the batch, earlier phases
    with _packed_bwd_shapes() as shapes:
        loss_k, got, used, peak_gb = measured()
    say("train_sr", check="packed_bwd_launches_by_shape", net="vivid-sr", **shapes)
    check(used == _train_launches(net.cfg),
          f"train_sr: one loss and its backward launched {used}, want {_train_launches(net.cfg)}")
    loss_p, want = gradient("plain")
    control = _rel_l2(gradient("control")[1], want)
    faulty = _rel_l2(gradient("fault_cross_dk_zeroed")[1], want)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()) and math.isfinite(loss_k), "train_sr: non-finite gradient")
    err = _rel_l2(got, want)
    gate = TOL_GRAD_CONTROL * control
    say("train_sr", check="gradient", net="vivid-sr", weights="emb_gains_1", batch=BATCH,
        values=got.numel(), loss_kernels=f"{loss_k:.6f}", loss_plain=f"{loss_p:.6f}",
        grad_norm_kernels=f"{got.norm().item():.6f}", grad_norm_plain=f"{want.norm().item():.6f}",
        grad_rel_l2=f"{err:.3e}", control_rel_l2=f"{control:.3e}",
        ratio=f"{err / control:.3f}", gate=f"{gate:.3e}", kernel_launches=used,
        fault_cross_dk_zeroed=f"{faulty:.3e}")
    check(err <= gate, f"train_sr: gradient kernels vs plain rel L2 {err} > {gate} "
          f"(control {control})")
    check(abs(loss_k - loss_p) <= 5e-2 * abs(loss_p),
          f"train_sr: loss {loss_k} through the kernels, {loss_p} through the plain versions")
    check(faulty > gate, f"train_sr: the planted fault gives {faulty}, which passes the gate {gate}")

    # Where the distance comes from (printed, not gated): each kernel family
    # alone through its kernels with the others through their plain versions,
    # and the control under another noise seed.
    families = {"k1_to_k4": (0, 1, 2, 3), "k1_k2": (0, 1), "k3_k4": (2, 3), "k6": (4,),
                "k8": (5, 6)}
    alone = {}
    for family, own in families.items():
        variants[family] = tuple(k if i in own else r
                                 for i, (k, r) in enumerate(zip(kernels, refs)))
        alone[f"only_{family}_rel_l2"] = f"{_rel_l2(gradient(family)[1], want):.3e}"
    say("train_sr", check="gradient_by_family", **alone,
        control_other_seed_rel_l2=f"{_rel_l2(gradient('control', 6)[1], want):.3e}")
    del want

    # Recompute in the backward pass: under True K6 runs again in every
    # recomputed block, under save_dots once a block, as without; K8 as often
    # in every mode; the gradient stays within the gate of the mode that
    # keeps every activation.
    say("train_sr", check="remat", mode=False, peak_memory_GB=f"{peak_gb:.2f}",
        resident_before_GB=f"{resident_gb:.2f}")
    _remat_modes("train_sr", card, net, params, got, gate, lambda: clamp_loss(loss_fn(
        net, batch["src"], batch["tgt"], batch["geometry"], sigma=sigma, eps=eps,
        cond_noise=cond_noise)).sum() / BATCH)
    del net, params, got
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="vivid_chip_smoke_train_sr_") as tmp:
        data = make_synthetic_dataset(os.path.join(tmp, "scenes256"), num_scenes=16,
                                      num_views=8, imsize=256, seed=0)
        snapshot, launches = _run_trainer(card, os.path.join(tmp, "remat"), data, "vivid-sr", 3,
                                          remat="true", preset_batch=128)
        _run_trainer(card, os.path.join(tmp, "no_remat"), data, "vivid-sr", 3,
                     remat="false", preset_batch=128)
        sr = load_snapshot(snapshot, device="cuda")
        check(sr.cfg.super_res and sr.cfg.img_resolution == 256, f"train_sr: snapshot {sr.cfg}")
        seeds = [0, 1]
        batches = list(generate_images_nvs(
            net=sr, vanilla_mode=True, seeds=seeds, max_batch_size=2, num_steps=4,
            outdir=os.path.join(tmp, "out"), datakwargs={"path": data}, device="cuda",
            verbose=False))
        torch.cuda.synchronize()
        lat = torch.cat([b.latents for b in batches])
        check(lat.shape == (2, 256, 256, 3) and bool(torch.isfinite(lat).all()),
              f"train_sr: sampling the trained snapshot gave latents {tuple(lat.shape)}")
        say("train_sr", sampled_seeds=seeds, snapshot=os.path.basename(snapshot),
            latents_absmax=f"{lat.abs().max().item():.3f}",
            pngs=len(os.listdir(os.path.join(tmp, "out"))))
        if keep_dir is not None:
            import shutil
            shutil.copy(snapshot, os.path.join(keep_dir, "vivid-sr.pkl"))
    return launches


def run_shell_phase(sr_model):
    """The `shell` phase in a process of its own, with
    CUBLAS_WORKSPACE_CONFIG set before its first cuBLAS call, so that the
    deterministic mode it turns on reaches no other phase's timings. Prints
    the phase's own lines; the trainer's, too, if the phase fails."""
    import torch
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=SHELL_CUBLAS_WORKSPACE)
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vivid_tpu_torch",
                          "tools", "smoke_phase.py")
    proc = subprocess.run([sys.executable, script, "shell", "--sr-model", sr_model], env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=900)
    lines = proc.stdout.splitlines()
    print("\n".join(l for l in lines if l.startswith("[shell]")) if proc.returncode == 0
          else "\n".join(lines[-300:]), flush=True)
    check(proc.returncode == 0, f"shell: the phase's process exited with {proc.returncode}")


def start_overfit_phase():
    """The `overfit` phase in a process of its own, started so that it runs
    beside the `dist` phase: both are bound by the host, and neither measures
    speed (dist's step times are marked as no speed, overfit's gates are its
    loss and its PSNR), so the card serves both at once. Its output goes to
    a temporary file, which no pipe's size can stall. Returns (the process,
    the file) for `finish_overfit_phase`."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vivid_tpu_torch",
                          "tools", "smoke_phase.py")
    log = tempfile.TemporaryFile(mode="w+")
    return subprocess.Popen([sys.executable, script, "overfit"], stdout=log,
                            stderr=subprocess.STDOUT, text=True), log


def finish_overfit_phase(proc, log, timeout=600):
    """Waits for `start_overfit_phase`'s process (killed after `timeout`
    more seconds) and prints its `[overfit]` lines, or its last lines if it
    failed."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    log.seek(0)
    lines = log.read().splitlines()
    log.close()
    print("\n".join(l for l in lines if l.startswith("[overfit]")) if proc.returncode == 0
          else "\n".join(lines[-300:]), flush=True)
    check(proc.returncode == 0, f"overfit: the phase's process exited with {proc.returncode}")


def _same_state(a, b):
    """The parts of two TrainStates that differ in any bit."""
    import torch
    equal = lambda xs, ys: all(torch.equal(x, y) for x, y in zip(xs, ys))
    diff = [g for g in ("params", "adam_m", "adam_v") if not equal(getattr(a, g), getattr(b, g))]
    diff += [f"emas[{i}]" for i, (x, y) in enumerate(zip(a.emas, b.emas)) if not equal(x, y)]
    return diff + (["adam_step"] if a.adam_step != b.adam_step else [])


def phase_shell(card, sr_model=None):
    """The trainer shell at full width: `vivid-base` (ch 128, 64px, dual
    source), batch 8 of the preset's 1024 (only the batch is cut), synthetic
    scenes, through `cli.train_nvs.launch_training`, deterministic. Run A
    takes 4 steps straight, with checkpoints and snapshots every 2 steps and
    a sample grid at its last (EMA 0, unguided, 32 Heun steps, then the SR
    model `sr_model`, a `vivid-sr` snapshot: a full-width random one when
    none is given). Run B takes the same as a slice of 2 steps and a resume;
    it must end with A's bits in the parameters, both Adam moments, both
    EMAs and the step count, and two planted faults in its resume (the
    loader not fast-forwarded; adam_v zeroed in the checkpoint) must break
    that. Run C is suspended at its third status tick and must leave a
    checkpoint of the 96-nimg state. Then the post-hoc EMA at std 0.075 from
    C's and A's snapshots, loaded and evaluated through the kernels; then ms
    per step with and without the deterministic mode, and the checkpoint's
    size and write times. Needs CUBLAS_WORKSPACE_CONFIG (`run_shell_phase`)."""
    import re
    from unittest import mock
    import numpy as np
    import PIL.Image
    import torch
    from vivid_tpu_torch.cli.train_nvs import launch_training, setup_training_config
    from vivid_tpu_torch.core import checkpoint, dist
    from vivid_tpu_torch.data.collate import BatchLoader, DualSourceCollate
    from vivid_tpu_torch.data.encoders import StandardRGBEncoder
    from vivid_tpu_torch.data.scenes import SceneDataset, make_synthetic_dataset
    from vivid_tpu_torch.diffusion import phema
    from vivid_tpu_torch.kernels import flash
    from vivid_tpu_torch.nn.precond import NVPrecond
    from vivid_tpu_torch.nn.unet import attention_feature_spec
    from vivid_tpu_torch.train import loop
    from vivid_tpu_torch.train.snapshots import load_snapshot, save_snapshot

    check(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == SHELL_CUBLAS_WORKSPACE,
          "shell: run it through run_shell_phase (CUBLAS_WORKSPACE_CONFIG unset)")
    step = BATCH * 6                      # nimg a step: the dual-source collate counts 6 a pair
    evals = 2 * 32 - 1
    with tempfile.TemporaryDirectory(prefix="vivid_chip_smoke_shell_") as tmp:
        data = make_synthetic_dataset(os.path.join(tmp, "scenes"), num_scenes=16,
                                      num_views=8, imsize=64, seed=0)
        test_data = make_synthetic_dataset(os.path.join(tmp, "scenes256"), num_scenes=8,
                                           num_views=8, imsize=256, seed=1)
        if sr_model is None:
            sr_model = os.path.join(tmp, "sr.pkl")
            save_snapshot(sr_model, _full_width_sr())

        def train(name, **kw):
            c = setup_training_config(
                preset="vivid-base", data=data, batch=BATCH, duration=4 * step, seed=0,
                device="cuda", deterministic=True, status=step, checkpoint=2 * step,
                snapshot=2 * step, samples=4 * step, test_data_path=test_data,
                sr_model=sr_model)
            c.lr_kwargs.rampup_Mimg = 0.0   # the preset's ramp-up starts at LR 0
            c.update(kw)
            run_dir = os.path.join(tmp, name)
            return run_dir, launch_training(run_dir, c)

        # Run A, with the sample grid's sampler calls counted.
        sampled = {"base": [], "sr": []}

        def counted(fn, key):
            def run(*args, **kwargs):
                before = dict(flash.launches)
                out = fn(*args, **kwargs)
                sampled[key].append(({k: n - before[k] for k, n in flash.launches.items()
                                      if n != before[k]}, out))
                return out
            return run

        for name in flash.launches:
            flash.launches[name] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(loop, "edm_sampler", counted(loop.edm_sampler, "base")), \
                mock.patch.object(loop, "sr_cascade", counted(loop.sr_cascade, "sr")):
            a_dir, a = train("a")
        torch.cuda.synchronize()
        a_seconds = time.perf_counter() - t0
        launches = dict(flash.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        cfg = a.state.net.cfg
        check(a.state.cur_nimg == 4 * step and a.state.adam_step == 4,
              f"shell: run A ended at {a.state.cur_nimg} nimg, step {a.state.adam_step}")
        per_eval = {"flash_fused_packed": len(attention_feature_spec(cfg.encoder_cfg)),
                    "flash_fused_packed_xattn": len(attention_feature_spec(cfg.unet_cfg)),
                    **_mp_per_eval(cfg)}
        want_base = {k: n * evals for k, n in per_eval.items()}
        want_sr = {k: n * evals for k, n in _sr_per_eval().items()}
        check(len(sampled["base"]) == len(sampled["sr"]) == 1,
              f"shell: {len(sampled['base'])} grids sampled, want 1")
        (base_used, base_lat), (sr_used, sr_lat) = sampled["base"][0], sampled["sr"][0]
        check(base_used == want_base and sr_used == want_sr,
              f"shell: the grid launched {base_used} + {sr_used}, want {want_base} + {want_sr}")
        want = {k: 4 * n + want_base.get(k, 0) + want_sr.get(k, 0)
                for k, n in _train_launches(cfg).items()}
        check(launches == want, f"shell: run A launched {launches}, want {want}")
        check(bool(torch.isfinite(base_lat).all() and torch.isfinite(sr_lat).all())
              and sr_lat.shape == (8, 256, 256, 3), f"shell: grid latents {sr_lat.shape}")
        grid_path = os.path.join(a_dir, "results", "generated-samples-0000000.png")
        grid = PIL.Image.open(grid_path)
        check(grid.size == (8 * 256, 3 * 256), f"shell: grid {grid.size}, want 3 rows of 256 px")
        check(float(np.asarray(grid, np.float32).std()) > 0, "shell: a constant grid")
        say("shell", run="A", steps=4, seconds=f"{a_seconds:.2f}", launches=launches,
            grid=f"{grid.size[0]}x{grid.size[1]}", grid_launches_base=base_used,
            grid_launches_sr=sr_used, peak_memory_GB=f"{peak_gb:.2f}", card=f"'{card}'")

        # The checkpoint's size and the holder's two times: the first save
        # allocates the pinned host copies, the second reuses them.
        io = checkpoint.CheckpointIO(state=a.state)
        path = os.path.join(tmp, "timing.pt")
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            io.save(path, async_=True)
            call_s = time.perf_counter() - t0
            io.wait()
            times.append((call_s, io.copy_seconds, io.write_seconds))
        size_gb = os.path.getsize(path) / 1e9
        os.remove(path)
        del io
        say("shell", checkpoint_GB=f"{size_gb:.3f}",
            save_call_s=[f"{t[0]:.3f}" for t in times],
            device_to_host_s=[f"{t[1]:.3f}" for t in times],
            background_write_s=[f"{t[2]:.3f}" for t in times],
            write_GB_per_s=f"{size_gb / times[1][2]:.2f}", card=f"'{card}'")

        # Run B: a slice of 2 steps, then a resume.
        b_dir, b1 = train("b", slice_nimg=2 * step)
        log = open(os.path.join(b_dir, "log.txt")).read()
        saved = os.path.join(b_dir, "training-state-0000000.pt")
        check(b1.state.cur_nimg == 2 * step and os.path.exists(saved)
              and f"Suspending at {2 * step} nimg with a checkpoint" in log,
              f"shell: the slice ended at {b1.state.cur_nimg} nimg:\n{log[-2000:]}")
        del b1
        # Links to the slice's checkpoint, for the faults and for run C.
        for name in ("fault_a", "fault_b"):
            os.makedirs(os.path.join(tmp, name))
            os.link(saved, os.path.join(tmp, name, "training-state-0000000.pt"))
        os.link(saved, os.path.join(tmp, "slice_96.pt"))
        _, b2 = train("b", slice_nimg=2 * step)
        log = open(os.path.join(b_dir, "log.txt")).read()
        resumed = re.search(r"Resumed at (\d+) nimg, step (\d+), in ([0-9.]+) s", log)
        check("Resuming from" in log and resumed and int(resumed.group(1)) == 2 * step,
              f"shell: run B did not resume:\n{log[-2000:]}")
        diff = _same_state(a.state, b2.state)
        check(not diff and b2.state.cur_nimg == 4 * step,
              f"shell: killed and resumed differs from straight in {diff}")
        del b2
        say("shell", run="B", gate="bitwise_equal_to_A", slice_nimg=2 * step,
            resume_s=resumed.group(3), card=f"'{card}'")

        # Planted faults in the resume: each must break the gate.
        quiet = dict(slice_nimg=2 * step, checkpoint_nimg=None, snapshot_nimg=None,
                     samples_nimg=None, test_dataset_path=None, sr_model=None)
        real_load = checkpoint.load_checkpoint

        def zero_adam_v(p):
            data = real_load(p)
            for t in data["state"]["adam_v"].values():
                t.zero_()
            return data

        faults = {"fault_a": mock.patch.object(
                      loop, "BatchLoader", lambda *args, skip_rows=0, **kw: BatchLoader(*args, **kw)),
                  "fault_b": mock.patch.object(checkpoint, "load_checkpoint", zero_adam_v)}
        for name, planted in faults.items():
            with planted:
                _, f = train(name, **quiet)
            diff = _same_state(a.state, f.state)
            check(f.state.cur_nimg == 4 * step and diff,
                  f"shell: {name} passes the gate (differs in {diff})")
            say("shell", planted=name, differs_in=diff)
            del f

        # Run C: suspended at its third status tick, no checkpoint interval reached.
        ticks = []

        def suspend_at_third_tick():
            ticks.append(1)
            return len(ticks) > 2

        with mock.patch.object(dist, "should_suspend", suspend_at_third_tick):
            c_dir, c = train("c", checkpoint_nimg=10 ** 9, samples_nimg=None)
        files = sorted(f for f in os.listdir(c_dir) if f.startswith("training-state-"))
        check(c.state.cur_nimg == 2 * step and files == ["training-state-0000000.pt"],
              f"shell: run C stopped at {c.state.cur_nimg} nimg with {files}")
        del c
        got = checkpoint.load_checkpoint(os.path.join(c_dir, files[0]))["state"]
        want_state = checkpoint.load_checkpoint(os.path.join(tmp, "slice_96.pt"))["state"]
        check(got["cur_nimg"] == 2 * step and got["adam_step"] == 2,
              f"shell: run C's checkpoint is at {got['cur_nimg']} nimg")
        for key in ("params", "adam_m", "adam_v"):
            check(all(torch.equal(got[key][n], want_state[key][n]) for n in want_state[key]),
                  f"shell: run C's {key} at 96 nimg differ from the slice's")
        check(all(torch.equal(x[n], y[n]) for x, y in zip(got["emas"], want_state["emas"])
                  for n in y), "shell: run C's EMAs at 96 nimg differ from the slice's")
        del got, want_state
        say("shell", run="C", suspended_at_nimg=2 * step, checkpoint=files[0],
            equal_to_the_slice_checkpoint=True)

        # Post-hoc EMA at std 0.075 from 2 points x 2 stds: C's snapshots at
        # 96 nimg and A's at 192 (both named for kimg 0).
        triples = [(nimg, std, load_snapshot(os.path.join(
                        d, f"network-snapshot-0000000-{std:.3f}.pkl")).net.state_dict())
                   for nimg, d in ((2 * step, c_dir), (4 * step, a_dir)) for std in (0.050, 0.100)]
        t0 = time.perf_counter()
        res = phema.reconstruct_phema(triples, 0.075, verbose=False)[0]
        phema_s = time.perf_counter() - t0
        coef = phema.solve_posthoc_coefficients([t[0] for t in triples], [t[1] for t in triples],
                                                [4 * step], [0.075])[:, 0]
        worst = 0.0
        for name, value in res.params.items():
            mix = sum(float(k) * t[2][name].double() for k, t in zip(coef, triples))
            worst = max(worst, ((value.double() - mix).abs().max()
                                / mix.abs().max().clamp_min(1e-30)).item())
        check(res.nimg == 4 * step and worst <= 1e-6,
              f"shell: post-hoc weights off the fp64 combination by {worst} (relative)")
        net = NVPrecond(cfg, device="meta").to_empty(device="cuda")
        net.load_state_dict(res.params)
        net.eval().requires_grad_(False)
        del triples, res
        loader = BatchLoader(iter(SceneDataset(data, seed=1)), DualSourceCollate(64, seed=1),
                             batch_size=BATCH)
        raw = next(loader)
        loader.close()
        enc = StandardRGBEncoder()
        src = enc.encode_latents(raw["src_image"], device="cuda")
        noisy = torch.randn((BATCH, 64, 64, 3), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(0))
        for name in flash.launches:
            flash.launches[name] = 0
        with torch.no_grad():
            out = net(src, noisy, torch.full((BATCH,), 1.0, device="cuda"),
                      torch.as_tensor(raw["geometry"], device="cuda"))
        torch.cuda.synchronize()
        used = {k: n for k, n in flash.launches.items() if n}
        check(bool(torch.isfinite(out).all()) and used == per_eval,
              f"shell: the post-hoc model's evaluation: finite {bool(torch.isfinite(out).all())}, "
              f"launches {used}, want {per_eval}")
        del net, out
        say("shell", phema_std=0.075, inputs="2_nimg_x_2_std", coefficients=[
            f"{k:+.5f}" for k in coef], max_rel_err_vs_fp64_mix=f"{worst:.2e}",
            reconstruct_s=f"{phema_s:.2f}", evaluation_launches=used)

        # ms per step with and without the deterministic mode (one run each:
        # a cut to the smoke's time from the turns True, False, False, True).
        step_ms = {True: [], False: []}
        for det in (True, False):
            _, r = train(f"timing_{len(step_ms[True]) + len(step_ms[False])}", deterministic=det,
                         **dict(quiet, slice_nimg=None))
            step_ms[det].append(statistics.median(t["seconds"] for t in r.ticks[2:]) * 1e3)
            del r
        torch.cuda.empty_cache()
        say("shell", ms_per_step_deterministic=[f"{x:.1f}" for x in step_ms[True]],
            ms_per_step_default=[f"{x:.1f}" for x in step_ms[False]],
            note="median_of_steps_2_to_4", card=f"'{card}'")


# ---------------------------------------------------------------------------
# Phase `dist`: torch.distributed on the one card. Each job runs in spawned
# processes of its own (one a rank), joined or killed within DIST_TIMEOUT.

DIST_TIMEOUT = 300      # seconds a job may take before its processes are killed
OUTLIER = 30.0          # one target row scaled by this (on rank 1): the clamp's statistics feel it
TOL_DIST_CUT = 1e-5     # rel L2, two ranks' gradient vs the batch cut the same way in one process
TOL_DIST_STEP = 1e-5    # relative, two ranks' step-1 loss and global norm vs that process's step


def _spawn_ranks(fn, world, workdir, timeout=DIST_TIMEOUT, env=None, **kwargs):
    """(results, problems): what `fn(rank, world, **kwargs)` returned on each
    of `world` spawned processes, and what went wrong (a rank that raised,
    exited without a result or outlived `timeout`, with the end of its
    output). Each rank finds the launcher's environment that `dist.init`
    reads: VIVID_COORDINATOR on a FileStore of this job's own under
    `workdir`, VIVID_NUM_PROCESSES and VIVID_PROCESS_ID. Each rank's output
    goes to a file; its `[dist]` lines are printed here. Every process is
    joined or killed before this returns."""
    import multiprocessing
    import pickle
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(workdir, f"store_{fn.__name__}")
    outs = [os.path.join(workdir, f"{fn.__name__}_rank{r}.pkl") for r in range(world)]
    with _environ(**(env or {})):
        procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, store, outs[r], kwargs))
                 for r in range(world)]
        for p in procs:
            p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
    results, problems = [], [f"rank {r} still running after {timeout} s" for r in hung]
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = open(out + ".log", errors="replace").read().splitlines() \
            if os.path.exists(out + ".log") else []
        for line in lines:
            if line.startswith("[dist]"):
                print(line, flush=True)
        tail = "\n".join(lines[-80:])
        if not os.path.exists(out):
            problems.append(f"rank {r} exited with {p.exitcode} and no result; its output "
                            f"ended:\n{tail}")
            results.append(None)
            continue
        with open(out, "rb") as f:
            status, value = pickle.load(f)
        if status == "error":
            problems.append(f"rank {r} raised:\n{value}\nits output ended:\n{tail}")
            value = None
        results.append(value)
    return results, problems


def _rank_entry(fn, rank, world, store, out, kwargs):
    """A spawned rank: the launcher's environment, its output to a file
    beside `out`, the card's settings as `phase_device` makes them, the job,
    its result written for the parent; then the process ends at once (a
    group whose start-up failed is not torn down)."""
    import pickle
    import traceback
    os.environ.update(VIVID_COORDINATOR=f"file://{store}", VIVID_NUM_PROCESSES=str(world),
                      VIVID_PROCESS_ID=str(rank))
    log = open(out + ".log", "w")
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    sys.stdout = sys.stderr = log
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        result = ("ok", fn(rank, world, **kwargs))
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    sys.stdout.flush()
    os._exit(0)


def _agree(a_state, b_state, lr, steps):
    """How two training states that took `steps` Adam steps at rate `lr`
    agree: (a line for each group, bitwise everywhere, within the hold
    everywhere). A line says bitwise or not, and for the parameters and
    EMAs the largest difference in units of lr and the share of values
    further apart than 0.01 lr a step, for the moments the relative L2. The
    hold is the CPU tests' on stepped tensors: 2.1 lr a step, a share of
    1e-3, moments 2e-3."""
    import torch
    from vivid_tpu_torch.core.sharding import full_tensor
    out, all_bitwise, all_held = {}, True, True
    pairs = [(g, getattr(a_state, g), getattr(b_state, g)) for g in ("params", "adam_m", "adam_v")]
    pairs += [(f"emas[{i}]", a, b) for i, (a, b) in enumerate(zip(a_state.emas, b_state.emas))]
    for group, xs, ys in pairs:
        bitwise, worst, far, n, sq_d, sq = True, 0.0, 0, 0, 0.0, 0.0
        for a, b in zip(xs, ys):
            a, b = full_tensor(a).double(), full_tensor(b).double()
            bitwise = bitwise and torch.equal(a, b)
            d = (a - b).abs()
            if d.numel():
                worst = max(worst, d.max().item())
            far += int((d > 0.01 * lr * steps).sum())
            n += d.numel()
            sq_d += d.square().sum().item()
            sq += b.square().sum().item()
        moments = group.startswith("adam")
        rel = (sq_d / max(sq, 1e-300)) ** 0.5
        out[group] = (f"bitwise={bitwise}_rel_l2={rel:.2e}" if moments else
                      f"bitwise={bitwise}_max_lr={worst / lr:.3g}_far_share={far / n:.2e}")
        all_bitwise = all_bitwise and bitwise
        all_held = all_held and (bitwise or (rel <= 2e-3 if moments else
                                             worst <= 2.1 * lr * steps and far <= 1e-3 * n))
    return out, all_bitwise, all_held


def _dist_one_card(rank, world, data, tmp):
    """NCCL at world size 1: the host reductions on the card; then
    `vivid-base` at full width, batch 8, 2 deterministic steps through the
    trainer's entry point with and without --fsdp, and a --fsdp slice of 1
    step resumed without --fsdp for the second. `dist.init` makes no group
    for one process, so this job makes it, on the launcher's store."""
    import numpy as np
    import torch
    from vivid_tpu_torch.cli.train_nvs import launch_training, setup_training_config
    from vivid_tpu_torch.core import dist, stats as stats_mod
    dist.init(device="cuda:0")
    check(not torch.distributed.is_initialized(), "dist: dist.init made a group of one")
    torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "nccl", init_method=os.environ["VIVID_COORDINATOR"], rank=rank, world_size=world,
        device_id=torch.device("cuda", 0))
    # Fault 1 of the port before this phase: its reductions took host
    # tensors, which NCCL refuses.
    try:
        torch.distributed.all_reduce(torch.ones(2))
        torch.cuda.synchronize()
        refused = None
    except Exception as err:   # noqa: BLE001 (the refusal is what is shown)
        refused = str(err).splitlines()[0][:160]
    check(refused is not None, "dist: NCCL took a host tensor")
    summed = dist.all_reduce_sum(np.array([1.5, 2.5]))
    stats = stats_mod.Stats()
    collector = stats_mod.Collector(stats)
    stats.report("x", [1.0, 3.0])
    collector.update()
    moments = collector.as_dict()["x"]
    check(list(summed) == [1.5, 2.5] and moments.num == 2 and moments.mean == 2.0,
          f"dist: all_reduce_sum {summed}, stats {moments}")
    say("dist", check="nccl_world_1", dist_init_made_a_group=False,
        backend=torch.distributed.get_backend(),
        group_device=dist.group_device(), all_reduce_sum=list(summed),
        stats_num=moments.num, stats_mean=moments.mean, host_tensor_refused=f"'{refused}'")

    def train(name, fsdp, steps, slice_nimg=None):
        c = setup_training_config(preset="vivid-base", data=data, batch=BATCH, remat="false",
                                  seed=0, device="cuda", deterministic=True, fsdp=fsdp)
        c.update(status_nimg=BATCH * 6, snapshot_nimg=None, samples_nimg=None,
                 checkpoint_nimg=BATCH * 6 if slice_nimg else None, max_steps=steps,
                 slice_nimg=slice_nimg)
        c.lr_kwargs.rampup_Mimg = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = launch_training(os.path.join(tmp, name), c)
        torch.cuda.synchronize()
        step_ms = [round(t["seconds"] * 1e3, 1) for t in result.ticks[1:]]
        say("dist", run=name, fsdp=fsdp, steps=steps, step_ms_not_speed=step_ms,
            total_s=f"{time.perf_counter() - t0:.2f}",
            loss=[round(t["loss"], 5) for t in result.ticks[1:]])
        return result.state

    plain = train("plain", False, 2)

    def compare(tag, other):
        lines, bitwise, held = _agree(other, plain, 0.0120, 2)   # the preset's learning rate
        say("dist", check=tag, bitwise=bitwise, within_hold=held, **lines)
        check(held, f"dist: {tag}: {lines}")
        return bitwise

    fsdp_state = train("fsdp", True, 2)
    fsdp_bitwise = compare("fsdp_vs_plain", fsdp_state)
    del fsdp_state
    train("fsdp_then_plain", True, 1, slice_nimg=BATCH * 6)
    resumed = train("fsdp_then_plain", False, 1)
    check(resumed.cur_nimg == plain.cur_nimg and resumed.adam_step == 2,
          f"dist: the resume ended at {resumed.cur_nimg} nimg, step {resumed.adam_step}")
    resume_bitwise = compare("fsdp_checkpoint_resumed_without_fsdp", resumed)
    return dict(fsdp_bitwise=fsdp_bitwise, resume_bitwise=resume_bitwise, refused=refused)


def _dist_nccl_probe(rank, world):
    """Two ranks on the one card through the port's start-up, `dist.init`
    on cuda:0, which picks NCCL: the start-up and one all-reduce, or NCCL's
    refusal, where it came (`stage`) and the group left behind (its backend,
    or None)."""
    import torch
    from vivid_tpu_torch.core import dist
    stage = "dist.init"
    try:
        dist.init(device="cuda:0")
        stage = "all_reduce"
        t = torch.ones(1, device="cuda:0")
        torch.distributed.all_reduce(t)
        torch.cuda.synchronize()
        return dict(ok=t.item() == world, answer="ok", stage=stage,
                    backend=torch.distributed.get_backend())
    except Exception as err:   # noqa: BLE001 (NCCL's refusal is the answer)
        text = " ".join(str(err).split())
        left = torch.distributed.get_backend() if torch.distributed.is_initialized() else None
        return dict(ok=False, answer=f"{stage}: {type(err).__name__}: {text[:300]}",
                    stage=stage, backend=left)


def _noisy_kernels(stack, noise_gen, names):
    """Patch the named attention kernels of `flash` so that each output
    moves by one bf16 ulp (the control of the model and train phases)."""
    from unittest import mock
    from vivid_tpu_torch.kernels import flash

    def noisy(fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            if isinstance(out, tuple):
                return (_ulp_noise(out[0], noise_gen),
                        tuple(_ulp_noise(t, noise_gen) for t in out[1]), out[2])
            return _ulp_noise(out, noise_gen)
        return run
    for name in names:
        stack.enter_context(mock.patch.object(flash, name, noisy(getattr(flash, name))))


def _noisy_products(stack, nets, noise_gen):
    """One bf16 ulp on every MPConv output of `nets` (forward hooks) and on
    every attention output: the control for tensor parallelism, which
    changes where the products' partial sums are rounded."""
    from vivid_tpu_torch.nn.mp import MPConv
    hooks = [m.register_forward_hook(lambda mod, args, out: _ulp_noise(out, noise_gen))
             for net in nets for m in net.modules() if isinstance(m, MPConv)]
    stack.callback(lambda: [h.remove() for h in hooks])
    _noisy_kernels(stack, noise_gen, ("flash_fused_packed", "flash_fused_packed_xattn",
                                      "flash_nomax"))


def _self_normalised(stack):
    """The planted fault of tensor parallelism: a row-parallel weight slice
    (input channels) normalised by itself instead of the whole weight."""
    from unittest import mock
    import torch
    from vivid_tpu_torch.nn import mp
    real = mp.MPConv.normalized_weight

    def sliced_first(conv, dtype, gain=1.0, rows=None, cols=None):
        if cols is None:
            return real(conv, dtype, gain, rows)
        part = mp.MPConv(1, 1, ())
        part.weight = torch.nn.Parameter(conv.weight[:, cols], requires_grad=False)
        return real(part, dtype, gain, rows)
    stack.enter_context(mock.patch.object(mp.MPConv, "normalized_weight", sliced_first))


def _digest(t):
    import hashlib
    return hashlib.sha256(t.detach().float().cpu().numpy().tobytes()).hexdigest()[:16]


def _dist_two_ranks(rank, world, backend, data, tmp):
    """Two ranks on the one card over `backend`: the data-parallel gradient
    and steps of full-width vivid-base against one rank at batch 8, with a
    planted per-rank clamp; the consistency check and a one-ulp nudge;
    tensor parallelism (tp 2) of vivid-base, vivid-uncond and vivid-sr
    against tp 1 with a planted fault, guided sampling under tp 2 and seed
    sharding through `generate_images_nvs`."""
    import contextlib
    import dataclasses
    from unittest import mock
    import PIL.Image
    import torch
    from vivid_tpu_torch import generate
    from vivid_tpu_torch.core import consistency, dist, sharding
    from vivid_tpu_torch.core.easydict import EasyDict
    from vivid_tpu_torch.diffusion.loss import NVLoss, clamp_loss, global_moments
    from vivid_tpu_torch.kernels import flash
    from vivid_tpu_torch.nn.blocks import Block
    from vivid_tpu_torch.train import step as step_mod
    from vivid_tpu_torch.train.step import TrainConfig, init_train_state, make_train_step
    dist.init(backend=backend, device="cuda:0")   # every rank on the one card
    check(torch.distributed.get_backend() == backend,
          f"dist: dist.init chose {torch.distributed.get_backend()}, not {backend}")
    group = dist.group()
    lead = rank == 0
    report = say if lead else (lambda *a, **k: None)

    def settle(tag, problems):
        """Fail on every rank if any rank found a problem: a check that only
        rank 0 makes must not leave rank 1 waiting in the next collective."""
        everyone = [None] * world
        torch.distributed.all_gather_object(everyone, problems)
        check(not any(everyone), f"dist: {tag}: {everyone}")

    # Data parallel: the gradient of one global batch of 8, 4 rows a rank.
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = dict(
        src=torch.randn(BATCH, 2, 64, 64, 3, generator=gen, device="cuda").clamp(-1, 1),
        tgt=torch.randn(BATCH, 64, 64, 3, generator=gen, device="cuda").clamp(-1, 1),
        geometry=torch.randn(BATCH, 2, 20, generator=gen, device="cuda"))
    batch["tgt"][BATCH - 1] *= OUTLIER
    loss_fn = NVLoss(P_mean=-0.8, P_std=1.6)
    draws = [(loss_fn.sample_sigma(gen, BATCH, "cuda"),
              torch.randn(batch["tgt"].shape, generator=gen, device="cuda")) for _ in range(2)]
    half = slice(rank * BATCH // world, (rank + 1) * BATCH // world)
    every = slice(0, BATCH)
    net = _full_width(uncond=False, train=True)
    params = list(net.parameters())
    noise_gen = torch.Generator(device="cuda")

    def gradient(rows, reduce=True, per_rank=False, control=False):
        with contextlib.ExitStack() as stack:
            if control:
                _noisy_kernels(stack, noise_gen, ("flash_fused_packed", "flash_fused_packed_xattn",
                                                  "flash_fused_packed_bwd",
                                                  "flash_fused_packed_xattn_bwd"))
            noise_gen.manual_seed(5)
            for p in params:
                p.grad = None
            sigma, eps = draws[0]
            loss = loss_fn(net, batch["src"][rows], batch["tgt"][rows], batch["geometry"][rows],
                           sigma=sigma[rows], eps=eps[rows])
            loss = clamp_loss(loss, None if per_rank or not reduce else group)
            (loss.sum() / loss.shape[0]).backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if reduce:
            sharding.all_reduce_gradients(grads, group)
        flat = torch.cat([g.float().reshape(-1) for g in grads])
        for p in params:
            p.grad = None
        return flat

    def gradient_split():
        """One process, the batch cut into the ranks' shares: each share's
        forward and clamp (with the whole batch's statistics), the mean of
        their scaled sums, one backward. The rounding that cutting the batch
        brings, with no communication."""
        for p in params:
            p.grad = None
        sigma, eps = draws[0]
        shares = [slice(r * BATCH // world, (r + 1) * BATCH // world) for r in range(world)]
        losses = [loss_fn(net, batch["src"][c], batch["tgt"][c], batch["geometry"][c],
                          sigma=sigma[c], eps=eps[c]) for c in shares]
        _, m, s = global_moments(torch.cat([l.detach().reshape(-1) for l in losses]))
        sum(torch.clamp(l, m - 3 * s, m + 3 * s).sum() / l.shape[0] for l in losses).div(
            world).backward()
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                          .float().reshape(-1) for p in params])
        for p in params:
            p.grad = None
        return flat

    got = gradient(half)
    faulty = gradient(half, per_rank=True)
    problems = []
    if lead:
        want = gradient(every, reduce=False)
        control = _rel_l2(gradient(every, reduce=False, control=True), want)
        split = gradient_split()
        control_split = _rel_l2(split, want)
        err, fault, cut = _rel_l2(got, want), _rel_l2(faulty, want), _rel_l2(got, split)
        gate = TOL_GRAD_CONTROL * max(control, control_split)
        report("dist", check="data_parallel_gradient",
               backend_chosen_by_dist_init=torch.distributed.get_backend(), net="vivid-base",
               batch=f"{BATCH}_as_2x{BATCH // world}", outlier_row=BATCH - 1,
               grad_rel_l2=f"{err:.3e}", control_ulp_rel_l2=f"{control:.3e}",
               control_batch_cut_rel_l2=f"{control_split:.3e}",
               ratio=f"{err / max(control, control_split):.3f}", gate=f"{gate:.3e}",
               vs_batch_cut_in_one_process_rel_l2=f"{cut:.3e}", batch_cut_gate=TOL_DIST_CUT,
               fault_per_rank_clamp_rel_l2=f"{fault:.3e}")
        if err > gate:
            problems.append(f"data-parallel gradient rel L2 {err} > {gate}")
        if cut > TOL_DIST_CUT:
            problems.append(f"data-parallel gradient against the batch cut in one process: "
                            f"rel L2 {cut} > {TOL_DIST_CUT}")
        if fault <= gate:
            problems.append(f"the per-rank clamp gives {fault}, within the gate {gate}")
        del want, split
    del got, faulty
    settle("data-parallel gradient", problems)

    # Two steps of make_train_step(group), each rank on its half, against one
    # process that steps the same cut batch: the halves as its two
    # microbatches (num_accum 2), clamped with the statistics that
    # global_moments takes over the ranks (each share's fp64 sums, added).
    # Step 1 is checked: the global loss, Grad/global_norm and every tensor
    # of the state after the update. Step 2 is reported, not checked: it
    # follows updates that differ by rounding, and Adam's first steps turn
    # the rounding of a gradient near 0 into up to 2 lr.
    cfg = TrainConfig(batch_size=BATCH, ref_lr=0.0120, ref_batches=35000, rampup_Mimg=0.0,
                      nimg_mult=6)
    state = init_train_state(net, cfg)
    step = make_train_step(loss_fn, cfg, group=group)
    shares = [slice(r * BATCH // world, (r + 1) * BATCH // world) for r in range(world)]
    if lead:
        one = init_train_state(_full_width(uncond=False, train=True), cfg)
        one_step = make_train_step(loss_fn, dataclasses.replace(cfg, num_accum=world))

    def sums(ls):
        return sum(torch.stack([torch.tensor(float(l.numel()), dtype=torch.float64,
                                             device=l.device), l.double().sum(),
                                l.double().square().sum()]) for l in ls)

    def cut_step(sigma, eps):
        """One step of the cut batch in one process: (its stats, the global
        loss of its clamped shares). The clamp's statistics come from the
        trainer's own forward, with autograd on: with it off the blocks take
        the fused elementwise kernels (kernels/mp_fused.py), whose pixel norm
        rounds apart from the composite that the ranks' step runs."""
        with torch.enable_grad():
            losses = [loss_fn(one.net, batch["src"][c], batch["tgt"][c], batch["geometry"][c],
                              sigma=sigma[c], eps=eps[c]).detach() for c in shares]
        n, s, ss = sums(losses).unbind()
        m = s / n
        sd = torch.sqrt(torch.clamp(ss / n - m * m, min=0.0))
        lo, hi = (m - 3 * sd).to(losses[0].dtype), (m + 3 * sd).to(losses[0].dtype)
        n, s, _ = sums([torch.clamp(l, lo, hi) for l in losses]).unbind()
        with mock.patch.object(step_mod, "clamp_loss",
                               lambda loss, group=None: torch.clamp(loss, lo, hi)):
            st = one_step(one, batch, sigma=sigma, eps=eps)
        return st, (s / n).item()

    stats, norms, step_ms, one_stats, one_norms = [], [], [], [], []
    for i, (sigma, eps) in enumerate(draws):
        problems = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = step(state, {k: v[half] for k, v in batch.items()}, sigma=sigma[half], eps=eps[half])
        stats.append(float(st["Loss/loss"]))
        norms.append(float(st["Grad/global_norm"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if lead:
            one_st, one_loss = cut_step(sigma, eps)
            one_stats.append(one_loss)
            one_norms.append(float(one_st["Grad/global_norm"]))
            lines, bitwise, held = _agree(state, one, cfg.ref_lr, i + 1)
            report("dist", check=f"data_parallel_step_{i + 1}", checked=i == 0,
                   against="one_process_cut_batch_global_clamp", loss_two_ranks=stats[-1],
                   loss_one_process=one_loss, global_norm_two_ranks=norms[-1],
                   global_norm_one_process=one_norms[-1],
                   step_ms_not_speed=round(step_ms[-1], 1), bitwise=bitwise, within_hold=held,
                   **lines)
            if i == 0:
                for what, a, b in (("global loss", stats[-1], one_loss),
                                   ("Grad/global_norm", norms[-1], one_norms[-1])):
                    if abs(a - b) > TOL_DIST_STEP * abs(b):
                        problems.append(f"step 1: {what} {a} on two ranks, {b} in one process")
                if not held:
                    problems.append(f"step 1: the state after the update: {lines}")
        settle(f"data-parallel step {i + 1}", problems)
    if lead:
        del one
    # The replicas agree; one ulp on rank 1 is caught on both ranks.
    named = dict(zip(state.names, state.params))
    check(consistency.check_param_consistency(named, "net params"), "dist: consistency")
    if rank == 1:
        with torch.no_grad():
            w = state.params[0].view(-1)
            w[0] = torch.nextafter(w[0], torch.tensor(float("inf"), device=w.device))
    try:
        consistency.check_param_consistency(named, "net params")
        nudged = None
    except RuntimeError as err:
        nudged = str(err)
    check(nudged is not None and "'net params'" in nudged,
          f"dist: a one-ulp divergence passed the consistency check: {nudged}")
    report("dist", check="consistency", equal_replicas="pass", one_ulp_on_rank_1=f"'{nudged}'")
    del net, params, state, step, named
    torch.cuda.empty_cache()

    # Tensor parallelism: one NVPrecond call at tp 2 against tp 1.
    tp_group, _, _, _ = sharding.tp_groups(world)
    g2 = torch.Generator(device="cuda").manual_seed(1)
    base_in = (torch.randn(BATCH, 2, 64, 64, 3, generator=g2, device="cuda").clamp(-1, 1),
               torch.randn(BATCH, 64, 64, 3, generator=g2, device="cuda"),
               torch.ones(BATCH, device="cuda"),
               torch.randn(BATCH, 2, 20, generator=g2, device="cuda"))
    sr_b = BATCH // 2
    sr_in = (torch.randn(sr_b, 1, 256, 256, 3, generator=g2, device="cuda").clamp(-1, 1),
             torch.randn(sr_b, 256, 256, 3, generator=g2, device="cuda"),
             torch.ones(sr_b, device="cuda"), torch.randn(sr_b, 1, 20, generator=g2, device="cuda"))
    sr_kw = dict(conditioning_image=torch.randn(sr_b, 256, 256, 3, generator=g2,
                                                device="cuda").clamp(-1, 1),
                 cond_noise=torch.randn(sr_b, 256, 256, 3, generator=g2, device="cuda"))
    for label, make, args, kw in (("vivid-base", lambda: _full_width(False), base_in, {}),
                                  ("vivid-uncond", lambda: _full_width(True), base_in, {}),
                                  ("vivid-sr", _full_width_sr, sr_in, sr_kw)):
        whole, split = make(), sharding.tensor_parallel(make(), tp_group)

        def run(net, stack_fn=None):
            with contextlib.ExitStack() as stack, torch.no_grad():
                if stack_fn:
                    stack_fn(stack)
                noise_gen.manual_seed(2)
                return net(*args, **kw)
        want = run(whole)
        control = _rel_l2(run(whole, lambda s: _noisy_products(s, [whole], noise_gen)), want)
        before = dict(flash.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run(split)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3
        used = {k: n - before[k] for k, n in flash.launches.items() if n - before[k]}
        faulty = _rel_l2(run(split, _self_normalised), want)
        digests = [None] * world
        torch.distributed.all_gather_object(digests, _digest(got))
        err = _rel_l2(got, want)
        gate = TOL_CONTROL * control
        blocks = [m for m in split.modules() if isinstance(m, Block)]
        n_split, n_blocks = sum(m.tp is not None for m in blocks), len(blocks)
        report("dist", check="tp2_forward", net=label, batch=args[1].shape[0],
               blocks_split=f"{n_split}_of_{n_blocks}", kernel_launches_per_rank=used,
               d_x_rel_l2_vs_tp1=f"{err:.3e}", control_rel_l2=f"{control:.3e}",
               ratio=f"{err / control:.3f}", gate=f"{gate:.3e}",
               fault_self_normalised_slice_rel_l2=f"{faulty:.3e}",
               ranks_bitwise_equal=len(set(digests)) == 1, eval_ms_not_speed=f"{eval_ms:.1f}")
        check(len(set(digests)) == 1, f"dist: {label}: the two ranks' D_x differ: {digests}")
        check(bool(torch.isfinite(got).all()) and err <= gate,
              f"dist: {label}: tp 2 against tp 1 rel L2 {err} > {gate} (control {control})")
        check(faulty > gate, f"dist: {label}: the self-normalised slice gives {faulty}, "
                             f"within the gate {gate}")
        del whole, split, want, got
        torch.cuda.empty_cache()

    # Guided sampling through generate_images_nvs at tp 2 (8 seeds, 4 Heun
    # steps: 7 guided evaluations), against tp 1 and its control on rank 0.
    # Those two call the sampler directly on the inputs the tp 2 run gave
    # it: generate_images_nvs itself is collective over the two ranks.
    from vivid_tpu_torch.diffusion.sampler import edm_sampler, make_denoiser
    seeds, steps = list(range(BATCH)), 2   # of the sampler's 32: a cut for time
    base, gnet = _full_width(False), _full_width(True)
    pair = lambda b, g: dict(net=EasyDict(net=b, cfg=b.cfg), gnet=EasyDict(net=g, cfg=g.cfg))
    common = dict(guidance=1.5, seeds=seeds, max_batch_size=BATCH, num_steps=steps,
                  datakwargs={"path": data}, device="cuda", verbose=False)

    def sample(nets, **kw):
        """The rows of generate_images_nvs, the sampler's output and what it
        was given: the base denoiser's sources and geometry, and the noise."""
        seen = {}
        real_sampler, real_denoiser = generate.edm_sampler, generate.make_denoiser

        def sampler(denoise, noise, **k):
            seen["noise"], seen["latents"] = noise, real_sampler(denoise, noise, **k)
            return seen["latents"]

        def denoiser(net, src=None, geometry=None, **k):
            if src is not None:
                seen["src"], seen["geometry"] = src, geometry
            return real_denoiser(net, src, geometry, **k)

        with mock.patch.object(generate, "edm_sampler", sampler), \
                mock.patch.object(generate, "make_denoiser", denoiser):
            rows = list(generate.generate_images_nvs(**nets, **common, **kw))
        torch.cuda.synchronize()
        return seen, rows

    def sample_whole(seen, stack_fn=None):
        with contextlib.ExitStack() as stack, torch.no_grad():
            if stack_fn:
                stack_fn(stack)
            noise_gen.manual_seed(3)
            out = edm_sampler(make_denoiser(base, seen["src"], seen["geometry"]), seen["noise"],
                              gnet_denoise=make_denoiser(gnet), guidance=1.5, seeds=seeds,
                              num_steps=steps)
        torch.cuda.synchronize()
        return out

    before = dict(flash.launches)
    t0 = time.perf_counter()
    seen, tp_rows = sample(pair(_full_width(False), _full_width(True)), tp=2,
                           outdir=os.path.join(tmp, "tp_out"))
    seconds = time.perf_counter() - t0
    tp_lat = seen["latents"]
    used = {k: n - before[k] for k, n in flash.launches.items() if n - before[k]}
    evals = 2 * steps - 1
    digests = [None] * world
    torch.distributed.all_gather_object(digests, _digest(tp_lat))
    mp = _mp_per_eval(_full_width_config(False), _full_width_config(True))
    want_used = {"flash_fused_packed": 34 * evals, "flash_fused_packed_xattn": 17 * evals,
                 **{k: n * evals for k, n in mp.items()}}
    problems = ([f"launched {used}, want 34 / 17 and {mp} per evaluation"]
                if used != want_used else [])
    if len(set(digests)) > 1:
        problems.append(f"the ranks sampled different latents: {digests}")
    if (tp_rows[0].images is None) != (rank != 0):
        problems.append(f"rank {rank} handed on images")
    if lead:
        one_lat = sample_whole(seen)
        control = _rel_l2(sample_whole(seen, lambda s: _noisy_products(s, [base, gnet],
                                                                       noise_gen)), one_lat)
        err = _rel_l2(tp_lat, one_lat)
        gate = TOL_CONTROL * control
        pngs = sorted(os.listdir(os.path.join(tmp, "tp_out")))
        report("dist", check="tp2_guided_sampling", seeds=len(seeds), heun_steps=steps,
               evaluations=evals, kernel_launches_per_rank=used,
               per_evaluation={k: n // evals for k, n in used.items()},
               latents_rel_l2_vs_tp1=f"{err:.3e}", control_rel_l2=f"{control:.3e}",
               ratio=f"{err / control:.3f}", gate=f"{gate:.3e}",
               ranks_bitwise_equal=len(set(digests)) == 1, pngs=len(pngs),
               seconds_not_speed=f"{seconds:.2f}",
               ms_per_evaluation_not_speed=f"{seconds * 1e3 / evals:.1f}")
        if not (bool(torch.isfinite(tp_lat).all()) and err <= gate):
            problems.append(f"rel L2 {err} > {gate} (control {control})")
        if len(pngs) != 3 * len(seeds):
            problems.append(f"wrote {pngs}")
    settle("tp 2 sampling", problems)
    del tp_lat, seen

    # Seed sharding: 8 seeds over the 2 ranks, each seed's PNGs written once.
    written = []
    real_save = PIL.Image.Image.save
    with mock.patch.object(PIL.Image.Image, "save",
                           lambda img, fp, *a, **k: (written.append(os.path.basename(fp)),
                                                     real_save(img, fp, *a, **k))[1]):
        _, rows = sample(pair(base, gnet), outdir=os.path.join(tmp, "seed_out"))
    everyone = [None] * world
    torch.distributed.all_gather_object(everyone, written)
    names = [n for w in everyone for n in w]
    mine = [s for r in rows for s in r.seeds]
    want_names = sorted(f"{p}_{s:06d}.png" for p in ("src", "tgt", "sample") for s in seeds)
    check(sorted(names) == want_names, f"dist: PNGs written {sorted(names)}")
    check(all(bool(torch.isfinite(torch.as_tensor(r.latents)).all()) for r in rows if r.seeds),
          "dist: non-finite latents in seed sharding")
    report("dist", check="seed_sharding", seeds=len(seeds), heun_steps=steps,
           rank0_seeds=mine, pngs_written=len(names), each_once=True)
    return {}


def phase_dist(card):
    """torch.distributed on the one card, each job in processes of its own:
    NCCL at world size 1 (the host reductions on the card; `vivid-base` with
    and without --fsdp through the trainer, and a --fsdp checkpoint resumed
    without it); NCCL's answer to two ranks on one card; then two ranks on
    the card over gloo with CUDA tensors (or NCCL, had it taken them): data
    parallel against one rank, consistency, tensor parallelism (tp 2), seed
    sharding. Its times are no speed: two ranks share one card, and gloo
    stages every collective through the host."""
    import torch
    from vivid_tpu_torch.data.scenes import make_synthetic_dataset
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="vivid_chip_smoke_dist_") as tmp:
        data = make_synthetic_dataset(os.path.join(tmp, "scenes"), num_scenes=16, num_views=8,
                                      imsize=64, seed=0)
        one, problems = _spawn_ranks(
            _dist_one_card, 1, tmp, env={"CUBLAS_WORKSPACE_CONFIG": SHELL_CUBLAS_WORKSPACE},
            data=data, tmp=tmp)
        check(not problems, "dist: NCCL at world size 1:\n" + "\n".join(problems))
        # The port's start-up at two ranks on the one card: NCCL, as dist.init
        # picks for a card. Where NCCL refuses, dist.init must raise and leave
        # no group of another backend behind.
        probe, problems = _spawn_ranks(_dist_nccl_probe, 2, tmp, timeout=120)
        backend = "nccl" if not problems and all(p["ok"] for p in probe) else "gloo"
        answers = sorted({p["answer"] for p in probe if p} | set(problems))
        left = sorted({str(p["backend"]) for p in probe if p and not p["ok"]})
        say("dist", check="nccl_two_ranks_on_one_card", through="dist.init(device='cuda:0')",
            answers=f"'{' | '.join(answers)}'", groups_left_after_refusal=left,
            two_rank_backend=backend)
        check(all(p["backend"] in (None, "nccl") for p in probe if p and not p["ok"]),
              f"dist: a refused NCCL start-up left a group behind: {left}")
        pair, problems = _spawn_ranks(_dist_two_ranks, 2, tmp, backend=backend, data=data,
                                      tmp=tmp)
        check(not problems, f"dist: two ranks over {backend}:\n" + "\n".join(problems))
    say("dist", seconds=f"{time.perf_counter() - t0:.1f}",
        fsdp_world_1_bitwise=one[0]["fsdp_bitwise"],
        fsdp_checkpoint_resumed_without_fsdp_bitwise=one[0]["resume_bitwise"],
        two_rank_backend=backend, card=f"'{card}'")


def phase_labs():
    """The [B, H, S, D] entries and the three kernel labs, as a user calls
    them. `attention_from_raw` (K5 forward with its norm pre-pass; backward the
    gradient of the unfused composite, through K8 forward and backward) and
    `fused_attention` (K8 both ways below 4096 queries, K6 + K8 from there
    on) at the 64px model's cross-attention shape and at 4096/8192: outputs
    by the forward limits and every gradient by TOL_GRAD_L2 against autograd
    through the plain composite in fp32. Then each lab's `main` at one timing
    case: parity first (a disagreement raises there), then its times. Returns
    the launch counts of the whole phase."""
    import torch
    from vivid_tpu_torch.kernels import attention, flash
    from vivid_tpu_torch.tools import bigs_attn_lab, fused_conv_lab, nomax_attn_lab
    for name in flash.launches:
        flash.launches[name] = 0
    gen = torch.Generator(device="cuda").manual_seed(12)

    def raw(b, h, s, d):
        x = torch.randn(b, h, s, d, generator=gen, device="cuda")
        return (x * torch.exp(torch.randn(b, h, s, 1, generator=gen, device="cuda"))).bfloat16()

    def plain_from_raw(q, k, v, bias=None, zero_sink=0):
        q, k, v = (t / (flash.NORM_EPS + t.norm(dim=-1, keepdim=True) / t.shape[-1] ** 0.5)
                   for t in (q, k, v))
        if zero_sink:
            k = torch.cat([k, k.new_zeros(*k.shape[:2], zero_sink, k.shape[3])], 2)
            v = torch.cat([v, v.new_zeros(*v.shape[:2], zero_sink, v.shape[3])], 2)
        return attention.reference_attention(q, k, v, bias)

    h, sq, sk = FUSED_SHAPES[0]
    entries = [
        ("attention_from_raw", attention.attention_from_raw, plain_from_raw, (BATCH, h, sq, sk, 64), {},
         {"flash_fused": 1, "flash_attention": 1, "flash_attention_bwd": 1}),
        ("attention_from_raw", attention.attention_from_raw, plain_from_raw, (BATCH, h, sq, sq, 64),
         {"zero_sink": 2 * sq}, {"flash_fused": 1}),
        ("attention_from_raw", attention.attention_from_raw, plain_from_raw, (2, h, sq, sk, 64),
         {"bias": True}, {"flash_fused": 1, "flash_attention": 1, "flash_attention_bwd": 1}),
        ("fused_attention", attention.fused_attention, attention.reference_attention,
         (BATCH, h, sq, sk, 64), {}, {"flash_attention": 1, "flash_attention_bwd": 1}),
        ("fused_attention", attention.fused_attention, attention.reference_attention,
         (1, 6, 4096, 8192, 32), {}, {"flash_nomax": 1, "flash_attention": 1, "flash_attention_bwd": 1}),
        ("fused_attention", attention.fused_attention, attention.reference_attention,
         (2, 2, 64, 192, 64), {}, {}),
    ]
    for name, entry, plain, (b, hh, s, skk, d), kw, want_launches in entries:
        q, k, v = raw(b, hh, s, d), raw(b, hh, skk, d), raw(b, hh, skk, d)
        if entry is attention.fused_attention:
            q, k, v = (flash._rms_norm(t) for t in (q, k, v))
        kw = dict(kw)
        if kw.get("bias"):
            kw["bias"] = torch.randn(b, hh, s, skk, generator=gen, device="cuda")
        g = torch.randn(b, hh, s, d, generator=gen, device="cuda").bfloat16()
        given = [q, k, v] + ([kw["bias"]] if "bias" in kw else [])
        leaves = [t.detach().requires_grad_() for t in given]
        leaves32 = [t.detach().float().requires_grad_() for t in given]
        before = dict(flash.launches)
        call = lambda ts: entry(*ts[:3], **dict(kw, **({"bias": ts[3]} if "bias" in kw else {})))
        out = call(leaves)
        grads = torch.autograd.grad(out, leaves, g)
        used = {k_: n - before[k_] for k_, n in flash.launches.items() if n - before[k_]}
        want = plain(*leaves32[:3], **dict(kw, **({"bias": leaves32[3]} if "bias" in kw else {})))
        want_grads = torch.autograd.grad(want, leaves32, g.float())
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        rel_max = err / want.square().mean().sqrt().item()
        rel = _rel_l2(out, want)
        grad_rel = max(_rel_l2(a, w) for a, w in zip(grads, want_grads))
        say("labs", entry=name, shape=f"'B={b} H={hh} Sq={s} Sk={skk} d={d}'",
            options={k_: (True if k_ == "bias" else x) for k_, x in kw.items()},
            max_abs_err=f"{err:.3e}", max_err_over_rms=f"{rel_max:.3e}", rel_l2=f"{rel:.3e}",
            max_grad_rel_l2=f"{grad_rel:.3e}", kernel_launches=used)
        check(used == want_launches, f"{name} {kw}: launched {used}, want {want_launches}")
        check(err <= TOL_KERNEL and rel <= TOL_KERNEL_L2 and rel_max <= TOL_KERNEL_MAX
              and grad_rel <= TOL_GRAD_L2,
              f"{name} at B={b} H={hh} Sq={s} Sk={skk} d={d} {list(kw)}: max abs {err}, rel L2 "
              f"{rel}, max err over RMS {rel_max}, gradients rel L2 {grad_rel}")
        del q, k, v, g, given, leaves, leaves32, out, grads, want, want_grads
    torch.cuda.empty_cache()

    for lab, argv in ((nomax_attn_lab, ["--cases", "sr64"]), (fused_conv_lab, []),
                      (bigs_attn_lab, ["--cases", "sr64"]), (bigs_attn_lab, ["--cases", "sr64", "--sweep"])):
        print(f"[labs] python -m {lab.__name__} {' '.join(argv)}", flush=True)
        results = lab.main(argv)
        torch.cuda.synchronize()
        times = [r for r in results if r["check"] == "time"]
        check(times and all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in times),
              f"{lab.__name__}: no times in {results}")
    torch.cuda.empty_cache()
    launches = dict(flash.launches)
    say("labs", launches={k: n for k, n in launches.items() if n})
    return launches


ENTRY_WRAPPERS = ("train_nvs_torch", "generate_images_torch", "calculate_metrics_torch",
                  "inspect_dataset_torch")
NAN_PLANT = "unet.enc.64x64_block0.conv_res0.weight"   # one conv weight of vivid-base
TRAINER_PEAK_GB = {}   # (preset, remat) -> the trainer's peak in the train phase


def _trainer_run(run_dir, data, steps, **opts):
    """`steps` steps of full-width vivid-base at batch 8 through
    `cli.train_nvs.launch_training` (no ramp-up, a status tick a step, no
    snapshots) -> (result, ms of each step after the first)."""
    import torch
    from vivid_tpu_torch.cli.train_nvs import launch_training, setup_training_config
    c = setup_training_config(preset="vivid-base", data=data, batch=BATCH, max_steps=steps,
                              remat="false", seed=0, device="cuda", **opts)
    c.update(status_nimg=BATCH * 6, snapshot_nimg=None, checkpoint_nimg=None)
    c.lr_kwargs.rampup_Mimg = 0.0
    result = launch_training(run_dir, c)
    torch.cuda.synchronize()
    return result, [t["seconds"] * 1e3 for t in result.ticks[2:]]


def phase_entry(card):
    """The port's entry points as a user starts them: the four root
    wrappers (--help, and a dry run of the trainer's with --debug-nans, each
    a process of its own), the quickstart at its defaults (K1-K4 launches),
    and --debug-nans at full width (vivid-base, batch 8) through the
    trainer's entry point: one NaN planted in one conv weight must raise
    FloatingPointError naming that module, a run without it must pass; ms
    per step with and without the flag."""
    import runpy
    from unittest import mock
    import torch
    from vivid_tpu_torch.data.scenes import make_synthetic_dataset
    from vivid_tpu_torch.kernels import flash
    from vivid_tpu_torch.train import loop

    root = os.path.dirname(os.path.abspath(__file__))
    cmds = {name: [sys.executable, f"{name}.py", "--help"] for name in ENTRY_WRAPPERS}
    cmds["train_nvs_torch_dry_run"] = [sys.executable, "train_nvs_torch.py", "--data",
                                       "scenes/", "--dry-run", "--debug-nans"]
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for k, cmd in cmds.items()}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        want = "Dry run" if name.endswith("dry_run") else "--help"
        check(proc.returncode == 0 and want in out,
              f"entry: {' '.join(cmds[name])} exited {proc.returncode}:\n{out[-2000:]}{err[-2000:]}")
        if name.endswith("dry_run"):
            check('"debug_nans": true' in out, f"entry: the dry run did not take --debug-nans:\n{out}")
    say("entry", check="root_wrappers", ran=sorted(cmds), seconds=f"{time.perf_counter() - t0:.2f}")

    with tempfile.TemporaryDirectory(prefix="vivid_chip_smoke_entry_") as tmp:
        for name in flash.launches:
            flash.launches[name] = 0
        quickstart = runpy.run_path(os.path.join(root, "examples", "quickstart_torch.py"))
        t0 = time.perf_counter()
        out = quickstart["main"](["--workdir", os.path.join(tmp, "quickstart")])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: n for k, n in flash.launches.items() if n}
        samples = [f for f in os.listdir(out["samples"]) if f.startswith("sample_")]
        check(all(launches.get(n) for n in ("flash_fused_packed", "flash_fused_packed_xattn",
                                            "flash_fused_packed_bwd",
                                            "flash_fused_packed_xattn_bwd")),
              f"entry: the quickstart launched {launches}")
        check(len(samples) == 8 and sorted(out["metrics"]) == ["psnr", "stub_fid"]
              and all(math.isfinite(v) for v in out["metrics"].values()),
              f"entry: quickstart samples {samples}, metrics {out['metrics']}")
        say("entry", run="quickstart", defaults=True, seconds=f"{seconds:.2f}",
            metrics=out["metrics"], launches=launches, card=f"'{card}'")

        data = make_synthetic_dataset(os.path.join(tmp, "scenes"), num_scenes=16,
                                      num_views=8, imsize=64, seed=0)

        class Planted(loop.NVPrecond):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                with torch.no_grad():
                    self.get_parameter(NAN_PLANT)[0, 0, 1, 1] = float("nan")

        module = "net." + NAN_PLANT.rsplit(".", 1)[0]
        try:
            with mock.patch.object(loop, "NVPrecond", Planted):
                _trainer_run(os.path.join(tmp, "planted"), data, 1, debug_nans=True)
            raised = None
        except FloatingPointError as err:
            raised = str(err)
        check(raised is not None and f"'{module}'" in raised,
              f"entry: --debug-nans with a NaN in {NAN_PLANT} raised {raised!r}")
        check(not torch.is_anomaly_enabled(), "entry: anomaly mode left on")
        ms = {}
        for flag, steps in ((True, 2), (False, 3)):   # a step with the flag: ~10 s
            result, ms[flag] = _trainer_run(os.path.join(tmp, f"clean_{flag}"), data, steps,
                                            debug_nans=flag)
            check(result.state.adam_step == steps and all(
                math.isfinite(t["loss"]) for t in result.ticks[1:]),
                f"entry: a clean run with debug_nans={flag}: {result.ticks}")
            del result
            torch.cuda.empty_cache()
        say("entry", run="debug_nans", net="vivid-base", batch=BATCH, planted=NAN_PLANT,
            raised=f"'{raised}'", step_ms_with_flag=[round(x, 1) for x in ms[True]],
            step_ms_without=[round(x, 1) for x in ms[False]],
            ratio=f"{statistics.median(ms[True]) / statistics.median(ms[False]):.2f}",
            card=f"'{card}'")


OVERFIT_STEPS = 200   # the overfit phase's cut of the tool's 2000 (PERF.md §4)


def phase_overfit(card, steps=OVERFIT_STEPS):
    """The convergence proof at the tool's widths (ch 64, 32 px, batch 16,
    attention at 16 and 8) for `steps` steps: both of its gates must pass,
    the loss gate the corrected one; prints the loss thirds, the PSNRs, each
    gate's margin and the kernels' launches."""
    import torch
    from vivid_tpu_torch.kernels import flash
    from vivid_tpu_torch.tools import overfit_smoke
    for name in flash.launches:
        flash.launches[name] = 0
    with tempfile.TemporaryDirectory(prefix="vivid_chip_smoke_overfit_") as tmp:
        out = os.path.join(tmp, "overfit.json")
        t0 = time.perf_counter()
        rc = overfit_smoke.main(["--steps", str(steps), "--out", out])
        seconds = time.perf_counter() - t0
        r = json.load(open(out))
    torch.cuda.synchronize()
    head, tail = r["loss_head_third"], r["loss_tail_third"]
    loss_margin = head - 0.3 * abs(head) - tail
    psnr_margin = r["psnr_after_db"] - r["psnr_before_db"] - 3.0
    say("overfit", steps=steps, batch=r["batch"], ch=r["ch"], imsize=r["imsize"],
        loss_head_third=f"{head:.4f}", loss_tail_third=f"{tail:.4f}",
        loss_gate_margin=f"{loss_margin:.4f}", psnr_before_db=f"{r['psnr_before_db']:.3f}",
        psnr_after_db=f"{r['psnr_after_db']:.3f}", psnr_ema_db=f"{r['psnr_after_ema_db']:.3f}",
        psnr_raw_db=f"{r['psnr_after_raw_db']:.3f}",
        psnr_src_floor_db=f"{r['psnr_src_floor_db']:.3f}", psnr_gate_margin_db=f"{psnr_margin:.3f}",
        train_wall_s=r["wall_s"], seconds=f"{seconds:.2f}",
        launches={k: n for k, n in flash.launches.items() if n}, card=f"'{card}'")
    check(rc == 0 and loss_margin > 0 and psnr_margin > 0,
          f"overfit: the gates failed after {steps} steps: {r}")


def phase_mem(card):
    """The memory reports on the card. `mem_report` of full-width vivid-sr
    at batch 8 under remat true, save_dots at area 4096, save_dots at the
    default, save_dots with every conv kept, and false: the bytes held
    after the forward pass must rise strictly along that sequence, and the
    peak must not fall. Then vivid-base (ch 128) at batch 8 without remat,
    beside the train phase's own peak, and `guided_mem` at ch 128 for
    batches 32 and 64 with 2 steps."""
    import torch
    from vivid_tpu_torch.kernels import flash
    from vivid_tpu_torch.tools import guided_mem, mem_report
    gb = lambda n: f"{n / 1e9:.3f}"
    sequence = [(True, None), ("save_dots", 4096), ("save_dots", None),
                ("save_dots", 1 << 40), (False, None)]
    rows = []
    for name in flash.launches:
        flash.launches[name] = 0
    old = os.environ.pop("VIVID_REMAT_HIRES_AREA", None)
    try:
        for remat, area in sequence:
            if area is None:
                os.environ.pop("VIVID_REMAT_HIRES_AREA", None)
            else:
                os.environ["VIVID_REMAT_HIRES_AREA"] = str(area)
            r = mem_report.report(mem_report.build_config(remat=remat, sr=True), BATCH)
            rows.append(r)
            say("mem", net="vivid-sr", batch=BATCH, remat=remat, hires_area=r["hires_area"],
                activations_GB=gb(r["activation_bytes"]), peak_GB=gb(r["peak_allocated_bytes"]),
                reserved_GB=gb(r["peak_reserved_bytes"]), params_GB=gb(r["param_bytes"]),
                adam_GB=gb(r["optimizer_bytes"]), emas_GB=gb(r["ema_bytes"]),
                card=f"'{card}'")
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("VIVID_REMAT_HIRES_AREA", None)
        if old is not None:
            os.environ["VIVID_REMAT_HIRES_AREA"] = old
    held = [r["activation_bytes"] for r in rows]
    peaks = [r["peak_allocated_bytes"] for r in rows]
    check(all(a < b for a, b in zip(held, held[1:])),
          f"mem: bytes held after the forward pass do not rise along {sequence}: {held}")
    check(all(a <= b for a, b in zip(peaks, peaks[1:])),
          f"mem: peak memory falls along {sequence}: {peaks}")
    sr_launches = {k: n for k, n in flash.launches.items() if n}
    check(sr_launches.get("flash_nomax") and sr_launches.get("flash_attention_bwd"),
          f"mem: the vivid-sr steps launched {sr_launches}")
    r = mem_report.report(mem_report.build_config(remat=False, flagship=True), BATCH)
    say("mem", net="vivid-base", batch=BATCH, remat=False, activations_GB=gb(r["activation_bytes"]),
        peak_GB=gb(r["peak_allocated_bytes"]), reserved_GB=gb(r["peak_reserved_bytes"]),
        params_GB=gb(r["param_bytes"]), adam_GB=gb(r["optimizer_bytes"]),
        emas_GB=gb(r["ema_bytes"]),
        train_phase_trainer_peak_GB=f"{TRAINER_PEAK_GB.get(('vivid-base', 'false'), float('nan')):.3f}",
        card=f"'{card}'")
    torch.cuda.empty_cache()
    for b in (32, 64):
        g = guided_mem.report(128, b, num_steps=2)
        say("mem", tool="guided_mem", ch=128, batch=b, steps=2, weights_GB=gb(g["weight_bytes"]),
            working_GB=gb(g["working_bytes"]), peak_GB=gb(g["peak_allocated_bytes"]),
            reserved_GB=gb(g["peak_reserved_bytes"]), seconds=f"{g['seconds']:.2f}",
            card=f"'{card}'")
        torch.cuda.empty_cache()
    say("mem", launches={k: n for k, n in flash.launches.items() if n}, sr_launches=sr_launches)


def phase_trace(card, base=None, gnet=None):
    """`core/trace.py` on the card: one full-width guided 64px evaluation
    (batch 8) in a `span` under `trace`; the trace file must hold its range,
    the hot path's ranges and K1/K2's kernels. The host's cost of a span
    outside a trace and inside one. Then `flops_analysis` of one
    full-width vivid-base training step (batch 8) through the kernels and
    through their plain versions (the train phase's patching): the counts
    must be equal. Without nets it builds the full-width pair from their
    seeds."""
    from unittest import mock
    import torch
    from vivid_tpu_torch.core.summary import flops_analysis
    from vivid_tpu_torch.core.trace import drain, span, trace
    from vivid_tpu_torch.diffusion.loss import NVLoss
    from vivid_tpu_torch.diffusion.sampler import edm_sampler, make_denoiser
    from vivid_tpu_torch.kernels import flash
    from vivid_tpu_torch.train.step import TrainConfig, init_train_state, make_train_step
    if base is None:
        base, gnet = _full_width(uncond=False), _full_width(uncond=True)
    gen = torch.Generator(device="cuda").manual_seed(21)
    src = torch.randn(BATCH, 2, 64, 64, 3, generator=gen, device="cuda").clamp(-1, 1)
    geo = torch.randn(BATCH, 2, 20, generator=gen, device="cuda")
    noise = torch.randn(BATCH, 64, 64, 3, generator=gen, device="cuda")

    @span("vivid_guided_evaluation")
    def evaluation():
        with torch.no_grad():   # one Heun step: one guided evaluation
            return edm_sampler(make_denoiser(base, src, geo), noise,
                               gnet_denoise=make_denoiser(gnet), num_steps=1, guidance=1.5)

    evaluation()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="vivid_chip_smoke_trace_") as tmp:
        t0 = time.perf_counter()
        with trace(tmp) as prof:
            evaluation()
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        size_mb = os.path.getsize(prof.trace_file) / 1e6
        events = json.load(open(prof.trace_file))["traceEvents"]
    names = [e.get("name", "") for e in events]
    kernels = {k: sum(k in n for n in names) for k in ("packed_fwd_norm_kernel",
                                                       "packed_fwd_kernel")}
    ranges = sum(n == "vivid_guided_evaluation" for n in names)
    # One Heun step is one guided evaluation: the net (encoder and denoiser) and the guide
    # (an unconditional net: no encoder). Host ranges only: the trace marks each range
    # on the card's timeline too (category gpu_user_annotation).
    host = [e.get("name", "") for e in events if e.get("cat") == "user_annotation"]
    path = {k: host.count(k) for k in ("sampler.step", "sampler.eval:net",
                                       "sampler.eval:guide", "net.encoder", "net.denoiser")}
    say("trace", evaluation="guided_64px", batch=BATCH, trace_MB=f"{size_mb:.1f}",
        events=len(events), ranges=ranges, path_ranges=path, kernel_events=kernels,
        seconds=f"{seconds:.2f}", card=f"'{card}'")
    check(ranges >= 1 and all(kernels.values()),
          f"trace: the range ({ranges}) or K1/K2's kernels ({kernels}) missing from the trace")
    check(path == {"sampler.step": 1, "sampler.eval:net": 1, "sampler.eval:guide": 1,
                   "net.encoder": 1, "net.denoiser": 2},
          f"trace: the hot path's ranges in one guided evaluation are {path}")

    # The host's cost of one span, always recorded, and of one under trace(), which is a
    # profiler range too.
    reps = 20000

    def span_us():
        drain()
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            with span("smoke.span", rows=1):
                pass
        took = (time.perf_counter_ns() - t0) / reps / 1e3
        check(len(drain()) == reps, "trace: a span was not recorded")
        return took
    plain_us = span_us()
    with tempfile.TemporaryDirectory(prefix="vivid_chip_smoke_ranges_") as tmp:
        with trace(tmp):
            traced_us = span_us()
    per_eval = sum(path.values())
    say("trace_cost", span_us=f"{plain_us:.3f}", traced_span_us=f"{traced_us:.3f}",
        spans_a_guided_evaluation=per_eval,
        spans_us_a_guided_evaluation=f"{per_eval * plain_us:.2f}",
        traced_us_a_guided_evaluation=f"{per_eval * traced_us:.2f}", card=f"'{card}'")

    net = _full_width(uncond=False, train=True)
    tcfg = TrainConfig(batch_size=BATCH, nimg_mult=6)
    state = init_train_state(net, tcfg)
    step = make_train_step(NVLoss(P_mean=-0.8, P_std=1.6), tcfg)
    batch = dict(src=src, tgt=noise.clamp(-1, 1), geometry=geo)
    names = ("flash_fused_packed", "flash_fused_packed_xattn", "flash_fused_packed_bwd",
             "flash_fused_packed_xattn_bwd")
    counts = {}
    for variant in ("kernels", "plain"):
        with contextlib.ExitStack() as stack:
            if variant == "plain":
                for name in names:
                    stack.enter_context(mock.patch.object(flash, name, getattr(flash, name + "_ref")))
            gen.manual_seed(5)
            t0 = time.perf_counter()
            counts[variant] = flops_analysis(step, state, batch, gen)
            torch.cuda.synchronize()
            counts[variant]["seconds"] = time.perf_counter() - t0
    k, p = counts["kernels"], counts["plain"]
    # The count is of executed operations: K3/K4's tallies (12 B H S Sk D)
    # hold their plain versions' recomputed forward (4 of the 12). Less that,
    # the model's own count (backward 8 B H S Sk D).
    recomputed = sum(k["kernels"].get(n, 0) for n in names[2:]) // 3
    say("trace", check="flops_of_a_train_step", net="vivid-base", batch=BATCH, remat=False,
        gflops_kernels=f"{k['flops'] / 1e9:.3f}", gflops_plain=f"{p['flops'] / 1e9:.3f}",
        model_gflops=f"{(k['flops'] - recomputed) / 1e9:.3f}",
        recomputed_forward_gflops=f"{recomputed / 1e9:.3f}",
        operators_gflops=f"{k['operators'] / 1e9:.3f}",
        kernel_gflops={n: f"{v / 1e9:.3f}" for n, v in k["kernels"].items()},
        plain_attention_gflops=f"{(p['operators'] - k['operators']) / 1e9:.3f}",
        seconds_kernels=f"{k['seconds']:.2f}", seconds_plain=f"{p['seconds']:.2f}",
        card=f"'{card}'")
    check(k["flops"] == p["flops"] and set(k["kernels"]) == set(names) and not p["kernels"],
          f"trace: the step's count through the kernels {k['flops']} != through the plain "
          f"versions {p['flops']} ({k['kernels']}, {p['kernels']})")
    del net, state
    torch.cuda.empty_cache()


def _busy_ms(dev):
    """ms of the union of the device events' intervals: the card's busy time."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy_us += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    return (busy_us + cur_end - cur_start) / 1e3


def _profile(tag, fn, units, unit):
    """Time `fn` (which does `units` units of work) with a host clock, then
    under torch.profiler. Busy time is the union of the device's kernel and
    copy intervals; idle share = 1 - busy / wall. Prints per-unit times, the
    shares of device time by kind of kernel, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / units
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / units
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    check(dev, "the profiler recorded no device activity")
    busy_ms = _busy_ms(dev) / units
    by_name = {}
    for e in dev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    total_us = sum(us for _, us in by_name.values())
    say(tag, **{f"{unit}s": units, f"wall_ms_per_{unit}": f"{wall_ms:.2f}",
                f"profiled_wall_ms_per_{unit}": f"{prof_wall_ms:.2f}",
                f"device_busy_ms_per_{unit}": f"{busy_ms:.2f}",
                f"device_ops_per_{unit}": len(dev) // units,
                "idle_share": f"{1 - busy_ms / wall_ms:.3f}",
                "idle_share_profiled": f"{1 - busy_ms / prof_wall_ms:.3f}"})
    kinds = {"attention_nomax": ("flash_nomax",),
             "attention_k8_fwd": ("flash_fwd_kernel",),
             "attention_k8_bwd": ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "bwd_prep_kernel"),
             "attention_fwd": ("packed_fwd_", "nomax_packed"),
             "attention_bwd": ("packed_bwd_",),
             "conv": ("fprop", "dgrad", "wgrad", "conv", "cudnn"),
             "gemm": ("gemm", "nvjet", "cutlass"), "reduce": ("reduce_kernel",)}
    shares = dict.fromkeys(list(kinds) + ["other"], 0.0)
    for name, (_, us) in by_name.items():
        kind = next((k for k, keys in kinds.items()
                     if any(key in name for key in keys)), "other")
        shares[kind] += us / total_us
    say(tag, **{f"{k}_share": f"{v:.3f}" for k, v in shares.items()},
        **{f"{k}_ms_per_{unit}": f"{v * total_us / 1e3 / units:.2f}" for k, v in shares.items()})
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (n, us) in top:
        say(tag, share=f"{us / total_us:.3f}", **{f"per_{unit}": n // units},
            **{f"ms_per_{unit}": f"{us / 1e3 / units:.3f}"}, kernel=f"'{name[:110]}'")


def phase_profile(base=None, gnet=None, nomax=False):
    """Where the time of a guided evaluation goes: the sampler's own loop
    (2 Heun steps = 3 guided evaluations of base + uncond at batch 8), with
    `nomax` under VIVID_NOMAX_PACKED=1 (K7 in place of K1/K2). Without nets
    it builds the full-width pair from their seeds."""
    import torch
    from vivid_tpu_torch.diffusion.sampler import edm_sampler, make_denoiser
    if base is None:
        base, gnet = _full_width(uncond=False), _full_width(uncond=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    src = torch.randn(BATCH, 2, 64, 64, 3, generator=gen, device="cuda").clamp(-1, 1)
    geo = torch.randn(BATCH, 2, 20, generator=gen, device="cuda")
    noise = torch.randn(BATCH, 64, 64, 3, generator=gen, device="cuda")

    def sample():
        with torch.no_grad():
            return edm_sampler(make_denoiser(base, src, geo), noise,
                               gnet_denoise=make_denoiser(gnet), num_steps=2,
                               guidance=1.5)

    with nomax_packed(nomax):
        _profile("profile_nomax" if nomax else "profile", sample, 3, "eval")


def phase_profile_nomax():
    """`phase_profile` under VIVID_NOMAX_PACKED=1 on the full-width pair from
    their seeds: `vivid_tpu_torch/tools/smoke_phase.py profile_nomax --port
    DIR` profiles another checkout's K7 on the same evaluations."""
    phase_profile(nomax=True)


def phase_profile_sr(sr):
    """Where the time of an SR evaluation goes: the sampler's own loop on
    full-width vivid-sr at batch 8 (2 Heun steps = 3 evaluations, each the
    encoder over one 256px source and the denoiser)."""
    import torch
    from vivid_tpu_torch.diffusion.sampler import edm_sampler, make_denoiser
    gen = torch.Generator(device="cuda").manual_seed(9)
    src = torch.randn(BATCH, 1, 256, 256, 3, generator=gen, device="cuda").clamp(-1, 1)
    geo = torch.randn(BATCH, 1, 20, generator=gen, device="cuda")
    cond = torch.randn(BATCH, 256, 256, 3, generator=gen, device="cuda").clamp(-1, 1)
    noise = torch.randn(BATCH, 256, 256, 3, generator=gen, device="cuda")

    def sample():
        with torch.no_grad():
            return edm_sampler(make_denoiser(sr, src, geo, conditioning_image=cond,
                                             generator=gen), noise, num_steps=2)

    _profile("profile_sr", sample, 3, "eval")


def phase_profile_train():
    """Where the time of a training step goes: 2 steps of full-width
    `vivid-base` at batch 8, no recompute, on one fixed batch."""
    import torch
    from vivid_tpu_torch.diffusion.loss import NVLoss
    from vivid_tpu_torch.train.step import TrainConfig, init_train_state, make_train_step
    gen = torch.Generator(device="cuda").manual_seed(6)
    batch = dict(
        src=torch.randn(BATCH, 2, 64, 64, 3, generator=gen, device="cuda").clamp(-1, 1),
        tgt=torch.randn(BATCH, 64, 64, 3, generator=gen, device="cuda").clamp(-1, 1),
        geometry=torch.randn(BATCH, 2, 20, generator=gen, device="cuda"))
    cfg = TrainConfig(batch_size=BATCH, ref_lr=0.0120, ref_batches=35000, rampup_Mimg=0.0,
                      nimg_mult=6)
    state = init_train_state(_full_width(uncond=False, train=True), cfg)
    step = make_train_step(NVLoss(P_mean=-0.8, P_std=1.6), cfg)

    def two_steps():
        for _ in range(2):
            stats = step(state, batch, gen)
        return float(stats["Loss/loss"])

    _profile("profile_train", two_steps, 2, "step")


def phase_profile_train_sr():
    """Where the time of a 256px training step goes: 2 steps of full-width
    `vivid-sr` at batch 8 with the preset's recompute, on one fixed batch."""
    import torch
    from vivid_tpu_torch.diffusion.loss import SRNVLoss
    from vivid_tpu_torch.train.step import TrainConfig, init_train_state, make_train_step
    gen = torch.Generator(device="cuda").manual_seed(11)
    batch = dict(
        src=torch.randn(BATCH, 1, 256, 256, 3, generator=gen, device="cuda").clamp(-1, 1),
        tgt=torch.randn(BATCH, 256, 256, 3, generator=gen, device="cuda").clamp(-1, 1),
        geometry=torch.randn(BATCH, 1, 20, generator=gen, device="cuda"))
    cfg = TrainConfig(batch_size=BATCH, ref_lr=0.0200, ref_batches=35000, rampup_Mimg=0.0,
                      nimg_mult=1)
    state = init_train_state(_full_width_sr(train=True, remat=True), cfg)
    step = make_train_step(SRNVLoss(P_mean=-0.8, P_std=1.6), cfg)

    def two_steps():
        for _ in range(2):
            stats = step(state, batch, gen)
        return float(stats["Loss/loss"])

    _profile("profile_train_sr", two_steps, 2, "step")


if __name__ == "__main__":
    sys.exit(main())
