#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

It runs every phase, in this order, each printing its results on lines of
its own:
  device   the card's name and power limit; TF32 off for the fp32 references
  build    compiles csrc/ with nvcc (route: shared library + ctypes)
  kernels  each CUDA kernel against its plain PyTorch version at every shape
           the 64px sampling path gives it, with times (CUDA events)
  model    full-width vivid-base / vivid-uncond from a seed: parameter
           counts, and one NVPrecond call through the kernels vs the plain
           versions, held against a one-ulp noise control; planted faults
           (a cross source skipped, the zero sink dropped) must fail it
  slice    snapshots -> synthetic scenes -> generate_images_nvs (guided,
           32 Heun steps, 8 seeds): PNGs, finite images, kernel launch counts
  profile  torch.profiler over 3 guided evaluations: device busy time,
           kernels per evaluation, idle share, the top kernels

Any failed check raises, so the script exits non-zero. Without a CUDA card
it exits non-zero before printing any result. The line before the last is
the kernel table as JSON; the last is {"ok": true, "device": {...}}.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

TOL_KERNEL = 2e-2      # max |kernel - fp32 plain| on bf16 inputs
TOL_MODEL = 1e-2       # relative L2 of D_x, kernels vs plain (emb gains at 0)
TOL_CONTROL = 1.2      # ... and at most this multiple of the ulp-noise control
SHAPES = [(1024, 4, 64), (256, 6, 64), (64, 8, 64)]   # (S, H, d) on the path
EXTRA_SHAPES = [(100, 4, 64), (256, 8, 32)]           # ragged, d = 32
BATCH = 8


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def say(tag, **kw):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


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
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip(), flush=True)


def _kernel_cases(torch, gen):
    """(label, kernel fn, plain fn on fp32 copies, plain fn as the path runs
    it) for K1 and K2 at every shape."""
    from vivid_tpu_torch.kernels import flash
    dev = "cuda"
    cases = []
    def rows(s, parts, h, d):
        # Each d-vector scaled by exp(N(0, 1)), so the in-kernel norm matters.
        x = torch.randn(BATCH, s, parts * h, d, generator=gen, device=dev)
        x = x * torch.exp(torch.randn(BATCH, s, parts * h, 1, generator=gen, device=dev))
        return x.reshape(BATCH, s, parts * h * d).bfloat16()

    for s, h, d in SHAPES + EXTRA_SHAPES:
        qkv = rows(s, 3, h, d)
        feats = [rows(s, 2, h, d) for _ in range(2)]
        bias = [torch.randn(BATCH, h, s, s, generator=gen, device=dev) for _ in range(2)]
        f32 = [f.float() for f in feats]
        for sink in (0, 2 * s):
            cases.append((
                "flash_fused_packed", f"S={s} H={h} d={d} sink={sink}",
                lambda qkv=qkv, h=h, sink=sink: flash.flash_fused_packed(qkv, h, zero_sink=sink),
                lambda qkv=qkv, h=h, sink=sink: flash.flash_fused_packed_ref(qkv.float(), h, sink),
                lambda qkv=qkv, h=h, sink=sink: flash.flash_fused_packed_ref(qkv, h, sink),
                (s, h, d) == SHAPES[0] and sink == 0))
        for biased in (False, True):
            bs = bias if biased else ()
            cases.append((
                "flash_fused_packed_xattn", f"S={s} H={h} d={d} n_src=2 bias={biased}",
                lambda qkv=qkv, h=h, bs=bs, feats=feats: flash.flash_fused_packed_xattn(qkv, feats, h, biases=bs),
                lambda qkv=qkv, h=h, bs=bs, f32=f32: flash.flash_fused_packed_xattn_ref(qkv.float(), f32, h, bs),
                lambda qkv=qkv, h=h, bs=bs, feats=feats: flash.flash_fused_packed_xattn_ref(qkv, feats, h, bs),
                (s, h, d) == SHAPES[0] and not biased))
    return cases


def phase_kernels(table):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, label, kern, plain32, plain, headline in _kernel_cases(torch, gen):
        got = kern().float()
        want = plain32().float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rms = want.square().mean().sqrt().item()
        check(math.isfinite(err) and err <= TOL_KERNEL,
              f"{name} {label}: max |kernel - plain| = {err} > {TOL_KERNEL}")
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain)
        say("kernel", name=name, case=f"'{label}'", max_abs_err=f"{err:.3e}",
            max_err_over_rms=f"{err / rms:.3e}", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}")
        row = table[name]
        row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
        if headline:
            row["ms"], row["plain_ms"] = ms, plain_ms


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
    }
    card = phase_device()
    phase_build()
    phase_kernels(table)
    phase_model()
    nets, launches = phase_slice(card)
    for name, n in launches.items():
        table[name]["launches"] = n
    phase_profile(*nets)
    print(json.dumps({"kernels": list(table.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _full_width(uncond, conditioned=True):
    """vivid-base / vivid-uncond at the published widths (64px, ch=128,
    extra_attn=1, bf16) with random weights from a seed. A fresh init has
    every gain at 0, which makes F_x vanish (out_gain) and switches off the
    sigma conditioning of every block (emb_gain: c = 1). So out_gain is set
    to 1, and with `conditioned` the emb gains too."""
    import torch
    from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
    cfg = PrecondConfig(img_resolution=64, model_channels=128, extra_attn=1,
                        uncond=uncond, use_bf16=True)
    net = NVPrecond(cfg, device="cuda", seed=1 if uncond else 0)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("out_gain") or conditioned and name.endswith("emb_gain"):
                p.fill_(1.0)
    return net.eval().requires_grad_(False)


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


def phase_model():
    """D_x of one NVPrecond call through the kernels against the same call
    through the plain versions. The network amplifies any rounding-level
    change of the attention outputs, so the reading is held against a
    control (the plain versions with one ulp of noise on every output) as
    well as against TOL_MODEL; planted faults must fail the same gate."""
    import contextlib
    from unittest import mock
    import torch
    from vivid_tpu_torch.kernels import flash
    k1, k2 = flash.flash_fused_packed, flash.flash_fused_packed_xattn
    k1_ref, k2_ref = flash.flash_fused_packed_ref, flash.flash_fused_packed_xattn_ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    src = torch.randn(BATCH, 2, 64, 64, 3, generator=gen, device="cuda").clamp(-1, 1)
    dst = torch.randn(BATCH, 64, 64, 3, generator=gen, device="cuda")
    geo = torch.randn(BATCH, 2, 20, generator=gen, device="cuda")
    sigma = torch.ones(BATCH, device="cuda")
    noise_gen = torch.Generator(device="cuda")
    variants = {
        "plain": (k1_ref, k2_ref),
        "control": (lambda qkv, h, zero_sink=0: _ulp_noise(k1_ref(qkv, h, zero_sink), noise_gen),
                    lambda qkv, feats, h, biases=(): _ulp_noise(k2_ref(qkv, feats, h, biases), noise_gen)),
        "fault_one_source": (k1, lambda qkv, feats, h, biases=(): k2(qkv, feats[:1], h, biases[:1])),
        "fault_no_sink": (lambda qkv, h, zero_sink=0: k1(qkv, h, 0), k2),
    }

    def run(net, variant=None):
        with contextlib.ExitStack() as stack:
            if variant:
                fn1, fn2 = variants[variant]
                stack.enter_context(mock.patch.object(flash, "flash_fused_packed", fn1))
                stack.enter_context(mock.patch.object(flash, "flash_fused_packed_xattn", fn2))
            noise_gen.manual_seed(2)
            with torch.no_grad():
                return net(src, dst, sigma, geo)

    want_params = {False: 250.65, True: 131.27}
    for uncond in (False, True):
        label = "vivid-uncond" if uncond else "vivid-base"
        # The base model has no sink to drop; the uncond model has no cross source.
        fault = "fault_no_sink" if uncond else "fault_one_source"
        for conditioned in (False, True):
            net = _full_width(uncond, conditioned)
            n_params = sum(t.numel() for t in net.state_dict().values())
            check(round(n_params / 1e6, 2) == want_params[uncond],
                  f"{label}: {n_params} parameters, want {want_params[uncond]}M")
            before = dict(flash.launches)
            got = run(net)
            used = {k: n - before[k] for k, n in flash.launches.items()}
            want = run(net, "plain")
            control = _rel_l2(run(net, "control"), want)
            faulty = _rel_l2(run(net, fault), want)
            torch.cuda.synchronize()
            check(all(used.values()) or uncond and used["flash_fused_packed"],
                  f"{label}: the forward launched {used}")
            check(bool(torch.isfinite(got).all()), f"{label}: non-finite D_x")
            err = _rel_l2(got, want)
            gate = TOL_CONTROL * control
            if not conditioned:
                gate = min(gate, TOL_MODEL)
            weights = "emb_gains_1" if conditioned else "emb_gains_0"
            say("model", net=label, weights=weights, params=n_params,
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


def phase_slice(card):
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
        per_eval = {
            "flash_fused_packed": len(attention_feature_spec(base.cfg.encoder_cfg))
            + len(attention_feature_spec(gnet.cfg.unet_cfg)),
            "flash_fused_packed_xattn": len(attention_feature_spec(base.cfg.unet_cfg)),
        }
        evals = 2 * steps - 1
        for run in ("cold", "warm"):
            outdir = os.path.join(tmp, f"out_{run}")
            for name in flash.launches:
                flash.launches[name] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batches = list(generate_images_nvs(
                net=base, gnet=gnet, guidance=1.5, seeds=seeds, max_batch_size=8,
                num_steps=steps, outdir=outdir, datakwargs={"path": data},
                device="cuda", verbose=False))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(flash.launches)
            if run == "cold":
                counted = dict(launches)
            for name, n in launches.items():
                check(n == per_eval[name] * evals,
                      f"{name}: {n} launches, want {per_eval[name]} x {evals}")
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
                launches=launches, per_eval=per_eval, evals=evals,
                latents_absmax=f"{lat.abs().max().item():.3f}", card=f"'{card}'")
    return (base.net, gnet.net), counted


def phase_profile(base, gnet):
    """Where the time of a guided evaluation goes: the sampler's own loop
    (2 Heun steps = 3 guided evaluations of base + uncond at batch 8) timed
    without the profiler, then under torch.profiler. Busy time is the union
    of the device's kernel and copy intervals; idle share = 1 - busy / wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vivid_tpu_torch.diffusion.sampler import edm_sampler, make_denoiser
    gen = torch.Generator(device="cuda").manual_seed(3)
    src = torch.randn(BATCH, 2, 64, 64, 3, generator=gen, device="cuda").clamp(-1, 1)
    geo = torch.randn(BATCH, 2, 20, generator=gen, device="cuda")
    noise = torch.randn(BATCH, 64, 64, 3, generator=gen, device="cuda")
    evals = 3

    def sample():
        with torch.no_grad():
            return edm_sampler(make_denoiser(base, src, geo), noise,
                               gnet_denoise=make_denoiser(gnet), num_steps=2,
                               guidance=1.5)

    sample()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / evals
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sample()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / evals
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    check(dev, "the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy_us += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    busy_ms = busy_us / 1e3 / evals
    by_name = {}
    for e in dev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    total_us = sum(us for _, us in by_name.values())
    say("profile", evals=evals, wall_ms_per_eval=f"{wall_ms:.2f}",
        profiled_wall_ms_per_eval=f"{prof_wall_ms:.2f}",
        device_busy_ms_per_eval=f"{busy_ms:.2f}",
        device_ops_per_eval=len(dev) // evals,
        idle_share=f"{1 - busy_ms / wall_ms:.3f}",
        idle_share_profiled=f"{1 - busy_ms / prof_wall_ms:.3f}")
    kinds = {"attention": ("flash_packed",), "conv": ("fprop", "conv", "cudnn"),
             "gemm": ("gemm", "nvjet", "cutlass"), "reduce": ("reduce_kernel",)}
    shares = dict.fromkeys(list(kinds) + ["other"], 0.0)
    for name, (_, us) in by_name.items():
        kind = next((k for k, keys in kinds.items()
                     if any(key in name for key in keys)), "other")
        shares[kind] += us / total_us
    say("profile", **{f"{k}_share": f"{v:.3f}" for k, v in shares.items()})
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (n, us) in top:
        say("profile", share=f"{us / total_us:.3f}", per_eval=n // evals,
            ms_per_eval=f"{us / 1e3 / evals:.3f}", kernel=f"'{name[:110]}'")


if __name__ == "__main__":
    sys.exit(main())
