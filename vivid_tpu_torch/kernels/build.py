"""Builds the CUDA kernels of `vivid_tpu_torch/csrc` at first use.

`nvcc` compiles each source into an object file, all at once, and links
them into one shared library with a plain C interface, loaded with ctypes
(no PyTorch headers: a build takes seconds). The library lands in `build/kernels/<hash>/` at the repository root, keyed
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the cached library. A missing `nvcc` or a failed build
raises; nothing falls back.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from vivid_tpu_torch.core.trace import span

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("flash_packed.cu", "flash_packed_bwd.cu", "flash_nomax.cu", "flash_bwd.cu",
           "flash_fused.cu", "flash_nomax_packed.cu", "flash_nomax_lab.cu", "conv3x3_silu.cu",
           "mp_fused.cu")
HEADERS = ("flash_common.cuh", "flash_hopper.cuh", "flash_fwd.cuh", "flash_packed.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libvivid_kernels.so"


def find_nvcc() -> str:
    """`nvcc` on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path) and os.access(path, os.X_OK):
        return path
    raise RuntimeError(
        "nvcc not found (not on PATH, nor under $CUDA_HOME/bin): the CUDA "
        "kernels of vivid_tpu_torch build only where the CUDA toolkit is "
        "installed. CPU tensors take the plain PyTorch versions instead.")


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build() -> dict:
    """Compile (or find cached) and return dict(path, seconds, log, cached)."""
    sources = [CSRC / s for s in SOURCES]
    nvcc = find_nvcc()
    out_dir = BUILD_DIR / _digest(sources + [CSRC / h for h in HEADERS])
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return dict(path=str(lib), seconds=0.0, log=log, cached=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objects = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    t0 = time.perf_counter()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    cmds.append([nvcc, "-shared", "-o", str(tmp), *map(str, objects)])
    try:
        outputs = [proc.communicate()[0] for proc in procs]
        codes = [proc.returncode for proc in procs]
        if not any(codes):
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            outputs.append(link.stdout + link.stderr)
            codes.append(link.returncode)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "".join(outputs)
    if any(codes):
        tmp.unlink(missing_ok=True)
        failed = " ; ".join(" ".join(cmd) for cmd, rc in zip(cmds, codes) if rc)
        raise RuntimeError(f"nvcc failed ({codes}):\n{failed}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return dict(path=str(lib), seconds=seconds, log=log, cached=False)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's signature set.
    Loading it is the span `kernels.load` (`core/trace.py`): nvcc and the
    `dlopen`, or with attribute `cached` the hash and the `dlopen` alone."""
    with span("kernels.load") as load:
        built = build()
        load.attrs["cached"] = built["cached"]
        lib = ctypes.CDLL(built["path"])
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vivid_flash_packed_fwd.argtypes = [
        ptr, ptr, ptr,                          # qkv, out, rows (scratch)
        i32, i32, i32, i32, i32,                # B, S, H, d, n_src
        ptr, i32, ptr, ptr, i32, ptr,           # feats/len/bias for 2 sources
        f32, f32, ptr]                          # eps, zero_sink, stream
    lib.vivid_flash_packed_fwd.restype = i32
    lib.vivid_flash_packed_info.argtypes = [i32, i32, ptr]   # d, biased, info[9]
    lib.vivid_flash_packed_info.restype = i32
    lib.vivid_flash_packed_bwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,           # qkv, g, dqkv, lse, delta, rows (scratch)
        i32, i32, i32, i32, i32,                # B, S, H, d, n_src
        ptr, ptr, i32, ptr, ptr,                # feats/dfeats/len/bias/dbias, source 0
        ptr, ptr, i32, ptr, ptr,                # ... source 1
        f32, f32, ptr]                          # eps, zero_sink, stream
    lib.vivid_flash_packed_bwd.restype = i32
    lib.vivid_flash_packed_bwd_info.argtypes = [i32, i32, i32, ptr]   # kernel, d, biased, info[9]
    lib.vivid_flash_packed_bwd_info.restype = i32
    lib.vivid_flash_nomax_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,           # q, k, v, bias, shift, out
        i32, i32, i32, i32, i32, ptr]           # B, H, Sq, Sk, d, stream
    lib.vivid_flash_nomax_fwd.restype = i32
    lib.vivid_flash_nomax_info.argtypes = [i32, i32, ptr]   # d, biased, info[9]
    lib.vivid_flash_nomax_info.restype = i32
    lib.vivid_flash_attn_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,           # q, k, v, bias, out, lse
        i32, i32, i32, i32, i32, ptr]           # B, H, Sq, Sk, d, stream
    lib.vivid_flash_attn_fwd.restype = i32
    lib.vivid_flash_attn_bwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,      # q, k, v, bias, out, lse, g
        ptr, ptr, ptr, ptr, ptr, ptr,           # qs, stats (scratch), dq, dk, dv, dbias
        i32, i32, i32, i32, i32, ptr]           # B, H, Sq, Sk, d, stream
    lib.vivid_flash_attn_bwd.restype = i32
    lib.vivid_flash_attn_info.argtypes = [i32, i32, i32, ptr]   # kernel, d, biased, info[9]
    lib.vivid_flash_attn_info.restype = i32
    lib.vivid_flash_fused_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr,                # q, k, v, bias, out
        ptr, ptr, ptr,                          # qn, kn, vn (scratch of the norm)
        i32, i32, i32, i32, i32,                # B, H, Sq, Sk, d
        i32, f32, f32, ptr]                     # norm, eps, zero_sink, stream
    lib.vivid_flash_fused_fwd.restype = i32
    lib.vivid_flash_fused_norm.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,           # q, k, v, qn, kn, vn
        i32, i32, i32, i32, i32, f32, ptr]      # B, H, Sq, Sk, d, eps, stream
    lib.vivid_flash_fused_norm.restype = i32
    lib.vivid_flash_fused_info.argtypes = [i32, i32, ptr]   # d, biased, info[9]
    lib.vivid_flash_fused_info.restype = i32
    lib.vivid_flash_nomax_packed_fwd.argtypes = [
        ptr, ptr, ptr,                          # qkv, out, rows (scratch)
        i32, i32, i32, i32, i32,                # B, S, H, d, n_src
        ptr, i32, ptr, i32,                     # feats/len for 2 sources
        f32, f32, ptr]                          # eps, zero_sink, stream
    lib.vivid_flash_nomax_packed_fwd.restype = i32
    lib.vivid_flash_nomax_packed_info.argtypes = [i32, i32, ptr]   # d, biased (0), info[9]
    lib.vivid_flash_nomax_packed_info.restype = i32
    lib.vivid_flash_nomax_lab_fwd.argtypes = [
        ptr, ptr, ptr, ptr,                     # q, k, v, out
        i32, i32, i32, i32, i32,                # B, H, Sq, Sk, d
        i32, i32, i32, ptr]                     # fold_l, chains, prescale, stream
    lib.vivid_flash_nomax_lab_fwd.restype = i32
    lib.vivid_flash_nomax_lab_info.argtypes = [i32, i32, i32, i32, ptr]   # d, fold_l, chains, prescale, info[9]
    lib.vivid_flash_nomax_lab_info.restype = i32
    lib.vivid_conv3x3_silu_fwd.argtypes = [
        ptr, ptr, ptr, i32, i32, i32,           # x, w, y, B, H, W
        i32, i32, ptr]                          # fuse_silu, blocks, stream
    lib.vivid_conv3x3_silu_fwd.restype = i32
    lib.vivid_conv3x3_silu_info.argtypes = [i32, ptr]   # fuse_silu, info[9]
    lib.vivid_conv3x3_silu_info.restype = i32
    i64 = ctypes.c_longlong
    lib.vivid_mp_norm_silu.argtypes = [
        ptr, ptr, ptr, i64, i32, i32, f32, ptr]   # x, xn, xs, rows, C, fp32, eps, stream
    lib.vivid_mp_scale_silu.argtypes = [
        ptr, ptr, ptr, i64, i64, i32, i32, ptr]   # y, c, out, rows, rows an image, C, fp32, stream
    lib.vivid_mp_sum_clip.argtypes = [
        ptr, ptr, ptr, i64, i32, f32, f32, f32, ptr]   # a, b, out, numel, fp32, t, norm, clip, stream
    lib.vivid_mp_cat_silu.argtypes = [
        ptr, ptr, ptr, ptr, i64, i32, i32, i32,   # a, b, cat, xs, rows, Ca, Cb, fp32
        f32, f32, ptr]                            # wa, wb, stream
    lib.vivid_mp_fused_info.argtypes = [i32, i32, i32, ptr]   # kernel, fp32, C, info[3]
    for name in ("norm_silu", "scale_silu", "sum_clip", "cat_silu", "fused_info"):
        getattr(lib, f"vivid_mp_{name}").restype = i32
    return lib
