"""The port's kernel labs (vivid_tpu_torch/tools) against the JAX package's
(tools/): the plain versions of the fused SiLU + 3x3 convolution (K9) and of
the no-max lab attention (K10) against the labs' Pallas kernels run in
interpret mode, on the same numpy inputs, and each lab's `main` on the CPU
(parity checks only). The JAX labs are scripts, loaded by path. The CUDA
kernels themselves run only on a card: chip_smoke.py compares them with these
plain versions there.

Tolerances. K9, fp32: 1e-4 absolute (576 products a pixel summed in another
order, outputs of magnitude 1); bf16: relative L2 3e-3, under one bf16 ulp
(both sides round the SiLU to bf16, accumulate in fp32 and round once more;
the output reaches 4, so an absolute limit would be a whole ulp there). K10,
fp32: 3e-5 absolute (sums in another order); bf16: 1e-2 absolute, a little
over one bf16 ulp of an output of magnitude 1."""

import importlib.util
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivid_tpu_torch.kernels import flash
from vivid_tpu_torch.tools import bigs_attn_lab, fused_conv_lab, nomax_attn_lab

torch.set_num_threads(1)

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"


def _jax_lab(name, monkeypatch):
    """A script of tools/ as a module. Both labs switch the persistent
    compilation cache on when they are imported: VIVID_COMP_CACHE=0 stops that."""
    monkeypatch.setenv("VIVID_COMP_CACHE", "0")
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", TOOLS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# (B, H, W): the square case, a non-square image (an H/W swap in the plain
# version shows there) and a batch of 3. The square case keeps its bare id.
_CONV_SHAPES = {"": (2, 16, 16), "-16x24": (2, 16, 24), "-b3": (3, 8, 16)}


@pytest.mark.parametrize("dtype,fuse_silu,shape", [
    pytest.param(dtype, fuse, shape, id=f"{dtype}-{fuse}{tag}")
    for tag, shape in _CONV_SHAPES.items() for dtype in ("float32", "bfloat16")
    for fuse in (True, False)])
def test_conv_ref_matches_pallas(fuse_silu, dtype, shape, monkeypatch):
    lab = _jax_lab("fused_conv_lab", monkeypatch)
    (b, hh, ww), c = shape, fused_conv_lab.CHANNELS
    rng = np.random.RandomState(0)
    x = rng.randn(b, hh, ww, c).astype(np.float32)                         # NHWC
    w = (rng.randn(3, 3, c, c) / np.sqrt(9 * c)).astype(np.float32)        # HWIO
    jdt = getattr(jnp, dtype)
    conv = lab.make_pallas_conv_h(hh, ww, c, jdt, chunk=4, fuse_silu=fuse_silu, interpret=True)
    want = np.asarray(conv(jnp.asarray(x).astype(jdt),
                           lab.pack_conv_weight_h(jnp.asarray(w).astype(jdt))), np.float32)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)                   # channels_last NCHW
    tw = torch.from_numpy(w).to(tdt).permute(3, 2, 0, 1).contiguous()      # OIHW, as compat lays it
    got = fused_conv_lab.conv3x3_silu(tx, tw, fuse_silu)
    assert got.dtype == tdt and got.shape == (b, c, hh, ww)
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got.permute(0, 2, 3, 1).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 3e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(nomax_attn_lab.VARIANTS))
def test_lab_attention_ref_matches_pallas(variant, dtype, monkeypatch):
    lab = _jax_lab("nomax_attn_lab", monkeypatch)
    fold_l, chains, prescale = nomax_attn_lab.VARIANTS[variant]
    b, h, sq, sk, d = 1, 2, 256, 512, 32
    rng = np.random.RandomState(1)

    def rows(s, normalised=True):
        x = rng.randn(b, h, s, d) * np.exp(rng.randn(b, h, s, 1))
        if normalised:
            x = x / (1e-4 + np.linalg.norm(x, axis=-1, keepdims=True) / np.sqrt(d))
        return x.astype(np.float32)

    arrays = [rows(sq), rows(sk), rows(sk, normalised=False)]
    want = lab.nomax_attention(*(jnp.asarray(a).astype(dtype) for a in arrays), block_q=128,
                               block_k=256, fold_l=fold_l, chains=chains, prescale=prescale,
                               interpret=True)
    got = nomax_attn_lab.nomax_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays),
        fold_l=fold_l, chains=chains, prescale=prescale)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol={"float32": 3e-5, "bfloat16": 1e-2}[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(nomax_attn_lab.VARIANTS))
def test_lab_attention_ref_matches_pallas_d64_ragged_keys(variant, dtype, monkeypatch):
    """d 64, and 192 keys: no multiple of the kernel's 128-key stage (its
    last stage is half padding) nor of the TPU kernel's default block; the
    TPU kernel takes blocks of 64 keys here, four chains 16 each."""
    lab = _jax_lab("nomax_attn_lab", monkeypatch)
    fold_l, chains, prescale = nomax_attn_lab.VARIANTS[variant]
    b, h, sq, sk, d = 1, 2, 128, 192, 64
    rng = np.random.RandomState(3)

    def rows(s, normalised=True):
        x = rng.randn(b, h, s, d) * np.exp(rng.randn(b, h, s, 1))
        if normalised:
            x = x / (1e-4 + np.linalg.norm(x, axis=-1, keepdims=True) / np.sqrt(d))
        return x.astype(np.float32)

    arrays = [rows(sq), rows(sk), rows(sk, normalised=False)]
    want = lab.nomax_attention(*(jnp.asarray(a).astype(dtype) for a in arrays), block_q=128,
                               block_k=64, fold_l=fold_l, chains=chains, prescale=prescale,
                               interpret=True)
    got = nomax_attn_lab.nomax_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays),
        fold_l=fold_l, chains=chains, prescale=prescale)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol={"float32": 3e-5, "bfloat16": 1e-2}[dtype], rtol=0)


def test_lab_attention_info_needs_a_card(monkeypatch):
    """What an instance of the lab kernel was built with comes from the
    built library alone: a head dim or chain count the kernel lacks raises
    first, and with no card the call raises before it builds or loads
    anything."""
    def no_library():
        raise AssertionError("nomax_attention_info reached the library")

    monkeypatch.setattr(nomax_attn_lab.build, "library", no_library)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="32 or 64"):
        nomax_attn_lab.nomax_attention_info(16)
    with pytest.raises(ValueError, match="chains"):
        nomax_attn_lab.nomax_attention_info(32, chains=3)
    for fold_l, chains, prescale in nomax_attn_lab.VARIANTS.values():
        with pytest.raises(RuntimeError, match="CUDA card"):
            nomax_attn_lab.nomax_attention_info(64, fold_l, chains, prescale)


@pytest.mark.parametrize("b,h,sq,grid", [
    (8, 4, 16384, (86, 4, 8)),   # the lab's three timing shapes: 85 full blocks and a third
    (8, 6, 4096, (22, 6, 8)),
    (8, 2, 16384, (86, 2, 8)),
    (2, 2, 1024, (6, 2, 2)),     # the parity shape
])
def test_lab_attention_plan(b, h, sq, grid):
    """The lab kernel's grid is K6's: ceil(Sq / 192) x H x B, one block an
    SM on 132 SMs."""
    plan = nomax_attn_lab.nomax_attention_plan(b, h, sq)
    blocks = grid[0] * grid[1] * grid[2]
    assert plan == dict(grid=grid, blocks=blocks, waves=round(blocks / 132, 3))


def test_lab_attention_fold_l_sums_the_rounded_p():
    """bf16: with fold_l the denominator is the sum of the rounded p (the
    product sums it), without it of the unrounded: other bits, same function."""
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(1, 1, 64, 32).astype(np.float32)).bfloat16()
               for _ in range(3))
    folded = nomax_attn_lab.nomax_attention_ref(q, k, v, fold_l=True).float()
    plain = nomax_attn_lab.nomax_attention_ref(q, k, v).float()
    assert 0 < (folded - plain).abs().max() <= 1e-2


def test_lab_wrappers_raise_on_what_the_kernels_do_not_take():
    before = dict(flash.launches)
    x = torch.zeros(1, 32, 8, 8)
    with pytest.raises(ValueError, match="64"):
        fused_conv_lab.conv3x3_silu(x, torch.zeros(32, 32, 3, 3))
    meta = torch.empty(1, 64, 8, 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="must be bf16 on"):
        fused_conv_lab.conv3x3_silu(meta, torch.zeros(64, 64, 3, 3))
    q = torch.empty(1, 2, 64, 32, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="must be on"):
        nomax_attn_lab.nomax_attention(q, q, q)
    with pytest.raises(ValueError, match="chains"):
        nomax_attn_lab.nomax_attention(torch.zeros(1, 1, 8, 32), torch.zeros(1, 1, 8, 32),
                                       torch.zeros(1, 1, 8, 32), chains=3)
    assert flash.launches == before


@pytest.mark.parametrize("lab,argv,checks", [
    (fused_conv_lab, ["--device", "cpu", "--batch", "1", "--res", "16"], 2),
    (nomax_attn_lab, ["--device", "cpu"], len(nomax_attn_lab.VARIANTS)),
    (bigs_attn_lab, ["--device", "cpu"], len(bigs_attn_lab.PARITY_SHAPES)),
])
def test_lab_main_checks_parity_on_the_cpu(lab, argv, checks, capsys):
    """Asked for the CPU a lab checks parity and prints no time."""
    results = lab.main(argv)
    assert len(results) == checks and all(r["check"] == "parity" for r in results)
    out = capsys.readouterr().out
    assert "parity" in out and " ms" not in out


def test_conv_info_raises_without_a_card(monkeypatch):
    """The kernel's build facts come from the loaded library, so only with a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fuse in (True, False):
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            fused_conv_lab.conv3x3_silu_info(fuse)


@pytest.mark.parametrize("lab", [fused_conv_lab, nomax_attn_lab, bigs_attn_lab])
def test_lab_main_raises_without_a_card(lab, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        lab.main([])


def test_lab_main_raises_on_failed_parity(monkeypatch):
    monkeypatch.setattr(nomax_attn_lab, "nomax_attention_ref",
                        lambda q, k, v, *a: nomax_attn_lab.reference_attention(q, k, 2 * v))
    with pytest.raises(AssertionError, match="parity"):
        nomax_attn_lab.main(["--device", "cpu"])
    assert "VIVID_NOMAX_PACKED" not in os.environ
