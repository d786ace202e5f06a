"""The plain versions of the port's packed attention kernels (K1
flash_fused_packed, K2 flash_fused_packed_xattn) against the JAX package's
Pallas kernels run in interpret mode, on the same numpy inputs (CPU, fp32,
atol 3e-5 as in test_flash_fused.py), and what the CPU can check of the CUDA
kernels' wrappers (arguments, grids). The kernels themselves run only on a
card: chip_smoke.py compares them with these plain versions there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivid_tpu.kernels.flash import flash_fused_packed as j_packed
from vivid_tpu.kernels.flash import flash_fused_packed_xattn as j_xattn
from vivid_tpu_torch.kernels import attention, build, flash

torch.set_num_threads(1)

ATOL = 3e-5


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("b,s,h,d,sink", [
    (2, 64, 2, 64, 0),
    (1, 128, 3, 32, 0),
    (2, 64, 2, 64, 128),
    (1, 64, 4, 16, 256),
])
def test_packed_self_matches_pallas(b, s, h, d, sink):
    qkv = _x(b, s, 3 * h * d)
    want = np.asarray(j_packed(jnp.asarray(qkv), h, zero_sink=sink, interpret=True))
    got = flash.flash_fused_packed(torch.from_numpy(qkv), h, zero_sink=sink)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,s,h,d,sfs,biased", [
    (2, 64, 2, 64, (64, 64), False),
    (1, 64, 2, 32, (128,), False),
    (2, 64, 2, 64, (64, 64), True),
    (1, 128, 1, 64, (64,), True),
    # sources of no whole number of 64-row tiles: the padding rows of the
    # kernel's key tiles, which its mask must keep out of the softmax
    (1, 64, 2, 64, (40, 72), False),
    (2, 100, 2, 32, (40, 72), True),
])
def test_packed_xattn_matches_pallas(b, s, h, d, sfs, biased):
    qkv = _x(b, s, 3 * h * d)
    feats = [_x(b, sf, 2 * h * d, seed=1 + i) for i, sf in enumerate(sfs)]
    biases = [0.5 * _x(b, h, s, sf, seed=10 + i) for i, sf in enumerate(sfs)] if biased else []
    want = np.asarray(j_xattn(jnp.asarray(qkv), [jnp.asarray(f) for f in feats], h,
                              biases=[jnp.asarray(x) for x in biases] or None,
                              interpret=True))
    got = flash.flash_fused_packed_xattn(torch.from_numpy(qkv),
                                         [torch.from_numpy(f) for f in feats], h,
                                         biases=[torch.from_numpy(x) for x in biases])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_packed_xattn_with_a_zero_source_matches_pallas():
    """The sink beside a source: a source of all-zero rows (the unconditional
    model's cross features, what the sink stands for) of 40 keys beside a
    source of 72, both lengths no whole number of 64-row tiles."""
    b, s, h, d = 1, 64, 2, 64
    qkv = _x(b, s, 3 * h * d)
    feats = [np.zeros((b, 40, 2 * h * d), np.float32), _x(b, 72, 2 * h * d, seed=2)]
    want = np.asarray(j_xattn(jnp.asarray(qkv), [jnp.asarray(f) for f in feats], h,
                              interpret=True))
    got = flash.flash_fused_packed_xattn(torch.from_numpy(qkv),
                                         [torch.from_numpy(f) for f in feats], h)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_zero_sink_equals_zero_columns():
    """The closed-form sink is attention over that many all-zero KV columns."""
    b, s, h, d = 1, 32, 2, 16
    qkv = torch.from_numpy(_x(b, s, 3 * h * d))
    zeros = torch.zeros(b, 2 * s, 2 * h * d)
    want = flash.flash_fused_packed_xattn_ref(qkv, [zeros], h)
    got = flash.flash_fused_packed_ref(qkv, h, zero_sink=2 * s)
    # A zero key row normalises to zero: logit 0 and value 0, as the sink.
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    qkv = torch.from_numpy(_x(1, 64, 3 * 2 * 32))
    feats = [torch.from_numpy(_x(1, 64, 2 * 2 * 32, seed=3))]
    before = dict(flash.launches)
    torch.testing.assert_close(attention.self_attention_from_packed(qkv, 2, zero_sink=5),
                               flash.flash_fused_packed_ref(qkv, 2, 5))
    torch.testing.assert_close(attention.xattn_from_packed(qkv, feats, 2),
                               flash.flash_fused_packed_xattn_ref(qkv, feats, 2))
    assert flash.launches == before


@pytest.mark.parametrize("shape,heads,feats,match", [
    ((1, 64, 3 * 2 * 64), 2, (), "must be on"),            # not a CUDA tensor
    ((1, 64, 3 * 2 * 16), 2, (), "head dim must be 32 or 64"),
    ((1, 64, 3 * 2 * 64), 2, [(1, 64, 4 * 64)] * 3, "at most 2 cross sources"),
])
def test_non_cpu_tensors_never_take_the_plain_version(shape, heads, feats, match):
    """Off the CPU a wrapper launches its kernel or raises; it checks what
    the kernel takes before building anything (meta tensors stand in)."""
    qkv = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    fs = [torch.empty(f, dtype=torch.bfloat16, device="meta") for f in feats]
    with pytest.raises(ValueError, match=match):
        if fs:
            flash.flash_fused_packed_xattn(qkv, fs, heads)
        else:
            flash.flash_fused_packed(qkv, heads)


def test_packed_info_needs_a_card(monkeypatch):
    """What K1/K2's kernel was built with comes from the built library alone:
    a head dim the kernel lacks raises first, and with no card the call
    raises before it builds or loads anything."""
    def no_library():
        raise AssertionError("flash_packed_info reached the library")

    monkeypatch.setattr(flash.build, "library", no_library)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="32 or 64"):
        flash.flash_packed_info(16)
    for d in (32, 64):
        for biased in (False, True):
            with pytest.raises(RuntimeError, match="CUDA card"):
                flash.flash_packed_info(d, biased)


@pytest.mark.parametrize("b,s,h,blocks", [
    (8, 1024, 4, 512),   # 32x32: 16 query tiles a head, 1.94 waves
    (8, 256, 6, 192),    # 16x16
    (8, 64, 8, 64),      # 8x8: one tile a head
])
def test_packed_fwd_plan(b, s, h, blocks):
    """The grid of K1/K2's forward at the 64px model's three attention
    shapes: a block for each 64-row query tile, whatever the sources, and
    the waves it makes at two blocks an SM on 132 SMs."""
    plan = flash.packed_fwd_plan(b, s, h)
    assert plan == {"fwd": dict(blocks=blocks, waves=round(blocks / (2 * 132), 3))}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    build.build.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    build.build.cache_clear()
