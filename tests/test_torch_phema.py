"""The port's post-hoc EMA against the JAX package's: the profile algebra
and the solver (fp64 on both sides, to 1e-12), the reconstruction from a
snapshot series on disk and from in-memory triples (to 1e-6), its CLI, and
the trackers' state dicts and the half-life EMA."""

import os

import numpy as np
import pytest
import torch

from vivid_tpu.diffusion import phema as jphema
from vivid_tpu_torch.cli import reconstruct_phema as cli
from vivid_tpu_torch.compat.from_jax import from_jax, to_jax
from vivid_tpu_torch.diffusion import phema
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.train.snapshots import load_snapshot, save_snapshot

RTOL = 1e-12
CFG = PrecondConfig(img_resolution=16, model_channels=16, channel_mult=(1, 2), num_blocks=1,
                    attn_resolutions=(8,), channels_per_head=8, use_bf16=False, remat=False)
SERIES = [(nimg, std) for nimg in (4000, 8000, 12000) for std in (0.050, 0.100)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_profile_algebra_and_solver_match_jax(seed):
    rng = np.random.RandomState(seed)
    ofs = np.repeat(np.sort(rng.choice(np.arange(1, 60), 3, replace=False)) * 1000.0, 2)
    std = np.tile([0.050, 0.100], 3)
    out_ofs, out_std = np.full(4, ofs.max()), rng.uniform(0.03, 0.15, 4)
    length = int(ofs.max()) + 1
    np.testing.assert_allclose(phema.power_function_response(ofs, std, length),
                               jphema.power_function_response(ofs, std, length), rtol=RTOL)
    args = (ofs.reshape(-1, 1), std.reshape(-1, 1), out_ofs.reshape(1, -1),
            out_std.reshape(1, -1))
    np.testing.assert_allclose(phema.power_function_correlation(*args),
                               jphema.power_function_correlation(*args), rtol=RTOL)
    got = phema.solve_posthoc_coefficients(ofs, std, out_ofs, out_std)
    np.testing.assert_allclose(got, jphema.solve_posthoc_coefficients(ofs, std, out_ofs, out_std),
                               rtol=RTOL)
    np.testing.assert_allclose(got.sum(axis=0), 1.0, rtol=RTOL)


@pytest.fixture(scope="module")
def series(tmp_path_factory):
    """Snapshots of one tiny model with different random weights at each
    (nimg, std), written in the format both packages read."""
    run_dir = tmp_path_factory.mktemp("phema_run")
    states = []
    for i, (nimg, std) in enumerate(SERIES):
        net = NVPrecond(CFG, seed=i)
        save_snapshot(str(run_dir / f"network-snapshot-{nimg // 1000:07d}-{std:.3f}.pkl"), net)
        # The snapshot is stored fp16; the triples carry what it loads as.
        states.append({k: v.half().float() for k, v in net.state_dict().items()})
    return run_dir, states


def _assert_close_rel(got, want, rtol):
    for name, w in want.items():
        w = w.double()
        err = (got[name].double() - w).abs().max().item()
        assert err <= rtol * max(w.abs().max().item(), 1e-30), (name, err)


def test_reconstruct_from_a_run_directory_matches_jax(series, tmp_path):
    run_dir, _ = series
    assert phema.list_phema_snapshots(str(run_dir)) == [
        (nimg, std, p) for nimg, std, p in jphema.list_phema_snapshots(str(run_dir))]
    got = phema.reconstruct_phema(str(run_dir), [0.075, 0.130], out_nimg=8000,
                                  out_dir=str(tmp_path / "port"), verbose=False)
    want = jphema.reconstruct_phema(str(run_dir), [0.075, 0.130], out_nimg=8000,
                                    out_dir=str(tmp_path / "jax"), verbose=False)
    for g, w in zip(got, want):
        assert (g.std, g.nimg) == (w.std, w.nimg) == (g.std, 8000)
        _assert_close_rel(g.params, from_jax(w.params), 1e-6)
        assert os.path.basename(g.path) == os.path.basename(w.path)
        # Each package's file loads in the port with the same weights (fp16).
        a, b = load_snapshot(g.path).net.state_dict(), load_snapshot(w.path).net.state_dict()
        _assert_close_rel(a, b, 1e-3)


def test_reconstruct_from_triples_matches_jax(series):
    _, states = series
    triples = [(nimg, std, s) for (nimg, std), s in zip(SERIES, states)]
    jtriples = [(nimg, std, to_jax(s)) for nimg, std, s in triples]
    got = phema.reconstruct_phema(triples, 0.075, verbose=False)
    want = jphema.reconstruct_phema(jtriples, 0.075, verbose=False)
    assert got[0].nimg == want[0].nimg == 12000
    _assert_close_rel(got[0].params, from_jax(want[0].params), 1e-6)
    # The result is the fp64 combination the solver gives.
    coef = phema.solve_posthoc_coefficients([t[0] for t in triples], [t[1] for t in triples],
                                            [12000.0], [0.075])[:, 0]
    name = next(iter(states[0]))
    mix = sum(c * s[name].double() for c, s in zip(coef, states))
    _assert_close_rel({name: got[0].params[name]}, {name: mix}, 1e-6)
    with pytest.raises(ValueError, match="snapshot-path"):
        phema.reconstruct_phema(triples, 0.075, out_dir="unused", verbose=False)


def test_reconstruct_cli_writes_loadable_snapshots(series, tmp_path):
    run_dir, _ = series
    results = cli.main(["--in-dir", str(run_dir), "--out-dir", str(tmp_path),
                        "--out-std", "0.075,0.130"], standalone_mode=False)
    assert sorted(os.listdir(tmp_path)) == ["phema-0000012-0.075.pkl", "phema-0000012-0.130.pkl"]
    snap = load_snapshot(str(tmp_path / "phema-0000012-0.075.pkl"))
    assert snap.cfg == CFG
    _assert_close_rel(snap.net.state_dict(), {k: v.half().float() for k, v in
                                               results[0].params.items()}, 1e-6)


def test_trackers_state_dicts_and_traditional_ema_match_jax():
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    p0 = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    p1 = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    ema = phema.TraditionalEMA([torch.tensor(p) for p in p0], halflife_Mimg=0.5)
    jema = jphema.TraditionalEMA([jnp.asarray(p) for p in p0], halflife_Mimg=0.5)
    for nimg in (64, 128, 10_000_000):
        ema.update([torch.tensor(p) for p in p1], nimg, 64)
        jema.update([jnp.asarray(p) for p in p1], nimg, 64)
    for a, b in zip(ema.get()[0][0], jema.get()[0][0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    other = phema.TraditionalEMA([torch.zeros(1)])
    other.load_state_dict(ema.state_dict())
    assert other.halflife_Mimg == 0.5 and all(torch.equal(a, b) for a, b in
                                              zip(other.ema, ema.ema))
    pf = phema.PowerFunctionEMA([torch.tensor(p) for p in p0], stds=(0.05, 0.1))
    pf.update([torch.tensor(p) for p in p1], 128, 64)
    fresh = phema.PowerFunctionEMA([torch.zeros(1)], stds=(0.2,))
    fresh.load_state_dict(pf.state_dict())
    assert fresh.stds == [0.05, 0.1]
    assert [s for _, s in fresh.get()] == [s for _, s in pf.get()] == ["-0.050", "-0.100"]
