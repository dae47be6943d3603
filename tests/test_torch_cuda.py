"""The port's CUDA kernels against their plain PyTorch versions on a card.

Imports neither JAX nor the JAX package, so that it runs on a machine
with a card and no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_cuda.py

Without a card the test skips (the CUDA kernel has no CPU mode).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from covid19uk_tpu_torch.inference.likelihood import make_context
from covid19uk_tpu_torch.models import seir
from covid19uk_tpu_torch.models.spec import Parameters
from covid19uk_tpu_torch.ops import fused_sweep as fs
from covid19uk_tpu_torch.utils import synthetic


def _sweep_args(C, M, T, cfg, gen):
    model = synthetic.build_synthetic_model(M, T, torch.float32,
                                            device="cuda")
    p = synthetic.initial_parameters(model)
    params = Parameters(*[a.expand((C,) + a.shape) for a in p])
    events = model.sample_seir(gen, params)
    state = seir.compute_state(model.initial_state, events)
    commute = model.commute_pressure(state[..., 2])
    ctx = make_context(model, params)
    logp = model.log_prob(params, events)
    decays = torch.tensor([0.8, 0.85, 0.9, 0.9, 0.9],
                          device="cuda").expand(C, 5)
    tbl, ttbl = fs.draw_tables(gen, C, M, T, cfg, "cuda")
    return (tbl, ttbl, events, state, commute, logp, ctx.exp_eta, ctx.psi_w,
            ctx.rate_ir_t, ctx.N, ctx.Cstar, decays)


@pytest.mark.gpu
@pytest.mark.parametrize("guided, mmax", [(False, 2), (True, 2), (True, 8)])
def test_cuda_fused_sweep_matches_plain_version(guided, mmax):
    """K1 against its plain version on the same inputs; the caller's
    tensors are left as they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    C, M, T = 6, 40, 30
    cfg = fs.SweepConfig(mmax=mmax, nmax=10, dmax=8, occult_nmax=5,
                         t_range=(T - 10, T), num_updates=3,
                         occult_guided=guided)
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = _sweep_args(C, M, T, cfg, gen)
    copies = [a.clone() for a in args]
    before = fs.fused_sweep.launches
    got = fs.fused_sweep(*args, cfg)
    torch.cuda.synchronize()
    assert fs.fused_sweep.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(args, copies))
    rec = []
    want = fs.fused_sweep_reference(*args, cfg, record=rec)
    ev, st, cm, lp, tr = [a.cpu() for a in got]
    ev_w, st_w, cm_w, lp_w, tr_w = [a.cpu() for a in want]
    assert torch.equal(ev, ev_w) and torch.equal(st, st_w)
    # commute: float32 rank-1 updates, equal up to rounding
    torch.testing.assert_close(cm, cm_w, rtol=1e-5, atol=1e-6)
    # logp: float32 sums in another order
    torch.testing.assert_close(lp, lp_w, rtol=1e-5, atol=0.0)
    cols = [0] + list(range(2, tr.shape[-1]))
    assert torch.equal(tr[..., cols], tr_w[..., cols])
    accepted = sum(int((r["log_u"] < r["log_alpha"]).sum()) for r in rec)
    assert accepted > 0, "nothing accepted: the apply paths never ran"
    if mmax == 2:
        assert int(tr[:, :, 0].sum()) > 0, "nothing accepted: vacuous"


@pytest.mark.gpu
@pytest.mark.parametrize("lead, T, zero_row", [
    ((), 37, None), ((3,), 37, None),
    ((4,), 85, None),  # the windowed batch's shape of days
    ((), 37, 2),  # one block row of zero blocks
])
def test_cuda_block_sparse_matches_plain_version(lead, T, zero_row):
    """K2 on the card against its plain version on the same inputs, within
    1e-5 of |A| @ |x| (float32 sums in another order, 3xTF32 products):
    one launch a matmul call, bitwise-equal y over two calls, x unchanged,
    zero rows for a block row of zero blocks; and its gradient through the
    autograd wrapper (one more launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from covid19uk_tpu_torch.ops import block_sparse as bs

    M = 1100
    model = synthetic.build_synthetic_model(M, T, torch.float32, sparse=True,
                                            radius_frac=0.05, device="cuda")
    op = model.data.Cstar_bsr
    if zero_row is not None:
        values = op.values.clone()
        values[zero_row] = 0.0
        op = bs.BlockSparse(values, op.col_idx, op.n, op.perm, op.inv_perm)
        assert int(op.slots[zero_row]) == 0
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(lead + (M, T), generator=gen, device="cuda",
                    requires_grad=True)
    x0 = x.detach().clone()
    before = bs.bsr_matmul.launches
    y = op.matmul(x)
    y2 = op.matmul(x.detach())
    torch.cuda.synchronize()
    assert bs.bsr_matmul.launches == before + 2
    assert torch.equal(y.detach(), y2)
    assert torch.equal(x.detach(), x0)

    def plain(values, v):
        return bs._plain(values, op.col_idx, op.perm, op.inv_perm,
                         v.reshape((-1, M, T))).reshape(lead + (M, T))

    want = plain(op.values, x.detach())
    scale = plain(op.values.abs(), x.detach().abs())
    err = float(((y.detach() - want).abs() / (scale + 1e-30)).max())
    assert err <= 1e-5, err
    if zero_row is not None:
        rows = op.perm[zero_row * bs.BLOCK:(zero_row + 1) * bs.BLOCK]
        assert bool((y.detach()[..., rows, :] == 0).all())
        return
    (g,) = torch.autograd.grad(y.sum(), x)
    assert bs.bsr_matmul.launches == before + 3
    dense = op.todense().astype("float64")
    g_err = (g.cpu().numpy() - dense.sum(axis=0)[:, None]) / (
        abs(dense).sum(axis=0)[:, None])
    assert abs(g_err).max() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("space", [2, 3])
def test_cuda_block_sparse_band_matches_plain_version(space):
    """K2 launched on each of ``space`` bands of block rows (a space-sharded
    rank's band) against the plain band on the same inputs, within 1e-5
    of |A| @ |x|: one launch a band, zeros outside the band's rows, and
    the bands summed bitwise equal to the whole launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from covid19uk_tpu_torch.ops import block_sparse as bs

    M, T = 768, 120  # 6 block rows
    model = synthetic.build_synthetic_model(M, T, torch.float32, sparse=True,
                                            radius_frac=0.05, device="cuda")
    op = model.data.Cstar_bsr
    x = torch.randn((2, M, T), generator=torch.Generator(
        device="cuda").manual_seed(2), device="cuda")
    scale = bs._plain(op.values.abs(), op.col_idx, op.perm, op.inv_perm,
                      x.abs())
    total = torch.zeros_like(x)
    for r in range(space):
        band = op.row_band(r, space)
        before = bs.bsr_matmul.launches
        y = band.matmul(x)
        torch.cuda.synchronize()
        assert bs.bsr_matmul.launches == before + 1
        want = bs._plain_band(op.values, op.col_idx, op.perm, band.r0,
                              band.r1, x)
        err = float(((y - want).abs() / (scale + 1e-30)).max())
        assert err <= 1e-5, err
        outside = want.abs().sum((0, 2)) == 0
        assert bool((y[:, outside] == 0).all())
        total += y
    assert torch.equal(total, op.matmul(x))


def _posterior_samples(S, M, T):
    """A synthetic model and S posterior-like samples (jittered scalar
    parameters, events simulated from each), as the numpy dict the verbs
    read."""
    from covid19uk_tpu_torch.models.spec import Parameters

    model = synthetic.build_synthetic_model(M, T, torch.float64,
                                            device="cpu")
    p = synthetic.initial_parameters(model)
    gen = torch.Generator().manual_seed(3)
    jitter = 1.0 + 0.05 * torch.randn((S, 6), generator=gen,
                                      dtype=torch.float64)
    scalars = [p[i] * jitter[:, i] for i in range(6)]
    params = Parameters(*scalars, p.alpha_t.expand(S, -1),
                        p.spatial_effect.expand(S, -1))
    events = model.sample_seir(gen, params)
    samples = {k: v.numpy() for k, v in zip(Parameters._fields, params)}
    samples["seir"] = events.numpy()
    return model, samples


@pytest.mark.gpu
def test_cuda_posterior_verbs_match_the_cpu():
    """R_it on the card (float32) within 1e-5 relative of float64 on the
    CPU; predictions on the card, in and out of sample, are non-negative
    integers that no compartment falls short of, with a non-negative
    implied state."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the verbs' entry points run on it")
    from covid19uk_tpu_torch.models.spec import ModelData
    from covid19uk_tpu_torch.posterior.predict import (
        prediction_data, predicted_incidence)
    from covid19uk_tpu_torch.posterior.reproduction_number import (
        calc_posterior_rit)

    S, M, T = 16, 11, 32
    model, samples = _posterior_samples(S, M, T)
    covariates, init = synthetic.synthetic_covariates(M, T)
    times = torch.arange(T)
    want = calc_posterior_rit(samples, init, times, ModelData.create(
        covariates, torch.float64, sparse=False, device="cpu"),
        dtype=torch.float64)
    got = calc_posterior_rit(samples, init, times, ModelData.create(
        covariates, torch.float32, sparse=False, device="cuda"))
    assert got.device.type == "cuda" and got.shape == (S, T, M)
    rel = ((got.cpu().double() - want).abs() / want.abs()).max()
    assert float(rel) <= 1e-5, float(rel)

    for start, days, oos in [(T - 7, 7, False), (T - 1, 14, True)]:
        data, _ = prediction_data(covariates, "2020-10-05", start + days,
                                  "cuda")
        new_init, ev = predicted_incidence(samples, init, data, start, days,
                                           out_of_sample=oos, seed=1)
        assert ev.device.type == "cuda" and ev.shape == (S, M, days, 3)
        assert seir.simulation_problems(new_init, ev) == []
        torch.testing.assert_close(
            new_init.cpu().double(),
            seir.compute_state(torch.as_tensor(init),
                               torch.as_tensor(samples["seir"]))[
                ..., start, :], rtol=1e-6, atol=0.0)


def _gamma_inputs(C, T, dtype, device):
    """UK-sized daily removals and exposures of C chains, starts near and
    off their conditional modes, and injected draws, from a numpy seed."""
    from covid19uk_tpu_torch.inference.gamma_gibbs import GammaNoise

    rng = np.random.default_rng(0)
    wd = (np.arange(T) % 7 < 5).astype(float)
    K = rng.integers(200, 3000, (C, T)).astype(float)
    N = K * rng.uniform(3.0, 8.0, (C, T))
    g = np.stack([np.log(-np.log1p(-K.sum(1) / N.sum(1))), np.zeros(C)], 1)
    g += rng.normal(0.0, 0.05, (C, 2))
    draws = (rng.normal(size=(C, 2)), rng.chisquare(5.0, C),
             rng.uniform(size=C))

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    return (t(g), t(K), t(N), t(wd - wd.mean()),
            GammaNoise(*[t(a) for a in draws]))


@pytest.mark.gpu
def test_cuda_gamma_refresh_and_gp_conditional_match_the_cpu():
    """The gamma refresh (injected draws) and the GP conditional in
    float64 on the card against float64 on the CPU, rtol 1e-9: the same
    decisions, the same draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the entry points run on it")
    from covid19uk_tpu_torch.inference.gamma_gibbs import gamma_gibbs_step
    from covid19uk_tpu_torch.models import gp

    outs = []
    for dev in ("cuda", "cpu"):
        *args, noise = _gamma_inputs(64, 120, torch.float64, dev)
        outs.append(gamma_gibbs_step(None, *args, noise=noise))
    got, want = outs
    assert got[0].device.type == "cuda"
    assert torch.equal(got[1].is_accepted.cpu(), want[1].is_accepted)
    assert bool(want[1].is_accepted.any())
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-9, atol=0.0)
    torch.testing.assert_close(got[1].log_accept_ratio.cpu(),
                               want[1].log_accept_ratio, rtol=1e-9,
                               atol=1e-9)

    x = np.linspace(0.0, 4.0, 40)[:, None]
    y = np.sin(x[:, 0])
    xs = np.linspace(-0.5, 4.5, 25)[:, None]
    posts = []
    for dev in ("cuda", "cpu"):
        prior = gp.GaussianProcess(gp.matern32_kernel(1.3, 0.8),
                                   torch.tensor(x, device=dev), 0.05)
        posts.append(gp.conditional_gp(prior, torch.tensor(y, device=dev),
                                       torch.tensor(xs, device=dev)))
    assert posts[0].mean.device.type == "cuda"
    for a, b in zip(posts[0], posts[1]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-9, atol=1e-12)
    probe = posts[1].mean + 0.1
    torch.testing.assert_close(posts[0].log_prob(probe.cuda()).cpu(),
                               posts[1].log_prob(probe), rtol=1e-9, atol=0.0)


@pytest.mark.gpu
def test_cuda_sharded_step_over_two_ranks_on_one_card(tmp_path):
    """Two gloo ranks on the one card run 4 chains each through K1 on
    the same StepNoise rows as the one-process step on 8: events
    identical, u within rtol 1e-5 (cuBLAS may pick another algorithm for
    the smaller batch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    # by its path: the card's machine may have another package named tests
    spec = importlib.util.spec_from_file_location(
        "torch_ranks", os.path.join(os.path.dirname(__file__),
                                    "torch_ranks.py"))
    torch_ranks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torch_ranks)
    torch_ranks.spawn("parallel", tmp_path, device="cuda")
    _, state, tune, noise, step = torch_ranks.step_case("cuda", torch.float32)
    before = fs.fused_sweep.launches
    want = [x.cpu() for x in torch_ranks.leaves(step(state, tune, None,
                                                     noise))]
    assert fs.fused_sweep.launches == before + 1
    for r in range(2):
        got = np.load(tmp_path / f"parallel_{r}.npz")
        np.testing.assert_array_equal(got["step_1"], want[1].numpy())
        np.testing.assert_allclose(got["step_0"], want[0].numpy(),
                                   rtol=1e-5, atol=0.0)


@pytest.mark.gpu
def test_cuda_debug_nans_names_the_op_and_the_kernel():
    """On the card the mode names an aten op's NaN, and K1's wrapper its
    own (a NaN logp in, a NaN logp out of the kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from covid19uk_tpu_torch.utils import nans

    zero = torch.zeros(4, device="cuda")
    with nans.NanCheck(), pytest.raises(FloatingPointError,
                                        match=r"aten\.mul"):
        torch.log(zero) * 0.0
    C, M, T = 4, 40, 30
    cfg = fs.SweepConfig(mmax=2, nmax=10, dmax=8, occult_nmax=5,
                         t_range=(T - 10, T), num_updates=2,
                         occult_guided=False)
    args = list(_sweep_args(C, M, T, cfg,
                            torch.Generator(device="cuda").manual_seed(0)))
    args[5] = args[5].clone()
    args[5][0] = float("nan")
    with nans.NanCheck(), pytest.raises(FloatingPointError,
                                        match="fused_sweep kernel"):
        fs.fused_sweep(*args, cfg)
