"""The port's ``debug_nans`` (``covid19uk_tpu_torch.utils.nans``), the
counterpart of JAX's ``jax_debug_nans``: the per-op mode names the op
that made a NaN (backward ops included) and lets an infinity pass, the
kernel wrappers check their own outputs inside it, the MCMC driver's flag
raises at a transition that returns a NaN and leaves a clean run's draws
as they are; and the port's version."""

import h5py
import numpy as np
import pytest
import torch

import covid19uk_tpu
from covid19uk_tpu import version as jversion
import covid19uk_tpu_torch
from covid19uk_tpu_torch import version as tversion
from covid19uk_tpu_torch.inference import driver
from covid19uk_tpu_torch.ops import block_sparse as bs
from covid19uk_tpu_torch.ops import fused_sweep as fs
from covid19uk_tpu_torch.utils import nans
from covid19uk_tpu_torch.utils.synthetic import (
    build_synthetic_model, initial_chain_state)
from tests import torch_ranks

TINY = dict(dmax=4, nmax=8, m=2, occult_nmax=4, num_event_time_updates=2,
            thin=1, dtype="float64", seed=1, num_chains=4)


def test_mode_names_the_op_and_lets_inf_pass():
    zero = torch.zeros(3)
    with nans.NanCheck():
        inf = torch.log(zero)  # -inf alone is no error, as in JAX
        assert bool(torch.isinf(inf).all())
        assert bool(torch.isinf(torch.ones(2) / 0.0).all())
        with pytest.raises(FloatingPointError, match=r"aten\.mul"):
            inf * 0.0
    assert bool(torch.isnan(torch.log(zero) * 0.0).all())  # mode off


def test_mode_sees_backward_ops():
    x = torch.zeros(3, requires_grad=True)
    y = (torch.sqrt(x) * 0.0).sum()  # forward: finite
    with nans.NanCheck(), pytest.raises(FloatingPointError, match="aten"):
        y.backward()  # d sqrt at 0 is inf, times 0


def test_kernel_wrappers_check_their_outputs(monkeypatch):
    """K1 and K2 run through ctypes, out of the mode's sight: a NaN their
    output gets without an aten op (here written through numpy into the
    plain version's output, as a kernel writes) raises through the
    wrapper's own check inside the mode, and passes outside it."""
    model, state, tune, noise, step = torch_ranks.step_case()
    sweep = fs.fused_sweep_reference

    def poisoned(*args, **kw):
        out = sweep(*args, **kw)
        out[3].numpy()[0] = np.nan  # logp, bypassing the dispatcher
        return out

    monkeypatch.setattr(fs, "fused_sweep_reference", poisoned)
    with nans.NanCheck(), pytest.raises(FloatingPointError,
                                        match="fused_sweep kernel"):
        step(state, tune, None, noise)
    out = torch_ranks.leaves(step(state, tune, None, noise))
    assert any(bool(torch.isnan(x).any()) for x in out
               if x.is_floating_point())  # no check outside the mode

    a = np.zeros((130, 130))
    a[3, 4] = a[4, 3] = 0.5
    op = bs.BlockSparse.from_dense(a, torch.float64, device="cpu")
    plain = bs._plain

    def poisoned_product(*args):
        y = plain(*args)
        y.numpy()[0, 0, 0] = np.nan
        return y

    monkeypatch.setattr(bs, "_plain", poisoned_product)
    with nans.NanCheck(), pytest.raises(FloatingPointError,
                                        match="bsr_matmul kernel"):
        op.matmul(torch.ones(130, 2, dtype=torch.float64))
    x = torch.ones(130, 2, dtype=torch.float64)
    assert bool(torch.isnan(op.matmul(x)).any())


def test_flag_raises_at_a_nan_parameter_naming_the_op(tmp_path):
    """``debug_nans`` on a run whose chains start from a NaN parameter:
    the first transition returns a NaN, runs again inside the mode, and
    the error names the aten op that made it; the same through
    ``checked_step`` alone."""
    model = build_synthetic_model(6, 12, torch.float64, device="cpu")
    state = initial_chain_state(model, torch.Generator().manual_seed(0))
    u = state.u.clone()
    u[0] = float("nan")  # psi
    state = state._replace(u=u)
    ecfg = driver.event_kernel_config(
        driver.McmcConfig(**TINY), 12)._replace(t_range=(6, 12))
    cfg = dict(TINY, num_bursts=1, num_burst_samples=1, debug_nans=True,
               warmup=dict(first_window=2, slow_window=1,
                           num_slow_windows=0, last_window=1))
    with pytest.raises(FloatingPointError, match=r"output of aten\."):
        driver.run_mcmc(model, state, ecfg, cfg, str(tmp_path / "a.h5"),
                        num_chains=4, device="cpu")
    step = nans.checked_step(driver.make_mcmc_step(model, 3, ecfg))
    _, _, tune, _, _ = torch_ranks.step_case()
    with pytest.raises(FloatingPointError, match=r"output of aten\."):
        step(driver.ChainState(u=u[None], events=state.events[None]),
             tune._replace(step_size=tune.step_size[:1],
                           inv_mass_diag=torch.ones_like(u[None])),
             torch.Generator().manual_seed(0))


def test_flag_leaves_a_clean_ni_window_unchanged(tmp_path):
    """A short NI run (a fast window of 3 draws, then 1 + 2) stores the
    same bits with the flag on and off."""
    cfg = dict(TINY, num_bursts=1, num_burst_samples=2,
               warmup=dict(first_window=3, slow_window=1,
                           num_slow_windows=0, last_window=1))
    paths = []
    for flag in (False, True):
        paths.append(str(tmp_path / f"{flag}.h5"))
        driver.mcmc(torch_ranks.NI_DATA, paths[-1],
                    dict(cfg, debug_nans=flag), device="cpu")
    with h5py.File(paths[0], "r") as a, h5py.File(paths[1], "r") as b:
        names = []
        a.visititems(lambda n, o: names.append(n)
                     if isinstance(o, h5py.Dataset) else None)
        assert "samples/seir" in names
        for name in names:
            np.testing.assert_array_equal(a[name][()], b[name][()],
                                          err_msg=name)
        assert a["samples/psi"].shape == (6, 4)


def test_version_matches_jax():
    assert covid19uk_tpu_torch.__version__ == covid19uk_tpu.__version__
    assert "__version__" in covid19uk_tpu_torch.__all__
    assert tversion.VERSION == jversion.VERSION
