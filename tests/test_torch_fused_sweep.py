"""Port parity for the fused event sweep: the JAX Pallas kernel in
interpret mode against the port's plain version, fed the same uniform
tables (drawn from the key as ops/pallas/fused_sweep.py draws them).
The CUDA kernel against the plain version is tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covid19uk_tpu.models import seir as jseir
from covid19uk_tpu.ops.pallas import fused_sweep as jfs
from covid19uk_tpu_torch.ops import fused_sweep as tfs

M, T, U = 12, 20, 2
KNOBS = dict(mmax=2, nmax=6, dmax=5, occult_nmax=4, t_range=(T - 6, T),
             num_updates=U)
DECAYS = (0.8, 0.85, 0.9, 0.9, 0.9)  # move se/ei, x se/ei, x occult


def _chains(C, seed=7):
    """C valid forward-simulated epidemics sharing N and Cstar."""
    rng = np.random.default_rng(seed)
    N = np.full(M, 500.0)
    Cm = rng.uniform(0.0, 20.0, (M, M))
    np.fill_diagonal(Cm, 0.0)
    Cstar = Cm + Cm.T
    psi_w = np.full((C, T), 0.5)
    rate_ir = np.full((C, T), 0.4)
    exp_eta = rng.uniform(0.5, 2.0, (C, M, 1)) * np.ones((C, M, T))
    init = np.zeros((C, M, 4))
    init[..., 0], init[..., 1], init[..., 2] = N - 10, 5, 5
    state = init.copy()
    events = np.zeros((C, M, T, 3))
    p_ei = 1.0 - np.exp(-float(jseir.NU))
    for t in range(T):
        commute = np.einsum("mn,cn->cm", Cstar, state[..., 2] / N)
        rate_se = exp_eta[..., t] * (state[..., 2] + 0.5 * commute) / N
        y = np.stack([
            rng.binomial(state[..., 0].astype(int), 1 - np.exp(-rate_se)),
            rng.binomial(state[..., 1].astype(int), p_ei),
            rng.binomial(state[..., 2].astype(int), 1 - np.exp(-0.4)),
        ], -1)
        events[:, :, t] = y
        state += y @ jseir.STOICHIOMETRY.astype(float)
    st = np.asarray(jseir.compute_state(init, events))
    commute = np.einsum("mn,cnt->cmt", Cstar, st[..., 2] / N[:, None])
    logp = rng.uniform(-2000.0, -1000.0, C)
    return dict(events=events, state=st, commute=commute, logp=logp,
                exp_eta=exp_eta, psi_w=psi_w, rate_ir_t=rate_ir, N=N,
                Cstar=Cstar)


def _jax_tables(key):
    """The kernel's uniform tables, as fused_sweep.py:799-801 draws them."""
    k_tbl, k_ttbl = jax.random.split(key)
    width = jfs._Offsets(M, KNOBS["mmax"]).width
    return (np.asarray(jax.random.uniform(k_tbl, (U, width), jnp.float32)),
            np.asarray(jax.random.uniform(k_ttbl, (U, T, 128), jnp.float32)))


def _port_args(d, tbl, ttbl, device="cpu"):
    t = lambda a: torch.tensor(np.asarray(a), device=device)  # noqa: E731
    C = d["events"].shape[0]
    return (t(tbl), t(ttbl), t(d["events"]), t(d["state"]), t(d["commute"]),
            t(d["logp"]), t(d["exp_eta"]), t(d["psi_w"]), t(d["rate_ir_t"]),
            t(d["N"]), t(d["Cstar"]), t(np.tile(DECAYS, (C, 1))))


def _cfg(guided):
    return tfs.SweepConfig(occult_guided=guided, **KNOBS)


def _assert_agree(got, want):
    ev, st, cm, lp, tr = [np.asarray(a) for a in got]
    ev_w, st_w, cm_w, lp_w, tr_w = [np.asarray(a) for a in want]
    np.testing.assert_array_equal(ev, ev_w)
    np.testing.assert_array_equal(st, st_w)
    # commute: f32 rank-1 updates, equal up to rounding
    np.testing.assert_allclose(cm, cm_w, rtol=1e-5, atol=1e-6)
    # logp: f32 sums in another order
    np.testing.assert_allclose(lp, lp_w, rtol=1e-5)
    cols = [0] + list(range(2, tr.shape[-1]))
    np.testing.assert_array_equal(tr[..., cols], tr_w[..., cols])
    np.testing.assert_allclose(tr[..., 1], tr_w[..., 1], rtol=1e-5)


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("C", [1, 3])
def test_plain_version_matches_jax_kernel(guided, C):
    d = _chains(C)
    keys = jax.random.split(jax.random.PRNGKey(11 + C), C)
    want = [[] for _ in range(5)]
    tbls = []
    for c, key in enumerate(keys):
        out = jfs.fused_sweep(
            key, *[jnp.asarray(d[f][c]) for f in (
                "events", "state", "commute", "logp", "exp_eta", "psi_w",
                "rate_ir_t")],
            jnp.asarray(d["N"]), jnp.asarray(d["Cstar"]),
            DECAYS[0], DECAYS[1], DECAYS[4], x_decay_se=DECAYS[2],
            x_decay_ei=DECAYS[3], occult_guided=guided, interpret=True,
            **KNOBS,
        )
        for acc, o in zip(want, out):
            acc.append(np.asarray(o))
        tbls.append(_jax_tables(key))
    want = [np.stack(w) for w in want]
    tbl = np.stack([a for a, _ in tbls])
    ttbl = np.stack([b for _, b in tbls])
    got = tfs.fused_sweep(*_port_args(d, tbl, ttbl), _cfg(guided))
    _assert_agree(got, want)
    # the JAX kernel reads only the first 2 * mmax day lanes: so does the
    # port, and the narrow table gives the same sweep
    got_narrow = tfs.fused_sweep(
        *_port_args(d, tbl, ttbl[..., :2 * KNOBS["mmax"]]), _cfg(guided))
    for a, b in zip(got_narrow, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(want[4][:, :, 0].sum()) > 0 or C == 1


def test_wrapper_checks():
    d = _chains(1)
    tbl, ttbl = _jax_tables(jax.random.PRNGKey(0))
    args = _port_args(d, tbl[None], ttbl[None])
    with pytest.raises(ValueError, match="num_updates"):
        # the JAX kernel quietly returns logp 0.0 here
        tfs.fused_sweep(*args, _cfg(False)._replace(num_updates=0))
    with pytest.raises(ValueError, match="tbl"):
        tfs.fused_sweep(args[0][:, :, :10], *args[1:], _cfg(False))
    with pytest.raises(ValueError, match="decays"):
        tfs.fused_sweep(*args[:-1], args[-1][:, :3], _cfg(False))
    with pytest.raises(ValueError, match="device"):
        tfs.fused_sweep(*[a.to("meta") for a in args], _cfg(False))
    before = tfs.fused_sweep.launches
    tfs.fused_sweep(*args, _cfg(False))
    assert tfs.fused_sweep.launches == before  # CPU: the plain version


def test_kernel_reads_callers_layouts():
    """The CUDA kernel takes the caller's float32 events and state without a
    copy, cell-major or as the plane-major view the wrapper returns; a
    tensor off 16-byte alignment (float4 loads) or of another type is
    copied.  M < mmax (too few locations for a move's distinct slots)
    raises."""
    x = torch.arange(2 * 3 * 4 * 3, dtype=torch.float32).reshape(2, 3, 4, 3)
    t, cell_major = tfs._kernel_layout(x)
    assert cell_major == 1 and t.data_ptr() == x.data_ptr()
    planes = x.permute(0, 3, 1, 2).contiguous()
    t, cell_major = tfs._kernel_layout(planes.permute(0, 2, 3, 1))
    assert cell_major == 0 and t.data_ptr() == planes.data_ptr()
    off = torch.zeros(x.numel() + 1)[1:].view(x.shape)
    off.copy_(x)
    t, cell_major = tfs._kernel_layout(off)
    assert cell_major == 1 and t.data_ptr() % 16 == 0 and torch.equal(t, x)
    t, _ = tfs._kernel_layout(x.double())
    assert t.dtype == torch.float32 and torch.equal(t, x)
    few = torch.zeros((1, 3, T, 3))
    with pytest.raises(ValueError, match="M >= mmax"):
        tfs.fused_sweep(None, None, few, *[None] * 9,
                        _cfg(False)._replace(mmax=4))


def test_plain_version_matches_jax_kernel_full_width():
    """At the main path's shapes (M=380, T=120, U=5, bench knobs, guided
    occults) on the synthetic full-UK model, one chain."""
    from covid19uk_tpu.inference.likelihood import make_context
    from covid19uk_tpu.models.spec import (
        constrain_parameters, unpack_parameters)
    from covid19uk_tpu.utils.synthetic import (
        build_synthetic_model, initial_chain_state)

    Mf, Tf, Uf = 380, 120, 5
    model = build_synthetic_model(Mf, Tf, jnp.float32)
    st = initial_chain_state(model)
    ctx = make_context(model, unpack_parameters(constrain_parameters(st.u),
                                                Tf, Mf))
    full = jseir.compute_state(model.initial_state, st.events)
    cm = model.commute_pressure(full[..., 2])
    knobs = dict(mmax=2, nmax=25, dmax=84, occult_nmax=15,
                 t_range=(Tf - 21, Tf), num_updates=Uf, occult_guided=True)
    key = jax.random.PRNGKey(1)
    want = jfs.fused_sweep(key, st.events, full, cm, jnp.float32(-2e4),
                           ctx.exp_eta, ctx.psi_w, ctx.rate_ir_t, ctx.N,
                           ctx.Cstar, 0.9, 0.9, 0.9, interpret=True, **knobs)
    k_tbl, k_ttbl = jax.random.split(key)
    tbl = jax.random.uniform(k_tbl, (Uf, jfs._Offsets(Mf, 2).width),
                             jnp.float32)
    ttbl = jax.random.uniform(k_ttbl, (Uf, Tf, 128), jnp.float32)
    b = lambda a: torch.tensor(np.asarray(a))[None]  # noqa: E731
    got = tfs.fused_sweep(
        b(tbl), b(ttbl), b(st.events), b(full), b(cm),
        torch.tensor([-2e4]), b(ctx.exp_eta), b(ctx.psi_w),
        b(ctx.rate_ir_t), torch.tensor(np.asarray(ctx.N)),
        torch.tensor(np.asarray(ctx.Cstar)), torch.full((1, 5), 0.9),
        tfs.SweepConfig(**knobs))
    _assert_agree(got, [np.asarray(w)[None] for w in want])
