"""Port parity for the unfused event sweep's pieces: the windowed
likelihood deltas and the proposal samplers against the JAX package, and
the exact invariance of the batched move, occult and pair kernels.

Tolerances: windowed deltas and commute updates in float64 at rtol 1e-10
(atol 1e-9 for deltas that cancel to ~0: they are differences of sums of
~1e5-sized terms); sampler draws exact and their log-masses at rtol 1e-5
(float32 arithmetic, as the JAX samplers do it; the two libraries' float32
``pow`` differ by an ulp); windowed against full
re-evaluation rtol 1e-9; invariance as total variation < 0.03 between the
target and the occupancy of 200k chains drawn from it and moved by the
kernel (the sampling noise alone is ~0.01 at that count).
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covid19uk_tpu.inference import event_kernels as jek
from covid19uk_tpu.inference import likelihood as jlik
from covid19uk_tpu.models import spec as jspec
from covid19uk_tpu.utils import synthetic as jsyn
from covid19uk_tpu_torch import convert
from covid19uk_tpu_torch.inference import event_kernels as tek
from covid19uk_tpu_torch.inference import likelihood as tlik
from covid19uk_tpu_torch.models import seir as tseir
from covid19uk_tpu_torch.models import spec as tspec
from covid19uk_tpu_torch.utils import synthetic as tsyn

M, T, C = 24, 20, 3


@functools.cache
def _setup(sparse):
    """The same chains in both packages: a synthetic model, per-chain
    parameters and events, state, commute and likelihood contexts (the
    JAX context batched over chains, its shared operators unbatched)."""
    jm = jsyn.build_synthetic_model(M, T, jnp.float64, sparse=sparse)
    tm = convert.model(jm, "cpu")
    assert (tm.data.Cstar_bsr is not None) == sparse
    u0 = tspec.unconstrain_parameters(tspec.pack_parameters(
        tsyn.initial_parameters(tm))).numpy()
    rng = np.random.default_rng(0)
    u = u0[None] + np.concatenate(
        [rng.normal(0, 0.05, (C, 6)), np.zeros((C, u0.shape[0] - 6))], 1)
    tparams = tspec.unpack_parameters(
        tspec.constrain_parameters(torch.tensor(u)), T, M)
    events = tm.sample_seir(torch.Generator().manual_seed(0), tparams)
    state = tseir.compute_state(tm.initial_state, events)
    jctx = jax.jit(jax.vmap(
        lambda m, v: jlik.make_context(m, jspec.unpack_parameters(
            jspec.constrain_parameters(v), T, M)),
        in_axes=(None, 0), out_axes=_CTX_AXES))(jm, jnp.asarray(u))
    return dict(
        jm=jm, tm=tm, events=events, state=state, jctx=jctx,
        tctx=tlik.make_context(tm, tparams), tparams=tparams,
        tcm=tm.commute_pressure(state[..., 2]),
    )


# chain-batched fields of the JAX LikelihoodContext
_CTX_AXES = jlik.LikelihoodContext(0, 0, 0, None, None, None, None)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


# (loc, t_from, t_to, x) per chain: a window against T (clamped start),
# one at 0, one inside
MOVE = ([3, 10, 23], [19, 0, 9], [17, 4, 6], [1.0, 2.0, 1.0])
# L = 2 joint moves per chain, overlapping and disjoint windows
JOINT = ([[0, 3], [5, 9], [1, 2]], [[4, 5], [3, 17], [18, 10]],
         [[8, 2], [6, 19], [15, 12]], [[2.0, 1.0], [1.0, 3.0], [1.0, 1.0]])
OCCULTS = ([2, 11, 20], [14, 19, 16], [2.0, -1.0, 3.0])
OCC_W = 8  # t_range = (T - 8, T)


def _port_deltas(ctx, ev, st, cm):
    """Every windowed delta of the test cases, from the port."""
    out = []
    twe = tlik.WindowedEvaluator(ctx, 6)
    for k in (0, 1):
        out.append(twe.move_delta(ev, st, *map(_t, MOVE), k, commute=cm))
    for W in (6, 12):  # L*W < T (windowed joint) and >= T (full-T joint)
        twe = tlik.WindowedEvaluator(ctx, W)
        for k in (0, 1):
            out.append(twe.joint_move_delta(ev, st, *map(_t, JOINT), k,
                                            commute=cm))
    twe = tlik.WindowedEvaluator(ctx, OCC_W)
    for k in (0, 1):
        out.append(twe.occult_delta(ev, st, *map(_t, OCCULTS), k,
                                    commute=cm))
    return torch.stack(out)


@jax.jit
def _jax_deltas(ctx, ev, st, cm):
    """The same deltas from the JAX package, vmapped over chains (``cm``
    None: unthreaded)."""

    def one(ctx, ev, st, cm, *case):
        mv, jt, oc = case[:4], case[4:8], case[8:]
        out = []
        we = jlik.WindowedEvaluator(ctx, 6)
        for k in (0, 1):
            out.append(we.move_delta(ev, st, *mv, k, commute=cm))
        for W in (6, 12):
            we = jlik.WindowedEvaluator(ctx, W)
            for k in (0, 1):
                out.append(we.joint_move_delta(ev, st, *jt, k, commute=cm))
        we = jlik.WindowedEvaluator(ctx, OCC_W)
        for k in (0, 1):
            out.append(we.occult_delta(ev, st, *oc, k, commute=cm))
        return jnp.stack(out)

    case = [jnp.asarray(a) for a in MOVE + JOINT + OCCULTS]
    return jax.vmap(one, in_axes=(_CTX_AXES, 0, 0, 0) + (0,) * len(case),
                    out_axes=1)(ctx, ev, st, cm, *case)


@pytest.mark.parametrize("sparse,threaded", [(False, False), (True, False),
                                             (False, True)],
                         ids=["dense", "bsr", "threaded"])
def test_windowed_deltas_match_jax(sparse, threaded):
    """move_delta (k = 0, 1), joint_move_delta on both of its branches and
    occult_delta against JAX: recomputing the commute densely or through
    the block-sparse operator, or slicing a threaded one (which never
    reads the operator)."""
    chains = _setup(sparse)
    ev, st = chains["events"], chains["state"]
    tcm = chains["tcm"] if threaded else None
    got = _port_deltas(chains["tctx"], ev, st, tcm)
    want = _jax_deltas(chains["jctx"], jnp.asarray(ev.numpy()),
                       jnp.asarray(st.numpy()),
                       None if tcm is None else jnp.asarray(tcm.numpy()))
    assert bool(torch.isfinite(got).any())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-9)


def test_apply_commute_and_event_deltas_match_jax():
    chains = _setup(False)
    ev, st, cm = chains["events"], chains["state"], chains["tcm"]
    twe = tlik.WindowedEvaluator(chains["tctx"], 6)
    loc, tf, td, x = map(_t, MOVE)
    I = jnp.asarray(st[..., 2].numpy())
    for occult in (False, True):
        got = twe.apply_commute(cm, loc, tf, td, x, 1, occult=occult)
        got_ev, got_st = tlik.apply_event_delta(ev, st, loc, tf, td, x, 1,
                                                occult=occult)
        for c in range(C):
            jc = chains["jctx"]
            jwe = jlik.WindowedEvaluator(jc._replace(
                exp_eta=jc.exp_eta[c], psi_w=jc.psi_w[c],
                rate_ir_t=jc.rate_ir_t[c]), 6)
            args = (int(loc[c]), int(tf[c]), int(td[c]), float(x[c]))
            want = jwe.apply_commute(chains["jm"].commute_pressure(I[c]),
                                     *args, 1, occult=occult)
            np.testing.assert_allclose(got[c].numpy(), np.asarray(want),
                                       rtol=1e-10, atol=1e-12)
            w_ev, w_st = jlik.apply_event_delta(
                jnp.asarray(ev[c].numpy()), jnp.asarray(st[c].numpy()),
                *args, 1, occult=occult)
            np.testing.assert_array_equal(got_ev[c].numpy(), w_ev)
            np.testing.assert_array_equal(got_st[c].numpy(), w_st)
    # the S->E transition leaves the commute as it is
    assert twe.apply_commute(cm, loc, tf, td, x, 0) is cm


def test_windowed_chain_matches_full_reevaluation():
    """Identical draws through the windowed evaluators (commute threaded)
    and through full re-evaluation give identical chains; the threaded
    commute and state stay consistent with the events."""
    chains = _setup(False)
    tm, params = chains["tm"], chains["tparams"]
    ctx = chains["tctx"]
    t_range = (T - 6, T)

    def logp_fn(e):
        return tm.log_prob(params, e)

    def run(windowed):
        gen = torch.Generator().manual_seed(4)
        ev, st = chains["events"], chains["state"]
        cm = chains["tcm"] if windowed else None
        mv = tlik.WindowedEvaluator(ctx, 6) if windowed else \
            tlik.FullEvaluator(logp_fn)
        oc = tlik.WindowedEvaluator(ctx, T - t_range[0]) if windowed else mv
        lp = logp_fn(ev)
        lps, acc = [], []
        for _ in range(20):
            infos = []
            for k in (0, 1):
                ev, st, cm, lp, i = tek.event_move_step(
                    gen, ev, st, lp, mv, k, 5, 2, 10, commute=cm)
                infos.append(i)
            for k in (0, 1):
                ev, st, cm, lp, i = tek.occult_step(
                    gen, ev, st, lp, oc, k, t_range, 5, commute=cm)
                infos.append(i)
            ev, st, cm, lp, i = tek.pair_move_step(gen, ev, st, lp, mv, 5,
                                                   2, 10, commute=cm)
            infos.append(i)
            lps.append(lp)
            acc.append(torch.stack([i.is_accepted for i in infos]))
        return ev, st, cm, torch.stack(lps), torch.stack(acc)

    ev_f, _, _, lps_f, acc_f = run(False)
    ev_w, st_w, cm_w, lps_w, acc_w = run(True)
    assert torch.equal(acc_f, acc_w)
    assert torch.equal(ev_f, ev_w)
    np.testing.assert_allclose(lps_w.numpy(), lps_f.numpy(), rtol=1e-9)
    np.testing.assert_allclose(
        lps_w[-1].numpy(), logp_fn(ev_w).numpy(), rtol=1e-9)
    torch.testing.assert_close(st_w, tseir.compute_state(tm.initial_state,
                                                         ev_w))
    torch.testing.assert_close(cm_w, tm.commute_pressure(st_w[..., 2]),
                               rtol=1e-8, atol=1e-10)
    assert float(acc_f.float().mean((0, 1)).min()) > 0.0


# ---------------------------------------------------------------- samplers


@pytest.mark.parametrize("decay", [0.9, 1.0, 0.3, "tensor-0.85"])
def test_samplers_match_jax(decay):
    """Fed the uniforms JAX draws from the same split keys, the port's
    samplers return JAX's draws and log-masses."""
    if isinstance(decay, str):
        jdec = jnp.asarray(0.85, jnp.float32)
        tdec = torch.tensor(0.85, dtype=torch.float32)
    else:
        jdec = tdec = decay
    rng = np.random.default_rng(1)
    n = 4000
    left = rng.integers(0, 40, n)
    right = rng.integers(0, 40, n)
    cap = rng.integers(0, 30, n).astype(np.float64)
    key = jax.random.PRNGKey(7)
    k_side, k_j = jax.random.split(key)
    d_j, lm_j = jek._sample_two_sided_geometric(
        key, jnp.asarray(left), jnp.asarray(right), jdec)
    d_t, lm_t = tek._sample_two_sided_geometric(
        _t(jax.random.uniform(k_side, (n,))), _t(jax.random.uniform(k_j,
                                                                    (n,))),
        _t(left), _t(right), tdec)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_allclose(lm_t.numpy(), np.asarray(lm_j), rtol=1e-5)
    x_j, lx_j = jek._sample_truncated_geometric(key, jnp.asarray(cap), jdec)
    x_t, lx_t = tek._sample_truncated_geometric(
        _t(jax.random.uniform(key, (n,))), _t(cap), tdec)
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    np.testing.assert_allclose(lx_t.numpy(), np.asarray(lx_j), rtol=1e-5)
    np.testing.assert_allclose(
        tek._log_mass_geometric(_t(cap), tdec).numpy(),
        np.asarray(jek._log_mass_geometric(jnp.asarray(cap), jdec)),
        rtol=1e-5)
    assert int((d_t != 0).sum()) == n  # a displacement is never 0


# ------------------------------------------------------- exact invariance


def _compositions(total, length):
    for cuts in itertools.combinations(range(total + length - 1),
                                       length - 1):
        prev, out = -1, []
        for c in cuts + (total + length - 1,):
            out.append(c - prev - 1)
            prev = c
        yield tuple(out)


def _check_invariance(cells, logp_of_cells, make_events, read_cells, step,
                      n=200_000, steps=3, seed=0):
    """Draws n chains from the exact target over the enumerated ``cells``
    (tuples of counts), applies ``step`` ``steps`` times to all of them at
    once and holds the occupancy against the target."""
    cells = np.asarray(cells, np.int64)
    lp = logp_of_cells(torch.tensor(cells, dtype=torch.float64)).numpy()
    target = np.exp(lp - lp.max())
    target /= target.sum()
    draws = np.random.default_rng(seed).choice(len(cells), size=n,
                                               p=target)
    events = make_events(torch.tensor(cells[draws], dtype=torch.float64))
    gen = torch.Generator().manual_seed(seed + 1)
    moved = torch.zeros(n, dtype=torch.bool)
    for _ in range(steps):
        events, accepted = step(gen, events)
        moved |= accepted
    base = int(cells.max()) + 2
    codes = cells @ base ** np.arange(cells.shape[1])
    order = np.argsort(codes)
    got = read_cells(events).numpy().astype(np.int64) @ base ** np.arange(
        cells.shape[1])
    pos = np.searchsorted(codes[order], got)
    assert np.all(codes[order][np.minimum(pos, len(codes) - 1)] == got), \
        "a chain left the target's support"
    freq = np.bincount(order[pos], minlength=len(cells)) / n
    tv = 0.5 * np.abs(freq - target).sum()
    assert tv < 0.03, tv
    assert float(moved.double().mean()) > 0.05, "the kernel hardly moved"


def _full(logp):
    return tlik.FullEvaluator(logp_fn=logp)


@pytest.mark.parametrize(
    "move_decay,x_decay",
    [(0.9, 1.0), (1.0, 1.0), (0.9, 0.7), ("tensor-0.85", 0.7)])
def test_event_move_exact_invariance(move_decay, x_decay):
    """M=1, T=4, 3 events of type 0: 20 states
    (tests/test_inference.py's target)."""
    if isinstance(move_decay, str):
        move_decay = torch.tensor(0.85, dtype=torch.float64)
    w = torch.tensor([0.2, 1.0, -0.5, 0.7], dtype=torch.float64)

    def lp_cells(c):
        return (c * w).sum(-1) - 0.1 * (c**2).sum(-1)

    def make(c):
        ev = torch.zeros((c.shape[0], 1, 4, 3), dtype=torch.float64)
        ev[:, 0, :, 0] = c
        return ev

    def read(ev):
        return ev[:, 0, :, 0]

    ev_full = _full(lambda e: lp_cells(read(e)))

    def step(gen, ev):
        st = torch.zeros(ev.shape[:-1] + (4,), dtype=ev.dtype)
        ev, _, _, _, info = tek.event_move_step(
            gen, ev, st, lp_cells(read(ev)), ev_full, 0, dmax=3, mmax=1,
            nmax=2, move_decay=move_decay, x_decay=x_decay)
        return ev, info.is_accepted

    _check_invariance(list(_compositions(3, 4)), lp_cells, make, read, step)


@pytest.mark.parametrize("x_decay", [1.0, 0.7])
def test_occult_exact_invariance(x_decay):
    """M=1, T=4, t_range=(2, 4), counts capped at 4: 25 states."""

    def lp_cells(c):
        ok = (c <= 4).all(-1)
        val = 0.8 * c[:, 0] - 0.3 * c[:, 1] - 0.15 * (c[:, 0] - c[:, 1])**2
        return torch.where(ok, val, -torch.inf)

    def make(c):
        ev = torch.zeros((c.shape[0], 1, 4, 3), dtype=torch.float64)
        ev[:, 0, 2:4, 0] = c
        return ev

    def read(ev):
        return ev[:, 0, 2:4, 0]

    ev_full = _full(lambda e: lp_cells(read(e)))

    def step(gen, ev):
        st = torch.zeros(ev.shape[:-1] + (4,), dtype=ev.dtype)
        ev, _, _, _, info = tek.occult_step(
            gen, ev, st, lp_cells(read(ev)), ev_full, 0, t_range=(2, 4),
            nmax=3, x_decay=x_decay)
        return ev, info.is_accepted

    _check_invariance(list(itertools.product(range(5), repeat=2)), lp_cells,
                      make, read, step)


def test_guided_occult_exact_invariance():
    """Location ~ Categorical(0.85, 0.15) over M=2; 4 cells capped at 2:
    81 states."""
    w = torch.tensor([[0.9, -0.4], [-0.6, 0.8]], dtype=torch.float64)

    def lp_cells(c):
        c = c.reshape(-1, 2, 2)
        val = (c * w).sum((1, 2)) - 0.1 * (c**2).sum((1, 2))
        return torch.where((c <= 2).all(-1).all(-1), val, -torch.inf)

    def make(c):
        ev = torch.zeros((c.shape[0], 2, 4, 3), dtype=torch.float64)
        ev[:, :, 2:4, 0] = c.reshape(-1, 2, 2)
        return ev

    def read(ev):
        return ev[:, :, 2:4, 0].reshape(-1, 4)

    ev_full = _full(lambda e: lp_cells(read(e)))
    guide = torch.log(torch.tensor([0.85, 0.15], dtype=torch.float64))

    def step(gen, ev):
        st = torch.zeros(ev.shape[:-1] + (4,), dtype=ev.dtype)
        ev, _, _, _, info = tek.occult_step(
            gen, ev, st, lp_cells(read(ev)), ev_full, 0, t_range=(2, 4),
            nmax=2, x_decay=0.8, guide_logits=guide.expand(ev.shape[0], 2))
        return ev, info.is_accepted

    _check_invariance(list(itertools.product(range(3), repeat=4)), lp_cells,
                      make, read, step)


def test_guided_move_exact_invariance():
    """Locations by a fixed 85/15 Gumbel top-k over M=2, per-location
    totals 2 and 1: 40 states."""
    w = torch.tensor([[0.2, 1.0, -0.5, 0.7], [0.9, -0.6, 0.3, -0.2]],
                     dtype=torch.float64)

    def lp_cells(c):
        c = c.reshape(-1, 2, 4)
        return (c * w).sum((1, 2)) - 0.1 * (c**2).sum((1, 2))

    def make(c):
        ev = torch.zeros((c.shape[0], 2, 4, 3), dtype=torch.float64)
        ev[:, :, :, 0] = c.reshape(-1, 2, 4)
        return ev

    def read(ev):
        return ev[:, :, :, 0].reshape(-1, 8)

    ev_full = _full(lambda e: lp_cells(read(e)))
    guide = torch.log(torch.tensor([0.85, 0.15], dtype=torch.float64))

    def step(gen, ev):
        st = torch.zeros(ev.shape[:-1] + (4,), dtype=ev.dtype)
        ev, _, _, _, info = tek.event_move_step(
            gen, ev, st, lp_cells(read(ev)), ev_full, 0, dmax=3, mmax=1,
            nmax=2, move_decay=0.9, x_decay=0.8,
            guide_logits=guide.expand(ev.shape[0], 2))
        return ev, info.is_accepted

    cells = [a + b for a in _compositions(2, 4) for b in _compositions(1, 4)]
    _check_invariance(cells, lp_cells, make, read, step)


@pytest.mark.parametrize("move_decay,x_decay", [(0.9, 0.8), (1.0, 1.0)])
def test_pair_move_exact_invariance(move_decay, x_decay):
    """M=1, T=4, 2 events of each of S->E and E->I: 100 states; the pair
    kernel alone preserves the target."""
    w0 = torch.tensor([0.3, 0.9, -0.4, 0.5], dtype=torch.float64)
    w1 = torch.tensor([-0.2, 0.6, 0.8, -0.3], dtype=torch.float64)

    def lp_cells(c):
        c0, c1 = c[:, :4], c[:, 4:]
        return ((c0 * w0).sum(-1) + (c1 * w1).sum(-1)
                - 0.1 * (c0**2).sum(-1) - 0.12 * (c1**2).sum(-1)
                + 0.05 * (c0 * c1).sum(-1))

    def make(c):
        ev = torch.zeros((c.shape[0], 1, 4, 3), dtype=torch.float64)
        ev[:, 0, :, 0] = c[:, :4]
        ev[:, 0, :, 1] = c[:, 4:]
        return ev

    def read(ev):
        return torch.cat([ev[:, 0, :, 0], ev[:, 0, :, 1]], -1)

    ev_full = _full(lambda e: lp_cells(read(e)))

    def step(gen, ev):
        st = torch.zeros(ev.shape[:-1] + (4,), dtype=ev.dtype)
        ev, _, _, _, info = tek.pair_move_step(
            gen, ev, st, lp_cells(read(ev)), ev_full, dmax=3, mmax=1,
            nmax=2, move_decay=move_decay, x_decay=x_decay)
        return ev, info.is_accepted

    cells = [a + b for a in _compositions(2, 4) for b in _compositions(2, 4)]
    _check_invariance(cells, lp_cells, make, read, step)


def test_compensated_kernels_raise():
    for fn in (tek.compensated_move_step, tek.compensated_pair_move_step):
        with pytest.raises(NotImplementedError):
            fn()
