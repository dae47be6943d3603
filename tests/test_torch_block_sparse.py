"""Port parity for the MSOA-scale operators: the block-sparse commute
(K2's plain version and its wrapper), the banded CAR prior, the sparse
model, and the sparse log-determinant, against the JAX package on the CPU
(its Pallas kernel in interpret mode).

Tolerances: block-ELL packing exact; float32 products within 1e-5 of
``|A| @ |x|`` elementwise (sums in another order; the rows of ``Cstar``
sum to about zero, so ``A x`` itself cancels); float64 operators and
densities rtol 1e-10; the float32 sparse model against the float32 dense
model as the JAX package's own test holds them (value rtol 2e-5, gradient
rtol 2e-3 and atol 1e-3: the dense and block-sparse products round
differently).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covid19uk_tpu.models import spec as jspec
from covid19uk_tpu.ops.banded import BandedSym as JBanded
from covid19uk_tpu.ops.pallas.block_sparse import BlockSparse as JBlockSparse
from covid19uk_tpu.utils import synthetic as jsyn
from covid19uk_tpu_torch import convert
from covid19uk_tpu_torch.models import spec as tspec
from covid19uk_tpu_torch.ops import block_sparse as tbs
from covid19uk_tpu_torch.ops.banded import BandedSym
from covid19uk_tpu_torch.utils import synthetic as tsyn


def _gravity_cstar(M, radius_frac=0.12, seed=0):
    """Cstar of the synthetic gravity model (as ModelData.create forms it)."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 1, size=(M, 2))
    N = np.clip(np.exp(rng.normal(np.log(1.5e5), 0.5, size=M)), 5e4, 1.2e6)
    C = tsyn.gravity_flows(rng, N, coords, radius_frac=radius_frac)
    C = C.astype(np.float64)
    np.fill_diagonal(C, 0.0)
    cstar = C + C.T
    np.fill_diagonal(cstar, -C.sum(axis=0))
    return cstar


def _random_symmetric_sparse(rng, M, n_entries=60):
    a = np.zeros((M, M))
    idx = rng.integers(0, M, size=(n_entries, 2))
    for (i, j), v in zip(idx, rng.normal(size=n_entries)):
        a[i, j] = a[j, i] = v
    return a + np.diag(rng.normal(size=M))


def _banded_test_matrix(M=300):
    """tests/test_block_sparse.py's CAR-like matrix, scrambled."""
    a = np.zeros((M, M))
    for i in range(M):
        for j in (i - 2, i - 1, i + 1, i + 2):
            if 0 <= j < M and abs(i * 7919 % 13) > 3:
                a[i, j] = a[j, i] = -0.25
    a[np.arange(M), np.arange(M)] = 4.0
    p = np.random.default_rng(0).permutation(M)
    return a[np.ix_(p, p)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_from_dense_matches_jax_exactly(dtype):
    cstar = _gravity_cstar(300).astype(dtype)
    jb = JBlockSparse.from_dense(cstar, jnp.dtype(dtype))
    tb = tbs.BlockSparse.from_dense(cstar, getattr(torch, dtype),
                                    device="cpu")
    np.testing.assert_array_equal(tb.values.numpy(), np.asarray(jb.values))
    np.testing.assert_array_equal(tb.col_idx.numpy(), np.asarray(jb.col_idx))
    np.testing.assert_array_equal(tb.perm.numpy(), np.asarray(jb.perm))
    np.testing.assert_array_equal(tb.inv_perm.numpy(),
                                  np.asarray(jb.inv_perm))
    assert tb.block_density == jb.block_density
    np.testing.assert_array_equal(tb.todense(), cstar)


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_bsr_matmul_matches_jax(lead):
    """[M, T], [S, M, T] and [L, S, M, T] (vmapped in JAX, folded into one
    product in the port)."""
    M, T = 300, 24
    cstar = _gravity_cstar(M).astype(np.float32)
    jb = JBlockSparse.from_dense(cstar, jnp.float32)
    tb = tbs.BlockSparse.from_dense(cstar, torch.float32, device="cpu")
    x = np.random.default_rng(1).normal(size=lead + (M, T)).astype(
        np.float32)
    f = jb.matmul
    for _ in lead:
        f = jax.vmap(f)
    want = np.asarray(f(jnp.asarray(x)))
    got = tb.matmul(torch.tensor(x)).numpy()
    # rows of Cstar sum to ~0 (diag = -colsum), so A x cancels: the error
    # is held relative to |A| @ |x|, elementwise
    scale = np.einsum("ij,...jt->...it", np.abs(cstar), np.abs(x)) + 1e-30
    assert np.max(np.abs(got - want) / scale) <= 1e-5
    exact = np.einsum("ij,...jt->...it", cstar.astype(np.float64), x)
    assert np.max(np.abs(got - exact) / scale) <= 1e-5


def test_bsr_matmul_gradcheck():
    """Autograd through the wrapper in float64: backward is the same
    product on the cotangent (A symmetric)."""
    rng = np.random.default_rng(2)
    a = _random_symmetric_sparse(rng, 140, n_entries=50)
    tb = tbs.BlockSparse.from_dense(a, torch.float64, device="cpu")
    x = torch.tensor(rng.normal(size=(2, 140, 3)), requires_grad=True)
    assert torch.autograd.gradcheck(tb.matmul, (x,))
    y = torch.tensor(rng.normal(size=(140, 3)), requires_grad=True)
    (g,) = torch.autograd.grad(torch.tanh(tb.matmul(y)).sum(), y)
    yd = y.detach().requires_grad_(True)
    (gd,) = torch.autograd.grad(
        torch.tanh(torch.tensor(a) @ yd).sum(), yd)
    torch.testing.assert_close(g, gd, rtol=1e-10, atol=1e-12)


def test_wrapper_counts_no_launch_on_the_cpu():
    tb = tbs.BlockSparse.from_dense(_gravity_cstar(200), torch.float32,
                                    device="cpu")
    before = tbs.bsr_matmul.launches
    tb.matmul(torch.ones(200, 5))
    assert tbs.bsr_matmul.launches == before
    with pytest.raises(ValueError):
        tbs._launch(tb.values, tb.col_idx.long(), torch.zeros(1, 200, 5),
                    tb.perm32, tb.slots, tb.order)


def test_derived_fields_match_between_builds():
    """The kernel's fields derived in the constructor (slots to visit,
    rows longest first, int32 perm) agree between from_dense and the
    operator carried over from the JAX package, and follow from the
    packing: every slot past a row's count is a zero block, the slot
    before it is not, and the rows run longest first, ties in row order.
    One block row zeroed: its count is 0."""
    cstar = _gravity_cstar(700, radius_frac=0.05).astype(np.float32)
    jb = JBlockSparse.from_dense(cstar, jnp.float32)
    tb = tbs.BlockSparse.from_dense(cstar, torch.float32, device="cpu")
    data = types.SimpleNamespace(
        **{f: np.zeros(1) for f in tspec.ModelData._fields[:8]},
        Cstar_bsr=jb, car_band=None)
    cb = convert.model_data(data, "cpu").Cstar_bsr
    for f in ("slots", "order", "perm32"):
        got, want = getattr(cb, f), getattr(tb, f)
        assert got.dtype == want.dtype == torch.int32, f
        assert torch.equal(got, want), f
    assert torch.equal(tb.perm32, tb.perm.int())
    vals, slots = tb.values.numpy(), tb.slots.numpy()
    R, K = tb.col_idx.shape
    held = np.abs(vals).reshape(R, K, -1).max(2) > 0
    for i in range(R):
        assert not held[i, slots[i]:].any()
        assert slots[i] == 0 or held[i, slots[i] - 1]
    assert len(set(slots)) > 1, "every row has the same slot count"
    order = tb.order.numpy()
    assert sorted(order) == list(range(R))
    assert all((-slots[a], a) < (-slots[b], b)
               for a, b in zip(order, order[1:]))
    zeroed = tbs.BlockSparse(tb.values.clone(), tb.col_idx, tb.n, tb.perm,
                             tb.inv_perm)
    zeroed.values[1] = 0.0
    zeroed = tbs.BlockSparse(zeroed.values, tb.col_idx, tb.n, tb.perm,
                             tb.inv_perm)
    assert int(zeroed.slots[1]) == 0 and int(zeroed.order[-1]) == 1
    ident = tbs.BlockSparse(tb.values, tb.col_idx, tb.n)
    assert torch.equal(ident.perm32, torch.arange(tb.n, dtype=torch.int32))


def test_auto_gates_match_jax():
    """The three "auto" gates (M < 1024, several chains, block density >
    0.3), and True forcing the operator, as the JAX package decides."""
    rng = np.random.default_rng(42)
    sparse = _random_symmetric_sparse(rng, 1536, n_entries=400)
    dense = rng.normal(size=(1024, 1024))
    dense = dense + dense.T
    small = _random_symmetric_sparse(rng, 300)
    cases = [
        (sparse, "auto", 1), (sparse, "auto", 4), (sparse, True, 4),
        (dense, "auto", 1), (dense, True, 1), (small, "auto", 1),
        (small, True, 1), (small, False, 1),
    ]
    for a, mode, chains in cases:
        j = jspec._maybe_block_sparse(a, jnp.float32, mode, chains)
        t = tspec._maybe_block_sparse(a, torch.float32, mode, chains, "cpu")
        assert (j is None) == (t is None), (a.shape, mode, chains)
        jb = jspec._maybe_banded(a, jnp.float32, mode)
        tb = tspec._maybe_banded(a, torch.float32, mode, "cpu")
        assert (jb is None) == (tb is None), (a.shape, mode)
    assert tspec._maybe_block_sparse(sparse, torch.float32, "auto", 1,
                                      "cpu") is not None
    assert tspec._maybe_block_sparse(dense, torch.float32, "auto", 1,
                                      "cpu") is None


def test_banded_matches_jax_and_dense():
    M = 300
    a = _banded_test_matrix(M)
    jb = JBanded.from_dense(a, jnp.float64)
    tb = BandedSym.from_dense(a, torch.float64, device="cpu")
    np.testing.assert_array_equal(tb.diag.numpy(), np.asarray(jb.diag))
    np.testing.assert_array_equal(tb.upper.numpy(), np.asarray(jb.upper))
    np.testing.assert_array_equal(tb.perm.numpy(), np.asarray(jb.perm))
    np.testing.assert_allclose(tb.todense(), a, atol=1e-12)

    rng = np.random.default_rng(3)
    xb = rng.normal(size=(4, M))
    x = torch.tensor(xb, requires_grad=True)
    q = tb.quad(x)
    want_q = np.asarray(jax.vmap(jb.quad)(jnp.asarray(xb)))
    np.testing.assert_allclose(q.detach().numpy(), want_q, rtol=1e-10)
    np.testing.assert_allclose(q.detach().numpy(),
                               np.einsum("ci,ij,cj->c", xb, a, xb),
                               rtol=1e-10)
    (g,) = torch.autograd.grad(0.5 * q.sum(), x)
    want_g = np.asarray(jax.vmap(jax.grad(lambda v: 0.5 * jb.quad(v)))(
        jnp.asarray(xb)))
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(g.numpy(), xb @ a, rtol=1e-9, atol=1e-12)
    mv = tb.matvec(torch.tensor(xb))
    np.testing.assert_allclose(mv.numpy(), np.asarray(
        jax.vmap(jb.matvec)(jnp.asarray(xb))), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(mv.numpy(), xb @ a, rtol=1e-10, atol=1e-12)
    (gm,) = torch.autograd.grad(torch.sin(tb.matvec(x)).sum(), x)
    xd = x.detach().requires_grad_(True)
    (gd,) = torch.autograd.grad(torch.sin(xd @ torch.tensor(a)).sum(), xd)
    np.testing.assert_allclose(gm.numpy(), gd.numpy(), rtol=1e-10,
                               atol=1e-12)


def test_sparse_model_matches_dense_model():
    """The port's model with both sparse operators == its dense model
    (tests/test_block_sparse.py's check, in the port)."""
    M, T = 150, 12
    dense = tsyn.build_synthetic_model(M, T, torch.float32, sparse=False,
                                       device="cpu")
    sparse = tsyn.build_synthetic_model(M, T, torch.float32, sparse=True,
                                        device="cpu")
    assert sparse.data.Cstar_bsr is not None
    assert sparse.data.car_band is not None
    assert sparse.data.car_precision.shape == (0, 0)
    state = tsyn.initial_chain_state(dense, torch.Generator().manual_seed(0))

    def value_and_grad(model):
        u = state.u.clone().requires_grad_(True)
        lp = model.joint_log_prob_unconstrained(u, state.events)
        (g,) = torch.autograd.grad(lp, u)
        return float(lp.detach()), g.numpy()

    v_d, g_d = value_and_grad(dense)
    v_s, g_s = value_and_grad(sparse)
    np.testing.assert_allclose(v_s, v_d, rtol=2e-5)
    np.testing.assert_allclose(g_s, g_d, rtol=2e-3, atol=1e-3)


def test_sparse_model_matches_jax():
    """Port and JAX package at sparse=True in float64: density and
    gradient, and the commute through the block-sparse operator."""
    M, T = 150, 12
    jm = jsyn.build_synthetic_model(M, T, jnp.float64, sparse=True)
    assert jm.data.Cstar_bsr is not None and jm.data.car_band is not None
    tm = convert.model(jm, "cpu")
    assert tm.data.Cstar_bsr is not None and tm.data.car_band is not None
    st = jsyn.initial_chain_state(jm)
    u, ev = np.asarray(st.u), np.asarray(st.events)
    lp_j, g_j = jax.value_and_grad(jm.joint_log_prob_unconstrained)(
        jnp.asarray(u), jnp.asarray(ev))
    ut = torch.tensor(u, requires_grad=True)
    lp_t = tm.joint_log_prob_unconstrained(ut, torch.tensor(ev))
    (g_t,) = torch.autograd.grad(lp_t, ut)
    np.testing.assert_allclose(float(lp_t.detach()), float(lp_j),
                               rtol=1e-10)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-10,
                               atol=1e-10)
    from covid19uk_tpu.models import seir as jseir

    I = np.asarray(jseir.compute_state(jm.initial_state, ev))[..., 2]
    np.testing.assert_allclose(
        tm.commute_pressure(torch.tensor(I)).numpy(),
        np.asarray(jm.commute_pressure(jnp.asarray(I))), rtol=1e-10,
        atol=1e-14)


def test_sparse_car_log_det_matches_jax():
    """The sparse-LU branch (M > 2048) against the JAX package's."""
    M = 2100
    coords = np.random.default_rng(5).uniform(0, 1, size=(M, 2))
    adj = tsyn.knn_adjacency(coords)
    prec = -0.25 * adj.astype(np.float64)
    prec[np.arange(M), np.arange(M)] += adj.sum(axis=1)
    got = tspec._car_log_det(prec)
    np.testing.assert_allclose(got, jspec._car_log_det(prec), rtol=1e-10)
    small = prec[:300, :300]
    np.testing.assert_allclose(tspec._car_log_det(small),
                               np.linalg.slogdet(small)[1], rtol=1e-10)
