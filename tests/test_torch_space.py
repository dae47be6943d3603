"""Port parity for the space axis's pieces, in one process: the band
partials of the reduced likelihood and K2's band products against the
whole and against the JAX package (its Pallas kernel in interpret mode),
the replicated fallback of an operator whose block rows do not split, and
the location sharding of a chain state.  The collectives themselves run
in ``tests/test_torch_space_driver.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covid19uk_tpu.models import seir as jseir
from covid19uk_tpu.models import spec as jspec
from covid19uk_tpu.ops.pallas.block_sparse import BlockSparse as JBlockSparse
from covid19uk_tpu.utils import synthetic as jsyn
from covid19uk_tpu_torch import convert
from covid19uk_tpu_torch.inference.gibbs import ChainState
from covid19uk_tpu_torch.models import seir as tseir
from covid19uk_tpu_torch.models import spec as tspec
from covid19uk_tpu_torch.ops import block_sparse as tbs
from covid19uk_tpu_torch.parallel.sharding import (
    SpaceBand,
    location_band,
    shard_chain_state,
)
from tests.test_torch_block_sparse import _gravity_cstar


class _Mesh:
    """The parts of a (chain, space) DeviceMesh that sharding reads, at one
    rank of it, with no process group."""

    mesh_dim_names = ("chain", "space")

    def __init__(self, chain, space, chain_rank, space_rank):
        self.shape = (chain, space)
        self._ranks = {"chain": chain_rank, "space": space_rank}

    def get_local_rank(self, name):
        return self._ranks[name]

    def get_group(self, name):
        return None


def test_band_partials_of_the_reduced_loglik_sum_to_the_whole_and_jax():
    """Two bands of M=4 locations, T=25, float64: the partial values and
    gradients summed equal the port's whole reduced likelihood and JAX's
    ``reduced_loglik_fn`` (rtol 1e-10)."""
    M, T = 4, 25
    jm = jsyn.build_synthetic_model(M, T, jnp.float64)
    st = jsyn.initial_chain_state(jm)
    u = np.asarray(st.u) + np.random.default_rng(3).normal(
        0, 0.05, st.u.shape)
    events = np.asarray(st.events)
    tm = convert.model(jm, "cpu")
    ev = torch.tensor(events)[None]
    state = tseir.compute_state(tm.initial_state, ev)
    commute = tm.commute_pressure(state[..., 2])

    def vg(loglik, x):
        x = torch.tensor(x[None], requires_grad=True)
        v = loglik(tspec.unpack_parameters(tspec.constrain_parameters(x),
                                           T, M))
        (g,) = torch.autograd.grad(v.sum(), x)
        return v.detach().numpy()[0], g.numpy()[0]

    whole_v, whole_g = vg(tm.reduced_loglik_fn(ev, state, commute), u)
    parts = []
    for r in range(2):
        rows = location_band(M, 2, r)
        parts.append(vg(tm.reduced_loglik_fn(
            ev[:, rows].contiguous(), state[:, rows].contiguous(),
            commute[:, rows].contiguous(), rows), u))
    band_v = parts[0][0] + parts[1][0]
    band_g = parts[0][1] + parts[1][1]
    np.testing.assert_allclose(band_v, whole_v, rtol=1e-10)
    np.testing.assert_allclose(band_g, whole_g, rtol=1e-10, atol=1e-10)

    jstate = jseir.compute_state(jm.initial_state, jnp.asarray(events))
    jloglik = jm.reduced_loglik_fn(
        jnp.asarray(events), jstate, jm.commute_pressure(jstate[..., 2]))

    def jfn(x):
        return jloglik(jspec.unpack_parameters(
            jspec.constrain_parameters(x), T, M))

    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(u))
    np.testing.assert_allclose(band_v, float(jv), rtol=1e-10)
    np.testing.assert_allclose(band_g, np.asarray(jg), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(jg)).max())
    # not vacuous: each band carries its own share
    assert all(abs(p[0]) > 1e-3 * abs(whole_v) for p in parts)


@pytest.mark.parametrize("space", [1, 2])
def test_k2_band_outputs_sum_to_the_whole_and_jax(space):
    """M=256 (two block rows), T=25, float64: the plain band products of
    the ranks, each zero outside its band's rows, sum bitwise to the
    port's whole product and to JAX's product (interpret mode) within
    1e-12 of ``|A| @ |x|``."""
    M, T = 256, 25
    cstar = _gravity_cstar(M)
    op = tbs.BlockSparse.from_dense(cstar, torch.float64, device="cpu")
    assert op.col_idx.shape[0] == 2
    x = np.random.default_rng(1).normal(size=(2, M, T))
    xt = torch.tensor(x)
    bands = [op.row_band(r, space) for r in range(space)]
    before = tbs.bsr_band_matmul.calls
    outs = [b.matmul(xt) for b in bands]
    assert tbs.bsr_band_matmul.calls == before + space
    assert [(b.r0, b.r1) for b in bands] == [
        (r * 2 // space, (r + 1) * 2 // space) for r in range(space)]
    total = sum(outs)
    assert torch.equal(total, op.matmul(xt))
    for b, y in zip(bands, outs):  # each writes its band's rows only
        mine = op.perm[b.r0 * tbs.BLOCK:min(b.r1 * tbs.BLOCK, M)]
        others = torch.ones(M, dtype=torch.bool)
        others[mine] = False
        assert not y[:, others].any() and y[:, mine].any()
    jb = JBlockSparse.from_dense(cstar, jnp.float64)
    want = np.stack([np.asarray(jb.matmul(jnp.asarray(xi))) for xi in x])
    scale = np.einsum("ij,sjt->sit", np.abs(cstar), np.abs(x)) + 1e-300
    assert np.max(np.abs(total.numpy() - want) / scale) <= 1e-12


def test_block_rows_that_do_not_split_stay_replicated():
    """The JAX driver's shard_bsr keeps an operator whole when its block
    rows do not divide the space axis: R=3 over 2 ranks has no band (the
    commute then runs the whole operator on every rank), R=3 over 3 has."""
    op = tbs.BlockSparse.from_dense(_gravity_cstar(300), torch.float64,
                                    device="cpu")
    assert op.col_idx.shape[0] == 3
    for r in range(2):
        assert SpaceBand(_Mesh(1, 2, 0, r), 300).bsr_band(op) is None
    with pytest.raises(ValueError):
        op.row_band(0, 2)
    bands = [SpaceBand(_Mesh(1, 3, 0, r), 300).bsr_band(op)
             for r in range(3)]
    assert [(b.r0, b.r1) for b in bands] == [(0, 1), (1, 2), (2, 3)]
    assert sorted(int(i) for b in bands for i in b.order) == [0, 1, 2]


def test_shard_chain_state_over_chain_and_space_round_trips():
    """A 2 x 2 mesh: each rank's rows of chains and band of locations
    (contiguous), joined over both axes, give the state back; a location
    count that the space axis does not divide raises."""
    rng = np.random.default_rng(0)
    state = ChainState(u=torch.tensor(rng.normal(size=(4, 9))),
                       events=torch.tensor(rng.normal(size=(4, 6, 5, 3))))
    rows = []
    for c in range(2):
        bands = []
        for s in range(2):
            part = shard_chain_state(state, _Mesh(2, 2, c, s), True)
            assert part.events.shape == (2, 3, 5, 3)
            assert part.events.is_contiguous()
            assert torch.equal(part.u, state.u[2 * c:2 * c + 2])
            bands.append(part.events)
        rows.append(torch.cat(bands, dim=1))
    assert torch.equal(torch.cat(rows), state.events)
    plain = shard_chain_state(state, _Mesh(2, 2, 1, 1))
    assert torch.equal(plain.events, state.events[2:])
    with pytest.raises(ValueError, match="multiple of space_devices"):
        shard_chain_state(state, _Mesh(1, 4, 0, 0), True)
