"""Port parity for the chain-parallel layer (``covid19uk_tpu_torch.parallel``):
the mesh shapes, the single-process no-op of ``initialize``, the sharded
step over two gloo ranks against the one-process batched step on a
replayed ``StepNoise``, pooled adaptation and the gate statistics over
gathered chains against the JAX package, the per-rank seeds and the
two-rank dry run.  Every two-rank case but the dry run comes from one
spawn (``tests/torch_ranks.py``)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covid19uk_tpu.inference import driver as jdriver
from covid19uk_tpu.inference import welford as jwelford
from covid19uk_tpu.parallel import distributed as jdist
from covid19uk_tpu.parallel.diagnostics import gate_statistics as jgate
from covid19uk_tpu.parallel.mesh import chain_mesh, chain_space_mesh
from covid19uk_tpu_torch.inference import driver as tdriver
from covid19uk_tpu_torch.parallel import distributed as tdist
from covid19uk_tpu_torch.parallel.mesh import mesh_shape
from tests import torch_ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    torch_ranks.spawn("parallel", tmp)
    return [dict(np.load(tmp / f"parallel_{r}.npz")) for r in range(2)], [
        json.loads((tmp / f"meshes_{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shapes_match_jax(n):
    assert mesh_shape(n) == dict(chain_space_mesh(n).shape)
    assert {"chain": n} == dict(chain_mesh(n).shape)
    with pytest.raises(ValueError):
        mesh_shape(n, space=3)


def test_device_meshes_over_two_ranks_match_jax(ranks):
    _, meshes = ranks
    for m in meshes:
        assert m["chain"] == dict(chain_mesh(2).shape)
        assert m["chain_space"] == dict(chain_space_mesh(2).shape)


def test_initialize_is_a_noop_single_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.initialize() is False and jdist.initialize() is False
    assert (tdist.world(), tdist.rank(), tdist.is_distributed()) == (
        1, 0, False)


def test_sharded_step_equals_the_batched_step(ranks):
    """Two ranks of 4 chains each on the same StepNoise rows: every output
    of the transition (u, events, every accept decision and trace) is
    bitwise the one-process step's on 8 chains (float64, fused sweep's
    plain version)."""
    outs, _ = ranks
    model, state, tune, noise, step = torch_ranks.step_case()
    want = torch_ranks.leaves(step(state, tune, None, noise))
    assert len(want) == sum(k.startswith("step_") for k in outs[0])
    for out in outs:  # every rank gathered all chains
        for i, w in enumerate(want):
            np.testing.assert_array_equal(out[f"step_{i}"], w.numpy(),
                                          err_msg=f"leaf {i}")
    np.testing.assert_array_equal(outs[0]["rows"], np.arange(4))
    np.testing.assert_array_equal(outs[1]["rows"], np.arange(4, 8))
    # not vacuous: the events moved and HMC accepted somewhere
    assert not torch.equal(want[1], state.events)
    assert bool(want[2].any())


def test_pooled_adaptation_over_gathered_chains_matches_jax(ranks):
    outs, _ = ranks
    case = torch_ranks.stats_case()
    m2 = case["var"] * case["count"][:, None]
    step_j, wf_j = jdriver.pool_adaptation(
        jnp.asarray(case["step_size"]), jwelford.RunningVariance(
            jnp.asarray(case["count"]), jnp.asarray(case["mean"]),
            jnp.asarray(m2)))
    for out in outs:
        np.testing.assert_allclose(out["pool_step_size"], step_j,
                                   rtol=1e-12)
        for name, j in (("count", wf_j.count), ("mean", wf_j.mean),
                        ("m2", wf_j.m2)):
            np.testing.assert_allclose(out[f"pool_{name}"], j, rtol=1e-12,
                                       err_msg=name)
    # and bitwise the port's pooling of the concatenated batch
    from covid19uk_tpu_torch.inference import welford

    step_t, wf_t = tdriver.pool_adaptation(
        torch.as_tensor(case["step_size"]), welford.from_stats(
            torch.as_tensor(case["count"]), torch.as_tensor(case["mean"]),
            torch.as_tensor(case["var"])))
    np.testing.assert_array_equal(outs[1]["pool_step_size"], step_t.numpy())
    np.testing.assert_array_equal(outs[1]["pool_m2"], wf_t.m2.numpy())


def test_gate_statistics_over_gathered_chains_match_jax(ranks):
    outs, _ = ranks
    want = jgate(torch_ranks.stats_case()["draws"])
    for out in outs:
        np.testing.assert_allclose(out["gate"], want, rtol=1e-10)


def test_rank_seeds_are_distinct():
    assert tdriver.rank_seed(7, 0, 1) == 7
    seeds = {tdriver.rank_seed(s, r, 4) for s in range(5) for r in range(4)}
    assert len(seeds) == 20
    assert tdriver.rank_seed(3, 1, 2) == tdriver.rank_seed(3, 1, 4)
    for s in seeds:
        torch.Generator().manual_seed(s)  # a valid 64-bit seed


def test_spawn_dryrun_two_cpu_ranks_agree():
    checksum, out = tdist.spawn_dryrun(2, "cpu", timeout=120)
    assert np.isfinite(checksum)
    assert "ranks=2" in out and "chains=4" in out and "device=cpu" in out
