"""The port's driver over ranks (``use_mesh``) on the NI data, on the CPU:
on one process ``use_mesh`` and ``space_devices`` change nothing (the JAX
driver's rule); over two gloo ranks each rank's chains equal a
one-process run seeded with ``rank_seed``, pooled adaptation, the decays
and the gate agree across ranks, a resumed run equals the uninterrupted
one, and a bad split raises on every rank.  The
two-rank runs come from one spawn (``tests/torch_ranks.py``, scenario
``driver``); the space axis's own runs are in
``tests/test_torch_space_driver.py``."""

import json
import pickle
import shutil

import h5py
import numpy as np
import pytest

from covid19uk_tpu_torch.config import McmcConfig
from covid19uk_tpu_torch.inference import driver as tdriver
from tests import torch_ranks

NI_DATA = torch_ranks.NI_DATA
WARM = 6 + 4 + 4


def _datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_driver")
    torch_ranks.spawn("driver", tmp)
    return tmp


@pytest.mark.parametrize("option", [dict(use_mesh=True),
                                    dict(space_devices=2)])
def test_mesh_options_do_nothing_on_one_process(tmp_path, option):
    """With one rank the JAX driver never enters its mesh branch; the
    port's run takes the plain path and stores the same bits."""
    cfg = torch_ranks.driver_config(use_mesh=False, num_bursts=2)
    tdriver.mcmc(NI_DATA, str(tmp_path / "plain.h5"), cfg, device="cpu")
    tdriver.mcmc(NI_DATA, str(tmp_path / "opt.h5"), dict(cfg, **option),
                 device="cpu")
    _assert_same(_datasets(tmp_path / "plain.h5"),
                 _datasets(tmp_path / "opt.h5"))


def test_each_rank_equals_a_one_process_run(ranks, tmp_path):
    """Without pooling or autotuning the ranks are independent: rank r's
    four chains in rank 0's store are bitwise a one-process run of four
    chains whose generator is seeded with rank_seed(seed, r, 2)."""
    got = _datasets(ranks / "b.h5")
    config = McmcConfig.from_dict(torch_ranks.driver_config(
        pooled_adaptation=False, autotune_acceptance=False, num_chains=4,
        use_mesh=False))
    for r in range(2):
        model, state, ecfg, _, _ = tdriver.prepare(NI_DATA, config, "cpu")
        out = str(tmp_path / f"rank{r}.h5")
        tdriver.run_mcmc(model, state, ecfg, config, out, num_chains=4,
                         seed=tdriver.rank_seed(config.seed, r, 2),
                         device="cpu").close()
        want = _datasets(out)
        for name, x in want.items():
            assert got[name].shape == (WARM + 9, 8) + x.shape[2:], name
            np.testing.assert_array_equal(got[name][:, 4 * r:4 * r + 4], x,
                                          err_msg=name)
    assert not np.array_equal(got["samples/seir"][:, :4],
                              got["samples/seir"][:, 4:])


def test_ranks_agree_on_adaptation_and_the_gate(ranks, tmp_path):
    calls = []
    for r in range(2):
        with open(ranks / f"c_calls_{r}.pkl", "rb") as f:
            calls.append(pickle.load(f))
    a, b = calls
    assert [c[0] for c in a] == [c[0] for c in b]  # same bursts: same stop
    windows = [c for c in a if c[0] == "window"]
    assert len(windows) == 3
    for (kind, ss_a, _, dec_a), (_, ss_b, _, dec_b) in zip(a, b):
        if kind == "window":  # pooled: one value for all 8 chains
            np.testing.assert_array_equal(ss_a, ss_b)
            assert len(set(ss_a.tolist())) == 1
        assert all(np.array_equal(x, y) for x, y in zip(dec_a, dec_b))
    # the slow window starts from the pooled mass, one row for all chains
    # (after it each chain keeps its own, as in the JAX driver)
    mass_a, mass_b = a[1][2], b[1][2]
    np.testing.assert_array_equal(mass_a, mass_b)
    assert (mass_a == mass_a[0]).all()
    assert len({d.item() for c in a for d in c[3]}) > 1  # decays tuned
    bursts = sum(c[0] == "burst" for c in a)
    with open(ranks / "c.jsonl") as f:
        events = [json.loads(line) for line in f]
    gates = [e for e in events if e["event"] == "gate"]
    # the gate stopped every rank at the same burst, before the last
    assert 1 < bursts < 4 and len(gates) == bursts
    assert gates[-1]["converged"] and not gates[0]["converged"]
    # rank 0's store: the one-process layout with a chain axis of 8
    got = _datasets(ranks / "c.h5")
    cfg = torch_ranks.driver_config(use_mesh=False, num_bursts=1,
                                    num_burst_samples=5)
    tdriver.mcmc(NI_DATA, str(tmp_path / "one.h5"), cfg, device="cpu")
    want = _datasets(tmp_path / "one.h5")
    assert got.keys() == want.keys()
    for name, x in want.items():
        assert got[name].dtype == x.dtype, name
        if name.startswith(("samples/", "results/")):
            assert got[name].shape == (WARM + 5 * bursts,) + x.shape[1:]
            assert x.shape[1] == 8
        else:
            assert got[name].shape == x.shape


def test_interrupted_two_rank_run_resumes_bitwise(ranks):
    """The run of the first case, interrupted at its third burst and
    resumed from the checkpoint (every rank's generator, all 8 chains),
    equals it in every dataset; a resume on another number of ranks
    raises."""
    _assert_same(_datasets(ranks / "b.h5"), _datasets(ranks / "d.h5"))
    cfg = torch_ranks.driver_config(
        pooled_adaptation=False, autotune_acceptance=False, use_mesh=False,
        checkpoint=str(ranks / "d.npz"))
    shutil.copy(ranks / "d.h5", ranks / "d1.h5")
    with pytest.raises(ValueError, match="2 ranks"):
        tdriver.mcmc(NI_DATA, str(ranks / "d1.h5"), cfg, device="cpu")


def test_space_axis_and_bad_splits_raise_over_two_ranks(ranks):
    """``space_devices=2`` with the gamma refresh on the NI data's 11
    locations (not a multiple of 2), 3 chains over 2 ranks and a run over
    ranks without ``use_mesh`` raise ``ValueError`` on every rank, each
    for its own split."""
    for r in range(2):
        refused = json.loads((ranks / f"e_{r}.json").read_text())
        assert {k: v[0] for k, v in refused.items()} == {
            "space": "ValueError", "chains": "ValueError",
            "no_mesh": "ValueError"}
        assert "multiple of space_devices=2" in refused["space"][1]
        assert "num_chains=3" in refused["chains"][1]
        assert "use_mesh" in refused["no_mesh"][1]
