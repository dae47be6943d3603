"""The port's CUDA kernels against their plain PyTorch versions on a card.

Imports neither JAX nor the JAX package, so that it runs on a machine
with a card and no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_cuda.py

Without a card the test skips (the CUDA kernel has no CPU mode).
"""

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
