"""Block-sparse (block-ELL) matrix times dense matrix: wrapper, launch
counter and plain PyTorch version.

Port of ``covid19uk_tpu/ops/pallas/block_sparse.py``.  At MSOA scale
(M ~ 7000) the commuting coupling ``Cstar @ (I/N)`` is a ``[M, M] @ [M, T]``
product with a mostly-zero ``Cstar``: after a reverse Cuthill-McKee
reordering its nonzeros fall in a few 128 x 128 blocks per block row.
Block-ELL keeps, for each of the ``R`` block rows, ``K`` blocks and their
column-block indices; padded slots are zero blocks at column 0, so they add
exactly zero and need no masks.

:func:`bsr_matmul` launches the CUDA kernel ``csrc/block_sparse.cu`` for
tensors on a CUDA device (counted in ``bsr_matmul.launches``) and runs
:func:`bsr_matmul_reference`, the plain version, for tensors on the CPU.
The matrix is symmetric, so the gradient with respect to ``x`` is the same
product applied to the cotangent; ``values`` and ``col_idx`` are constants.
"""

import numpy as np
import torch

BLOCK = 128  # rows and columns of one block


def _round_up(x, m):
    return -(-x // m) * m


def bsr_matmul_reference(values, col_idx, xp):
    """The plain version: ``values [R, K, B, B]`` gathered by ``col_idx
    [R, K]`` times padded ``xp [S, R*B, Tp]`` -> ``[S, R*B, Tp]``."""
    R, K, B, _ = values.shape
    S, _, Tp = xp.shape
    xb = xp.reshape(S, R, B, Tp)[:, col_idx.long()]  # [S, R, K, B, Tp]
    y = torch.einsum("rkij,srkjt->srit", values, xb)
    return y.reshape(S, R * B, Tp)


def _launch(values, col_idx, xp):
    """The CUDA kernel on padded float32 ``xp [S, R*B, Tp]``."""
    from covid19uk_tpu_torch.ops import _build

    R, K, B, _ = values.shape
    S, rows, Tp = xp.shape
    if values.dtype != torch.float32 or xp.dtype != torch.float32:
        raise ValueError("the block-sparse kernel takes float32 values and x")
    if col_idx.dtype != torch.int32:
        raise ValueError("col_idx must be int32")
    if B != BLOCK or rows != R * B or Tp % 64:
        raise ValueError(f"bad shapes: values {tuple(values.shape)}, "
                         f"x {tuple(xp.shape)}")
    if not (values.is_contiguous() and col_idx.is_contiguous()
            and xp.is_contiguous()):
        raise ValueError("values, col_idx and x must be contiguous")
    devices = {values.device, col_idx.device, xp.device}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    lib = _build.block_sparse_library().lib
    y = torch.empty_like(xp)
    dev = xp.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bsr_matmul_launch(values.data_ptr(), col_idx.data_ptr(),
                                    xp.data_ptr(), y.data_ptr(), R, K, S, Tp,
                                    stream)
    if err != 0:
        raise RuntimeError(
            f"block-sparse kernel launch failed: CUDA error {err} "
            f"({_build.error_string(lib.block_sparse_error_string, err)})")
    bsr_matmul.launches += 1
    return y


def _apply(values, col_idx, x):
    """Pads ``x [..., n, T]`` to ``[S, R*B, round_up(T, 128)]`` (leading
    dims folded into S), applies the operator and crops back."""
    R, K, B, _ = values.shape
    lead, n, t = x.shape[:-2], x.shape[-2], x.shape[-1]
    tp = _round_up(max(t, 1), BLOCK)
    S = int(np.prod(lead, dtype=np.int64)) if lead else 1
    xp = x.new_zeros((S, R * B, tp))
    xp[:, :n, :t] = x.reshape(S, n, t)
    if x.device.type == "cpu":
        y = bsr_matmul_reference(values, col_idx, xp)
    elif x.device.type == "cuda":
        y = _launch(values, col_idx, xp)
    else:
        raise ValueError(f"no block-sparse product for device {x.device}")
    return y[:, :n, :t].reshape(lead + (n, t))


class _BsrMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, col_idx, x):
        ctx.save_for_backward(values, col_idx)
        return _apply(values, col_idx, x)

    @staticmethod
    def backward(ctx, g):
        values, col_idx = ctx.saved_tensors
        # A is symmetric: A^T g = A g
        return None, None, _apply(values, col_idx, g.contiguous())


def bsr_matmul(values, col_idx, x):
    """``A @ x`` for symmetric block-ELL ``A``; x is ``[M, T]``,
    ``[S, M, T]`` or more leading dims (folded into one launch)."""
    return _BsrMatmul.apply(values, col_idx, x)


bsr_matmul.launches = 0


class BlockSparse:
    """A symmetric block-sparse (block-ELL) matrix on a device.

    ``values [R, K, B, B]`` and ``col_idx [R, K]`` hold ``P A P^T`` for the
    RCM permutation ``perm`` (``inv_perm`` its inverse): :meth:`matmul`
    permutes ``x`` in and ``y`` out."""

    def __init__(self, values, col_idx, n, perm=None, inv_perm=None):
        self.values = values
        self.col_idx = col_idx
        self.n = n
        self.perm = perm
        self.inv_perm = inv_perm

    @property
    def block_density(self):
        R, K = self.col_idx.shape
        return R * K / max(1, _round_up(self.n, BLOCK) // BLOCK) ** 2

    @classmethod
    def from_dense(cls, a, dtype=torch.float32, check_symmetric=True,
                   device="cuda"):
        """Block-ELL form of a symmetric dense matrix after a reverse
        Cuthill-McKee reordering (host-side, once per model build); the JAX
        package's packing, slot for slot."""
        a = np.asarray(a)
        n = a.shape[0]
        if a.shape != (n, n):
            raise ValueError(f"expected square matrix, got {a.shape}")
        if check_symmetric and not np.allclose(a, a.T, rtol=1e-6,
                                               atol=1e-12):
            raise ValueError(
                "BlockSparse.from_dense requires a symmetric matrix "
                "(the gradient uses A^T = A)")
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        S = csr_matrix(a != 0)
        p = np.asarray(reverse_cuthill_mckee(S, symmetric_mode=True)
                       ).astype(np.int64)
        inv = np.empty(n, np.int64)
        inv[p] = np.arange(n)
        coo = S.tocoo()
        r, c = inv[coo.row], inv[coo.col]
        B = BLOCK
        R = _round_up(n, B) // B
        pairs = np.unique((r // B) * R + (c // B))
        pbi, pbj = pairs // R, pairs % R
        K = max(1, int(np.bincount(pbi, minlength=R).max()))
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        values = np.zeros((R, K, B, B), np_dtype)
        col_idx = np.zeros((R, K), np.int32)
        slot = np.zeros(R, np.int32)
        for bi, bj in zip(pbi, pbj):
            s_i = slot[bi]
            slot[bi] += 1
            col_idx[bi, s_i] = bj
            ro = p[bi * B:min((bi + 1) * B, n)]
            co = p[bj * B:min((bj + 1) * B, n)]
            values[bi, s_i, :len(ro), :len(co)] = a[np.ix_(ro, co)]

        def dev(x, dt):
            return torch.as_tensor(x, dtype=dt, device=device)

        return cls(dev(values, dtype), dev(col_idx, torch.int32), n,
                   dev(p, torch.int64), dev(inv, torch.int64))

    def matmul(self, x):
        """``A @ x`` for ``x`` of shape ``[..., M, T]``."""
        if self.perm is not None:
            x = x[..., self.perm, :]
        y = bsr_matmul(self.values, self.col_idx, x)
        if self.inv_perm is not None:
            y = y[..., self.inv_perm, :]
        return y

    def todense(self):
        """Dense ``[n, n]`` numpy reconstruction (tests, debugging)."""
        R, K, B, _ = self.values.shape
        vals = self.values.cpu().numpy()
        cidx = self.col_idx.cpu().numpy()
        dense = np.zeros((R * B, R * B), vals.dtype)
        for i in range(R):
            for j in range(K):
                c = cidx[i, j]
                dense[i * B:(i + 1) * B, c * B:(c + 1) * B] += vals[i, j]
        dense = dense[:self.n, :self.n]
        if self.inv_perm is not None:
            ip = self.inv_perm.cpu().numpy()
            dense = dense[np.ix_(ip, ip)]
        return dense
