"""Block-sparse (block-ELL) matrix times dense matrix: wrapper, launch
counter and plain PyTorch version.

Port of ``covid19uk_tpu/ops/pallas/block_sparse.py``.  At MSOA scale
(M ~ 7000) the commuting coupling ``Cstar @ (I/N)`` is a ``[M, M] @ [M, T]``
product with a mostly-zero ``Cstar``: after a reverse Cuthill-McKee
reordering its nonzeros fall in a few 128 x 128 blocks per block row.
Block-ELL keeps, for each of the ``R`` block rows, ``K`` blocks and their
column-block indices; padded slots are zero blocks at column 0, so they add
exactly zero and need no masks.

:func:`bsr_matmul` applies a :class:`BlockSparse` operator.  For tensors on
a CUDA device it is one launch of the CUDA kernel ``csrc/block_sparse.cu``
(counted in ``bsr_matmul.launches``), which reads ``x`` and writes ``y``
through the permutation with no padded copy; for tensors on the CPU it runs
:func:`_plain`, the plain version (gather, pad, :func:`bsr_matmul_reference`,
crop, gather).  The matrix is symmetric, so the gradient with respect to
``x`` is the same product applied to the cotangent; the operator is a
constant.
"""

import functools

import numpy as np
import torch

BLOCK = 128  # rows and columns of one block


def _round_up(x, m):
    return -(-x // m) * m


def bsr_matmul_reference(values, col_idx, xp):
    """The plain block-ELL product: ``values [R, K, B, B]`` gathered by
    ``col_idx [R, K]`` times padded ``xp [S, R*B, Tp]`` -> ``[S, R*B, Tp]``."""
    R, K, B, _ = values.shape
    S, _, Tp = xp.shape
    xb = xp.reshape(S, R, B, Tp)[:, col_idx.long()]  # [S, R, K, B, Tp]
    y = torch.einsum("rkij,srkjt->srit", values, xb)
    return y.reshape(S, R * B, Tp)


def _plain(values, col_idx, perm, inv_perm, x):
    """The plain version of the whole product on ``x [S, n, T]``: ``x``
    gathered through ``perm`` into a zero-padded ``[S, R*B, round_up(T,
    128)]``, :func:`bsr_matmul_reference`, cropped, gathered back through
    ``inv_perm``."""
    R, _, B, _ = values.shape
    S, n, t = x.shape
    if perm is not None:
        x = x[:, perm]
    xp = x.new_zeros((S, R * B, _round_up(max(t, 1), B)))
    xp[:, :n, :t] = x
    y = bsr_matmul_reference(values, col_idx, xp)[:, :n, :t]
    return y if inv_perm is None else y[:, inv_perm]


@functools.cache
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def tile_days(R, S, T, sms):
    """Days a thread block of the kernel owns: 16, 32, 48 or 64 (each of
    its two warp columns takes a fixed number of 8-day tiles; days past T
    are zeros).  Among the widths whose grid of ``2 R S ceil(T / width)``
    blocks (64 rows each) gives at least two blocks an SM, the one that
    computes the fewest padded days, the widest of those on a tie; the
    narrowest when none fills the card."""
    fills = [w for w in (64, 48, 32, 16) if 2 * R * S * -(-T // w) >= 2 * sms]
    if not fills:
        return 16
    return min(fills, key=lambda w: (-(-T // w) * w, -w))


def _kernel_args(values, col_idx, x, perm, slots, order, sms=None):
    """Checks the kernel's inputs and returns (its C arguments before the
    stream, the output ``y``, allocated): ``x [S, M, T]`` float32,
    ``perm [M]``, ``slots [R]``, ``order [R]`` and ``col_idx`` int32, all
    contiguous on one device; ``sms`` (the device's SM count when None)
    sets the day tile."""
    R, K, B, _ = values.shape
    if values.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError("the block-sparse kernel takes float32 values and x")
    for name, t in (("col_idx", col_idx), ("perm", perm), ("slots", slots),
                    ("order", order)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32")
    if (B != BLOCK or x.dim() != 3 or perm.shape != (x.shape[1],)
            or x.shape[1] > R * B or col_idx.shape != (R, K)
            or slots.shape != (R,) or order.shape != (R,)):
        raise ValueError(f"bad shapes: values {tuple(values.shape)}, "
                         f"x {tuple(x.shape)}, perm {tuple(perm.shape)}")
    tensors = (values, col_idx, x, perm, slots, order)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the block-sparse kernel's inputs must be "
                         "contiguous")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    S, M, T = x.shape
    if sms is None:
        sms = _sm_count(x.device)
    y = torch.empty_like(x)
    args = (values.data_ptr(), col_idx.data_ptr(), slots.data_ptr(),
            order.data_ptr(), perm.data_ptr(), x.data_ptr(), y.data_ptr(),
            R, K, M, S, T, tile_days(R, S, T, sms))
    return args, y


def _launch(values, col_idx, x, perm, slots, order):
    """The CUDA kernel: ``y [S, M, T]``, row ``perm[r]`` of it the
    operator's row ``r`` times ``x [S, M, T]`` read through ``perm``; one
    launch, ``y`` its only allocation."""
    from covid19uk_tpu_torch.ops import _build

    args, y = _kernel_args(values, col_idx, x, perm, slots, order)
    lib = _build.block_sparse_library().lib
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bsr_matmul_launch(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"block-sparse kernel launch failed: CUDA error {err} "
            f"({_build.error_string(lib.block_sparse_error_string, err)})")
    bsr_matmul.launches += 1
    return y


def _apply(op, x):
    """``op``'s product on ``x [..., n, T]`` (leading dims folded into
    one batch)."""
    lead, n, t = x.shape[:-2], x.shape[-2], x.shape[-1]
    x3 = x.reshape((-1, n, t))
    if x.device.type == "cpu":
        y = _plain(op.values, op.col_idx, op.perm, op.inv_perm, x3)
    elif x.device.type == "cuda":
        y = _launch(op.values, op.col_idx, x3.contiguous(), op.perm32,
                    op.slots, op.order)
    else:
        raise ValueError(f"no block-sparse product for device {x.device}")
    return y.reshape(lead + (n, t))


class _BsrMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        return _apply(op, x)

    @staticmethod
    def backward(ctx, g):
        # A is symmetric: A^T g = A g
        return _apply(ctx.op, g.contiguous()), None


def bsr_matmul(op, x):
    """``A @ x`` for a :class:`BlockSparse` ``op``; x is ``[M, T]``,
    ``[S, M, T]`` or more leading dims (folded into one launch)."""
    return _BsrMatmul.apply(x, op)


bsr_matmul.launches = 0


class BlockSparse:
    """A symmetric block-sparse (block-ELL) matrix on a device.

    ``values [R, K, B, B]`` and ``col_idx [R, K]`` hold ``P A P^T`` for the
    RCM permutation ``perm`` (``inv_perm`` its inverse; None for the
    identity): :meth:`matmul` permutes ``x`` in and ``y`` out.

    What the kernel needs is derived once, here: ``slots [R]``, the slots
    to visit in each row (1 + the index of its last slot that holds a
    nonzero; every slot after it is a zero block, so skipping it adds
    exactly nothing), ``order [R]``, the rows longest first, and
    ``perm32``, ``perm`` as int32."""

    def __init__(self, values, col_idx, n, perm=None, inv_perm=None):
        self.values = values
        self.col_idx = col_idx
        self.n = n
        self.perm = perm
        self.inv_perm = inv_perm
        R, K = col_idx.shape
        held = values.reshape(R, K, -1).ne(0).any(2)
        upto = torch.arange(1, K + 1, dtype=torch.int32,
                            device=values.device)
        self.slots = (held * upto).amax(1).to(torch.int32)
        self.order = torch.argsort(self.slots, descending=True,
                                   stable=True).to(torch.int32)
        self.perm32 = (torch.arange(n, device=values.device) if perm is None
                       else perm).to(torch.int32)

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
        return bsr_matmul(self, x)

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
