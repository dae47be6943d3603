"""Symmetric block-tridiagonal operator for RCM-banded sparse matrices.

Port of ``covid19uk_tpu/ops/banded.py``.  Built for the CAR spatial-prior
precision ``Dw - rho * W``: an adjacency-sparse matrix that reverse
Cuthill-McKee reordering makes banded.  Stored as dense diagonal and
super-diagonal ``s x s`` blocks (``s >= bandwidth``), the quadratic form is
two batched block products.  Plain PyTorch (``einsum``), differentiated by
autograd; the permutation's gradient is autograd's of an index gather.
:meth:`quad` and :meth:`matvec` take ``x [..., n]``: leading dims (chains)
are a batch.
"""

import numpy as np
import torch

# block size: the bandwidth + 1 rounded up to a multiple of BLOCK
BLOCK = 128
# above this bandwidth the banded form would be mostly zeros
MAX_BANDWIDTH = 2048


class BandedSym:
    """A symmetric banded matrix in block-tridiagonal form.

    Attributes:
      diag: ``[nb, s, s]`` diagonal blocks (of the RCM-permuted matrix).
      upper: ``[nb-1, s, s]`` super-diagonal blocks (lower = transpose).
      perm / inv_perm: ``[n]`` RCM permutation and its inverse.
      n: logical size.
    """

    def __init__(self, diag, upper, perm, inv_perm, n):
        self.diag = diag
        self.upper = upper
        self.perm = perm
        self.inv_perm = inv_perm
        self.n = n

    @classmethod
    def from_dense(cls, a, dtype=torch.float32, device="cuda"):
        """Banded form of a symmetric sparse matrix (host-side), or None if
        the RCM bandwidth exceeds ``MAX_BANDWIDTH``."""
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        a = np.asarray(a)
        n = a.shape[0]
        S = csr_matrix(a != 0)
        p = np.asarray(reverse_cuthill_mckee(S, symmetric_mode=True)
                       ).astype(np.int64)
        inv = np.empty(n, np.int64)
        inv[p] = np.arange(n)
        coo = S.tocoo()
        bw = int(np.abs(inv[coo.row] - inv[coo.col]).max()) if coo.nnz else 0
        if bw > MAX_BANDWIDTH:
            return None
        s = max(BLOCK, -(-(bw + 1) // BLOCK) * BLOCK)
        nb = -(-n // s)
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        diag = np.zeros((nb, s, s), np_dtype)
        upper = np.zeros((max(nb - 1, 0), s, s), np_dtype)
        for i in range(nb):
            ri = p[i * s:min((i + 1) * s, n)]
            diag[i, :len(ri), :len(ri)] = a[np.ix_(ri, ri)]
            if i + 1 < nb:
                rj = p[(i + 1) * s:min((i + 2) * s, n)]
                upper[i, :len(ri), :len(rj)] = a[np.ix_(ri, rj)]

        def dev(x, dt):
            return torch.as_tensor(x, dtype=dt, device=device)

        return cls(dev(diag, dtype), dev(upper, dtype), dev(p, torch.int64),
                   dev(inv, torch.int64), n)

    def _blocked(self, x):
        """Permutes and pads ``x [..., n]`` into ``[..., nb, s]`` blocks."""
        nb, s, _ = self.diag.shape
        xp = x[..., self.perm]
        pad = nb * s - self.n
        if pad:
            xp = torch.nn.functional.pad(xp, (0, pad))
        return xp.reshape(x.shape[:-1] + (nb, s))

    def matvec(self, x):
        """``A @ x`` for ``x [..., n]``."""
        nb, s, _ = self.diag.shape
        xs = self._blocked(x)
        y = torch.einsum("nij,...nj->...ni", self.diag, xs)
        if nb > 1:
            up = torch.einsum("nij,...nj->...ni", self.upper, xs[..., 1:, :])
            lo = torch.einsum("nji,...nj->...ni", self.upper, xs[..., :-1, :])
            zero = torch.zeros_like(y[..., :1, :])
            y = y + torch.cat([up, zero], -2) + torch.cat([zero, lo], -2)
        y = y.reshape(x.shape[:-1] + (nb * s,))[..., :self.n]
        return y[..., self.inv_perm]

    def quad(self, x):
        """Quadratic form ``x' A x`` for ``x [..., n]`` -> ``[...]``."""
        nb, s, _ = self.diag.shape
        xs = self._blocked(x)
        q = torch.sum(xs * torch.einsum("nij,...nj->...ni", self.diag, xs),
                      dim=(-2, -1))
        if nb > 1:
            q = q + 2.0 * torch.sum(
                xs[..., :-1, :]
                * torch.einsum("nij,...nj->...ni", self.upper, xs[..., 1:, :]),
                dim=(-2, -1),
            )
        return q

    def todense(self):
        """Dense numpy reconstruction (tests, debugging)."""
        nb, s, _ = self.diag.shape
        diag = self.diag.cpu().numpy()
        upper = self.upper.cpu().numpy()
        d = np.zeros((nb * s, nb * s), diag.dtype)
        for i in range(nb):
            d[i * s:(i + 1) * s, i * s:(i + 1) * s] = diag[i]
            if i + 1 < nb:
                d[i * s:(i + 1) * s, (i + 1) * s:(i + 2) * s] = upper[i]
                d[(i + 1) * s:(i + 2) * s, i * s:(i + 1) * s] = upper[i].T
        d = d[:self.n, :self.n]
        ip = self.inv_perm.cpu().numpy()
        return d[np.ix_(ip, ip)]
