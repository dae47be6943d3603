"""Synthetic model/state builders for the chip smoke run and the tests.

Port of ``covid19uk_tpu/utils/synthetic.py``.  The covariates are numpy
from the same seed, so they are identical to the JAX package's; only the
forward-simulated events come from a torch generator.
"""

import numpy as np
import torch


def _pairwise_dist(coords):
    """[M, M] Euclidean distances in one float32 buffer."""
    c = np.asarray(coords, np.float32)
    sq = (c**2).sum(axis=1)
    d2 = c @ c.T
    d2 *= -2.0
    d2 += sq[:, None]
    d2 += sq[None, :]
    np.maximum(d2, 0.0, out=d2)
    np.sqrt(d2, out=d2)
    return d2


def gravity_flows(rng, N, coords, commute_frac=0.15, radius_frac=0.12):
    """Origin-destination commuting matrix from a gravity model with a
    distance cutoff: ``commute_frac * N_i`` workers per origin, spread
    over destinations within ``radius_frac`` with weight
    ``N_j / (d_ij + d0)^2``.  Returns ``[M, M]`` float32, zero diagonal."""
    w = _pairwise_dist(coords)
    d0 = 0.2 * radius_frac
    far = w > radius_frac
    w += d0
    np.square(w, out=w)
    np.divide(N[None, :].astype(np.float32), w, out=w)
    w[far] = 0.0
    np.fill_diagonal(w, 0.0)
    row = w.sum(axis=1, dtype=np.float64)
    scale = np.where(
        row > 0, commute_frac * N / np.maximum(row, 1e-30), 0.0
    ).astype(np.float32)
    w *= scale[:, None]
    return w


def knn_adjacency(coords, k=6):
    """Symmetric k-nearest-neighbour adjacency (every degree >= k, so the
    CAR precision ``Dw - 0.25 A`` is strictly diagonally dominant)."""
    M = coords.shape[0]
    d = _pairwise_dist(coords)
    np.fill_diagonal(d, np.inf)
    k = min(k, M - 1)
    nn = np.argpartition(d, k, axis=1)[:, :k]
    adjacency = np.zeros((M, M), np.float32)
    rows = np.repeat(np.arange(M), k)
    adjacency[rows, nn.ravel()] = 1.0
    np.maximum(adjacency, adjacency.T, out=adjacency)
    return adjacency


def build_synthetic_model(M, T, dtype=torch.float32, rng_seed=0,
                          sparse="auto", radius_frac=0.12, keep_C=True,
                          device="cuda"):
    """A CovidUK model over gravity-model covariates at (M, T) on
    ``device``; the same covariates as the JAX package's
    ``build_synthetic_model`` for the same seed.

    ``sparse`` and ``keep_C`` go to ``ModelData.create``; ``radius_frac``
    is the commuting cutoff radius (0.12 suits M ~ 380, MSOA-scale runs
    use 0.05)."""
    from covid19uk_tpu_torch.models.spec import CovidUK, ModelData

    rng = np.random.default_rng(rng_seed)
    coords = rng.uniform(0, 1, size=(M, 2))
    N = np.exp(rng.normal(np.log(1.5e5), 0.5, size=M))
    N = np.clip(N, 5e4, 1.2e6)
    C = gravity_flows(rng, N, coords, radius_frac=radius_frac)
    covariates = dict(
        C=C,
        W=np.ones(T),
        N=N,
        adjacency=knn_adjacency(coords),
        weekday=(np.arange(T) % 7 < 5).astype(float),
        area=rng.uniform(1e8, 5e9, size=M),
    )
    data = ModelData.create(covariates, dtype, sparse=sparse, keep_C=keep_C,
                            device=device)
    init = np.stack(
        [N - 60.0, np.full(M, 20.0), np.full(M, 40.0), np.zeros(M)], axis=-1
    )
    return CovidUK(
        data, torch.as_tensor(init, dtype=dtype, device=device), 0, T
    )


def initial_parameters(model, rng_seed=0):
    """The plausible starting parameters of the JAX ``initial_chain_state``
    (same numpy draws for alpha_t and the spatial effect)."""
    from covid19uk_tpu_torch.models.spec import Parameters

    M, T = model.data.num_locations, model.num_steps
    like = model.initial_state

    def t(x):
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)

    rng = np.random.default_rng(rng_seed)
    return Parameters(
        psi=t(0.3), sigma_space=t(0.05), beta_area=t(0.1), gamma0=t(-1.0),
        gamma1=t(0.05), alpha_0=t(-4.0),
        alpha_t=t(rng.normal(0, 0.005, T - 1)),
        spatial_effect=t(rng.normal(0, 0.3, M)),
    )


def initial_chain_state(model, generator, rng_seed=0):
    """A valid single-chain ChainState: :func:`initial_parameters` and
    events forward-simulated with ``generator``."""
    from covid19uk_tpu_torch.inference.gibbs import ChainState
    from covid19uk_tpu_torch.models.spec import (
        pack_parameters,
        unconstrain_parameters,
    )

    params = initial_parameters(model, rng_seed)
    events = model.sample_seir(generator, params)
    u = unconstrain_parameters(pack_parameters(params))
    return ChainState(u=u, events=events)
