"""PyTorch/CUDA port of ``covid19uk_tpu`` (the JAX package beside it).

The port runs the sampling transition of the full-UK model on an NVIDIA
card: preconditioned HMC over the parameters (torch autograd) and the
fused event sweep as a hand-written CUDA kernel
(:mod:`covid19uk_tpu_torch.ops.fused_sweep`), the MSOA-scale transition
with the block-sparse commute kernel, and around them the MCMC driver
(:mod:`covid19uk_tpu_torch.inference.driver`: warmup adaptation,
checkpointed bursts, diagnostics, the HDF5 posterior, the inference CLI),
the posterior verbs (:mod:`covid19uk_tpu_torch.posterior`: thin, predict,
R_t, within/between) and the ETL (:mod:`covid19uk_tpu_torch.data`, host
pandas).  The model API (the SEIR process, ``CovidUK`` and its
parameter packing, the next-generation matrix) is at top level, as in
the JAX package.  It imports torch and numpy, h5py and PyYAML inside the
functions that need them, pandas in the ETL and inside within/between;
never JAX nor the JAX package.  Module names follow the JAX package so
each counterpart is easy to find.  Entry points that compute take an
explicit ``device`` (default ``"cuda"``) and never move to the CPU on
their own.
"""

from covid19uk_tpu_torch.models.seir import (
    NU,
    STOICHIOMETRY,
    TIME_DELTA,
    chain_binomial_log_prob,
    chain_binomial_sample,
    compute_state,
)
from covid19uk_tpu_torch.models.spec import (
    CovidUK,
    ModelData,
    constrain_parameters,
    pack_parameters,
    unconstrain_parameters,
    unpack_parameters,
)
from covid19uk_tpu_torch.models.ngm import next_generation_matrix_fn

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "STOICHIOMETRY",
    "TIME_DELTA",
    "NU",
    "compute_state",
    "chain_binomial_log_prob",
    "chain_binomial_sample",
    "CovidUK",
    "ModelData",
    "pack_parameters",
    "unpack_parameters",
    "constrain_parameters",
    "unconstrain_parameters",
    "next_generation_matrix_fn",
    "assemble_data",
    "mcmc",
    "thin_posterior",
    "predict",
    "reproduction_number",
    "within_between",
]

# The six pipeline verbs, imported on first use: their modules pull in
# pandas (the ETL) and the driver; importing the package needs neither
# pandas, h5py nor PyYAML.
_VERBS = {
    "assemble_data": "covid19uk_tpu_torch.data.assemble",
    "mcmc": "covid19uk_tpu_torch.inference.driver",
    "thin_posterior": "covid19uk_tpu_torch.posterior.thin",
    "predict": "covid19uk_tpu_torch.posterior.predict",
    "reproduction_number": "covid19uk_tpu_torch.posterior.reproduction_number",
    "within_between": "covid19uk_tpu_torch.posterior.within_between",
}


def __getattr__(name):
    if name in _VERBS:
        import importlib

        return getattr(importlib.import_module(_VERBS[name]), name)
    raise AttributeError(
        f"module 'covid19uk_tpu_torch' has no attribute {name!r}")
