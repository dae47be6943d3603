"""PyTorch/CUDA port of ``covid19uk_tpu`` (the JAX package beside it).

The port runs the sampling transition of the full-UK model on an NVIDIA
card: preconditioned HMC over the parameters (torch autograd) and the
fused event sweep as a hand-written CUDA kernel
(:mod:`covid19uk_tpu_torch.ops.fused_sweep`), the MSOA-scale transition
with the block-sparse commute kernel, and around them the MCMC driver
(:mod:`covid19uk_tpu_torch.inference.driver`: warmup adaptation,
checkpointed bursts, diagnostics, the HDF5 posterior, the inference CLI).
It imports torch and numpy only (h5py and PyYAML inside its IO functions),
never JAX nor the JAX package; module names follow the JAX package so
each counterpart is easy to find.  Entry points take an explicit
``device`` (default ``"cuda"``) and never move to the CPU on their own.
"""
