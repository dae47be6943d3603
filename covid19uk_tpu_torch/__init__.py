"""PyTorch/CUDA port of ``covid19uk_tpu`` (the JAX package beside it).

The port runs the sampling transition of the full-UK model on an NVIDIA
card: preconditioned HMC over the parameters (torch autograd) and the
fused event sweep as a hand-written CUDA kernel
(:mod:`covid19uk_tpu_torch.ops.fused_sweep`).  It imports torch and numpy
only, never JAX nor the JAX package; module names follow the JAX package so
each counterpart is easy to find.  Entry points take an explicit ``device``
(default ``"cuda"``) and never move to the CPU on their own.
"""
