"""Typed, validated configuration.

Port of ``covid19uk_tpu/config.py`` (pure Python, copied so the port does
not import the JAX package): the ``Mcmc`` section validated into a
dataclass up front, with the same fields, defaults and checks; unknown keys
and out-of-range values fail fast with a pointed message.  The raw-dict
interface is still accepted everywhere.  Why each default is what it is,
with the measurements behind it, is in the JAX package's ``config.py``:
those were taken with the JAX package, none with this port.  Every field
runs, alone and together, over one rank or several (chain and space
axes alike).
"""

from dataclasses import dataclass, fields
from typing import Optional


@dataclass
class WarmupConfig:
    first_window: int = 200
    slow_window: int = 25
    num_slow_windows: int = 6
    last_window: int = 50


@dataclass
class McmcConfig:
    """The Mcmc config section (reference example_config.yaml:25-34 plus
    framework extensions)."""

    dmax: int = 84
    nmax: int = 25
    m: int = 2
    occult_nmax: int = 15
    num_event_time_updates: int = 5
    move_decay: float = 0.9  # event-move displacement decay; 1.0 = uniform
    x_decay: float = 0.9  # event-count proposal decay; 1.0 = uniform
    # Robbins–Monro autotuning of the move kernels' displacement decays
    # during warmup windows, targeting move_accept_target acceptance
    # (reference manual-tuning practice ~23%, lancs tex:325-326).  Each of
    # move S->E / move E->I gets its own decay, updated between windows
    # from the window's pooled acceptance and frozen for the sampling
    # phase (so sampling is exact fixed-kernel MH).
    autotune_acceptance: bool = True
    move_accept_target: float = 0.23
    # Episode-translation pair moves (S->E and downstream E->I moved
    # together): the measured fix for the slow infectious-person-time
    # mode that throttles gamma0 ESS (gibbs.EventKernelConfig).
    num_pair_updates: int = 1  # pair proposals per sweep, WARMUP windows
    # Pair proposals during sampling bursts: ESS-neutral per draw at
    # equilibrium but a large share of a transition's wall time, so off by
    # default (the warmup phase does the equilibrating).
    num_pair_updates_sampling: int = 0
    pair_mmax: int = 1  # locations per pair proposal
    # Pair-proposal displacement decay, decoupled from move_decay: episode
    # translation removes the E-sojourn penalty so long strides survive,
    # and uniform (1.0) mixed gamma0 better than 0.9 at UK scale.
    pair_move_decay: float = 1.0
    # Deterministic gamma0 ridge compensation inside each pair proposal
    # (event_kernels.compensated_pair_move_step): removes the I->R penalty
    # on large person-time strides so gamma0 decorrelates faster.
    pair_compensate_gamma0: bool = False
    # Near-iid conditional refresh of (gamma0, gamma1) | events after each
    # event sweep (inference/gamma_gibbs.py): a Laplace independence-MH
    # draw from the exact 2-D conditional.  It lowered gamma0's ESS at UK
    # equilibrium: the conditional is tight, so the refresh slaves gamma0
    # to the slow person-time mode.  Kept as an option for far-from-
    # equilibrium starts; off by default.
    gamma_gibbs: bool = False
    # Guided occult location proposal (gibbs.EventKernelConfig
    # occult_guided): sample the occult location from fixed observed-case
    # weights (+ uniform floor) instead of Uniform(M).  Exact — the fixed
    # location factor cancels from the Hastings ratio; stationarity
    # tested.  "auto" guides at M >= 64 (uniform occults accept well at
    # NI scale and almost never at UK scale).  "always"/"never" force.
    occult_guided: str = "auto"
    occult_guide_floor: float = 0.1  # uniform mixture weight (ergodicity)
    # Guided MOVE/PAIR location proposal (gibbs.EventKernelConfig
    # move_guided): sample the mmax move locations weighted-without-
    # replacement by the same fixed observed-case weights (full [0, T)
    # window) instead of uniform.  Exact (location factor cancels);
    # "never" until the UK-scale mixing A/B certifies a win.
    move_guided: str = "never"
    move_guide_floor: float = 0.1
    # Joint (gamma0, E->I events) ridge move: kept as an option, off by
    # default.
    compensate_gamma0: bool = False
    num_compensated_updates: int = 1  # ridge-move proposals per sweep
    num_bursts: int = 50
    num_burst_samples: int = 100
    thin: int = 1
    # Write warmup-window draws to the posterior store (reference behavior).
    # At MSOA scale the warmup event draws dominate the store and the HDF5
    # write wall; set False to store the sampling phase only
    # (ThinPosterior.start is then 0).
    store_warmup: bool = True
    num_adaptation_iterations: int = 1000  # accepted for parity; unused
    num_chains: int = 1
    pooled_adaptation: bool = True  # pool step-size/mass across chains
    # Shard the chains over the ranks of a multi-process run (each rank one
    # device); with one rank it does nothing.
    use_mesh: bool = False
    # With use_mesh: devices along the mesh's `space` axis — the location
    # axis of the event tensor / commuting matmul is sharded over it
    # (MSOA-scale model parallelism, SURVEY.md §2.8).  1 = chains only.
    # With one rank it does nothing.
    space_devices: int = 1
    # Convergence gating (SURVEY.md §5 "gated burst loop"): checked between
    # bursts on the scalar parameters; sampling stops early when every
    # enabled criterion is met.  None disables a criterion.
    rhat_stop: Optional[float] = None  # stop when max split R-hat < this
    ess_stop: Optional[int] = None  # stop when min bulk ESS >= this
    # Block-sparse operators for Cstar / the CAR precision: "auto"
    # (size/density gate in ModelData.create), "always", or "never".
    sparse: str = "auto"
    # Let the acceptance autotuner drive the move kernels' EVENT-COUNT
    # (x) decay alongside the displacement decay.  At NI scale the event
    # count is the binding rejection factor and x-tuning helps gamma0's
    # ESS; at UK scale forcing the band shrinks the moves and costs it.
    # "auto" enables x-tuning at M < 64; "always"/"never" force.
    autotune_x: str = "auto"
    # Fused event sweep (gibbs.EventKernelConfig fused_sweep): run the
    # whole U x 4-kernel multiscan as ONE kernel launch per draw (the CUDA
    # kernel ops/csrc/fused_sweep.cu; on the CPU its plain version).  Same
    # proposals/accept rules as the unfused sweep.  "auto" resolves to the
    # unfused sweep.
    fused_sweep: str = "never"
    dtype: str = "float32"
    seed: int = 1
    # Geometric lag rates for the initialization imputation
    # (I->R -> E->I lag, E->I -> S->E lag).  The default is the reference's
    # (0.25, 0.5) (model_spec.py:108-126) — INCONSISTENT with the model's
    # own sojourn rates; the calibration study (docs/calibration.md)
    # attributes a gamma0 recovery offset to the initial state this
    # derives.  (removal_rate_estimate, 0.28) reduces it.
    impute_rates: tuple = (0.25, 0.5)
    checkpoint: Optional[str] = None
    log_file: Optional[str] = None
    profile_dir: Optional[str] = None
    # Raise FloatingPointError at a NaN, naming the op that made it
    # (utils/nans.py).
    debug_nans: bool = False
    warmup: Optional[dict] = None

    def __post_init__(self):
        positive = [
            "dmax", "nmax", "m", "occult_nmax", "num_event_time_updates",
            "num_compensated_updates", "pair_mmax",  # num_pair_updates may be 0
            "num_bursts", "num_burst_samples", "thin", "num_chains",
            "space_devices",
        ]
        for name in positive:
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"Mcmc.{name} must be a positive int, got {v!r}")
        for name in ("num_pair_updates", "num_pair_updates_sampling"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 0:
                raise ValueError(
                    f"Mcmc.{name} must be a non-negative int, got {v!r}"
                )
        for name in ("move_decay", "x_decay", "pair_move_decay"):
            v = getattr(self, name)
            if not (0.0 < v <= 1.0):
                raise ValueError(f"Mcmc.{name} must be in (0, 1], got {v!r}")
        self.impute_rates = tuple(self.impute_rates)
        if len(self.impute_rates) != 2 or any(
            not (isinstance(r, (int, float)) and r > 0.0)
            for r in self.impute_rates
        ):
            raise ValueError(
                "Mcmc.impute_rates must be two positive rates, got "
                f"{self.impute_rates!r}"
            )
        if not (0.0 < self.move_accept_target < 1.0):
            raise ValueError(
                "Mcmc.move_accept_target must be in (0, 1), got "
                f"{self.move_accept_target!r}"
            )
        if self.rhat_stop is not None and not self.rhat_stop > 1.0:
            raise ValueError(
                f"Mcmc.rhat_stop must be > 1.0, got {self.rhat_stop!r}"
            )
        if self.ess_stop is not None and (
            not isinstance(self.ess_stop, int) or self.ess_stop < 1
        ):
            raise ValueError(
                f"Mcmc.ess_stop must be a positive int, got {self.ess_stop!r}"
            )
        if self.sparse not in ("auto", "always", "never"):
            raise ValueError(
                f"Mcmc.sparse must be auto/always/never, got {self.sparse!r}"
            )
        for name in ("occult_guided", "move_guided", "fused_sweep",
                     "autotune_x"):
            if getattr(self, name) not in ("auto", "always", "never"):
                raise ValueError(
                    f"Mcmc.{name} must be auto/always/never, got "
                    f"{getattr(self, name)!r}"
                )
        for name in ("occult_guide_floor", "move_guide_floor"):
            if not (0.0 < getattr(self, name) <= 1.0):
                raise ValueError(
                    f"Mcmc.{name} must be in (0, 1], got "
                    f"{getattr(self, name)!r}"
                )
        if self.dtype not in ("float32", "float64"):
            raise ValueError(
                f"Mcmc.dtype must be float32 or float64, got {self.dtype!r}"
            )
        if self.warmup is not None:
            known = {f.name for f in fields(WarmupConfig)}
            unknown = set(self.warmup) - known
            if unknown:
                raise ValueError(f"Mcmc.warmup unknown keys: {sorted(unknown)}")

    @classmethod
    def from_dict(cls, d):
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"Unknown Mcmc config keys: {sorted(unknown)} "
                f"(known: {sorted(known)})"
            )
        if "num_adaptation_iterations" in d:
            import warnings

            warnings.warn(
                "Mcmc.num_adaptation_iterations is accepted for "
                "reference-config compatibility but has NO effect here: "
                "warmup length is the Stan-style window schedule "
                "(Mcmc.warmup: first_window/slow_window/num_slow_windows/"
                "last_window, default 200 + 25*2^0..2^5 + 50 = 1825 draws). "
                "Set Mcmc.warmup to change warmup length.",
                stacklevel=2,
            )
        return cls(**d)

    def to_dict(self):
        return {f.name: getattr(self, f.name) for f in fields(self)}
