"""Incremental HDF5 posterior store.

Replaces ``gemlib.mcmc.Posterior`` (contract per call sites
``/root/reference/covid19uk/inference/inference.py:352-359,376-381,460-468``):
preallocates ``samples/*`` and ``results/*`` datasets sized for the full run,
then appends warmup windows and sampling bursts at ``first_dim_offset``.
Killing a run loses only the in-flight burst — together with
:mod:`covid19uk_tpu_torch.utils.checkpoint` this gives burst-granular resume.

Layout (matches the reference so downstream tooling interoperates):

    samples/{psi, sigma_space, beta_area, gamma0, gamma1, alpha_0,
             alpha_t, spatial_effect, seir}
    results/hmc/{is_accepted, target_log_prob, step_size}
    results/{move/S->E, move/E->I, occult/S->E, occult/E->I}/
            {is_accepted, target_log_prob, proposed_delta}
    results/move/{E->I_compensated, S->E+E->I_pair}/...   (framework
            extensions — additive, reference groups unchanged)
    initial_state, time                       (root datasets)

With ``num_chains > 1`` every dataset gains a chain axis at position 1.

Port of ``covid19uk_tpu/utils/store.py``; ``h5py`` is imported where a
file is opened, so importing this module needs no h5py.
"""

import numpy as np


class Posterior:
    """Preallocated, append-by-offset HDF5 sample/results store."""

    def __init__(self, path, sample_dict, results_dict, num_samples):
        """Creates the file and preallocates datasets.

        Args:
          path: output HDF5 path.
          sample_dict: template dict of one burst of samples; first dim is
            the draw axis (its size is ignored, only trailing shape/dtype
            matter).
          results_dict: nested template dict of traced results, same rule.
          num_samples: total number of draws to preallocate.
        """
        import h5py

        self._file = h5py.File(path, "w")
        self._num_samples = num_samples

        def make(group, d):
            for k, v in d.items():
                if isinstance(v, dict):
                    make(group + "/" + k, v)
                else:
                    v = np.asarray(v)
                    shape = (num_samples,) + v.shape[1:]
                    self._file.create_dataset(
                        group + "/" + k,
                        shape=shape,
                        dtype=v.dtype,
                        chunks=(min(100, num_samples),) + v.shape[1:],
                        maxshape=(None,) + v.shape[1:],
                    )

        make("samples", sample_dict)
        make("results", results_dict)

    def _write(self, group, d, offset):
        for k, v in d.items():
            if isinstance(v, dict):
                self._write(group + "/" + k, v, offset)
            else:
                v = np.asarray(v)
                end = offset + v.shape[0]
                self._file[group + "/" + k][offset:end] = v

    def write_samples(self, sample_dict, first_dim_offset):
        self._write("samples", sample_dict, first_dim_offset)
        self._file.flush()

    def write_results(self, results_dict, first_dim_offset):
        self._write("results", results_dict, first_dim_offset)
        self._file.flush()

    def truncate(self, num_draws):
        """Shrinks every samples/results dataset to ``num_draws`` along the
        draw axis — used when convergence gating stops sampling early."""
        import h5py

        def shrink(item):
            if isinstance(item, h5py.Group):
                for child in item.values():
                    shrink(child)
            elif item.shape and item.shape[0] > num_draws:
                item.resize(num_draws, axis=0)

        for root in ("samples", "results"):
            if root in self._file:
                shrink(self._file[root])
        self._file.flush()

    @classmethod
    def open(cls, path, sample_dict=None, results_dict=None):
        """Re-opens an existing posterior store for resumed appends.

        When ``sample_dict``/``results_dict`` templates are given (same
        convention as the constructor: first dim = draw axis, ignored),
        every dataset's trailing shape and dtype are checked against the
        template so a resume with a changed ``num_chains``/``thin``/model
        shape fails fast instead of scribbling misaligned rows.
        """
        import h5py

        self = cls.__new__(cls)
        self._file = h5py.File(path, "r+")
        self._num_samples = None

        def check(group, d):
            for k, v in d.items():
                name = group + "/" + k
                if isinstance(v, dict):
                    if name not in self._file:
                        raise ValueError(
                            f"resume: store {path!r} is missing group "
                            f"{name!r} required by the current config"
                        )
                    check(name, v)
                    continue
                v = np.asarray(v)
                if name not in self._file:
                    raise ValueError(
                        f"resume: store {path!r} is missing dataset "
                        f"{name!r} required by the current config"
                    )
                ds = self._file[name]
                if ds.shape[1:] != v.shape[1:] or ds.dtype != v.dtype:
                    raise ValueError(
                        f"resume: store dataset {name!r} has trailing shape "
                        f"{ds.shape[1:]} dtype {ds.dtype}, but the current "
                        f"run expects {v.shape[1:]} dtype {v.dtype} — the "
                        "resumed config (num_chains/thin/dtype/model shape) "
                        "does not match the original run"
                    )

        if sample_dict is not None:
            check("samples", sample_dict)
        if results_dict is not None:
            check("results", results_dict)
        return self

    def create_dataset(self, name, data):
        if name in self._file:
            del self._file[name]
        self._file.create_dataset(name, data=data)

    def __getitem__(self, key):
        return self._file[key]

    def close(self):
        self._file.close()

    def __del__(self):
        try:
            self._file.close()
        except Exception:
            pass
