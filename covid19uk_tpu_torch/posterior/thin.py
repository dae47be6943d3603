"""Thin posterior HDF5 -> pickle.

Port of ``covid19uk_tpu/posterior/thin.py``: slice every ``samples/*``
dataset by ``start:end:by``, carry ``initial_state``, pickle the dict.
When the posterior was sampled with several chains (``seir`` of
``[draw, chain, M, T, X]``), the chain axis folds into the draw axis
after thinning.  The pickle holds numpy arrays only, so it loads in
either package's ``predict``.  h5py and PyYAML are imported inside the
functions that need them.
"""

import pickle as pkl

import numpy as np


def thin_samples(samples, initial_state, config):
    """Thins a mapping of sample arrays (``name -> [draw, ...]``) by
    ``config``'s ``start:end:by`` and folds a chain axis into the draws;
    returns a dict of numpy arrays with ``initial_state`` added."""
    idx = slice(config["start"], config["end"], config["by"])
    out = {k: np.asarray(v[idx]) for k, v in samples.items()}
    # Multi-chain runs store [draw, chain, ...]: fold chains into draws.
    if out["seir"].ndim == 5:  # [draw, chain, M, T, X]
        out = {k: v.reshape((-1,) + v.shape[2:]) for k, v in out.items()}
    out["initial_state"] = np.asarray(initial_state)
    return out


def thin_posterior(input_file, output_file, config):
    """Slices ``samples/*`` of a posterior HDF5 by ``start:end:by`` and
    pickles the dict (reference thin.py:7-21)."""
    import h5py

    with h5py.File(input_file, "r") as f:
        output_dict = thin_samples(
            f["samples"], f["initial_state"][:], config)

    with open(output_file, "wb") as fo:
        pkl.dump(output_dict, fo)

    return output_dict


def main(argv=None):
    import argparse

    import yaml

    parser = argparse.ArgumentParser(
        description="Thin a posterior HDF5 file into a samples pickle"
    )
    parser.add_argument("samples", help="posterior HDF5 file")
    parser.add_argument("-c", "--config", required=True, help="YAML config")
    parser.add_argument("-o", "--output", required=True, help="output .pkl")
    args = parser.parse_args(argv)

    with open(args.config) as f:
        section = yaml.safe_load(f)["ThinPosterior"]
    thin_posterior(args.samples, args.output, section)


if __name__ == "__main__":
    main()
