"""CLI entry point: ``python -m covid19uk_tpu_torch.inference.inference``.

Port of ``covid19uk_tpu/inference/inference.py`` (the reference CLI,
``-c config.yaml -o posterior.h5 data.h5``), plus ``--device``: the run is
on the card unless ``--device cpu`` asks for the CPU.  Reads the YAML's
``Mcmc`` section; needs PyYAML and h5py.
"""

from covid19uk_tpu_torch.inference.driver import mcmc, run_mcmc  # noqa: F401


def main(argv=None):
    from argparse import ArgumentParser

    import yaml

    parser = ArgumentParser(description="Run MCMC inference algorithm")
    parser.add_argument(
        "-c", "--config", type=str, help="Config file", required=True
    )
    parser.add_argument(
        "-o", "--output", type=str, help="Output file", required=True
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device of the run (default cuda; cpu for the CPU)",
    )
    parser.add_argument("data_file", type=str, help="Data HDF5 file")
    args = parser.parse_args(argv)

    with open(args.config, "r") as f:
        config = yaml.safe_load(f)

    mcmc(args.data_file, args.output, config["Mcmc"], device=args.device)


if __name__ == "__main__":
    main()
