"""Package version.

Port of ``covid19uk_tpu/version.py`` (pure Python, copied so that the port
does not import the JAX package): resolved from the installed
distribution's metadata when available, falling back to the in-tree
pyproject.toml, then to the hardcoded default.
"""

VERSION = "0.1.0"


def _version():
    try:
        from importlib.metadata import version

        return version("covid19uk_tpu")
    except Exception:
        pass
    try:
        import pathlib
        import tomllib

        pyproject = pathlib.Path(__file__).parent.parent / "pyproject.toml"
        with open(pyproject, "rb") as f:
            return tomllib.load(f)["project"]["version"]
    except Exception:
        return VERSION


VERSION = _version()
