"""Legacy config-file helpers.

Covers the reference's remaining ``util.py`` config utilities
(the reference's ``covid19uk/util.py:25-54``; port of
``covid19uk_tpu/utils/settings.py``): a YAML loader and the
parameter/settings sanitisers its early pipelines used.  The framework's
own entry points use the typed, validated :mod:`covid19uk_tpu_torch.config`
dataclasses instead; these exist for users migrating scripts that called
the reference helpers directly.
"""

import numpy as np

__all__ = ["load_config", "sanitise_parameter", "sanitise_settings"]


def load_config(config_filename):
    """Loads a YAML config file (reference ``util.py:25-27``; ``safe_load``
    rather than ``FullLoader`` — configs are data, not Python objects)."""
    import yaml

    with open(config_filename) as f:
        return yaml.safe_load(f)


def sanitise_parameter(par_dict):
    """Coerces every parameter value to ``np.float64``
    (reference ``util.py:30-33``)."""
    return {key: np.float64(val) for key, val in par_dict.items()}


def sanitise_settings(par_dict):
    """Coerces the settings section's date ranges / holiday / lockdown lists
    to numpy datetimes and ``time_step`` to float
    (reference ``util.py:36-53``)."""
    return {
        "inference_period": np.array(
            par_dict["inference_period"], dtype=np.datetime64
        ),
        "prediction_period": np.array(
            par_dict["prediction_period"], dtype=np.datetime64
        ),
        "time_step": float(par_dict["time_step"]),
        "holiday": np.array(
            [np.datetime64(d) for d in par_dict["holiday"]]
        ),
        "lockdown": np.array(
            [np.datetime64(d) for d in par_dict["lockdown"]]
        ),
    }
