"""Data-layer validators, LAD-code merging, and filename decoration.

Port of ``covid19uk_tpu/data/util.py``, itself the reference's
``covid19uk/data/util.py`` (merge map
``util.py:40-49``, validators ``util.py:57-91``, filename helpers
``util.py:10-37``).
"""

import datetime as _datetime
import os
import re

import numpy as np
import pandas as pd

# Merged LADs become one combined location whose code is the comma-joined
# pair (reference data/util.py:40-49).
_MERGE_MAP = {
    "E06000052": "E06000052,E06000053",  # Cornwall & Isles of Scilly
    "E06000053": "E06000052,E06000053",
    "E09000001": "E09000001,E09000033",  # City of London & Westminster
    "E09000033": "E09000001,E09000033",
}


def merge_lad_codes(lad19cd):
    if isinstance(lad19cd, pd.Series):
        return lad19cd.apply(lambda x: _MERGE_MAP.get(x, x))
    return [_MERGE_MAP.get(x, x) for x in lad19cd]


def merge_lad_values(df):
    """Sums values over merged LAD codes (reference data/util.py:52-54)."""
    return df.groupby("lad19cd").sum().reset_index()


def get_date_low_high(config):
    """Parses the config date range into numpy datetimes."""
    return tuple(np.datetime64(x) for x in config["date_range"])


def check_date_format(df):
    df = df.reset_index()
    if (
        not pd.to_datetime(df["date"], format="%Y-%m-%d", errors="coerce")
        .notnull()
        .all()
    ):
        raise ValueError("Invalid date format")
    return True


def check_date_bounds(df, date_low, date_high):
    if not ((date_low <= df["date"]) & (df["date"] < date_high)).all():
        raise ValueError("Date out of bounds")
    return True


def check_lad19cd_format(df):
    """One region letter followed by 8 digits; merged comma-joined pairs of
    such codes also pass (reference data/util.py:82-92)."""
    df = df.reset_index()
    pattern = re.compile(r"^[ENSW]\d{8}(,[ENSW]\d{8})*$")
    ok = df["lad19cd"].astype(str).apply(lambda x: bool(pattern.match(x)))
    if not ok.all():
        raise ValueError("Invalid lad19cd format")
    return True


def invalid_input(value):
    raise NotImplementedError(f'Input type "{value}" mode not implemented')


def prepend_date(filename, today=None):
    """``<YYYY-MM-DD>_<filename>`` (reference ``util.py:10-13``, whose
    ``datetime.now()`` call on the *module* is a latent AttributeError —
    fixed here).  ``today`` is injectable for tests."""
    today = today or _datetime.date.today()
    return f"{today.strftime('%Y-%m-%d')}_{filename}"


def prepend_id(filename, config):
    """``<Global.prependID_Str>_<filename>`` (reference ``util.py:16-17``)."""
    return f"{config['Global']['prependID_Str']}_{filename}"


def format_input_filename(filename, config):
    """Applies the configured run-ID prefix to an input path's basename
    (reference ``util.py:20-27``)."""
    path, base = os.path.split(filename)
    if config["Global"]["prependID"]:
        base = prepend_id(base, config)
    return os.path.join(path, base)


def format_output_filename(filename, config, today=None):
    """Applies run-ID and date prefixes to an output path's basename
    (reference ``util.py:30-37``)."""
    path, base = os.path.split(filename)
    if config["Global"]["prependID"]:
        base = prepend_id(base, config)
    if config["Global"]["prependDate"]:
        base = prepend_date(base, today)
    return os.path.join(path, base)
