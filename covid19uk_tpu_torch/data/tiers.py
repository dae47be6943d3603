"""COVID alert-tier covariate ETL.

Covers the reference's ``TierData`` strategy class
(the reference's ``covid19uk/data/tiers.py``; port of
``covid19uk_tpu/data/tiers.py``): turns a long table of
per-LAD lockdown tiers into a ``[date, location, level]`` 0/1 indicator
tensor of policy factors (a :class:`TierArray`; ``to_xarray()`` for interop).

Input modes: ``csv`` (local file) and ``api`` (the gov.uk alert-level feed —
needs network egress, deferred import like the other loaders).  Adapt
formats: ``tidy`` (long ``code``/``date``/``tier`` with the post-2020-12-02
tier renaming rule, tiers.py:116-121) and ``api``
(``areaCode``/``alertLevel``, daily-reindexed with forward/backward fill,
tiers.py:86-92).  The reference's ``lancs*`` formats call a ``LancsData``
class that is not defined anywhere in the package — a ``NameError`` on any
invocation (tiers.py:166-172) — so that dead path is not rebuilt.

The indicator tensor is built by direct one-hot scatter over
``(date, code, level)`` integer indices instead of the reference's
pandas-MultiIndex ``Series.to_xarray`` round-trip; this also removes the
fake-``TESTLAD``-row workaround the reference needs to force all tier
levels to appear (tiers.py:127-137).
"""

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import pandas as pd

from covid19uk_tpu_torch.data.area_code import AreaCodeData
from covid19uk_tpu_torch.data.util import (
    get_date_low_high,
    invalid_input,
    merge_lad_codes,
)


@dataclass
class TierArray:
    """A labeled [date, location, level] indicator tensor.

    xarray is not a dependency of this package (nor is netCDF4: see
    utils/ncio.py), so the reference's ``xarray.DataArray`` return type is
    replaced by this minimal coordinate-indexed array with the two access
    patterns the pipeline needs (``sel`` and ``sum``) plus a gated
    ``to_xarray()`` for interop where xarray *is* installed.
    """

    values: np.ndarray
    dims: Tuple[str, ...]
    coords: Dict[str, np.ndarray] = field(default_factory=dict)
    name: str = "value"

    @property
    def shape(self):
        return self.values.shape

    def _axis_index(self, dim, value):
        coord = np.asarray(self.coords[dim])
        if coord.dtype.kind == "M":
            value = np.datetime64(value)
        hits = np.nonzero(coord == value)[0]
        if hits.size != 1:
            raise KeyError(f"{value!r} not a unique {dim} coordinate")
        return int(hits[0])

    def sel(self, **kwargs):
        """Selects by coordinate value along named dims, dropping them."""
        out_vals = self.values
        out_dims = list(self.dims)
        out_coords = dict(self.coords)
        for dim, value in kwargs.items():
            axis = out_dims.index(dim)
            out_vals = np.take(
                out_vals, self._axis_index(dim, value), axis=axis
            )
            out_dims.pop(axis)
            out_coords.pop(dim, None)
        return TierArray(out_vals, tuple(out_dims), out_coords, self.name)

    def sum(self, dim=None):
        if dim is None:
            return TierArray(
                np.asarray(self.values.sum()), (), {}, self.name
            )
        axis = self.dims.index(dim)
        dims = self.dims[:axis] + self.dims[axis + 1:]
        coords = {d: c for d, c in self.coords.items() if d != dim}
        return TierArray(self.values.sum(axis=axis), dims, coords, self.name)

    def item(self):
        return self.values.item()

    def to_xarray(self):
        import xarray  # deferred: an optional dependency

        return xarray.DataArray(
            self.values, dims=self.dims, coords=self.coords, name=self.name
        )

_GOV_ALERT_API = (
    "https://api.coronavirus.data.gov.uk/v2/data"
    "?areaType=ltla&metric=alertLevel&format=csv"
)
_DECEMBER_SPLIT = np.datetime64("2020-12-02")


def _one_hot(dates, codes, levels, d_idx, c_idx, l_idx):
    """[len(dates), len(codes), len(levels)] float indicator with ones at
    the given (row-aligned) index triples; duplicates collapse to 1."""
    arr = np.zeros((len(dates), len(codes), len(levels)), np.float64)
    arr[d_idx, c_idx, l_idx] = 1.0
    return arr


class TierData:
    @staticmethod
    def get(config):
        settings = config["TierData"]
        mode = settings["input"]
        if mode == "csv":
            return pd.read_csv(settings["address"])
        if mode == "api":
            import requests  # deferred: offline environments never import

            from io import StringIO

            response = requests.get(_GOV_ALERT_API, timeout=30)
            response.raise_for_status()
            return pd.read_csv(StringIO(response.text))
        invalid_input(mode)

    @staticmethod
    def check(data_array, config):
        """Format check — the reference's is a stub returning True
        (tiers.py:32-36); kept as the extension point."""
        return True

    @staticmethod
    def adapt(df, config):
        settings = config["TierData"]
        if "lad19cds" in config:
            lads = list(config["lad19cds"])
        else:
            lads = AreaCodeData.process(config)["lad19cd"].tolist()
        date_low, date_high = get_date_low_high(config)

        fmt = settings["format"].lower()
        if fmt == "tidy":
            return TierData._adapt_tidy(
                df, date_low, date_high, lads, settings["lockdown_states"]
            )
        if fmt == "api":
            return TierData._adapt_api(df, date_low, date_high, lads)
        invalid_input(fmt)

    @staticmethod
    def _adapt_api(df, date_low, date_high, lads):
        """gov.uk alert-level feed -> [date, lad19cd, alert_level] one-hot.

        The feed is sparse in time (a row only when a LAD's level changes);
        levels are forward-filled onto the daily inference grid and
        back-filled before the first observation (tiers.py:86-92)."""
        long = pd.DataFrame(
            {
                "date": pd.to_datetime(df["date"], format="%Y-%m-%d"),
                "lad19cd": merge_lad_codes(df["areaCode"]),
                "alert_level": df["alertLevel"].astype(int),
            }
        )
        if lads:
            long = long[long["lad19cd"].isin(lads)]
        long = long.drop_duplicates()

        wide = long.pivot(
            index="date", columns="lad19cd", values="alert_level"
        ).sort_index()
        grid = pd.date_range(date_low, date_high - np.timedelta64(1, "D"))
        # Forward-fill over the union index, slice to the grid, THEN
        # backfill — so a level observed strictly after date_high cannot
        # leak backward into the window (the reference backfills only
        # within the grid; tiers.py:86-92).
        wide = wide.reindex(grid.union(wide.index)).ffill()
        wide = wide.loc[grid].bfill()

        codes = list(wide.columns)
        vals = wide.to_numpy()  # [D, C]
        # Level axis from the values actually present on the grid — a level
        # observed only outside [date_low, date_high) must not create an
        # all-zero slice (the reference's MultiIndex is built post-reindex).
        levels = np.unique(vals[~np.isnan(vals)].astype(int))
        d_idx, c_idx = np.nonzero(~np.isnan(vals))
        l_idx = np.searchsorted(levels, vals[d_idx, c_idx].astype(int))
        arr = _one_hot(grid, codes, levels, d_idx, c_idx, l_idx)
        return TierArray(
            arr,
            dims=("date", "lad19cd", "alert_level"),
            coords={
                "date": grid.to_numpy(),
                "lad19cd": np.asarray(codes),
                "alert_level": levels.astype(np.int64),
            },
        )

    @staticmethod
    def _adapt_tidy(df, date_low, date_high, lads, lockdown_states):
        """Long code/date/tier table -> [date, code, tier] one-hot over the
        configured ``lockdown_states`` level list.

        Tiers announced after 2020-12-02 are distinct policy regimes and are
        renamed ``dec_<tier>`` before encoding (tiers.py:116-121).  The date
        axis is the dates present in the (filtered) table plus ``date_low``
        (the reference never reindexes this format, but its TESTLAD rows
        pin date_low onto the axis)."""
        sub = df.assign(
            date=pd.to_datetime(df["date"], format="%Y-%m-%d"),
            code=merge_lad_codes(df["code"]),
            tier=df["tier"].astype(str),
        )
        renamed = sub["tier"].where(
            sub["date"].to_numpy() <= _DECEMBER_SPLIT, "dec_" + sub["tier"]
        )
        # Only the base tiers split at December (tiers.py:116-118).
        sub["tier"] = renamed.where(
            sub["tier"].isin(["one", "two", "three"]), sub["tier"]
        )
        if lads:
            sub = sub[sub["code"].isin(lads)]
        in_span = (sub["date"].to_numpy() >= date_low) & (
            sub["date"].to_numpy() < date_high
        )
        sub = sub[in_span].drop_duplicates(["date", "code", "tier"])

        # The reference's TESTLAD injection (tiers.py:127-137) dates its
        # fake rows at date_low, which forces date_low onto the date axis
        # even when no real row falls on it — keep that axis shape.
        dates = np.union1d(
            sub["date"].unique(), np.asarray([date_low], "datetime64[ns]")
        )
        codes = np.sort(sub["code"].unique())
        levels = list(lockdown_states)
        # Rows whose tier is outside lockdown_states still define the
        # date/code axes (the reference one-hots everything, then selects
        # the lockdown columns, tiers.py:139-146) but contribute no ones.
        keep = sub["tier"].isin(levels).to_numpy()
        d_idx = np.searchsorted(dates, sub["date"].to_numpy()[keep])
        c_idx = np.searchsorted(codes, sub["code"].to_numpy()[keep])
        level_pos = {t: i for i, t in enumerate(levels)}
        l_idx = np.array(
            [level_pos[t] for t in sub["tier"].to_numpy()[keep]], np.intp
        )
        arr = _one_hot(dates, codes, levels, d_idx, c_idx, l_idx)
        return TierArray(
            arr,
            dims=("date", "code", "tier"),
            coords={
                "date": dates,
                "code": codes,
                "tier": np.asarray(levels, object),
            },
        )

    @staticmethod
    def process(config):
        fmt = config["TierData"]["format"].lower()
        if fmt.startswith("lancs"):
            raise NotImplementedError(
                "The reference's 'lancs*' tier formats call an undefined "
                "LancsData class (reference tiers.py:166-172 raises "
                "NameError); dead path, not rebuilt."
            )
        df = TierData.get(config)
        data_array = TierData.adapt(df, config)
        if TierData.check(data_array, config):
            return data_array
