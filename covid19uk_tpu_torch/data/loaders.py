"""Covariate loaders: mobility matrix, population, traffic flow.

Port of ``covid19uk_tpu/data/loaders.py``, the live loaders of the
reference's ``covid19uk/data/loaders.py``
(the dead PHE line-listing and tier readers are intentionally not rebuilt —
SURVEY.md §2.3).  All host-side pandas; returns plain numpy + index labels.
"""

import numpy as np
import pandas as pd


def read_mobility(path, locations=None):
    """Census commuting CSV (Flow, From, To) -> dense [M, M] matrix.

    Pivots to ``[dest, src]`` sorted by LAD code on both axes
    (reference loaders.py:17-41).

    Returns:
      (matrix [M, M] float, codes list) — rows=dest, cols=src.
    """
    mobility = pd.read_csv(path)
    mobility = mobility.rename(columns={"From": "src", "To": "dest"})
    if locations is not None:
        mobility = mobility[
            mobility["src"].isin(locations) & mobility["dest"].isin(locations)
        ]
    mobility = mobility.sort_values(["src", "dest"])
    mobility = (
        mobility.groupby(["src", "dest"]).agg({"Flow": "sum"}).reset_index()
    )
    mob_matrix = mobility.pivot(index="dest", columns="src", values="Flow")
    mob_matrix[mob_matrix.isna()] = 0.0
    # Ensure square and aligned
    codes = sorted(set(mob_matrix.index) | set(mob_matrix.columns))
    mob_matrix = mob_matrix.reindex(
        index=codes, columns=codes, fill_value=0.0
    )
    return mob_matrix.to_numpy(np.float64), list(codes)


def read_population(path, locations=None):
    """Age-structured population CSV summed over age columns
    (reference loaders.py:44-57).

    Returns:
      (population [M] float, codes list) sorted by LAD code.
    """
    pop = pd.read_csv(path, index_col="lad19cd")
    if locations is not None:
        pop = pop[pop.index.isin(locations)]
    pop = pop.sum(axis=1)
    pop = pop.sort_index()
    return pop.to_numpy(np.float64), list(pop.index)


def read_traffic_flow(path, date_low, date_high):
    """DfT traffic-flow spreadsheet -> daily relative flow series.

    ``path=None`` returns an all-ones series — the documented fallback the
    NI example exercises (reference loaders.py:60-91, example_config.yaml:9).

    Returns:
      (flow [T] float, dates [T] datetime64)
    """
    dates = np.arange(date_low, date_high, np.timedelta64(1, "D"))
    if path is None:
        return np.ones(dates.shape[0], np.float64), dates

    if str(path).endswith((".xls", ".xlsx")):
        commute_raw = pd.read_excel(
            path, index_col="Date", skiprows=5, usecols=["Date", "Cars"]
        )
    else:
        commute_raw = pd.read_csv(path, index_col="Date")
        commute_raw = commute_raw[["Cars"]]
    commute_raw.index = pd.to_datetime(commute_raw.index, format="%Y-%m-%d")
    series = commute_raw["Cars"].sort_index()
    # Align onto the requested daily grid: dates the spreadsheet covers map
    # directly; dates before/after its span clamp to the first/last
    # observation (dates *inside* the span but absent stay NaN, matching
    # the reference's left-merge behavior, loaders.py:75-91).
    flow = np.array(series.reindex(dates).to_numpy(), np.float64)
    flow[dates < series.index[0].to_datetime64()] = float(series.iloc[0])
    flow[dates > series.index[-1].to_datetime64()] = float(series.iloc[-1])
    return flow / 100.0, dates
