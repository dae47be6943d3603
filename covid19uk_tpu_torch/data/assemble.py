"""ETL orchestrator: config -> inferencedata HDF5.

Port of ``covid19uk_tpu/data/assemble.py``, itself the reference's
``covid19uk/data/assemble.py`` +
``model_spec.gather_data`` (model_spec.py:49-105).  Output file has groups
``constant_data`` (C, W, N, adjacency, weekday, area, locations) and
``observations`` (cases), interoperable with the rest of the pipeline.

Adjacency / area sourcing: the reference derives both from a geopackage of
LAD polygons (model_spec.py:29-46,66-77) that is a missing large blob
upstream and requires geopandas (not a dependency of this package).
Sources supported:

* ``geopackage`` + geopandas installed -> polygon distance < 200 m,
  exactly the reference's rule (gated import);
* ``adjacency_file`` / ``area_file`` CSVs (lad19cd, value);
* fallback: adjacency from symmetrized mobility > 0, equal areas
  (centred log-area is then identically zero, making beta_area inert —
  documented capability caveat, SURVEY.md §7 hard part 5).
"""

import numpy as np
import pandas as pd

from covid19uk_tpu_torch.data.area_code import AreaCodeData
from covid19uk_tpu_torch.data.case_data import CasesData
from covid19uk_tpu_torch.data.loaders import (
    read_mobility,
    read_population,
    read_traffic_flow,
)
from covid19uk_tpu_torch.data.util import get_date_low_high
from covid19uk_tpu_torch.utils import ncio


def _compute_adjacency_from_geopackage(path, layer, lad19cds, tol=200):
    """Polygon-distance adjacency (reference model_spec.py:29-46).
    Requires geopandas; only reachable when it is installed."""
    import geopandas as gp

    geo = gp.read_file(path, layer=layer)
    geo = geo.sort_values("lad19cd")
    geo = geo[geo["lad19cd"].isin(lad19cds)]
    geom = geo.geometry
    mat = geom.apply(lambda x: geom.distance(x) < tol).to_numpy()
    np.fill_diagonal(mat, False)
    num_neighbours = mat.sum(axis=-1)
    islands = np.where(num_neighbours == 0)[0]
    closest = [geom.distance(geom.iloc[i]).argsort()[1] for i in islands]
    mat[islands, closest] = True
    mat = mat | mat.T
    return mat.astype(np.float64), geo.area.to_numpy(np.float64)


def _load_keyed_csv(path, lad19cds, value_col=None):
    df = pd.read_csv(path, index_col="lad19cd")
    df = df[df.index.isin(lad19cds)].sort_index()
    col = value_col or df.columns[0]
    return df[col].to_numpy(np.float64)


def gather_data(config):
    """Loads all covariates; returns (constant_data, observations) Groups."""
    date_low, date_high = get_date_low_high(config)
    locations = AreaCodeData.process(config)
    lad19cds = config["lad19cds"]

    mobility, mob_codes = read_mobility(config["mobility_matrix"], lad19cds)
    popsize, pop_codes = read_population(config["population_size"], lad19cds)
    if mob_codes != pop_codes:
        raise ValueError(
            "Mobility and population files cover different LAD sets: "
            f"{sorted(set(mob_codes) ^ set(pop_codes))[:5]}"
        )
    flow, flow_dates = read_traffic_flow(
        config.get("commute_volume"), date_low, date_high
    )

    M = len(mob_codes)
    if config.get("geopackage"):
        adjacency, area = _compute_adjacency_from_geopackage(
            config["geopackage"],
            config.get("geopackage_layer", "UK2019mod_pop_xgen"),
            mob_codes,
        )
    else:
        adjacency = (
            ((mobility + mobility.T) > 0).astype(np.float64)
            if not config.get("adjacency_file")
            else None
        )
        if config.get("adjacency_file"):
            adj_df = pd.read_csv(config["adjacency_file"], index_col=0)
            adj_df = adj_df.loc[mob_codes, mob_codes]
            adjacency = adj_df.to_numpy(np.float64)
        np.fill_diagonal(adjacency, 0.0)
        # guard isolated locations (CAR precision must stay full-rank)
        isolated = np.where(adjacency.sum(-1) == 0)[0]
        for i in isolated:
            j = int(np.argsort(-mobility[i])[0])
            if j == i:
                j = (i + 1) % M
            adjacency[i, j] = adjacency[j, i] = 1.0
        area = (
            _load_keyed_csv(config["area_file"], mob_codes)
            if config.get("area_file")
            else np.full(M, 1.0e8)
        )

    dates = np.arange(date_low, date_high, np.timedelta64(1, "D"))
    weekday = (
        (dates.astype("datetime64[D]").view("int64") + 3) % 7 < 5
    ).astype(np.float64)

    cases_ser = CasesData.process(config)
    cases = (
        cases_ser.unstack(level="time")
        .reindex(index=mob_codes)
        .to_numpy(np.float64)
    )

    name_by_code = dict(zip(locations["lad19cd"], locations["name"]))
    constant = ncio.Group(
        variables=dict(
            C=mobility,
            W=flow,
            N=popsize,
            adjacency=adjacency,
            weekday=weekday,
            area=area,
            locations=np.asarray(
                [name_by_code.get(c, "n/a") for c in mob_codes], dtype="S"
            ),
        ),
        dims=dict(
            C=("location", "location_dest"),
            W=("time",),
            N=("location",),
            adjacency=("location", "location_dest"),
            weekday=("time",),
            area=("location",),
            locations=("location",),
        ),
        coords=dict(location=np.asarray(mob_codes, dtype="S"), time=dates),
    )
    observations = ncio.Group(
        variables=dict(cases=cases),
        dims=dict(cases=("location", "time")),
        coords=dict(location=np.asarray(mob_codes, dtype="S"), time=dates),
    )
    return constant, observations


def assemble_data(output_file, config):
    """Runs the ETL and writes the inferencedata file
    (reference assemble.py:8-16)."""
    constant, observations = gather_data(config)
    ncio.save_group(output_file, "constant_data", constant, mode="w")
    ncio.save_group(output_file, "observations", observations)
    return constant, observations


def main(argv=None):
    from argparse import ArgumentParser

    import yaml

    parser = ArgumentParser(description="Assemble inference data")
    parser.add_argument("config", type=str, help="Config file")
    parser.add_argument("output_file", type=str, help="Output HDF5 file")
    args = parser.parse_args(argv)

    with open(args.config, "r") as f:
        config = yaml.safe_load(f)

    assemble_data(args.output_file, config["ProcessData"])


if __name__ == "__main__":
    main()
