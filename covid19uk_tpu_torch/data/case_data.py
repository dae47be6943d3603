"""COVID-19 case-count retrieval.

Port of ``covid19uk_tpu/data/case_data.py``, the live path of the
reference's ``covid19uk/data/case_data.py``:
the gov-API format (url with exponential-backoff retry / csv / processed
input modes), reindexed to the full ``[location, time]`` grid with 0-fill.
The confidential PHE line-listing path (``adapt_phe``) is dead in the main
pipeline and not rebuilt (SURVEY.md §2.3).
"""

import json
import time
from warnings import warn

import pandas as pd

from covid19uk_tpu_torch.data.area_code import AreaCodeData
from covid19uk_tpu_torch.data.util import (
    get_date_low_high,
    invalid_input,
    merge_lad_codes,
)


class CasesData:
    @staticmethod
    def get(config):
        settings = config["CasesData"]
        mode = settings["input"]
        if mode == "url":
            return CasesData.get_url(settings["address"])
        if mode == "csv":
            return pd.read_csv(settings["address"])
        if mode == "processed":
            return pd.read_csv(settings["address"], index_col=[0, 1])
        invalid_input(mode)

    @staticmethod
    def get_url(url, max_tries=5, base_delay=5):
        """gov-API fetch with exponential-backoff retry
        (reference case_data.py:44-65)."""
        import requests  # deferred: offline environments never import this

        for i in range(max_tries):
            try:
                response = requests.get(url)
                content = json.loads(response.content)
                return pd.DataFrame.from_dict(content["body"])
            except Exception as e:  # noqa: BLE001 — retry loop
                warn(f"Attempt {i + 1} failed: {e}")
                time.sleep(base_delay * 2**i)
        raise ConnectionError(
            f"Data download timed out after {max_tries} attempts"
        )

    @staticmethod
    def adapt(df, config):
        settings = config["CasesData"]
        if settings["input"] == "processed":
            ser = df.iloc[:, 0]
            ser.index.names = ["location", "time"]
            ser.name = "cases"
            return ser
        date_low, date_high = get_date_low_high(config)
        if "lad19cds" not in config:
            AreaCodeData.process(config)
        areacodes = config["lad19cds"]
        if settings["format"].lower() == "gov":
            return CasesData.adapt_gov_api(df, date_low, date_high, areacodes)
        raise NotImplementedError(settings["format"])

    @staticmethod
    def adapt_gov_api(df, date_low, date_high, areacodes):
        """Tabulates the API frame onto the full [location, time] grid.

        Same contract as the reference's reindex recipe
        (case_data.py:135-154): LAD codes merged, duplicates summed,
        missing (location, date) cells 0-filled, ``[date_low, date_high)``
        half-open — expressed here as a location x date pivot re-stacked
        into the series layout the ETL writes.
        """
        dates = pd.date_range(date_low, date_high, inclusive="left")
        cases = pd.DataFrame(
            {
                "location": merge_lad_codes(df["areaCode"]),
                "date": pd.to_datetime(df["date"]),
                "cases": df["newCasesBySpecimenDate"].astype(float),
            }
        )
        table = (
            cases[cases["location"].isin(areacodes)]
            .pivot_table(
                index="location",
                columns="date",
                values="cases",
                aggfunc="sum",
                fill_value=0.0,
            )
            .reindex(index=list(areacodes), columns=dates, fill_value=0.0)
        )
        ser = table.stack()
        ser.index.names = ["location", "time"]
        ser.name = "cases"
        return ser

    @staticmethod
    def process(config):
        df = CasesData.get(config)
        return CasesData.adapt(df, config)
