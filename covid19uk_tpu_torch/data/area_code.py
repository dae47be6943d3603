"""LAD19 area-code retrieval and filtering.

Port of ``covid19uk_tpu/data/area_code.py``, itself the reference's
``covid19uk/data/area_code.py`` (strategy class with
url / json / csv / processed input modes, ONS-format adaptation, region
filter, LAD merging).  The census-merged 2011->2019 mapping path
(``area_code.py:73-133``) is dead in the main pipeline and not rebuilt.
"""

import json

import pandas as pd

from covid19uk_tpu_torch.data.util import (
    check_lad19cd_format,
    invalid_input,
    merge_lad_codes,
)


class AreaCodeData:
    @staticmethod
    def get(config):
        settings = config["AreaCodeData"]
        mode = settings["input"]
        if mode == "url":
            df = AreaCodeData.get_url(settings["address"], config)
            df.columns = [x.lower() for x in df.columns]
        elif mode == "json":
            df = AreaCodeData.get_json(settings["address"])
        elif mode == "csv":
            df = pd.read_csv(settings["address"])
        elif mode == "processed":
            df = pd.read_csv(settings["address"])
        else:
            invalid_input(mode)
        return df

    @staticmethod
    def get_url(url, config):
        """ONS ArcGIS API fetch (reference area_code.py:55-71); requires
        network egress — offline environments use json/csv/processed."""
        import requests  # deferred: offline environments never import this

        settings = config["AreaCodeData"]
        fields = ["LAD19CD", "LAD19NM"]
        api_params = {"outFields": ",".join(fields), "f": "json"}
        response = requests.get(url, params=api_params, timeout=5)
        if response.status_code >= 400:
            raise RuntimeError(f"Request failed: {response.text}")
        if settings["format"] == "ons":
            return AreaCodeData.get_json_str(response.text)
        raise NotImplementedError(settings["format"])

    @staticmethod
    def get_json(file):
        with open(file) as f:
            return AreaCodeData.get_json_str(f.read())

    @staticmethod
    def get_json_str(text):
        data = json.loads(text)["features"]
        records = [rec["attributes"] for rec in data]
        return pd.DataFrame.from_records(records)

    @staticmethod
    def adapt(df, config):
        settings = config["AreaCodeData"]
        if settings["input"] == "processed":
            return df
        if settings["format"].lower() == "ons":
            df = AreaCodeData.adapt_ons(df, settings["regions"])
        if "lad19cds" in config:
            df = df[df["lad19cd"].isin(config["lad19cds"])]
        return df

    @staticmethod
    def adapt_ons(df, regions):
        df = df.copy()
        df.columns = ["lad19cd", "name"]
        df = df[df["lad19cd"].str.contains("|".join(regions))]
        df["lad19cd"] = merge_lad_codes(df["lad19cd"])
        df = df.drop_duplicates(subset="lad19cd")
        return df

    @staticmethod
    def process(config):
        """get -> adapt -> check; records the code list into the config
        (side-channel preserved for parity: reference area_code.py:180-185,
        consumed by CasesData at case_data.py:117-119)."""
        df = AreaCodeData.get(config)
        df = AreaCodeData.adapt(df, config)
        check_lad19cd_format(df)
        config["lad19cds"] = df["lad19cd"].tolist()
        return df
