"""Data/ETL layer: area codes, case counts, covariate loaders, assembly."""

from covid19uk_tpu_torch.data.area_code import AreaCodeData
from covid19uk_tpu_torch.data.case_data import CasesData
from covid19uk_tpu_torch.data.loaders import (
    read_mobility,
    read_population,
    read_traffic_flow,
)

__all__ = [
    "AreaCodeData",
    "CasesData",
    "read_mobility",
    "read_population",
    "read_traffic_flow",
]
