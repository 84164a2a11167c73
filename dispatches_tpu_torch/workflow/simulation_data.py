"""Sweep-output parsing for market-surrogate training (a copy of
``dispatches_tpu/workflow/simulation_data.py``: numpy and pandas only).

Capability counterpart of the reference's
``workflow/train_market_surrogates/dynamic/Simulation_Data.py``
(:22-432): reads Prescient sweep outputs (csv dispatch series + h5 input
tables), scales annual dispatch into capacity factors per case family
(RE by wind pmax :246-278, NE by swept pmin :221-244, FE by plant+storage
pmax with the >1 band compressed into [1, 1.2] :305-336), and exposes
revenue/wind readers for surrogate labels (:369-432).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

# RTS-GMLC wind generators and nameplate capacities (reference
# Simulation_Data.py:246-259)
WIND_GEN_PMAX = {
    "309_WIND_1": 148.3,
    "317_WIND_1": 799.1,
    "303_WIND_1": 847.0,
    "122_WIND_1": 713.5,
}

_FE_PMAX = 436.0
_FE_PMIN = 284.0
_NE_PMAX = 400.0


class SimulationData:
    def __init__(self, dispatch_data_file, input_data_file, num_sims, case_type):
        self.dispatch_data_file = dispatch_data_file
        self.input_data_file = input_data_file
        self.num_sims = num_sims
        self.case_type = case_type
        self.read_data_to_dict()

    # -- validated properties (reference :52-135) ---------------------

    @property
    def num_sims(self) -> int:
        return self._num_sims

    @num_sims.setter
    def num_sims(self, value):
        if not isinstance(value, int):
            raise TypeError(
                f"num_sims expects a positive int (simulation years); "
                f"got {type(value).__name__}"
            )
        if value < 1:
            raise ValueError(
                f"num_sims expects a positive int (simulation years); got {value}"
            )
        self._num_sims = value

    @property
    def case_type(self) -> str:
        return self._case_type

    @case_type.setter
    def case_type(self, value):
        if not isinstance(value, str):
            raise TypeError(
                f"case_type expects a str; got {type(value).__name__}"
            )
        if value not in ("RE", "NE", "FE"):
            raise ValueError(
                f"case_type must be 'RE', 'NE' or 'FE'; got {value!r}"
            )
        self._case_type = value

    # -- readers (reference :138-218) ---------------------------------

    def _read_data_to_array(self) -> Tuple[np.ndarray, List[int]]:
        df = pd.read_csv(self.dispatch_data_file, nrows=self.num_sims)
        data = df.iloc[:, 1:].to_numpy(dtype=float)
        index = [
            int(re.split(r"_|\.", str(run))[1]) for run in df.iloc[:, 0]
        ]
        return data, index

    @staticmethod
    def _read_input_table(path) -> pd.DataFrame:
        """Read the sweep-input table: pandas HDF when pytables is
        available, else an h5py reader for the pandas 'fixed' layout
        (df/axis0 column names + df/block0_values), else plain csv."""
        p = str(path)
        if p.endswith((".h5", ".hdf", ".hdf5")):
            try:
                return pd.read_hdf(p)
            except ImportError:
                import h5py

                with h5py.File(p, "r") as f:
                    g = f[next(iter(f.keys()))]  # sole top-level group
                    axis0 = [c.decode() for c in g["axis0"][:]]
                    cols = {}
                    i = 0
                    while f"block{i}_items" in g:
                        items = [c.decode() for c in g[f"block{i}_items"][:]]
                        vals = g[f"block{i}_values"][:]
                        for j, name in enumerate(items):
                            cols[name] = vals[:, j]
                        i += 1
                return pd.DataFrame({c: cols[c] for c in axis0})
        return pd.read_csv(p)

    def read_data_to_dict(self):
        dispatch_array, index = self._read_data_to_array()
        dispatch_dict = {idx: dispatch_array[n] for n, idx in enumerate(index)}

        df_input = self._read_input_table(self.input_data_file)
        num_col = df_input.shape[1]
        X = df_input.iloc[index, list(range(1, num_col))].to_numpy()
        input_data_dict = {idx: x for idx, x in zip(index, X)}

        self._dispatch_dict = dispatch_dict
        self._input_data_dict = input_data_dict
        self._index = index
        return dispatch_dict, input_data_dict

    # -- per-case scaling (reference :221-336) ------------------------

    def _read_NE_pmin(self) -> Dict[int, float]:
        return {
            idx: _NE_PMAX - _NE_PMAX * self._input_data_dict[idx][1]
            for idx in self._index
        }

    def _read_RE_pmax(self, wind_gen: str = "303_WIND_1") -> float:
        if wind_gen not in WIND_GEN_PMAX:
            raise NameError(f"wind generator name {wind_gen} is invalid.")
        return WIND_GEN_PMAX[wind_gen]

    def _read_FE_pmax(self) -> Dict[int, float]:
        return {
            idx: _FE_PMAX + self._input_data_dict[idx][1]
            for idx in self._index
        }

    def _scale_data(self) -> Dict[int, np.ndarray]:
        scaled = {}
        if self.case_type == "FE":
            pmax_dict = self._read_FE_pmax()
            for idx in self._index:
                cf = (self._dispatch_dict[idx] - _FE_PMIN) / (_FE_PMAX - _FE_PMIN)
                over = cf > 1.0
                # storage-deployed hours: compress the >1 band to [1, 1.2]
                # (reference :330-336)
                denom = pmax_dict[idx] - _FE_PMAX
                if np.any(over) and denom > 0:
                    cf = np.where(
                        over,
                        (cf - 1.0) * (_FE_PMAX - _FE_PMIN) / denom * 0.2 + 1.0,
                        cf,
                    )
                scaled[idx] = cf
        elif self.case_type == "NE":
            pmin_dict = self._read_NE_pmin()
            for idx in self._index:
                pmin = pmin_dict[idx]
                scaled[idx] = (self._dispatch_dict[idx] - pmin) / (_NE_PMAX - pmin)
        else:  # RE
            pmax = self._read_RE_pmax()
            for idx in self._index:
                scaled[idx] = self._dispatch_dict[idx] / pmax
        return scaled

    # -- label/auxiliary readers (reference :369-432) -----------------

    def read_wind_data(self, wind_file=None, wind_gen: str = "303_WIND_1"):
        """(364, 24)-shaped list of daily wind capacity factors from an
        RTS-GMLC real-time wind csv.  The reference hardcodes its data
        package's file; here the path is an argument (no package data)."""
        if wind_file is None:
            raise ValueError(
                "wind_file is required (no packaged RTS wind data in this build)"
            )
        pmax = self._read_RE_pmax(wind_gen)
        series = pd.read_csv(wind_file)[wind_gen].to_numpy() / pmax
        day_num = len(series) // 24
        return [np.asarray(series[i * 24 : (i + 1) * 24]) for i in range(day_num)]

    def read_rev_data(self, rev_path) -> Dict[int, float]:
        df = pd.read_csv(rev_path, nrows=self.num_sims)
        rev = df.iloc[:, 1:].to_numpy(dtype=float)
        return {
            idx: rev[i][0] for i, idx in enumerate(self._dispatch_dict.keys())
        }
