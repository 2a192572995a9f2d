"""Observation report sources (prepbufr-style station JSON).

A copy of vaevar_tpu/data/reports.py (tests/test_torch_import.py holds it
equal). `SyntheticReports` seeds each timestamp's noise with Python's
`hash()` of the stamp, which PYTHONHASHSEED randomises per process: its
noisy reports replay within a process, not across processes (with the
default noise 0 the reports are the truth and do not depend on it).

Replaces the reference's S3 JSON fetch (da_4dvar.py:168-177) with a local
directory of `%Y-%m-%d_%H.json` files. Report format (da_4dvar.py:196-236):
{id: {"position": [lon_deg, lat_deg, plev_hpa, dt_hours],
      "value": [plev, z, q, u, v, t, ?, msl]}}.
`SyntheticReports` fabricates a deterministic station network from a truth
source — the "simulated station network" configuration (BASELINE.json
config 4).
"""

from __future__ import annotations

import json
import os

import numpy as np

from vaevar_tpu_torch import channels

_FMT = "%Y-%m-%d_%H"


def _stamp(ts) -> str:
    return ts.strftime(_FMT) if hasattr(ts, "strftime") else str(ts)


class LocalReportsStore:
    def __init__(self, root: str):
        self.root = root

    def get_reports(self, ts) -> dict:
        path = os.path.join(self.root, _stamp(ts) + ".json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)


class SyntheticReports:
    """Simulated station network: fixed random stations reporting the truth
    (plus optional noise) at a random pressure level each cycle."""

    def __init__(self, truth_source, n_stations: int = 2000, seed: int = 0,
                 noise: float = 0.0, dt_range: tuple = (0.0, 0.0)):
        self.truth = truth_source
        self.noise = noise
        rng = np.random.default_rng(seed)
        self.lons = rng.uniform(0.0, 360.0, n_stations)
        self.lats = rng.uniform(-88.0, 88.0, n_stations)
        self.levels = rng.choice(
            np.asarray(channels.PRESSURE_LEVELS, np.float64), n_stations
        )
        # report-time offsets (hours) relative to the file timestamp; real
        # prepbufr files carry reports spread across the window
        # (da_4dvar.py:209-224) — spread dt to populate window slots
        self.dts = rng.uniform(*dt_range, n_stations)
        self._seed = seed

    def get_reports(self, ts) -> dict:
        state = self.truth.get_state(ts)  # (69, H, W) physical
        H, W = state.shape[-2:]
        rng = np.random.default_rng(self._seed + hash(_stamp(ts)) % 100000)
        out = {}
        lv_idx = {p: i for i, p in enumerate(channels.PRESSURE_LEVELS)}
        for s in range(len(self.lons)):
            lon = int(np.round(self.lons[s] / 360.0 * W)) % W
            lat = min(int(np.round((90.0 - self.lats[s]) / 180.0 * H)), H - 1)
            li = lv_idx[self.levels[s]]
            noise = self.noise * rng.normal(size=6)
            # invert the gridding unit conversions so grid_real_obs
            # reconstructs physical values (da_4dvar.py:340-362)
            z = state[4 + li, lat, lon] / 9.8
            q = state[4 + 13 + li, lat, lon] / 1e-6
            u = state[4 + 26 + li, lat, lon]
            v = state[4 + 39 + li, lat, lon]
            t = state[4 + 52 + li, lat, lon] - 273.15
            msl = state[3, lat, lon] / 100.0
            out[f"s{s}"] = {
                "position": [float(self.lons[s]), float(self.lats[s]),
                             float(self.levels[s]), float(self.dts[s])],
                "value": [float(self.levels[s]), float(z + noise[0]),
                          float(q + noise[1]), float(u + noise[2]),
                          float(v + noise[3]), float(t + noise[4]),
                          None, float(msl + noise[5])],
            }
        return out
