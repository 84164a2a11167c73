"""Double-loop result readers (counterpart of
``dispatches_tpu/grid/double_loop_utils.py``, a copy: the module is
pandas only).

pandas readers over the market-simulation output CSVs
(``hourly_summary.csv``, ``bus_detail.csv``, ``renewables_detail.csv`` /
``thermal_detail.csv``) and the double-loop participant logs
(``tracker_detail.csv``, ``bidder_detail.csv``) that the port's market
co-simulator (``grid/market.py``) writes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd


def _index_by_datetime(df, hour_col="Hour", minute_col=None):
    minutes = (
        df[minute_col].astype(str) if minute_col is not None else "00"
    )
    dt = pd.to_datetime(
        df["Date"].astype(str)
        + " "
        + df[hour_col].astype(str)
        + ":"
        + minutes,
        format="%Y-%m-%d %H:%M",
    )
    df = df.set_index(pd.DatetimeIndex(dt, name="Datetime"))
    drop = ["Date", hour_col] + ([minute_col] if minute_col else [])
    return df.drop(columns=[c for c in drop if c in df.columns])


def read_prescient_outputs(output_dir, source_dir, gen_name=None):
    """Summary + per-generator detail frames (reference :18-64)."""
    output_dir = Path(output_dir)

    summary = _index_by_datetime(pd.read_csv(output_dir / "hourly_summary.csv"))
    bus = pd.read_csv(output_dir / "bus_detail.csv")
    bus["LMP"] = bus["LMP"].astype(float)
    if "LMP DA" in bus.columns:
        bus["LMP DA"] = bus["LMP DA"].astype(float)
    bus = _index_by_datetime(bus, minute_col="Minute" if "Minute" in bus else None)
    summary = pd.merge(
        summary.reset_index(), bus.reset_index(), how="outer", on=["Datetime"]
    ).set_index("Datetime")

    frames = []
    for fname in ("renewables_detail.csv", "thermal_detail.csv"):
        p = output_dir / fname
        if not p.exists():
            continue
        df = pd.read_csv(p)
        if gen_name is not None and gen_name not in df.get(
            "Generator", pd.Series(dtype=str)
        ).unique():
            continue
        df = _index_by_datetime(
            df, minute_col="Minute" if "Minute" in df.columns else None
        )
        frames.append(df)
    if not frames:
        gen_df = pd.DataFrame()
    elif len(frames) == 1:
        gen_df = frames[0]
    else:
        gen_df = pd.merge(
            frames[0].reset_index(),
            frames[1].reset_index(),
            how="outer",
            on=["Datetime", "Generator"],
        ).set_index("Datetime")
    return summary, gen_df


def read_rts_gmlc_wind_inputs(source_dir, gen_name=None):
    """DA/RT wind capacity factors from RTS-GMLC SourceData; RT series
    come 12-per-hour and are averaged to hourly, both rolled by one
    period (reference :67-113)."""
    source_dir = Path(source_dir)
    gen_df = pd.read_csv(source_dir / "gen.csv")
    wind_gens = (
        [g for g in gen_df["GEN UID"] if "WIND" in g]
        if gen_name is None
        else [gen_name]
    )
    ts_dir = source_dir.parent / "timeseries_data_files" / "WIND"
    rt = pd.read_csv(ts_dir / "REAL_TIME_wind.csv")
    da = pd.read_csv(ts_dir / "DAY_AHEAD_wind.csv")

    start = pd.Timestamp(
        f"{rt.Year.values[0]}-{int(rt.Month.values[0]):02d}-"
        f"{int(rt.Day.values[0]):02d} 00:00:00"
    )
    n_hours = len(da)
    ix = pd.date_range(start=start, periods=n_hours, freq="1h")
    out = pd.DataFrame(index=ix)
    for k in wind_gens:
        rt_wind = np.reshape(rt[k].values, (n_hours, -1)).mean(1)
        pmax = gen_df[gen_df["GEN UID"] == k]["PMax MW"].values[0]
        out[k + "-RTCF"] = np.roll(rt_wind, 1) / pmax
        out[k + "-DACF"] = np.roll(da[k].values, 1) / pmax
    return out


def prescient_outputs_for_gen(output_dir, source_dir, gen_name):
    """Joined summary + generator detail (+ wind forecasts for WIND
    generators) filtered to the generator's bus (reference :116-144)."""
    source_dir = Path(source_dir)
    summary, gen_df = read_prescient_outputs(output_dir, source_dir, gen_name)
    bus_names = pd.read_csv(source_dir / "bus.csv")
    bus_dict = dict(
        zip(bus_names["Bus ID"].values, bus_names["Bus Name"].values)
    )
    bus_name = bus_dict[int(gen_name.split("_")[0])]
    if "Bus" in summary.columns:
        summary = summary[summary.Bus == bus_name]
    if "Generator" in gen_df.columns:
        gen_df = gen_df[gen_df.Generator == gen_name]
    df = pd.concat([summary, gen_df], axis=1)
    if "WIND" in gen_name:
        try:
            wf = read_rts_gmlc_wind_inputs(source_dir, gen_name)
            wf = wf[wf.index.isin(df.index)]
            df = pd.concat([df, wf], axis=1)
        except FileNotFoundError:
            pass
    return df


def prescient_double_loop_outputs_for_gen(output_dir):
    """Tracker + bidder logs merged on (Datetime, Horizon, Model)
    (reference :147-187)."""
    output_dir = Path(output_dir)
    tracker = _index_by_datetime(pd.read_csv(output_dir / "tracker_detail.csv"))
    tracker.loc[:, "Model"] = "Tracker"

    bidder = pd.read_csv(output_dir / "bidder_detail.csv")
    gen_name = bidder["Generator"].values[0] if "Generator" in bidder else None
    da = bidder[bidder["Market"] == "Day-ahead"].copy()
    rt = bidder[bidder["Market"] == "Real-time"].copy()
    for df, label in ((da, "DA Bidder"), (rt, "RT Bidder")):
        df.loc[:, "Model"] = label
    da = _index_by_datetime(da.rename(columns={"Hour": "Horizon [hr]"})
                            .assign(Hour=0))
    rt = _index_by_datetime(rt)
    merged = pd.concat([da, rt, tracker], axis=0, join="outer")
    return merged.drop(
        columns=[c for c in ("Market", "Generator") if c in merged.columns]
    ), gen_name
