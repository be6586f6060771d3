"""Loader for IfG multi-stage triaxial creep-test CSV records.

The port's copy of examples/mechanics/MaterialCalibration/lab_data.py
(numpy and csv only): it parses the raw IfG export layout (see
examples/mechanics/MaterialCalibration/data/README.md) into numpy arrays
ready for the differentiable calibration in calibrate_labdata.py.
"""
from __future__ import annotations

import csv
import numpy as np


def load_ifg_creep_csv(path):
    """Parse one IfG creep-test CSV.

    Returns a dict:
      times_s   (T,) seconds from load application (clipped at t >= 0)
      eps_axial (T,) axial creep strain, fraction (lab % / 100),
                compression POSITIVE (the lab convention)
      s1_Pa, sdiff_Pa, s3_Pa (T,) effective stresses, Pa, positive values
      T_K       (T,) cell temperature, Kelvin
      meta      dict with sample id and any dynamic moduli found
                (Ed [GPa], vd) for seeding the elastic spring
    """
    rows = list(csv.reader(open(path, encoding="utf-8-sig")))
    meta = {}
    unit_row = None
    for i, r in enumerate(rows):
        if not r:
            continue
        if r[0].startswith("Probe/sample") and len(r) > 2:
            meta["sample"] = r[2]
        if r[0].startswith("Ed =") and len(r) > 2:
            meta["Ed_GPa"] = float(r[2])
        if r[0].startswith("vd =") and len(r) > 2:
            meta["vd"] = float(r[2])
        if r[0].startswith("[TT"):
            unit_row = i
            break
    if unit_row is None:
        raise ValueError(f"{path}: no IfG unit row ('[TT.MM.JJJJ]') found")

    t_h, eps, s1, sd, s3, T_c = [], [], [], [], [], []
    for r in rows[unit_row + 1:]:
        try:
            t_h.append(float(r[2]))
            eps.append(float(r[4]))
            s1.append(float(r[8]))
            sd.append(float(r[9]))
            s3.append(float(r[10]))
            T_c.append(float(r[11]))
        except (ValueError, IndexError):
            continue
    t_h = np.asarray(t_h)
    keep = t_h >= 0.0          # drop the pre-load reference sample
    # stage transitions are logged twice at the same hour (before/after the
    # load change); keep the LAST row of each timestamp so the stress series
    # is the one applied from that time onward (left-piecewise-constant)
    idx = np.where(keep)[0]
    last = {t: i for t, i in zip(t_h[idx], idx)}
    keep = np.zeros_like(keep)
    keep[list(last.values())] = True
    MPa = 1e6
    return {
        "times_s": t_h[keep] * 3600.0,
        "eps_axial": np.asarray(eps)[keep] / 100.0,
        "s1_Pa": np.asarray(s1)[keep] * MPa,
        "sdiff_Pa": np.asarray(sd)[keep] * MPa,
        "s3_Pa": np.asarray(s3)[keep] * MPa,
        "T_K": np.asarray(T_c)[keep] + 273.15,
        "meta": meta,
    }
