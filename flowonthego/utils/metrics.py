"""Flow evaluation metrics (Middlebury methodology).

Equivalent of the reference's evaluation tooling
(flow_code/C — the repo evaluates average endpoint error
vs MPI-Sintel ground truth, docs/index.md:127-148).
"""

from __future__ import annotations

import numpy as np

from ..io.flo import UNKNOWN_FLOW_THRESH


def endpoint_error(flow: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Per-pixel endpoint error |flow - gt|_2, NaN where gt is unknown."""
    flow = np.asarray(flow, np.float64)
    gt = np.asarray(gt, np.float64)
    err = np.sqrt(((flow - gt) ** 2).sum(-1))
    unknown = (np.abs(gt) > UNKNOWN_FLOW_THRESH).any(-1) | np.isnan(gt).any(-1)
    err[unknown] = np.nan
    return err


def average_epe(flow: np.ndarray, gt: np.ndarray) -> float:
    """Average endpoint error over known pixels."""
    return float(np.nanmean(endpoint_error(flow, gt)))


def angular_error(flow: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Per-pixel angular error (degrees) in the (u, v, 1) space."""
    flow = np.asarray(flow, np.float64)
    gt = np.asarray(gt, np.float64)
    num = (flow * gt).sum(-1) + 1.0
    den = np.sqrt((flow ** 2).sum(-1) + 1.0) * np.sqrt((gt ** 2).sum(-1) + 1.0)
    return np.degrees(np.arccos(np.clip(num / den, -1.0, 1.0)))
