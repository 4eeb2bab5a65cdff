"""Carry odometry state and configuration across engines as plain arrays.

The dense engine has no weights; what two engines must share to continue
from the same point is ``DenseOdomState`` (pose, last delta, both moment
windows, scan index, last metrics). These helpers convert it to and from a
dict of numpy arrays — the form any engine's state takes after
``np.asarray`` — and build the port's ``OdometryConfig`` from
``dataclasses.asdict`` of a configuration with the same fields.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from tpu_slam_torch.mapping.dense_map import DenseMomentGrid
from tpu_slam_torch.pipeline.config import ICPParams, OdometryConfig
from tpu_slam_torch.pipeline.odometry_dense import DenseOdomState
from tpu_slam_torch.registration.ndt import NDTParams

STATE_KEYS = ("pose", "last_delta", "grid_rows", "grid_origin_cell",
              "wide_rows", "wide_origin_cell", "scan_index", "last_metrics")

# NDTParams fields of the reference that select TPU gather/layout tiers;
# the port has one kernel path and ignores them
_TPU_TIER_FIELDS = ("dense_lookup_max_bits", "pack_budget_mb",
                    "pack_any_backend", "window_bits", "terms_impl")


def state_from_numpy(d: Dict[str, np.ndarray], dims: Tuple[int, int, int],
                     device) -> DenseOdomState:
    """DenseOdomState on ``device`` from a dict of arrays (STATE_KEYS;
    the two ``wide_*`` entries may be absent or None)."""
    def t(key, dtype):
        return torch.as_tensor(np.array(d[key]), dtype=dtype, device=device)

    dims = tuple(dims)
    wide = None
    if d.get("wide_rows") is not None:
        wide = DenseMomentGrid(rows=t("wide_rows", torch.float32),
                               origin_cell=t("wide_origin_cell", torch.int32),
                               dims=dims)
    return DenseOdomState(
        pose=t("pose", torch.float32), last_delta=t("last_delta",
                                                    torch.float32),
        grid=DenseMomentGrid(rows=t("grid_rows", torch.float32),
                             origin_cell=t("grid_origin_cell", torch.int32),
                             dims=dims),
        scan_index=t("scan_index", torch.int32),
        last_metrics=t("last_metrics", torch.float32), wide=wide)


def state_to_numpy(state: DenseOdomState) -> Dict[str, np.ndarray]:
    """The state's tensors as host arrays under STATE_KEYS."""
    def a(x):
        return None if x is None else x.detach().cpu().numpy()

    wide = state.wide
    return {"pose": a(state.pose), "last_delta": a(state.last_delta),
            "grid_rows": a(state.grid.rows),
            "grid_origin_cell": a(state.grid.origin_cell),
            "wide_rows": a(wide.rows) if wide is not None else None,
            "wide_origin_cell": (a(wide.origin_cell) if wide is not None
                                 else None),
            "scan_index": a(state.scan_index),
            "last_metrics": a(state.last_metrics)}


def config_from_dict(d: dict) -> OdometryConfig:
    """OdometryConfig from ``dataclasses.asdict`` of an odometry config.

    Unknown fields raise (TypeError from the dataclass), except the NDT
    fields that only select the reference's TPU tiers.
    """
    d = dict(d)
    ndt = {k: v for k, v in dict(d.pop("ndt")).items()
           if k not in _TPU_TIER_FIELDS}
    if ndt.get("window_dims") is not None:
        ndt["window_dims"] = tuple(ndt["window_dims"])
    icp = dict(d.pop("icp"))
    return OdometryConfig(ndt=NDTParams(**ndt), icp=ICPParams(**icp), **d)
