"""Laser-to-axis extrinsic calibration (5 DoF): the reference's solvers.

Port of ``tpu_slam.ingest.calibration`` (after m3d_calibration):

  * the **cost** is the reference's half-space overlap count
    (m3d_calibration_twiddle.cpp:199-308): apply the candidate extrinsic to
    every captured segment through its rotation transform, split the
    points by the sign of their LASER-frame up-axis coordinate (the two
    half-rotation clouds that should coincide), voxel-downsample both at
    0.1 m, and count second-half points with no first-half neighbour
    within 0.05 m (grid-hash NN in place of KdTreeFLANN);
  * **twiddle**: coordinate descent with multiplicative step adaptation
    1.1 / 0.9, converged at sum(steps) < 1e-6 (:345-396);
  * **simulated annealing**: T 1.0 -> < 0.001, alpha = 0.99, +-0.001
    perturbations, Metropolis accept exp((best - cand)/T)
    (m3d_calibration_sa.cpp:313-356);
  * **gradient solver**: a sigmoid relaxation of the count, its gradient
    from ``torch.autograd`` through the whole pipeline (the centroids of
    both halves), stepped by optax.adam's update written on tensors
    (``adam_update``: the step count a device tensor).

The 5 DoF are [ty, tz, rx, ry, rz]; tx is fixed at 0 as the reference's
call sites do (testData(0, p[0..4]), m3d_calibration_twiddle.cpp:345).
The extrinsic composes as p_base = T_segment @ (R p_laser + R t), Eigen's
rotate-then-translate order in testData (:217-220).

Costs run on the device of the captured data. The reference's compiled
programs are CUDA graphs on the card (``compiled=True``, the default; on
the CPU their bodies run eagerly, and ``compiled=False`` runs them
eagerly everywhere, with the same bits): ``overlap_cost`` is one graph
for each (data shapes, ``cfg``), the 5 parameters a static input, so
twiddle and annealing make one small copy to the card, one replay and
one read an evaluation; a gradient step (the soft cost, its gradient
through ``torch.autograd.grad``, Adam's update in place and the cost
written into a history on the card) is one graph, and
``calibrate_gradient`` reads the history once, after the last step.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PAD_COORD, PointCloud
from tpu_slam_torch.core.scatter import accumulate_rows
from tpu_slam_torch.ingest.frames import Calibration, rotation_link_transform
from tpu_slam_torch.kernels.downsample import voxel_downsample
from tpu_slam_torch.kernels.nn_search import nearest_neighbors_hash
from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec, sort_by_key
from tpu_slam_torch.utils.capture import (CapturedStep, compiled_call,
                                          signature)


@dataclasses.dataclass(frozen=True)
class CalibrationData:
    """Captured segments: laser-frame points + unit transform per segment.

    points: (S, L, 3); valid: (S, L); transforms: (S, 4, 4) — the
    ``original_Transform`` of each segment (base <- rotating link at the
    capture instant, m3d_calibration_twiddle.cpp:56-82).
    """

    points: torch.Tensor
    valid: torch.Tensor
    transforms: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.points.device


@dataclasses.dataclass(frozen=True)
class CalibConfig:
    """Cost configuration (the reference's constants)."""

    leaf: float = 0.1               # VoxelGrid leaf (:281)
    radius: float = 0.05            # match radius (:299)
    up_axis: int = 1                # laserUpAxis param (:176); 2 for Velodyne
    half_extent: float = 30.0       # world extent of the match grid
    capacity: int = 65536           # padded size of each half cloud


def extrinsic_matrix(params5: torch.Tensor) -> torch.Tensor:
    """[ty, tz, rx, ry, rz] -> 4x4 extrinsic, Eigen rotate-then-translate:
    R = Rx(rx) @ Ry(ry) @ Rz(rz) (testData:212-214), translation R @ t.
    Differentiable in ``params5``."""
    p = params5
    zero, one = torch.zeros_like(p[0]), torch.ones_like(p[0])
    t = torch.stack([zero, p[0], p[1]])

    def rot(axis, a):
        c, s = torch.cos(a), torch.sin(a)
        rows = ([[one, zero, zero], [zero, c, -s], [zero, s, c]],
                [[c, zero, s], [zero, one, zero], [-s, zero, c]],
                [[c, -s, zero], [s, c, zero], [zero, zero, one]])[axis]
        return torch.stack([torch.stack(r) for r in rows])

    R = rot(0, p[2]) @ rot(1, p[3]) @ rot(2, p[4])
    return se3.from_rt(R, R @ t)


def _half_clouds(data: CalibrationData, M: torch.Tensor, cfg: CalibConfig
                 ) -> Tuple[PointCloud, PointCloud]:
    """Transform all segments and split by laser-frame up-axis sign."""
    world = se3.apply(data.transforms @ M, data.points).reshape(-1, 3)
    valid = data.valid.reshape(-1)
    up = data.points.reshape(-1, 3)[:, cfg.up_axis]
    first_mask = valid & (up > 0)
    second_mask = valid & (up <= 0)
    first = PointCloud(points=torch.where(first_mask[:, None], world,
                                          PAD_COORD), mask=first_mask)
    second = PointCloud(points=torch.where(second_mask[:, None], world,
                                           PAD_COORD), mask=second_mask)
    return first, second


def _matched(data: CalibrationData, params5: torch.Tensor, cfg: CalibConfig):
    """Both downsampled halves, the sorted first half, and each second-half
    point's hash neighbour (idx into the sorted first half, distance)."""
    first, second = _half_clouds(data, extrinsic_matrix(params5), cfg)
    spec = VoxelGridSpec.centered(leaf=cfg.leaf, half_extent=cfg.half_extent)
    first_ds = voxel_downsample(first, spec, capacity=cfg.capacity)
    second_ds = voxel_downsample(second, spec, capacity=cfg.capacity)
    skeys, stgt = sort_by_key(first_ds, spec)
    with torch.no_grad():
        idx, dist = nearest_neighbors_hash(second_ds.points, skeys,
                                           stgt.points, spec, k_per_cell=2)
    return first_ds, second_ds, stgt, idx, dist


def _params(data: CalibrationData, params5) -> torch.Tensor:
    return torch.as_tensor(params5, dtype=torch.float32, device=data.device)


# overlap_cost's graphs, one for each (data signature, cfg)
_costs: Dict = {}


def _overlap_program(data: CalibrationData, params5: torch.Tensor,
                     cfg: CalibConfig) -> torch.Tensor:
    """``overlap_cost``'s body: reads nothing back."""
    _, second_ds, _, _, dist = _matched(data, params5, cfg)
    unmatched = second_ds.mask & ~(dist <= cfg.radius)
    return unmatched.sum(dtype=torch.int32)


def overlap_cost(data: CalibrationData, params5,
                 cfg: CalibConfig = CalibConfig(),
                 compiled: bool = True) -> torch.Tensor:
    """The reference's outlier count (int32, on the data's device):
    second-half points (downsampled) with no first-half neighbour within
    ``radius``. Lower is better. ``compiled``: a graph replay on the card
    (module docstring)."""
    p = _params(data, params5)
    with torch.no_grad():
        if not compiled:
            return _overlap_program(data, p, cfg)
        return compiled_call(_costs, functools.partial(_overlap_program,
                                                       cfg=cfg),
                             (data, p), static=cfg)


class _TakeRows(torch.autograd.Function):
    """``table[idx]`` whose backward sums the rows of a repeated index
    through ``core.scatter.accumulate_rows``: in a fixed order on both
    devices, so a gradient repeats bit for bit (several second-half points
    may share one first-half neighbour)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        out = grad.new_zeros((ctx.rows,) + tuple(grad.shape[1:]))
        return accumulate_rows(out, idx, grad), None


def soft_overlap_cost(data: CalibrationData, params5: torch.Tensor,
                      cfg: CalibConfig = CalibConfig(),
                      sharpness: float = 60.0) -> torch.Tensor:
    """Differentiable relaxation: sigmoid((d - radius) * sharpness) summed
    over the second half; approaches the count as sharpness grows. The
    matched distance is recomputed through the points, so autograd reaches
    ``params5`` through both halves' centroids."""
    _, second_ds, stgt, idx, _ = _matched(data, params5, cfg)
    matched = _TakeRows.apply(stgt.points, torch.clamp(idx, min=0).long())
    d = torch.linalg.vector_norm(second_ds.points - matched, dim=-1)
    d = torch.where(idx >= 0, d, 10.0 * cfg.radius)
    soft = torch.sigmoid((d - cfg.radius) * sharpness)
    return torch.where(second_ds.mask, soft, 0.0).sum()


class CalibrationCapture:
    """Collect (line cloud, rotation transform) segments from the rotating
    stream until the axis sweeps ``sweep_rad``.

    The live twin of the reference's segment collection
    (m3d_calibration_twiddle.cpp:56-82 addSegment, :312-317 N*pi gate; 2pi
    by default, 6pi for Velodyne). Lines are stored RAW (laser frame) with
    the PURE rotation transform T_rot(angle): the candidate extrinsic
    stands in for the calibration/sensor tail of the live chain, as the
    reference's laserOffsetMatrix does. Everything here is host-side
    (numpy and CPU float32 torch); ``data`` moves the capture to the
    device once.
    """

    def __init__(self, line_capacity: int = 1024,
                 max_segments: int = 4096,
                 sweep_rad: float = 2.0 * math.pi,
                 encoder_offset: float = math.pi):
        self.line_capacity = line_capacity
        self.max_segments = max_segments
        self.sweep_rad = sweep_rad
        self.encoder_offset = encoder_offset
        self._pts: list = []
        self._val: list = []
        self._T: list = []
        self._last_angle: Optional[float] = None
        self._swept = 0.0

    @property
    def complete(self) -> bool:
        return self._swept >= self.sweep_rad

    @property
    def progress(self) -> float:
        """Percent of the required sweep (the reference's progress topic)."""
        return 100.0 * self._swept / self.sweep_rad

    @property
    def n_segments(self) -> int:
        return len(self._pts)

    def add_line(self, points: np.ndarray, valid: np.ndarray,
                 encoder_angle: float) -> bool:
        """Store one laser line at its encoder angle; returns ``complete``."""
        if self.complete or len(self._pts) >= self.max_segments:
            return True
        L = self.line_capacity
        p = np.zeros((L, 3), np.float32)
        v = np.zeros((L,), bool)
        n = min(len(points), L)
        p[:n], v[:n] = points[:n], valid[:n]
        a = float(encoder_angle) - self.encoder_offset
        self._pts.append(p)
        self._val.append(v)
        self._T.append(rotation_link_transform(
            torch.tensor(a, dtype=torch.float32)).numpy())
        if self._last_angle is not None:
            # rotation about a fixed axis: the quaternion distance between
            # consecutive line transforms is |delta angle|, shortest-arc
            # (an encoder wrap is a tiny step, not ~2pi)
            d = abs(a - self._last_angle) % (2.0 * math.pi)
            self._swept += min(d, 2.0 * math.pi - d)
        self._last_angle = a
        return self.complete

    def data(self, pad_to: int = 64, device=None) -> CalibrationData:
        """Freeze into CalibrationData on ``device`` (CUDA unless the
        caller asks for the CPU); the segment count is padded to a
        multiple of ``pad_to`` with identity transforms and no valid
        points."""
        from tpu_slam_torch import default_device

        S = len(self._pts)
        if S == 0:
            raise ValueError("no segments captured")
        Sp = -(-S // pad_to) * pad_to
        L = self.line_capacity
        pts = np.zeros((Sp, L, 3), np.float32)
        val = np.zeros((Sp, L), bool)
        Ts = np.broadcast_to(np.eye(4, dtype=np.float32),
                             (Sp, 4, 4)).copy()
        pts[:S] = np.stack(self._pts)
        val[:S] = np.stack(self._val)
        Ts[:S] = np.stack(self._T)
        dev = default_device(device)
        return CalibrationData(points=torch.from_numpy(pts).to(dev),
                               valid=torch.from_numpy(val).to(dev),
                               transforms=torch.from_numpy(Ts).to(dev))


def capture_from_lms(lms, angle_source: Callable[[], float],
                     capture: CalibrationCapture,
                     start_angle_deg: float = -45.0,
                     range_min: float = 0.01, range_max: float = 100.0,
                     max_lines: int = 100000,
                     poll_timeout_ms: int = 2000) -> CalibrationCapture:
    """Drive a CalibrationCapture from a connected NativeLms stream: poll
    telegrams, expand to laser-frame points, tag each with the encoder
    angle (m3d_calibration_twiddle.cpp:430 rotLaserPointCloudCallback)."""
    dirs = None
    for _ in range(max_lines):
        out = lms.poll(timeout_ms=poll_timeout_ms)
        if out is None:
            break
        meta, ranges, _ = out
        if dirs is None or dirs.shape[0] != ranges.shape[0]:
            ang = (math.radians(start_angle_deg)
                   + math.radians(meta.ang_step_deg)
                   * np.arange(ranges.shape[0]))
            dirs = np.stack([np.cos(ang), np.sin(ang),
                             np.zeros_like(ang)], axis=1).astype(np.float32)
        pts = dirs * ranges[:, None]
        valid = (ranges >= range_min) & (ranges <= range_max)
        if capture.add_line(pts, valid, angle_source()):
            break
    return capture


@dataclasses.dataclass
class CalibResult:
    params5: np.ndarray
    cost: float
    evaluations: int
    history: list

    def to_calibration(self) -> Calibration:
        M = extrinsic_matrix(torch.as_tensor(self.params5,
                                             dtype=torch.float32))
        q = se3.quat_from_matrix(M[:3, :3])
        return Calibration(translation=tuple(float(v) for v in M[:3, 3]),
                           orientation_xyzw=tuple(float(v) for v in q))


def calibrate_twiddle(data: CalibrationData,
                      cfg: CalibConfig = CalibConfig(),
                      init: Optional[np.ndarray] = None,
                      initial_step: float = 0.01,
                      tolerance: float = 1e-6,
                      max_evaluations: int = 2000,
                      compiled: bool = True) -> CalibResult:
    """Coordinate-descent twiddle (m3d_calibration_twiddle.cpp:345-396);
    one ``overlap_cost`` and one read an evaluation."""
    p = np.zeros(5, np.float32) if init is None else np.array(init, np.float32)
    dp = np.full(5, initial_step, np.float32)
    evals = 0
    history = []

    def cost(v):
        nonlocal evals
        evals += 1
        return int(overlap_cost(data, v, cfg, compiled=compiled))

    best = cost(p)
    history.append(best)
    while dp.sum() > tolerance and evals < max_evaluations:
        for i in range(5):
            p[i] += dp[i]
            c = cost(p)
            if c < best:
                best = c
                dp[i] *= 1.1
            else:
                p[i] -= 2 * dp[i]
                c = cost(p)
                if c < best:
                    best = c
                    dp[i] *= 1.1
                else:
                    p[i] += dp[i]
                    dp[i] *= 0.9
        history.append(best)
    return CalibResult(params5=p, cost=float(best), evaluations=evals,
                       history=history)


def calibrate_sa(data: CalibrationData,
                 cfg: CalibConfig = CalibConfig(),
                 init: Optional[np.ndarray] = None,
                 t_start: float = 1.0,
                 t_end: float = 0.001,
                 alpha: float = 0.99,
                 step: float = 0.001,
                 seed: int = 0,
                 compiled: bool = True) -> CalibResult:
    """Simulated annealing (m3d_calibration_sa.cpp:313-356); the draws
    come from ``np.random.default_rng(seed)``, in the reference's order;
    one ``overlap_cost`` and one read an evaluation."""
    rng = np.random.default_rng(seed)
    p = np.zeros(5, np.float32) if init is None else np.array(init, np.float32)
    evals = 0

    def cost(v):
        nonlocal evals
        evals += 1
        return float(overlap_cost(data, v, cfg, compiled=compiled))

    best_p = p.copy()
    best = cost(p)
    cur = best
    history = [best]
    T = t_start
    while T > t_end:
        cand = p + rng.uniform(-step, step, 5).astype(np.float32)
        c = cost(cand)
        if c < cur or rng.random() < math.exp(min((cur - c) / max(T, 1e-9),
                                                  0.0)):
            p, cur = cand, c
            if c < best:
                best, best_p = c, cand.copy()
        T *= alpha
        history.append(best)
    return CalibResult(params5=best_p, cost=best, evaluations=evals,
                       history=history)


@dataclasses.dataclass(frozen=True)
class AdamState:
    """optax.adam's state on tensors: the two moments and the step count,
    a () int32 on the parameters' device (so no bias correction is fixed
    when a step is captured)."""

    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor


def adam_init(params: torch.Tensor) -> AdamState:
    return AdamState(mu=torch.zeros_like(params),
                     nu=torch.zeros_like(params),
                     count=torch.zeros((), dtype=torch.int32,
                                       device=params.device))


def adam_update(params: torch.Tensor, grad: torch.Tensor, state: AdamState,
                learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> None:
    """optax.adam's update (its defaults: no eps inside the root) applied
    to ``params`` and ``state`` in place, in optax's order of operations;
    reads nothing back."""
    with torch.no_grad():
        state.count.add_(1)
        state.mu.copy_((1.0 - b1) * grad + b1 * state.mu)
        state.nu.copy_((1.0 - b2) * (grad * grad) + b2 * state.nu)
        t = state.count.to(grad.dtype)
        mu_hat = state.mu / (1.0 - torch.pow(b1, t))
        nu_hat = state.nu / (1.0 - torch.pow(b2, t))
        params.add_(-learning_rate * (mu_hat / (torch.sqrt(nu_hat) + eps)))


@dataclasses.dataclass(frozen=True)
class GradientState:
    """A gradient solve on the device: the parameters, Adam's state, and
    the soft cost of every step so far (slot t: step t's)."""

    params5: torch.Tensor
    adam: AdamState
    history: torch.Tensor


def _gradient_step(state: GradientState, data: CalibrationData,
                   cfg: CalibConfig, learning_rate: float) -> GradientState:
    """One step of ``calibrate_gradient`` on ``state``, in place: the soft
    cost and its gradient (``torch.autograd.grad``), the cost written at
    the step's slot of the history, Adam's update. Reads nothing back."""
    p = state.params5.detach().requires_grad_(True)
    with torch.enable_grad():
        c = soft_overlap_cost(data, p, cfg)
        (g,) = torch.autograd.grad(c, p)
    with torch.no_grad():
        state.history.index_copy_(0, state.adam.count.reshape(1).long(),
                                  c.detach().reshape(1))
        adam_update(state.params5, g, state.adam, learning_rate)
    return state


# the gradient step's graphs, one for each (state and data signature, cfg,
# learning rate)
_grad_steps: Dict = {}


def _captured_gradient_step(state: GradientState, data: CalibrationData,
                            cfg: CalibConfig,
                            learning_rate: float) -> CapturedStep:
    key = signature((state, data, cfg, learning_rate))
    step = _grad_steps.get(key)
    if step is None:
        step = _grad_steps[key] = CapturedStep(
            functools.partial(_gradient_step, cfg=cfg,
                              learning_rate=learning_rate), state, (data,))
    return step


def calibrate_gradient(data: CalibrationData,
                       cfg: CalibConfig = CalibConfig(),
                       init: Optional[np.ndarray] = None,
                       steps: int = 200,
                       learning_rate: float = 3e-3,
                       compiled: bool = True) -> CalibResult:
    """Adam on the sigmoid-relaxed cost: each step one forward pass, its
    gradient and Adam's update on the device (``_gradient_step``; with
    ``compiled`` on the card, one graph replay). The history, the
    parameters and the final count are read back once, after the last
    step."""
    p = torch.zeros(5, dtype=torch.float32, device=data.device)
    if init is not None:
        p = _params(data, init).clone()
    state = GradientState(params5=p, adam=adam_init(p),
                          history=torch.zeros(steps, dtype=torch.float32,
                                              device=data.device))
    if compiled and data.device.type == "cuda":
        step = _captured_gradient_step(state, data, cfg, learning_rate)
    else:
        step = functools.partial(_gradient_step, cfg=cfg,
                                 learning_rate=learning_rate)
    for _ in range(steps):
        state = step(state, data)
    final = overlap_cost(data, state.params5, cfg, compiled=compiled)
    out = torch.cat([state.history, state.params5,
                     final.to(torch.float32).reshape(1)]).cpu().numpy()
    return CalibResult(params5=out[steps:steps + 5].copy(),
                       cost=float(out[-1]), evaluations=steps,
                       history=[float(c) for c in out[:steps]])


def export_verification(data: CalibrationData, params5,
                        cfg: CalibConfig = CalibConfig(),
                        ply_path: Optional[str] = None) -> dict:
    """Verification artifact of a calibration solve.

    The reference closed its calibration loop with a human check: the PCL
    visualizer rendered the two half-rotation clouds red/green and the
    operator accepted with 'A' (m3d_calibration_twiddle.cpp:384-424,
    140-164). Headless equivalent: the aligned half-clouds as a red/green
    .ply plus residual statistics to gate on before persisting the solve.

    Returns {"n_first", "n_second", "matched_fraction", "mean_nn_dist_m",
    "outlier_count", "ply_path"}: matched_fraction is the share of
    second-half points with a first-half neighbour within cfg.radius — a
    good solve on overlapping geometry scores > 0.9.
    """
    with torch.no_grad():
        first_ds, second_ds, _, _, dist = _matched(
            data, _params(data, params5), cfg)
    m2 = second_ds.mask.cpu().numpy()
    d = dist.cpu().numpy()
    matched = m2 & (d <= cfg.radius)
    n2 = max(int(m2.sum()), 1)
    stats = {
        "n_first": int(first_ds.mask.sum()),
        "n_second": int(m2.sum()),
        "matched_fraction": round(float(matched.sum()) / n2, 4),
        "mean_nn_dist_m": round(float(d[matched].mean())
                                if matched.any() else float("inf"), 4),
        "outlier_count": int((m2 & ~matched).sum()),
        "ply_path": None,
    }
    if ply_path is not None:
        from tpu_slam_torch.utils.ply import write_ply
        m1 = first_ds.mask.cpu().numpy()
        p1 = first_ds.points.cpu().numpy()[m1]
        p2 = second_ds.points.cpu().numpy()[m2]
        pts = np.concatenate([p1, p2])
        col = np.concatenate([
            np.tile(np.array([[220, 40, 40]], np.uint8), (len(p1), 1)),
            np.tile(np.array([[40, 200, 40]], np.uint8), (len(p2), 1))])
        stats["ply_path"] = write_ply(ply_path, pts, col)
    return stats
