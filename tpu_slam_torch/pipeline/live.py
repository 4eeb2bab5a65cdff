"""The composed live pipeline: device stream -> 3D scans -> SLAM.

Port of ``tpu_slam.pipeline.live``, the runtime twin of the reference's
bringup (universal.launch + m3d_husky_bringup.launch): where the reference
wires lms_poller -> (TF from encoder_node_li) -> m3d_aggregator ->
gpu_6dslam_node through ROS topics, this pipeline wires

    NativeLms (C++ TCP poller)  --producer thread-->  NativeFeeder (C++
    ring)  --consumer-->  polar->cartesian  ->  FrameChain (encoder TF)
    ->  ScanAggregator (on the device)  ->  SLAMSystem

in one process. The encoder angle is sampled at line arrival (producer
side), or interpolated at the line's arrival time from a sampler thread's
history (``encoder_rate_hz``), the reference's TF lookup
(m3d_aggregator.cpp:261-262).

Per line the consumer stages the line (points, valid flags, intensities
and its encoder angle) in one pinned buffer, copies it to the device once
and runs the line's program (its transform and the aggregation) as one
CUDA graph replay (``ScanAggregator.add_staged_line``), then reads one
flag back (is the 3D scan complete?), in the reference's order; that read
also orders the next line's staging after this line's copy. That work is
``feed_line``, which ``run`` calls for each line the socket delivers and
which an offline replay of a recorded stream calls itself (``begin``
first), with no socket: the same code path, bit for bit. While the
recorder records (``utils.tracing``) each line is the span ``live.line``
and adds one to the host counter ``live_lines``.
``compiled=False`` runs the line eagerly from three copies (points, valid
flags, intensities), with the same bits. Everything the chain builds or
initialises at first use (the native library, the kernels of the SLAM
path, its captured graphs, the line's graph, the device's context) is
done before the stream opens: the feeder holds ``feeder_slots`` lines
(2.56 s of an LMS100 at 50 Hz), and a first step that waited on a
compiler would overflow it and drop real lines.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from tpu_slam_torch.ingest.aggregator import (AggregatorConfig,
                                              ScanAggregator, stage_line,
                                              staged_size)
from tpu_slam_torch.ingest.frames import (EncoderHistory, FrameChain,
                                          SensorModel, front_laser_transform)
from tpu_slam_torch.ingest.native import NativeFeeder, NativeLms
from tpu_slam_torch.utils import tracing

# the CUDA libraries SLAMSystem's path launches (NDT terms in every LM
# evaluation, brute-force NN in loop verification)
SLAM_KERNELS = ("ndt_terms", "nn_search")


@dataclasses.dataclass(frozen=True)
class LiveConfig:
    """Static configuration of the live chain."""

    sensor_model: str = "LMS100"
    line_capacity: int = 1024        # padded beams per line (static shape)
    range_min: float = 0.01          # lms_poller.cpp:26-29 params
    range_max: float = 100.0
    start_angle_deg: float = -45.0   # startAngle param (lms_poller.cpp:74)
    invert_scan: bool = False        # mirror-mounted scanner
    feeder_slots: int = 128
    poll_timeout_ms: int = 2000
    aggregator: AggregatorConfig = AggregatorConfig(line_length=1024)


class LivePipeline:
    """Feed from a connected NativeLms; produce 3D scans (and SLAM poses).

    ``angle_source`` is called once per scan line (producer side) and must
    return the current encoder angle in radians: live hardware passes
    ``NativeM3d.angle``, tests and simulations a profile. Runs on the
    device of ``slam`` when one is given, else on ``device`` (CUDA unless
    the caller asks for the CPU).

    ``slam_state`` is the SLAM state after the newest scan (``on_scan``
    may read it); after ``run``, ``lines`` counts the lines consumed and
    ``dropped_lines`` the lines the full feeder ring refused. ``compiled``
    (the default): each line one staged copy and one graph replay (see the
    module docstring); the SLAM system has its own.
    """

    def __init__(self, config: LiveConfig, chain: Optional[FrameChain] = None,
                 slam=None, device=None, compiled: bool = True):
        from tpu_slam_torch import default_device

        if config.aggregator.line_length != config.line_capacity:
            raise ValueError("aggregator.line_length must equal "
                             "line_capacity")
        if slam is not None:
            if device is not None and torch.device(device) != slam.device:
                raise ValueError(f"device {device} is not the SLAM system's "
                                 f"({slam.device})")
            self.device = slam.device
        else:
            self.device = default_device(device)
        self.config = config
        self.chain = chain or FrameChain(
            sensor=SensorModel.by_name(config.sensor_model))
        self.slam = slam
        self.compiled = compiled
        self.aggregator = ScanAggregator(config.aggregator,
                                         device=self.device,
                                         compiled=compiled)
        # the staging buffer of a line (pinned on a CUDA device)
        self._staging = torch.zeros(
            staged_size(config.line_capacity), dtype=torch.float32,
            pin_memory=self.device.type == "cuda")
        self._dirs = None            # (L, 3) beam direction table
        self._meta0 = None
        self._producer_done = threading.Event()
        self._producer_error: Optional[BaseException] = None
        self._enc_hist: Optional[EncoderHistory] = None
        self.line_angles: List[Tuple[float, float]] = []  # (t, angle) used
        self.lines = 0
        self.dropped_lines = 0
        self.slam_state = None
        self._agg_state = None
        self._step_deg = 0.5

    # -- producer ----------------------------------------------------------

    def _produce(self, lms: NativeLms, feeder: NativeFeeder,
                 angle_source: Optional[Callable[[], float]],
                 max_lines: Optional[int]) -> None:
        n = 0
        interp = self._enc_hist is not None
        try:
            while max_lines is None or n < max_lines:
                out = lms.poll(timeout_ms=self.config.poll_timeout_ms)
                if out is None:                      # poll timeout
                    break
                meta, ranges, intens = out
                if self._meta0 is None:
                    self._meta0 = meta
                if intens.size != ranges.size:
                    intens = np.zeros_like(ranges)
                # interpolated mode: the feeder's angle slot carries the
                # line's arrival time RELATIVE to the run's start (the slot
                # is float32, and absolute monotonic time would lose ~50 ms
                # in it); the consumer interpolates the encoder history at
                # it. Otherwise: the angle source sampled at arrival.
                a = (time.monotonic() - self._t_ref if interp
                     else float(angle_source()))
                feeder.push(ranges, intens,
                            stamp=meta.time_since_startup_us * 1e-6,
                            angle=a)
                n += 1
        except ConnectionError:
            pass                                     # device closed: drain
        except BaseException as e:                   # raised again in run()
            self._producer_error = e
        finally:
            self._producer_done.set()

    # -- consumer ----------------------------------------------------------

    def _directions(self, n_beams: int) -> np.ndarray:
        """Beam direction table from the first telegram's metadata
        (polar->cartesian of m3d_aggregator.cpp:269-286 with the
        startAngle override of lms_poller.cpp:74-100)."""
        if self._dirs is not None and self._dirs.shape[0] == n_beams:
            return self._dirs
        meta = self._meta0
        step = math.radians(meta.ang_step_deg if meta else self._step_deg)
        a0 = math.radians(self.config.start_angle_deg)
        ang = a0 + step * np.arange(n_beams)
        if self.config.invert_scan:
            ang = ang[::-1].copy()
        self._dirs = np.stack([np.cos(ang), np.sin(ang),
                               np.zeros(n_beams)], axis=1).astype(np.float32)
        return self._dirs

    def warm_up(self) -> None:
        """Everything built or initialised at first use, done now: one
        line on the device (its context and kernels; the line's graph
        captured), the CUDA libraries of the SLAM path built and loaded,
        and the SLAM system's graphs for the aggregator's clouds captured
        (``SLAMSystem.warm_up``)."""
        L = self.config.line_capacity
        dev = self.device
        if self.compiled:
            warm = self.aggregator.add_staged_line(
                self.aggregator.init_state(),
                self._staging.to(dev, non_blocking=True), self.chain)
        else:
            warm = self.aggregator.add_line(
                self.aggregator.init_state(),
                torch.zeros((L, 3), dtype=torch.float32, device=dev),
                torch.zeros(L, dtype=torch.bool, device=dev),
                self.chain.base_from_laser(0.0, device=dev),
                torch.zeros(L, dtype=torch.float32, device=dev))
        bool(self.aggregator.ready(warm))
        if self.slam is not None and dev.type == "cuda":
            from tpu_slam_torch.kernels import _build
            for name in SLAM_KERNELS:
                _build.load(name)
            # an emitted cloud's shapes: points, mask, intensity as attrs
            cloud, _ = self.aggregator.emit(self.aggregator.init_state())
            self.slam.warm_up(cloud)

    def begin(self, init_pose=None, ang_step_deg: float = 0.5) -> None:
        """Start a stream: an empty aggregation, no line counted, and with
        a SLAM system its initial state at ``init_pose`` (the identity when
        None). ``run`` begins each stream so, and its scanner's first
        telegram then gives the beam step; an offline replay calls it
        (after ``warm_up``) before its first ``feed_line``, with the beam
        step of its lines (``ang_step_deg``, the LMS100's 0.5 by
        default)."""
        self._step_deg = ang_step_deg
        self._dirs = None
        self._agg_state = self.aggregator.init_state()
        self.slam_state = (self.slam.init_state(init_pose)
                           if self.slam is not None else None)
        self.lines = 0

    def feed_line(self, ranges: np.ndarray, intensities: np.ndarray,
                  angle: float) -> Optional[Tuple]:
        """One scan line through the chain, the consumer's work a line:
        ``ranges`` (n,) m of the line's beams (0 or out of the range gates:
        no return) and their ``intensities``, at encoder ``angle`` (rad).
        The line is staged, copied, transformed and aggregated, and the
        scan-complete flag read back (the span ``live.line``). Returns None
        until the line completes a 3D scan; then the scan is emitted, fed
        through the SLAM system when there is one (``slam_state`` is the
        state after it), and (cloud, SLAM metrics or None) returned."""
        cfg = self.config
        dev = self.device
        with tracing.span("live.line"):
            n = ranges.shape[0]
            pts = self._directions(n) * ranges[:, None]
            valid = (ranges >= cfg.range_min) & (ranges <= cfg.range_max)
            if self.compiled:
                # the staging buffer is free again: the last line's ready
                # read came after its copy
                stage_line(self._staging.numpy(), pts, valid, intensities,
                           float(angle))
                self._agg_state = self.aggregator.add_staged_line(
                    self._agg_state, self._staging.to(dev, non_blocking=True),
                    self.chain)
            else:
                L = cfg.line_capacity
                pts_p = np.zeros((L, 3), np.float32)
                val_p = np.zeros((L,), bool)
                int_p = np.zeros((L,), np.float32)
                pts_p[:n], val_p[:n], int_p[:n] = pts, valid, intensities
                T = self.chain.base_from_laser(float(angle), device=dev)
                self._agg_state = self.aggregator.add_line(
                    self._agg_state, torch.from_numpy(pts_p).to(dev),
                    torch.from_numpy(val_p).to(dev), T,
                    torch.from_numpy(int_p).to(dev))
            self.lines += 1
            tracing.count("live_lines", 1)
            done = bool(self.aggregator.ready(self._agg_state))
        if not done:
            return None
        cloud, self._agg_state = self.aggregator.emit(self._agg_state)
        metrics = None
        if self.slam is not None:
            self.slam_state, metrics = self.slam.step(self.slam_state, cloud)
        return cloud, metrics

    def run(self, lms: NativeLms,
            angle_source: Callable[[], float],
            max_scans: Optional[int] = None,
            max_lines: Optional[int] = None,
            on_scan: Optional[Callable] = None,
            encoder_rate_hz: float = 0.0) -> List[Tuple]:
        """Drive the chain until the stream ends or ``max_scans`` emitted.

        Returns a list of (cloud, slam_metrics_or_None) per emitted 3D
        scan; when a SLAMSystem was supplied each emitted cloud is also
        fed through it.

        ``encoder_rate_hz`` > 0 enables the time-interpolated encoder
        join: a sampler thread polls ``angle_source`` at that rate into an
        EncoderHistory, and each line's angle is INTERPOLATED at the
        line's arrival time instead of sampled once per line. The angles
        used are recorded in ``self.line_angles``.
        """
        cfg = self.config
        sampler = None
        self._enc_hist = None
        self._sampler_stop = threading.Event()
        self._producer_done.clear()
        self._producer_error = None
        self.line_angles = []
        if encoder_rate_hz > 0:
            hist = EncoderHistory()
            self._enc_hist = hist

            def _sample():
                # the unwrap needs consecutive samples < pi apart:
                # encoder_rate_hz must exceed rotation_speed / pi. The
                # sampler outlives the producer on purpose: lines backlogged
                # in the socket are drained in a burst, and the consumer
                # must still find bracketing samples for them.
                period = 1.0 / encoder_rate_hz
                while not self._sampler_stop.is_set():
                    hist.push(time.monotonic() - self._t_ref,
                              float(angle_source()))
                    time.sleep(period)

            sampler = threading.Thread(target=_sample, daemon=True)
        feeder = NativeFeeder(cfg.feeder_slots, cfg.line_capacity)
        producer = threading.Thread(
            target=self._produce, args=(lms, feeder, angle_source, max_lines),
            daemon=True)
        self.warm_up()
        self.begin()
        results: List[Tuple] = []
        if sampler is not None:
            # t_ref after the warm-up: a reference sample taken long before
            # the sampler's first could be > pi of rotation away from it
            # and fold the unwrap by 2 pi
            self._t_ref = time.monotonic()
            self._enc_hist.push(0.0, float(angle_source()))
            sampler.start()
        producer.start()
        try:
            while max_scans is None or len(results) < max_scans:
                out = feeder.pop(timeout_ms=100)
                if out is None:
                    if self._producer_done.is_set() and feeder.depth == 0:
                        break
                    continue
                ranges, intens, stamp, angle = out
                if self._enc_hist is not None:
                    q = float(angle)              # line arrival, rel. t_ref
                    t_arr = self._t_ref + q
                    # bounded wait for a bracketing sample: one comes at
                    # most a sampler period away, so wait up to ~5 periods
                    deadline = time.monotonic() + 5.0 / encoder_rate_hz
                    while (self._enc_hist.newest_t() < q
                           and time.monotonic() < deadline):
                        time.sleep(0.25 / encoder_rate_hz)
                    angle = self._enc_hist.at(q)
                    self.line_angles.append((t_arr, angle))
                out = self.feed_line(ranges, intens, angle)
                if out is not None:
                    results.append(out)
                    if on_scan is not None:
                        on_scan(*out)
        finally:
            self._producer_done.wait(timeout=cfg.poll_timeout_ms / 1e3 + 1.0)
            producer.join(timeout=2.0)
            self._sampler_stop.set()
            if sampler is not None:
                sampler.join(timeout=2.0)
            self.dropped_lines = feeder.dropped
            feeder.close()
        if self._producer_error is not None:
            raise self._producer_error
        return results

    # -- second (front) static laser ----------------------------------------

    def run_front(self, lms: NativeLms,
                  on_line: Callable[[np.ndarray, np.ndarray, float], None],
                  max_lines: Optional[int] = None,
                  sensor_model: Optional[str] = None) -> int:
        """Stream the front-facing STATIC laser (universal.launch's second
        SICK; TF at encoder_node_li.cpp:83-85) into base-frame planar
        scans on the host: ``on_line(points_base, valid, stamp)`` receives
        each line. Returns the number of lines delivered."""
        cfg = self.config
        sm = SensorModel.by_name(sensor_model or cfg.sensor_model)
        T = front_laser_transform(sm).numpy()
        dirs = None
        n = 0
        while max_lines is None or n < max_lines:
            out = lms.poll(timeout_ms=cfg.poll_timeout_ms)
            if out is None:
                break
            meta, ranges, _ = out
            if dirs is None or dirs.shape[0] != ranges.shape[0]:
                step = math.radians(meta.ang_step_deg)
                ang = (math.radians(cfg.start_angle_deg)
                       + step * np.arange(ranges.shape[0]))
                if cfg.invert_scan:
                    ang = ang[::-1].copy()
                dirs = np.stack([np.cos(ang), np.sin(ang),
                                 np.zeros_like(ang)], axis=1)
            pts = (dirs * ranges[:, None]) @ T[:3, :3].T + T[:3, 3]
            valid = (ranges >= cfg.range_min) & (ranges <= cfg.range_max)
            on_line(pts.astype(np.float32), valid,
                    meta.time_since_startup_us * 1e-6)
            n += 1
        return n
