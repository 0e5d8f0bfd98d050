"""YAML configuration with the reference-compatible schema + hot reload.

Schema and defaults mirror the reference config.yml (reference config.yml:1-152,
parsed in src/Resources.cpp:70-136): camera, geometry, thresholds, color,
tracking, network, stream, debug sections. Tunables (thresholds, tracking,
colors, debug) reload live from disk on a 0.5 s mtime poll; structural
sections (camera, geometry, network, stream) need a restart.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field as dc_field
from pathlib import Path

import numpy as np
import yaml

from .log import get_logger

log = get_logger(__name__)


def _get(d: dict | None, key: str, default):
    if not d:
        return default
    return d.get(key, default)


@dataclass
class CameraSection:
    driver: str = "OPENCV"
    id: int = 0
    path: str | None = None
    width: int = 0
    height: int = 0
    exposure: float = 0.0
    gain: float = 0.0
    gamma: float = 1.0
    white_balance: object = "OUTDOOR"


@dataclass
class VisionConfig:
    cam_id: int = 0
    bot_heights_file: str = "robot-heights.yml"
    camera: CameraSection = dc_field(default_factory=CameraSection)

    # geometry (restart-only)
    camera_amount: int = 1
    camera_height: float = 0.0
    # True only when the config file's geometry section spells out
    # camera_height — automated height calibration (the reference's
    # `camera_height: 0.0` semantics) must be an explicit operator
    # request, not the dataclass default of a missing section
    camera_height_set: bool = False
    line_corners: list = dc_field(default_factory=list)
    geometry_refinement: bool = True
    field_line_threshold: int = 5
    min_line_segment_length: float = 10.0
    max_line_segment_offset: float = 10.0
    max_line_segment_angle: float = 3.0 * math.pi / 180.0

    # thresholds (live)
    min_circularity: float = 15.0
    min_score: float = 5.0
    max_blobs: int = 2000
    min_confidence: float = 0.2
    min_cam_edge_distance: float = 170.0
    resampling_factor: float = 1.0
    clipping_tolerance: float = 10.0
    geometry_tolerance: float = 10.0
    # opt-in color-plausibility veto on untracked emissions (see
    # models/detector.color_implausible). Off by default for strict
    # parity: the reference's detection scoring is geometry-only
    # (reference src/blobs/hypothesis.cpp:97-205)
    color_plausibility_veto: bool = False
    # run color update / id recalc / ball filters in-graph (the host keeps
    # only protobuf assembly); the host finishing path remains available
    # for parity testing and as a fallback
    device_finish: bool = True

    # color (live)
    reference_force: float = 0.1
    history_force: float = 0.7
    orange_reference: np.ndarray = dc_field(
        default_factory=lambda: np.array([192, 128, 64])
    )
    field_reference: np.ndarray = dc_field(
        default_factory=lambda: np.array([128, 128, 128])
    )
    yellow_reference: np.ndarray = dc_field(
        default_factory=lambda: np.array([255, 128, 0])
    )
    blue_reference: np.ndarray = dc_field(
        default_factory=lambda: np.array([0, 128, 255])
    )
    green_reference: np.ndarray = dc_field(
        default_factory=lambda: np.array([0, 255, 128])
    )
    pink_reference: np.ndarray = dc_field(
        default_factory=lambda: np.array([255, 0, 128])
    )

    # tracking (live)
    min_tracking_radius: float = 20.0
    max_bot_acceleration: float = 6500.0  # mm/s^2

    # network (restart-only)
    gc_ip: str = "224.5.23.1"
    gc_port: int = 10003
    vision_ip: str = "224.5.23.2"
    vision_port: int = 10006

    # stream (restart-only)
    stream_active: bool = True
    raw_feed: bool = False
    stream_ip_base_prefix: str = "224.5.23."
    stream_ip_base_end: int = 100
    stream_port: int = 10100
    # H.264 debug-stream QP (CAVLC intra tier, 10-29); 0 selects the
    # lossless I_PCM tier (~12 bits/px — capture only, LAN-hostile)
    stream_qp: int = 24
    # target debug-stream bitrate in kbit/s: frame-level rate control
    # walks the QP inside [10, 29] to hold it (the reference pins its
    # libav codec at 3500 kbps, reference src/rtpstreamer.cpp:70);
    # 0 = fixed QP (stream_qp)
    stream_bitrate_kbps: int = 0
    # GOP length for the H.264 inter tier: an IDR every N frames, P frames
    # (P_Skip / motion-compensated) between — mostly-static field views
    # shrink ~N-fold. Loss-recovery tradeoff on RTP/UDP multicast: one
    # lost packet corrupts the stream until the next IDR (up to N frames);
    # gop=1 restores the all-intra stream that recovers every frame.
    # 0 = default (30 = one IDR/second at 30 fps); VPTPU_GOP overrides.
    stream_gop: int = 0

    # debug (live)
    ground_truth: str = "gt.yml"
    wait_for_geometry: bool = False
    debug_images: bool = False
    debug_stream_interval_ms: int = 0

    # bookkeeping
    config_path: str | None = None
    _mtime: float = 0.0
    _last_check: float = 0.0

    @classmethod
    def load(cls, path: str | Path | None) -> "VisionConfig":
        cfg = cls()
        if path is None:
            return cfg
        cfg.config_path = str(path)
        with open(path) as fh:
            raw = yaml.safe_load(fh) or {}
        cfg._mtime = os.stat(path).st_mtime_ns
        cfg._apply_structural(raw)
        cfg.apply_tunables(raw)
        return cfg

    def _apply_structural(self, raw: dict) -> None:
        self.cam_id = _get(raw, "cam_id", self.cam_id)
        if not 0 <= self.cam_id <= 7:
            raise ValueError(f"Invalid camera ID, must be in [0, 7]: {self.cam_id}")
        self.bot_heights_file = _get(raw, "bot_heights_file", self.bot_heights_file)

        cam = _get(raw, "camera", {}) or {}
        self.camera = CameraSection(
            driver=_get(cam, "driver", "OPENCV"),
            id=_get(cam, "id", 0),
            path=_get(cam, "path", None),
            width=_get(cam, "width", 0),
            height=_get(cam, "height", 0),
            exposure=_get(cam, "exposure", 0.0),
            gain=_get(cam, "gain", 0.0),
            gamma=_get(cam, "gamma", 1.0),
            white_balance=_get(cam, "white_balance", "OUTDOOR"),
        )

        geo = _get(raw, "geometry", {}) or {}
        self.camera_amount = _get(geo, "camera_amount", 1)
        self.camera_height = _get(geo, "camera_height", 0.0)
        self.camera_height_set = "camera_height" in geo
        self.line_corners = [
            np.asarray(c, dtype=np.float64) for c in _get(geo, "line_corners", [])
        ]
        self.geometry_refinement = _get(geo, "refinement", True)
        self.field_line_threshold = _get(geo, "field_line_threshold", 5)
        self.min_line_segment_length = _get(geo, "min_line_segment_length", 10.0)
        self.max_line_segment_offset = _get(geo, "max_line_segment_offset", 10.0)
        self.max_line_segment_angle = (
            _get(geo, "max_line_segment_angle", 3.0) * math.pi / 180.0
        )

        th = _get(raw, "thresholds", {}) or {}
        self.max_blobs = _get(th, "blobs", 2000)
        self.geometry_tolerance = _get(th, "geometry_tolerance", 10.0)

        net = _get(raw, "network", {}) or {}
        self.gc_ip = _get(net, "gc_ip", "224.5.23.1")
        self.gc_port = _get(net, "gc_port", 10003)
        self.vision_ip = _get(net, "vision_ip", "224.5.23.2")
        self.vision_port = _get(net, "vision_port", 10006)

        st = _get(raw, "stream", {}) or {}
        self.stream_active = _get(st, "active", True)
        self.raw_feed = _get(st, "raw_feed", False)
        self.stream_ip_base_prefix = _get(st, "ip_base_prefix", "224.5.23.")
        self.stream_ip_base_end = _get(st, "ip_base_end", 100)
        self.stream_port = _get(st, "port", 10100)
        self.stream_qp = _get(st, "qp", 24)
        self.stream_bitrate_kbps = _get(st, "bitrate_kbps", 0)
        self.stream_gop = _get(st, "gop", 0)

        dbg = _get(raw, "debug", {}) or {}
        self.ground_truth = _get(dbg, "ground_truth", "gt.yml")
        self.wait_for_geometry = _get(dbg, "wait_for_geometry", False)

    def apply_tunables(self, raw: dict) -> None:
        th = _get(raw, "thresholds", {}) or {}
        self.min_circularity = _get(th, "circularity", 15.0)
        self.min_score = _get(th, "score", 5.0)
        self.min_confidence = _get(th, "min_confidence", 0.2)
        self.min_cam_edge_distance = _get(th, "min_cam_edge_distance", 170.0)
        self.resampling_factor = _get(th, "resampling_factor", 1.0)
        self.clipping_tolerance = _get(th, "clipping_tolerance", 10.0)
        self.color_plausibility_veto = bool(
            _get(th, "color_plausibility_veto", False))
        # resampling is the XLA gather on every platform; the key stays
        # readable so existing configs ("auto", "gather") keep loading
        mode = str(_get(th, "resample_mode", "auto"))
        if mode not in ("auto", "gather"):
            raise ValueError(
                f"thresholds.resample_mode {mode!r}: only 'auto' and "
                "'gather' (the same XLA gather) exist")
        # VPTPU_DEVICE_FINISH env overrides the config (ops escape hatch
        # to fall back to host finishing without touching config files)
        env_df = os.environ.get("VPTPU_DEVICE_FINISH")
        self.device_finish = (
            env_df not in ("0", "false", "no")
            if env_df is not None
            else bool(_get(th, "device_finish", True))
        )

        tr = _get(raw, "tracking", {}) or {}
        self.min_tracking_radius = _get(tr, "min_tracking_radius", 20.0)
        self.max_bot_acceleration = 1000.0 * _get(tr, "max_bot_acceleration", 6.5)

        col = _get(raw, "color", {}) or {}
        self.reference_force = _get(col, "reference_force", 0.1)
        self.history_force = _get(col, "history_force", 0.7)
        self.orange_reference = np.asarray(_get(col, "orange", [192, 128, 64]))
        self.field_reference = np.asarray(_get(col, "field", [128, 128, 128]))
        self.yellow_reference = np.asarray(_get(col, "yellow", [255, 128, 0]))
        self.blue_reference = np.asarray(_get(col, "blue", [0, 128, 255]))
        self.green_reference = np.asarray(_get(col, "green", [0, 255, 128]))
        self.pink_reference = np.asarray(_get(col, "pink", [255, 0, 128]))

        dbg = _get(raw, "debug", {}) or {}
        self.debug_images = _get(dbg, "debug_images", False)
        self.debug_stream_interval_ms = _get(dbg, "debug_stream_interval_ms", 0)

    def reload_if_changed(self) -> bool:
        """Re-apply live tunables when the config file changed on disk
        (0.5 s mtime poll like the reference, src/Resources.cpp:216-237)."""
        if self.config_path is None:
            return False
        now = time.monotonic()
        if now - self._last_check < 0.5:
            return False
        self._last_check = now
        try:
            mtime = os.stat(self.config_path).st_mtime_ns
        except OSError:
            return False
        if mtime == self._mtime:
            return False
        self._mtime = mtime
        try:
            with open(self.config_path) as fh:
                raw = yaml.safe_load(fh) or {}
            self.apply_tunables(raw)
            log.info("Reloaded tunables from %s", self.config_path)
            return True
        except Exception as exc:  # keep previous values on parse failure
            log.warning("Config reload failed, keeping previous values: %s", exc)
            return False

    def stream_url(self) -> str:
        return (
            f"rtp://{self.stream_ip_base_prefix}"
            f"{self.stream_ip_base_end + self.cam_id}:{self.stream_port}"
        )
