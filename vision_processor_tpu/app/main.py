"""vision_processor entry point: the production per-camera loop.

Usage: python -m vision_processor_tpu.app.main [config.yml]

Orchestration mirrors the reference main loop (reference src/main.cpp:251-427):
read frame -> adopt geometry -> detection path when calibrated, calibration
path when geometry known but uncalibrated, raw streaming otherwise; multicast
the detection frame, run clock sync, feed the debug stream + snapshots.
"""
from __future__ import annotations

import signal
import sys
import time
from pathlib import Path

import numpy as np
import yaml

from ..io.camera import open_camera
from ..io.rtp import RTPStreamer
from ..io.snapshot import SnapshotWriter
from ..net.udp import GCSocket, VisionSocket, get_real_time
from ..proto import SSL_WrapperPacket, SSL_SOURCE_VISION_PROCESSOR
from ..utils.config import VisionConfig
from ..utils.log import get_logger
from .processor import Processor, TrackedArrays

log = get_logger(__name__)


class App:
    def __init__(self, config_path: str | None):
        self.config = VisionConfig.load(config_path)
        cfg = self.config

        heights_path = Path(cfg.bot_heights_file)
        if heights_path.exists():
            bot_heights = yaml.safe_load(heights_path.read_text()) or {}
        else:
            bot_heights = {}
        self.gc_socket = GCSocket(cfg.gc_ip, cfg.gc_port, bot_heights)
        self.socket = VisionSocket(
            cfg.vision_ip, cfg.vision_port, cfg.cam_id,
            self.gc_socket.default_bot_height,
        )
        self.camera = open_camera(cfg.camera)
        self.processor = Processor(cfg, self.socket, self.gc_socket)
        self.streamer = RTPStreamer(cfg.stream_active, cfg.stream_url(),
                                    qp=cfg.stream_qp,
                                    bitrate_kbps=cfg.stream_bitrate_kbps,
                                    gop=cfg.stream_gop)
        self.snapshots = SnapshotWriter()
        self.running = True
        self._last_snapshot = 0.0
        self._debug_view = 0

        from ..utils.timing import FrameStats, StageTimer

        self.frame_stats = FrameStats()
        self.frame_stats_timer = StageTimer()
        import os

        self.benchmark = os.environ.get("VPTPU_BENCHMARK", "") == "1"
        # one-frame device/host overlap: dispatch frame n+1 before finishing
        # frame n on the host (detections ship one frame later; colors lag
        # one frame). ON by default — the device step and host finishing are
        # comparable in cost, so the overlap nearly doubles sustained
        # throughput; VPTPU_PIPELINE=0 restores the reference's frame-serial
        # loop exactly.
        self.pipeline = os.environ.get("VPTPU_PIPELINE", "1") != "0"
        self._pending = None

        if cfg.wait_for_geometry:
            log.info("Waiting for geometry...")
            while self.socket.geometry_version == 0:
                self.socket.geometry_check()
                time.sleep(0.001)

    def stop(self, *_):
        self.running = False

    # -- per-frame paths ----------------------------------------------------

    def run(self):
        frame_id = 0
        while self.running:
            if self.config.reload_if_changed():
                self.processor.apply_tunables()
            frame = self.camera.read_image()
            if frame is None:
                break
            frame_id += 1
            start = self.camera.get_time()
            real_start = get_real_time()

            self.processor.geometry_check(frame.width, frame.height)

            try:
                if self.processor.perspective.geometry_version:
                    self._detection_path(frame, start, real_start)
                elif self.socket.geometry_version:
                    self._calibration_path(frame, real_start)
                else:
                    self._idle_path(frame, frame_id, real_start)
            except Exception:  # keep the camera loop alive on transient
                log.exception("frame %d failed, continuing", frame_id)
                self._pending = None

        if self._pending is not None:
            device_out, start, ts = self._pending
            self._pending = None
            wrapper, _, _ = self.processor.finish_frame(device_out, start, ts)
            wrapper.detection.t_sent = self.camera.get_time()
            self.socket.send(wrapper)

        log.info("Stopping vision_processor")
        self.close()

    def _detection_path(self, frame, start, real_start):
        tracked = TrackedArrays.build(
            self.socket.get_tracked_objects(), start,
            self.processor.det_cfg.max_tracked,
        )
        with self.frame_stats_timer.stage("device_step") as _:
            device_out = self.processor.device_step(frame.data, frame.fmt, tracked)
        if self.pipeline:
            pending, self._pending = self._pending, (device_out, start, frame.timestamp)
            if pending is None:
                return
            device_out, start, ts = pending
        else:
            ts = frame.timestamp
        with self.frame_stats_timer.stage("host_finish"):
            wrapper, blobs, det = self.processor.finish_frame(
                device_out, start, ts
            )
        wrapper.detection.t_sent = self.camera.get_time()
        self.socket.send(wrapper)
        self.socket.update_time()

        if self.config.debug_images and self.processor.frame_id == 1:
            views = self.processor.debug_views(frame.data, frame.fmt)
            import cv2

            for name, key in (
                ("flat", "flat_rgb"), ("gradDot", "grad_rgb"), ("blob", "circ_rgb"),
            ):
                cv2.imwrite(f".{name}.1.png", views[key][..., ::-1])

        processing = get_real_time() - real_start
        overrun = self.frame_stats.add(processing, self.camera.expected_frametime())
        if overrun:
            log.info(
                "frame time overrun: %.1f ms, %d blobs, %d balls, %d bots",
                processing * 1e3,
                int(blobs["count"]),
                len(wrapper.detection.balls),
                len(wrapper.detection.robots_yellow)
                + len(wrapper.detection.robots_blue),
            )
        if self.benchmark and self.processor.frame_id % 100 == 0:
            log.info("frame stats: %s", self.frame_stats.summary())
            self.frame_stats_timer.print_runtimes()
            self.frame_stats_timer.clear()

        self._stream_and_snapshot(frame, real_start)

    def _calibration_path(self, frame, real_start):
        from ..calib.geometry import geometry_calibration
        from ..ops.frame import quad2rgba, raw2quad

        import jax.numpy as jnp

        planes = raw2quad(jnp.asarray(frame.data), frame.fmt)
        rgb = np.asarray(quad2rgba(planes, frame.fmt))
        model = geometry_calibration(
            self.config, self.socket.geometry.field, rgb
        )
        if model is not None:
            wrapper = SSL_WrapperPacket()
            wrapper.source = SSL_SOURCE_VISION_PROCESSOR
            wrapper.geometry.CopyFrom(self.socket.geometry)
            wrapper.geometry.ClearField("calib")
            wrapper.geometry.calib.append(model.to_proto(self.config.cam_id))
            self.socket.send(wrapper)
        self._maybe_snapshot_raw(rgb, real_start)

    def _idle_path(self, frame, frame_id, real_start):
        from .debug_io import emit_idle_raw

        self._last_snapshot = emit_idle_raw(
            self.streamer, self.snapshots, self.config, frame, real_start,
            self._last_snapshot, force_snapshot=frame_id == 100,
        )
        if frame_id == 100:
            log.info("Saved sample image")

    # -- debug output -------------------------------------------------------

    def _stream_and_snapshot(self, frame, real_start):
        from .debug_io import emit_debug_views

        self._last_snapshot = emit_debug_views(
            self.processor, self.streamer, self.snapshots, self.config,
            frame, self.camera.get_time(), real_start, self._last_snapshot,
        )

    def _maybe_snapshot_raw(self, rgb, real_start):
        if (
            self.config.debug_stream_interval_ms > 0
            and (real_start - self._last_snapshot) * 1e3
            >= self.config.debug_stream_interval_ms
        ):
            self.snapshots.offer(rgb, f"img/{self.config.cam_id}.raw.jpg")
            self._last_snapshot = real_start

    def close(self):
        self.streamer.close()
        self.snapshots.close()
        self.socket.close()
        self.gc_socket.close()
        self.camera.close()


def main(argv=None):
    from ..utils import setup_compile_cache

    setup_compile_cache()
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) > 1:
        # N configs -> production multi-camera mode: all cameras batched
        # into one XLA program on one chip (parallel/multicam.py)
        from .multicam_app import MultiCamApp

        app = MultiCamApp(argv)
    else:
        app = App(argv[0] if argv else "config.yml")
    signal.signal(signal.SIGTERM, app.stop)
    signal.signal(signal.SIGINT, app.stop)
    app.run()


if __name__ == "__main__":
    main()
