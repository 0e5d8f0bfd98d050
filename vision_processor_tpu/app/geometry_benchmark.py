"""geometry_benchmark: calibration quality evaluation.

Usage: python -m vision_processor_tpu.app.geometry_benchmark [config.yml]

Reads one frame, thresholds field-line pixels, scores the adopted camera
model by the line-pixel miss rate (`[Model score]` line), and multicasts the
ground-truth detections reprojected through the model for downstream
comparison (reference src/geometry_benchmark.cpp:54-72).
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

from ..calib.geometry import model_error
from ..calib.lines import (
    get_line_pixels,
    half_line_width_estimation,
    threshold_image,
)
from ..io.camera import open_camera
from ..net.geometry_io import load_geometry
from ..net.udp import VisionSocket, get_real_time
from ..proto import SSL_WrapperPacket
from ..utils.config import VisionConfig
from ..utils.log import get_logger
from .ground_truth import corresponding_frame, parse_ground_truth
from .processor import Processor

log = get_logger(__name__)


def main(argv=None):
    from ..utils import setup_compile_cache

    setup_compile_cache()
    argv = argv if argv is not None else sys.argv[1:]
    config = VisionConfig.load(argv[0] if argv else "config.yml")

    camera = open_camera(config.camera)
    frame = camera.read_image()
    if frame is None:
        log.warning("no frame")
        return 1

    geom_path = Path(config.ground_truth).parent / "geometry.yml"
    socket = VisionSocket(config.vision_ip, config.vision_port, config.cam_id, 145.0)
    if geom_path.exists():
        geometry = load_geometry(geom_path).geometry
        version = 1
    else:
        deadline = time.time() + 10.0
        while socket.geometry_version == 0 and time.time() < deadline:
            socket.geometry_check()
            time.sleep(0.01)
        geometry = socket.geometry
        version = socket.geometry_version

    proc = Processor(config)
    proc.geometry_check(frame.width, frame.height, geometry=geometry, version=version)
    persp = proc.perspective
    if not persp.geometry_version:
        log.warning("no calibration for this camera")
        return 1

    import jax.numpy as jnp

    from ..ops.frame import quad2rgba, raw2quad

    planes = raw2quad(jnp.asarray(frame.data), frame.fmt)
    rgb = np.asarray(quad2rgba(planes, frame.fmt))

    import cv2

    gray = cv2.cvtColor(np.clip(rgb, 0, 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
    hlw = half_line_width_estimation(
        persp.field, config.cam_id, config.camera_amount, gray.shape
    )
    thresholded = threshold_image(gray, hlw, config.field_line_threshold)
    persp.model.ensure_size(np.array([gray.shape[1], gray.shape[0]]))
    line_pixels = get_line_pixels(thresholded)
    error = model_error(persp.field, persp.model, line_pixels)
    print(f"[Model score] {error / max(len(line_pixels), 1)}")

    # reproject ground truth through the adopted model and broadcast
    groundtruth = parse_ground_truth(config.ground_truth)
    gt = corresponding_frame(groundtruth, 1)
    if gt is not None:
        wrapper = SSL_WrapperPacket()
        det = wrapper.detection
        det.CopyFrom(gt)
        for robots in (det.robots_yellow, det.robots_blue):
            for bot in robots:
                pos = persp.model.image2field(
                    np.array([bot.pixel_x, bot.pixel_y]), bot.height or 143.0
                )
                bot.x, bot.y = float(pos[0]), float(pos[1])
        for ball in det.balls:
            pos = persp.model.image2field(
                np.array([ball.pixel_x, ball.pixel_y]),
                persp.field.ball_radius or 21.5,
            )
            ball.x, ball.y = float(pos[0]), float(pos[1])
        det.camera_id = config.cam_id
        det.t_capture = get_real_time()
        det.t_sent = get_real_time()
        socket.send(wrapper)

    socket.close()
    camera.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
