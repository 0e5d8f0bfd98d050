"""blob_benchmark: device-stage quality evaluation.

Usage: python -m vision_processor_tpu.app.blob_benchmark [config.yml]

Replays a recorded/synthetic scene, runs the blob response chain, and scores
the circularity map against ground-truth blob positions: per-color position
error, worst-blob/percentile ratio and timing, with the same human and
machine-readable output lines as the reference benchmark
(reference src/blob_benchmark.cpp:114-223, parsed by
python/blob_benchmark.py:78-98).
"""
from __future__ import annotations

import sys
import time
from collections import defaultdict

import numpy as np

from ..io.camera import open_camera
from ..models.pattern import (
    CENTER_BLOB_RADIUS,
    PATTERNS,
    PATTERN_ANGLES_B2B,
    PATTERN_POS,
    SIDE_BLOB_RADIUS,
)
from ..net.geometry_io import load_geometry
from ..net.udp import VisionSocket, get_real_time
from ..utils.config import VisionConfig
from ..utils.log import get_logger
from .ground_truth import corresponding_frame, parse_ground_truth
from .processor import Processor

log = get_logger(__name__)

ORANGE, YELLOW, BLUE, GREEN, PINK, BOT = range(6)


def field2flat(persp, max_bot_height: float, field_pos: np.ndarray) -> np.ndarray:
    img = persp.model.field2image(field_pos)
    return persp.field2flat(persp.model.image2field(img, max_bot_height)[:2])


def score_blob(persp, circ: np.ndarray, flat_pos: np.ndarray, radius: float):
    """Best local-max score within `radius` of flat_pos, with sub-pixel
    refinement (reference src/blob_benchmark.cpp:45-84).
    Returns (max_score, subpixel_pos) or (None, None)."""
    h, w = circ.shape
    cx, cy = flat_pos
    best = None
    best_pos = None
    y0 = max(0, int(np.floor(cy - radius)))
    y1 = min(h, int(np.ceil(cy + radius)))
    for y in range(y0, y1):
        dy = y - cy
        xr = np.sqrt(max(radius * radius - dy * dy, 0.0))
        x0 = max(0, int(np.floor(cx - xr)))
        x1 = min(w, int(np.ceil(cx + xr)))
        for x in range(x0, x1):
            s = circ[y, x]
            if best is not None and s <= best:
                continue
            c = circ[y, x]
            cnx = circ[y, max(0, x - 1)]
            cpx = circ[y, min(w - 1, x + 1)]
            cny = circ[max(0, y - 1), x]
            cpy = circ[min(h - 1, y + 1), x]
            if c > cnx and c > cpx and c > cny and c > cpy:
                xdiv = cnx - 2 * c + cpx
                ydiv = cny - 2 * c + cpy
                best = s
                best_pos = np.array(
                    [
                        x + (0.5 * (cnx - cpx) / xdiv if xdiv != 0 else 0.0),
                        y + (0.5 * (cny - cpy) / ydiv if ydiv != 0 else 0.0),
                    ]
                )
    return best, best_pos


class Accumulator:
    def __init__(self):
        self.amount = defaultdict(int)
        self.error = defaultdict(float)
        self.sq_error = defaultdict(float)
        self.offset = defaultdict(lambda: np.zeros(2))

    def add(self, color: int, offset_mm: np.ndarray):
        n = np.linalg.norm(offset_mm)
        self.amount[color] += 1
        self.error[color] += n
        self.sq_error[color] += n * n
        self.offset[color] = self.offset[color] + offset_mm


def main(argv=None):
    from ..utils import setup_compile_cache

    setup_compile_cache()
    argv = argv if argv is not None else sys.argv[1:]
    config = VisionConfig.load(argv[0] if argv else "config.yml")
    config.wait_for_geometry = False

    camera = open_camera(config.camera)
    groundtruth = parse_ground_truth(config.ground_truth)

    # benchmarks don't need the bus, but geometry must come from somewhere:
    # take it from the dataset geometry file next to the ground truth when
    # present, else listen briefly on the vision bus
    from pathlib import Path

    geom_path = Path(config.ground_truth).parent / "geometry.yml"
    socket = None
    if geom_path.exists():
        wrapper = load_geometry(geom_path)
        geometry = wrapper.geometry
        version = 1
    else:
        socket = VisionSocket(
            config.vision_ip, config.vision_port, config.cam_id, 145.0
        )
        deadline = time.time() + 10.0
        while socket.geometry_version == 0 and time.time() < deadline:
            socket.geometry_check()
            time.sleep(0.01)
        geometry = socket.geometry
        version = socket.geometry_version
        if version == 0:
            log.warning("No geometry received, aborting")
            return 1

    proc = Processor(config)
    acc = Accumulator()
    frame_id = 0
    image_time = 0.0
    processing_time = 0.0
    analysis_time = 0.0
    blob_score_sum = 0.0
    percentile_sum = 0.0
    max_bot_height = 150.0

    import jax

    while True:
        t0 = get_real_time()
        frame = camera.read_image()
        if frame is None:
            break
        image_time += get_real_time() - t0

        t0 = get_real_time()
        proc.geometry_check(
            frame.width, frame.height, geometry=geometry, version=version
        )
        persp = proc.perspective
        if not persp.geometry_version:
            continue
        proc._ensure_step(frame.fmt, tuple(np.shape(frame.data)))

        from ..ops import blob as B
        from ..ops import frame as F
        import jax.numpy as jnp

        cfg = proc._bm_cfg
        planes = F.raw2quad(jnp.asarray(frame.data), cfg.fmt)
        flat = F.resample_flat(
            planes, jnp.asarray(persp.model.packed()), jnp.float32(max_bot_height),
            cfg.field_scale, cfg.field_offset, cfg.flat_shape, cfg.fmt,
        )
        grad = B.gradient_dot(flat, cfg.grad_offset)
        sat = B.summed_area_table(grad)
        circ_dev = B.circularity(sat, cfg.sat_radius)
        jax.block_until_ready(circ_dev)
        processing_time += get_real_time() - t0

        t0 = get_real_time()
        circ = np.asarray(circ_dev)
        frame_id += 1
        gt = corresponding_frame(groundtruth, frame_id)
        if gt is None:
            continue

        frame_score = 0.0

        def score_one(field_pos, radius_mm, color):
            nonlocal frame_score
            flat_pos = field2flat(persp, max_bot_height, field_pos)
            score, pos = score_blob(
                persp, circ, flat_pos, radius_mm / persp.field_scale
            )
            if score is None:
                return np.zeros(2)
            offset = persp.flat2field(pos) - persp.flat2field(flat_pos)
            acc.add(color, offset)
            frame_score += score
            return offset

        for ball in gt.balls:
            score_one(
                np.array([ball.x, ball.y, 30.0]),
                persp.field.ball_radius or 21.5,
                ORANGE,
            )
        for bots, color in ((gt.robots_yellow, YELLOW), (gt.robots_blue, BLUE)):
            for bot in bots:
                pattern = int(PATTERNS[bot.robot_id])
                bot_offset = np.zeros(2)
                for i in range(5):
                    orientation = bot.orientation + PATTERN_ANGLES_B2B[5 * i]
                    dist = np.linalg.norm(PATTERN_POS[i])
                    pos = np.array(
                        [
                            bot.x + dist * np.cos(orientation),
                            bot.y + dist * np.sin(orientation),
                            bot.height or 143.0,
                        ]
                    )
                    blob_color = (
                        color if i == 0
                        else (GREEN if (pattern & (8 >> i)) else PINK)
                    )
                    radius = CENTER_BLOB_RADIUS if i == 0 else SIDE_BLOB_RADIUS
                    bot_offset = bot_offset + score_one(pos, radius, blob_color) / 5
                acc.add(BOT, bot_offset)
                # score_one already counted the per-blob colors; undo the
                # double-counted BOT offset accumulation style of the
                # reference (it adds the bot mean separately)

        percentile_sum += float(np.percentile(circ, 99))
        blob_score_sum += frame_score
        analysis_time += get_real_time() - t0

    total_error = sum(
        acc.error[c] for c in (ORANGE, YELLOW, BLUE, GREEN, PINK)
    )
    total_sq = sum(
        acc.sq_error[c] for c in (ORANGE, YELLOW, BLUE, GREEN, PINK)
    )
    total_blobs = sum(
        acc.amount[c] for c in (ORANGE, YELLOW, BLUE, GREEN, PINK)
    )
    for color in sorted(acc.amount):
        n = acc.amount[color]
        stddev = (
            np.sqrt(max(n * acc.sq_error[color] - acc.error[color] ** 2, 0)) / n
            if n else float("nan")
        )
        print(
            f"[Blob benchmark] Avg color {color} error: "
            f"{acc.error[color] / n if n else float('nan')}±{stddev} "
            f"systematic offset: {acc.offset[color] / n if n else np.zeros(2)}"
        )
    if total_blobs:
        blob_score_sum /= total_blobs
        total_stddev = (
            np.sqrt(max(total_blobs * total_sq - total_error**2, 0)) / total_blobs
        )
        ppr_denom = abs(blob_score_sum) + abs(percentile_sum)
        print(
            f"[Blob benchmark] Total error: {total_error / total_blobs}"
            f"±{total_stddev} worstblob/percentile: "
            f"{blob_score_sum / ppr_denom if ppr_denom else float('nan')}"
        )
    print(
        f"[Blob benchmark] Avg processing time: "
        f"{processing_time / max(frame_id, 1)} frame load time: "
        f"{image_time / max(frame_id, 1)} analysis time: "
        f"{analysis_time / max(frame_id, 1)} frames: {frame_id}"
    )
    print(
        f"[BlobMachine] {frame_id} {total_blobs} {total_error} {total_sq} "
        f"{blob_score_sum} {percentile_sum} "
        f"{acc.amount[ORANGE]} {acc.error[ORANGE]} {acc.sq_error[ORANGE]} "
        f"{acc.amount[BOT]} {acc.error[BOT]} {acc.sq_error[BOT]} "
        f"{total_blobs * proc.perspective.field_scale} {processing_time}"
    )
    if socket is not None:
        socket.close()
    camera.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
