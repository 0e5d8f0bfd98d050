"""Per-camera frame processor: device step + host finishing.

The orchestration equivalent of the reference's Resources + main loop
(reference src/Resources.cpp:70-136, src/main.cpp:262-423), with the entire
compute path — blob machine and hypothesis search — compiled into one XLA
program per geometry. The host side handles geometry adoption, tracking
input, color state, protobuf emission.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.colors import ColorState
from ..models.detector import DetectorConfig, detect, estimate_bot_ids
from ..models.device_finish import finish_on_device, pack_field_marks
from ..models.host_detect import HostDetector
from ..models.perspective import Perspective
from ..ops.pipeline import BlobMachineConfig, blob_machine
from ..proto import SSL_WrapperPacket, SSL_SOURCE_VISION_PROCESSOR
from ..utils.config import VisionConfig
from ..utils.log import get_logger

log = get_logger(__name__)

def full_step(bm_cfg: BlobMachineConfig, det_cfg: DetectorConfig, raw, packed_cam,
              colors7, tracked, params, rs_grid=None, colors7_ref=None,
              marks=None):
    """blob machine + hypothesis search, one device program.

    With ``marks`` (packed field markings), the full finishing sequence —
    color update, id recalc, ball scoring and filters, emission
    projections — also runs in-graph (models/device_finish.py) and a
    third ``fin`` output is returned; the host then only assembles
    protobuf. Without it, finishing stays on the host (parity/fallback
    path)."""
    blobs = blob_machine(
        bm_cfg, raw, packed_cam, params["max_bot_height"],
        params["min_circularity"], rs_grid=rs_grid,
    )
    det = detect(det_cfg, blobs, tracked, colors7[:6], packed_cam, params)
    # first-pass ids in-graph (pre-update colors — exactly what the host's
    # build_bots pass needs; the post-color-update pass runs in
    # finish_on_device or on the host)
    det["bot_id_est"] = estimate_bot_ids(det, blobs["color"], colors7)
    out_blobs = {
        k: blobs[k]
        for k in ("pos", "field_pos", "color", "center", "circ", "score", "valid", "count")
    }
    if marks is None:
        return out_blobs, det
    fin = finish_on_device(
        blobs, det, colors7, colors7_ref, packed_cam, marks, params
    )
    return out_blobs, det, fin


@dataclass
class TrackedArrays:
    """Fixed-shape tracked-bot tensors for the device step."""

    id: np.ndarray
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    w: np.ndarray
    vx: np.ndarray
    vy: np.ndarray
    vw: np.ndarray
    time_delta: np.ndarray
    valid: np.ndarray

    @classmethod
    def build(cls, tracked_by_cam: dict, now: float, slots: int) -> "TrackedArrays":
        # one row per robot id: each camera that sees a robot reports its
        # own estimate, so the flattened per-camera lists carry duplicates
        # in overlap regions. Keep the freshest estimate per id — dedup
        # keeps every robot of a legal scene (<=32 ids) inside `slots`
        # instead of silently truncating the later cameras' robots.
        best: dict[int, object] = {}
        for _cam, entries in sorted(tracked_by_cam.items()):
            for t in entries:
                if t.id == -1:
                    continue  # balls are not searched as constellations
                prev = best.get(t.id)
                if prev is None or t.timestamp > prev.timestamp:
                    best[t.id] = t
        rows = list(best.values())[:slots]
        arr = cls(
            id=np.full(slots, -1, dtype=np.int32),
            x=np.zeros(slots, dtype=np.float32),
            y=np.zeros(slots, dtype=np.float32),
            z=np.zeros(slots, dtype=np.float32),
            w=np.zeros(slots, dtype=np.float32),
            vx=np.zeros(slots, dtype=np.float32),
            vy=np.zeros(slots, dtype=np.float32),
            vw=np.zeros(slots, dtype=np.float32),
            time_delta=np.zeros(slots, dtype=np.float32),
            valid=np.zeros(slots, dtype=bool),
        )
        for i, t in enumerate(rows):
            arr.id[i] = t.id
            arr.x[i] = t.x
            arr.y[i] = t.y
            arr.z[i] = t.z
            arr.w[i] = t.w
            arr.vx[i] = t.vx
            arr.vy[i] = t.vy
            arr.vw[i] = t.vw
            arr.time_delta[i] = now - t.timestamp
            arr.valid[i] = True
        return arr

    def as_dict(self) -> dict:
        return {
            "id": self.id,
            "x": self.x,
            "y": self.y,
            "z": self.z,
            "w": self.w,
            "vx": self.vx,
            "vy": self.vy,
            "vw": self.vw,
            "time_delta": self.time_delta,
            "valid": self.valid,
        }


class Processor:
    """One camera's full detection stack."""

    def __init__(
        self,
        config: VisionConfig,
        socket=None,
        gc_socket=None,
        max_tracked: int = 32,
    ):
        self.config = config
        self.socket = socket
        self.gc_socket = gc_socket
        self.perspective = Perspective(
            cam_id=config.cam_id, geometry_tolerance=config.geometry_tolerance
        )
        self.colors = ColorState(
            orange_ref=np.asarray(config.orange_reference, dtype=np.int64),
            field_ref=np.asarray(config.field_reference, dtype=np.int64),
            yellow_ref=np.asarray(config.yellow_reference, dtype=np.int64),
            blue_ref=np.asarray(config.blue_reference, dtype=np.int64),
            green_ref=np.asarray(config.green_reference, dtype=np.int64),
            pink_ref=np.asarray(config.pink_reference, dtype=np.int64),
            reference_force=config.reference_force,
            history_force=config.history_force,
        )
        self.host = HostDetector(config, self.colors, self.perspective)
        self.det_cfg = DetectorConfig(
            max_blobs=config.max_blobs, max_tracked=max_tracked
        )
        self._step = None
        self._debug_fn = None
        self._bm_cfg = None
        self._geom_key = None
        self._grid = None
        self._grid_key = None
        self._marks = None
        self._marks_key = None
        # device-carried color table (fused finishing): each dispatch
        # consumes the previous step's in-graph color update directly, so
        # colors evolve with exact serial semantics even when the App
        # pipelines dispatch ahead of host finishing (host-side adoption
        # would lag one extra frame there and halve the convergence rate
        # of the adaptive colors)
        self._colors_dev = None
        self.frame_id = 0

    def apply_tunables(self) -> None:
        """Propagate hot-reloaded tunables into live state (the reference's
        applyTunables refreshes the reference colors and blend forces,
        reference src/Resources.cpp:188-214; thresholds flow into the device
        step through params() every frame already)."""
        cfg = self.config
        self.colors.orange_ref = np.asarray(cfg.orange_reference, dtype=np.int64)
        self.colors.field_ref = np.asarray(cfg.field_reference, dtype=np.int64)
        self.colors.yellow_ref = np.asarray(cfg.yellow_reference, dtype=np.int64)
        self.colors.blue_ref = np.asarray(cfg.blue_reference, dtype=np.int64)
        self.colors.green_ref = np.asarray(cfg.green_reference, dtype=np.int64)
        self.colors.pink_ref = np.asarray(cfg.pink_reference, dtype=np.int64)
        self.colors.reference_force = cfg.reference_force
        self.colors.history_force = cfg.history_force

    # -- geometry -----------------------------------------------------------

    @property
    def max_bot_height(self) -> float:
        return self.gc_socket.max_bot_height if self.gc_socket else 150.0

    def geometry_check(self, width: int, height: int, geometry=None, version=None):
        """Adopt geometry from the socket (or explicit args in offline use)."""
        if geometry is None:
            if self.socket is None:
                return
            self.socket.geometry_check()
            geometry = self.socket.geometry
            version = self.socket.geometry_version
        had_calib = self.perspective.geometry_version
        changed = self.perspective.update_geometry(
            geometry,
            version,
            width,
            height,
            self.max_bot_height,
            self.config.resampling_factor,
        )
        if changed:
            self._geom_key = None  # force recompile
            # re-broadcast calib with derived world position when missing
            if self.socket is not None and not had_calib:
                for calib in geometry.calib:
                    if calib.camera_id == self.config.cam_id and not calib.HasField(
                        "derived_camera_world_tx"
                    ):
                        wrapper = SSL_WrapperPacket()
                        wrapper.source = SSL_SOURCE_VISION_PROCESSOR
                        wrapper.geometry.CopyFrom(geometry)
                        wrapper.geometry.ClearField("calib")
                        wrapper.geometry.calib.append(
                            self.perspective.model.to_proto(self.config.cam_id)
                        )
                        self.socket.send(wrapper)

    def _ensure_step(self, fmt: str, raw_shape: tuple):
        key = (fmt, raw_shape, tuple(self.perspective.reprojected_field_size))
        if self._geom_key == key:
            return
        self._bm_cfg = BlobMachineConfig.from_perspective(
            self.perspective, fmt, raw_shape, max_blobs=self.config.max_blobs
        )
        # note on buffer lifetime: the uint8 raw frame cannot alias any
        # output (no dtype/shape-compatible result), so donation buys
        # nothing — XLA frees the buffer right after the Bayer split reads
        # it, which is already the minimal-footprint behavior
        self._step = jax.jit(partial(full_step, self._bm_cfg, self.det_cfg))
        self._debug_fn = None
        self._geom_key = key
        log.info(
            "Compiled pipeline for %s raw=%s flat=%s",
            fmt,
            raw_shape,
            self._bm_cfg.flat_shape,
        )

    # -- per-frame ----------------------------------------------------------

    def params(self) -> dict:
        field = self.perspective.field
        return {
            "max_bot_height": jnp.float32(self.max_bot_height),
            "min_circularity": jnp.float32(self.config.min_circularity),
            "max_robot_radius": jnp.float32(field.max_robot_radius or 90.0),
            "min_tracking_radius": jnp.float32(self.config.min_tracking_radius),
            "max_bot_acceleration": jnp.float32(self.config.max_bot_acceleration),
            "min_confidence": jnp.float32(self.config.min_confidence),
            "clipping_tolerance": jnp.float32(self.config.clipping_tolerance),
            # 0/1 runtime scalar: the opt-in untracked color veto
            # (hot-reloadable like every threshold; no recompile)
            "color_plausibility_veto": jnp.float32(
                1.0 if self.config.color_plausibility_veto else 0.0),
            "ball_radius": jnp.float32(field.ball_radius or 21.5),
            # in-graph finishing (models/device_finish.py)
            "min_score": jnp.float32(self.config.min_score),
            "min_cam_edge_distance": jnp.float32(
                self.config.min_cam_edge_distance
            ),
            "reference_force": jnp.float32(self.colors.reference_force),
            "history_force": jnp.float32(self.colors.history_force),
            "bot_heights_yb": jnp.asarray(
                [
                    self.gc_socket.yellow_bot_height if self.gc_socket else 145.0,
                    self.gc_socket.blue_bot_height if self.gc_socket else 145.0,
                ],
                dtype=jnp.float32,
            ),
        }

    def _resample_grid(self):
        """Frame-invariant sampling geometry, recomputed on calibration /
        geometry / bot-height change only (the projection is the most
        expensive part of resampling and never changes between frames).

        Keyed on the frozen BlobMachineConfig VALUE (not the compile key):
        it carries field_scale/field_offset, so a geometry update that
        shifts the visible extent without changing the rounded flat-grid
        shape still invalidates the cached projection."""
        packed = self.perspective.model.packed()
        key = (self._bm_cfg, packed.tobytes(), float(self.max_bot_height))
        if self._grid_key != key:
            self._grid = self._bm_cfg.make_resample_grid(
                packed, self.max_bot_height
            )
            self._grid_key = key
        return self._grid

    def _field_marks(self):
        """Packed field-marking arrays for the in-graph finisher, cached
        per geometry version (shapes are geometry-static)."""
        key = (
            self.perspective.geometry_version,
            float(self.config.geometry_tolerance),
        )
        if self._marks_key != key:
            self._marks = pack_field_marks(
                self.perspective.field, self.config.geometry_tolerance
            )
            self._marks_key = key
        return self._marks

    def device_step(self, raw: np.ndarray, fmt: str, tracked: TrackedArrays):
        """Dispatch the jitted step; returns device arrays (async)."""
        self._ensure_step(fmt, tuple(raw.shape))
        if not self.config.device_finish:
            return self._step(
                jnp.asarray(raw),
                jnp.asarray(self.perspective.model.packed()),
                jnp.asarray(self.colors.packed()),
                tracked.as_dict(),
                self.params(),
                self._resample_grid(),
            )
        colors_in = (
            self._colors_dev
            if self._colors_dev is not None
            else jnp.asarray(self.colors.packed())
        )
        out = self._step(
            jnp.asarray(raw),
            jnp.asarray(self.perspective.model.packed()),
            colors_in,
            tracked.as_dict(),
            self.params(),
            self._resample_grid(),
            jnp.asarray(self.colors.packed_refs()),
            self._field_marks(),
        )
        self._colors_dev = out[2]["colors7"]
        return out

    def _frame_shell(self, t_capture: float, t_capture_camera: float):
        self.frame_id += 1
        wrapper = SSL_WrapperPacket()
        wrapper.source = SSL_SOURCE_VISION_PROCESSOR
        frame = wrapper.detection
        frame.frame_number = self.frame_id
        frame.t_capture = t_capture
        if t_capture_camera:
            frame.t_capture_camera = t_capture_camera
        frame.camera_id = self.config.cam_id
        return wrapper, frame

    def finish_frame_fused(self, device_out, t_capture: float,
                           t_capture_camera: float = 0.0):
        """Protobuf-only host finishing for the in-graph finisher: adopt
        the device-updated colors and fill the detection frame from the
        final arrays (everything else already ran on device)."""
        blobs_dev, det_dev, fin_dev = device_out
        blobs, det, fin = jax.device_get((blobs_dev, det_dev, fin_dev))
        self.colors.adopt_packed(fin["colors7"])

        wrapper, frame = self._frame_shell(t_capture, t_capture_camera)
        ids = fin["bot_id"]
        world = fin["bot_world"]
        pix = fin["bot_pixel"]
        orient = fin["bot_orientation"]
        score = fin["bot_score"]
        for i in np.flatnonzero(fin["bot_valid"]):
            bid = int(ids[i])
            entry = (
                frame.robots_yellow.add() if bid < 16
                else frame.robots_blue.add()
            )
            entry.confidence = float(score[i])
            entry.robot_id = bid % 16
            entry.x = float(world[i, 0])
            entry.y = float(world[i, 1])
            entry.height = float(world[i, 2])
            entry.orientation = float(orient[i])
            entry.pixel_x = float(pix[i, 0])
            entry.pixel_y = float(pix[i, 1])
        bworld = fin["ball_world"]
        bpix = fin["ball_pixel"]
        bscore = fin["ball_score"]
        for j in np.flatnonzero(fin["ball_valid"]):
            entry = frame.balls.add()
            entry.confidence = float(bscore[j])
            entry.x = float(bworld[j, 0])
            entry.y = float(bworld[j, 1])
            entry.pixel_x = float(bpix[j, 0])
            entry.pixel_y = float(bpix[j, 1])

        if self.socket is not None:
            for off in self.socket.get_received_offsets():
                frame.t_offsets.append(off)
        return wrapper, blobs, det

    def finish_frame(self, device_out, t_capture: float, t_capture_camera: float = 0.0):
        """Host finishing: colors, ids, filters, protobuf."""
        if len(device_out) == 3:
            return self.finish_frame_fused(device_out, t_capture, t_capture_camera)
        blobs_dev, det_dev = device_out
        blobs = {k: np.asarray(v) for k, v in blobs_dev.items()}
        det = {k: np.asarray(v) for k, v in det_dev.items()}

        max_bot_height = self.max_bot_height
        bots = self.host.build_bots(det, blobs)
        balls = self.host.build_balls(det, blobs)

        self.host.update_colors(bots, balls, max_bot_height)
        self.host.recalc_post_color(bots, balls)
        balls = self.host.filter_balls(balls, max_bot_height)

        wrapper, frame = self._frame_shell(t_capture, t_capture_camera)

        heights = {
            "yellow": self.gc_socket.yellow_bot_height if self.gc_socket else 145.0,
            "blue": self.gc_socket.blue_bot_height if self.gc_socket else 145.0,
        }
        self.host.emit(frame, bots, balls, heights, max_bot_height)

        if self.socket is not None:
            for off in self.socket.get_received_offsets():
                frame.t_offsets.append(off)
        return wrapper, blobs, det

    def debug_views(self, raw: np.ndarray, fmt: str) -> dict:
        """Render the four debug views (raw demosaic, flat dRGB, gradient,
        circularity) as uint8 RGB images for streaming/snapshots
        (reference src/main.cpp:377-403)."""
        import jax.numpy as jnp

        from ..ops import blob as B
        from ..ops import frame as F

        cfg = self._bm_cfg
        if cfg is None:
            raise RuntimeError("debug_views requires a compiled pipeline")

        if self._debug_fn is None:

            def render(raw_in, packed, maxh):
                planes = F.raw2quad(raw_in, cfg.fmt)
                rgb = F.quad2rgba(planes, cfg.fmt)
                flat = F.resample_flat(
                    planes, packed, maxh, cfg.field_scale, cfg.field_offset,
                    cfg.flat_shape, cfg.fmt,
                )
                grad = B.gradient_dot(flat, cfg.grad_offset)
                sat = B.summed_area_table(grad)
                circ = B.circularity(sat, cfg.sat_radius)
                clip = lambda x: jnp.clip(x, 0, 255).astype(jnp.uint8)
                grad_vis = clip(grad * 0.25 + 128.0)
                circ_vis = clip(circ + 127.0)
                return {
                    "raw_rgb": clip(rgb),
                    "flat_rgb": clip(flat),
                    "grad_rgb": jnp.stack([grad_vis] * 3, axis=-1),
                    "circ_rgb": jnp.stack([circ_vis] * 3, axis=-1),
                }

            self._debug_fn = jax.jit(render)

        out = self._debug_fn(
            jnp.asarray(raw),
            jnp.asarray(self.perspective.model.packed()),
            jnp.float32(self.max_bot_height),
        )
        return {k: np.asarray(v) for k, v in out.items()}

    def process_frame(self, frame, tracked_by_cam=None, now=None):
        """Full synchronous frame: device + host. Returns the wrapper packet."""
        if now is None:
            now = frame.timestamp
        if tracked_by_cam is None:
            tracked_by_cam = (
                self.socket.get_tracked_objects() if self.socket else {}
            )
        tracked = TrackedArrays.build(
            tracked_by_cam, now, self.det_cfg.max_tracked
        )
        out = self.device_step(frame.data, frame.fmt, tracked)
        return self.finish_frame(out, now, frame.timestamp)
