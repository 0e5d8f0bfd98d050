"""Production multi-camera mode: N cameras on one GPU, one XLA program.

``python -m vision_processor_tpu.app.main cfg0.yml cfg1.yml ...`` (more than
one config) drives all cameras through ``parallel.multicam`` instead of one
process per camera. This is the chip-native re-expression of the reference's
process-per-camera architecture (reference README architecture diagram): the
per-frame compute of every camera is batched into one jitted program (the
camera loop is unrolled inside, see parallel/multicam.py), while each camera
keeps its own multicast socket, geometry, color state and host finishing, so
the wire behavior is indistinguishable from N reference processes.

Tracking input comes from the UDP tracker (full fleet state, real
finite-difference velocities), not the device summary loop — host-side id
assignment stays authoritative (reference src/udpsocket.cpp:204-256).
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import yaml

from ..io.camera import open_camera
from ..io.rtp import RTPStreamer
from ..io.snapshot import SnapshotWriter
from ..net.udp import GCSocket, VisionSocket, get_real_time
from ..parallel.multicam import MultiCamConfig, batched_step_host_tracked
from ..models.detector import DetectorConfig
from ..ops.pipeline import BlobMachineConfig
from ..utils.config import VisionConfig
from ..utils.log import get_logger
from .processor import Processor, TrackedArrays

log = get_logger(__name__)


def free_height_cameras(configs) -> set:
    """Camera indices whose height the pair solver may move: everything
    except operator-MEASURED nonzero camera_heights. A camera whose
    geometry section omits camera_height carries an arbitrary manifold
    height from the ill-conditioned single-camera fit — anchoring on it
    would pin the rig solve to a wrong value, so it is free too."""
    return {i for i, c in enumerate(configs)
            if not (c.camera_height_set and c.camera_height != 0.0)}


class MultiCamApp:
    """N-camera production loop on one chip."""

    def __init__(self, config_paths: list[str]):
        import jax

        self.configs = [VisionConfig.load(p) for p in config_paths]
        self.n_cams = len(self.configs)
        cfg0 = self.configs[0]

        heights_path = Path(cfg0.bot_heights_file)
        bot_heights = (
            yaml.safe_load(heights_path.read_text()) or {}
            if heights_path.exists() else {}
        )
        self.gc_socket = GCSocket(cfg0.gc_ip, cfg0.gc_port, bot_heights)
        # one socket per camera, matching the reference's per-process buses
        self.sockets = [
            VisionSocket(
                c.vision_ip, c.vision_port, c.cam_id,
                self.gc_socket.default_bot_height,
            )
            for c in self.configs
        ]
        self.cameras = [open_camera(c.camera) for c in self.configs]
        self.processors = [
            Processor(c, s, self.gc_socket)
            for c, s in zip(self.configs, self.sockets)
        ]
        # per-camera debug streams + one snapshot writer, like the
        # reference's per-process RTP/snapshot side channels; the batched
        # loop feeds them round-robin (one camera's views per frame-set),
        # so an N-camera rig streams each camera at frame_rate/N
        self.streamers = [
            RTPStreamer(c.stream_active, c.stream_url(), qp=c.stream_qp,
                        bitrate_kbps=c.stream_bitrate_kbps, gop=c.stream_gop)
            for c in self.configs
        ]
        self.snapshots = SnapshotWriter()
        self._last_snapshot = [0.0] * self.n_cams
        self._jax = jax
        self._step = None
        self._geom_key = None
        # +1 worker: a stale camera's in-flight blocking read must not
        # steal a slot from the healthy cameras' reads/finishing
        self._pool = ThreadPoolExecutor(self.n_cams + 1)
        self.running = True

        # automated rig-height calibration (reference config.yml:
        # `camera_height: 0.0` = calibrate the height; the single-camera
        # branch is degenerate for near-nadir views, reference
        # GeomModel.cpp:585). With >=2 cameras the pair solver breaks the
        # ambiguity from dual-view robot observations in the overlap
        # region (calib/pair.py); one-shot, then the refined calibs are
        # re-broadcast like any other calibration.
        # gated on an EXPLICIT `camera_height: 0.0` in some config — a
        # missing geometry section also defaults to 0.0 but is not an
        # operator request, and force-equalizing a rig whose cameras sit
        # at genuinely different heights would corrupt good calibrations
        self._pair_height_active = (
            self.n_cams >= 2
            and any(c.camera_height == 0.0 and c.camera_height_set
                    for c in self.configs)
        )
        self._height_obs: list = []
        self._height_obs_target = 32

        # one-frame device/host overlap, same contract as the
        # single-camera App: dispatch frame-set n+1 before finishing n on
        # the host (detections ship one frame later; with the in-graph
        # finisher the per-camera color chain is device-carried, so color
        # evolution keeps exact serial semantics). VPTPU_PIPELINE=0
        # restores the reference's frame-serial loop.
        import os

        self.pipeline = os.environ.get("VPTPU_PIPELINE", "1") != "0"
        # staggered per-camera dispatch (bench.measure_staggered_serial's
        # production form): camera c's CORE program (blob machine +
        # hypothesis search) dispatches as soon as its raw lands on
        # device, one small batched TAIL (NMS + ids + in-graph finisher)
        # after the last core — uploads 1..n-1 hide under compute, which
        # is what shortens the strict serial glass-to-wire latency of a
        # frame-set (the batched program exposes the whole frame-set
        # upload because every input must be resident before dispatch).
        # Default: on for the frame-serial latency mode
        # (VPTPU_PIPELINE=0), off when pipelining already hides the
        # upload under the previous frame-set's compute.
        # tests/test_staggered.py pins semantic equality with the batched
        # step
        _stag = os.environ.get("VPTPU_STAGGERED")
        self.staggered = (_stag != "0") if _stag is not None \
            else not self.pipeline
        self._core_step = None
        self._tail_step = None
        self._pending = None
        self._colors_dev = None
        # graceful degradation state: last good frame per camera (to keep
        # the batched program's shape through a camera outage), the
        # previous iteration's stale flags (transition logging + the
        # non-blocking read path), and in-flight reads of stale cameras
        self._last_frames = None
        self._stale_prev = [False] * self.n_cams
        self._read_pending: dict = {}

        if cfg0.wait_for_geometry:
            log.info("Waiting for geometry on %d sockets...", self.n_cams)
            while any(s.geometry_version == 0 for s in self.sockets):
                for s in self.sockets:
                    s.geometry_check()
                time.sleep(0.001)

    def stop(self, *_):
        self.running = False

    # -- compile ------------------------------------------------------------

    def _ensure_step(self, fmt: str, raw_shape: tuple):
        persp = [p.perspective for p in self.processors]
        # geometry_version is in the key so an in-run recalibration that
        # happens to preserve reprojected sizes (e.g. the rig-height solve
        # moves cameras along the z=0-invariant manifold) still refreshes
        # the per-camera debug configs against the NEW models (CLAUDE.md:
        # cache keys cover every projection input)
        key = (fmt, raw_shape,
               tuple(pp.geometry_version for pp in persp),
               tuple(tuple(pp.reprojected_field_size) for pp in persp))
        if self._geom_key == key:
            return True
        if any(pp.geometry_version == 0 for pp in persp):
            return False  # all cameras must be calibrated first
        hf = max(int(pp.reprojected_field_size[1]) for pp in persp)
        wf = max(int(pp.reprojected_field_size[0]) for pp in persp)
        ref = persp[0]
        from ..ops import blob as B

        bm = BlobMachineConfig(
            fmt=fmt,
            raw_shape=tuple(raw_shape),
            flat_shape=(hf, wf),
            field_scale=float(ref.field_scale),
            field_offset=(0.0, 0.0),
            grad_offset=B.gradient_offset(ref.max_blob_radius, ref.field_scale),
            sat_radius=B.sat_radius(ref.min_blob_radius, ref.field_scale),
            disc_radius=B.disc_radius(ref.min_blob_radius, ref.field_scale),
            max_blobs=self.configs[0].max_blobs,
        )
        det = DetectorConfig(max_blobs=bm.max_blobs,
                             max_tracked=self.processors[0].det_cfg.max_tracked)
        self.mc_cfg = MultiCamConfig(bm=bm, det=det, n_cams=self.n_cams)
        self._step = batched_step_host_tracked(self.mc_cfg)
        if self.staggered:
            from ..parallel.multicam import (
                percam_core_step, staggered_tail_step,
            )

            self._core_step = percam_core_step(self.mc_cfg)
            self._tail_step = staggered_tail_step(self.mc_cfg)
        self._geom_key = key
        # per-camera configs for the debug-view renderer (each camera's own
        # flat shape; compiled lazily on the first stream/snapshot request)
        for proc in self.processors:
            proc._bm_cfg = BlobMachineConfig.from_perspective(
                proc.perspective, fmt, tuple(raw_shape),
                max_blobs=bm.max_blobs,
            )
            proc._debug_fn = None
        log.info("Compiled %d-camera pipeline: raw=%s flat=%s max_blobs=%d",
                 self.n_cams, raw_shape, bm.flat_shape, bm.max_blobs)
        return True

    # -- per-frame ----------------------------------------------------------

    def _read_all(self):
        """Read the next frame from every camera concurrently.

        A camera already in outage (stale) is read WITHOUT blocking: its
        read future is left pending and polled next iteration, so a dead
        camera's driver timeout (e.g. the 1 s GenICam/V4L2 pops) throttles
        the fleet for at most the ONE frame-set where it first fails,
        not for the whole outage. A HEALTHY camera's read is bounded too
        (2x its frame period, floored at 1 s for slow first frames): the
        docstring contract that drivers pop after ~1 s is now enforced
        rather than assumed, so a driver whose read blocks indefinitely
        becomes an outage transition instead of stalling the fleet.

        Returns ``(frames, pending)``: ``frames[c]`` is None when camera c
        delivered nothing this set; ``pending[c]`` is True when that None
        is merely an in-flight read (timeout / stale poll), False when the
        read actually completed with None (true end of stream)."""
        from concurrent.futures import TimeoutError as FutTimeout

        futs = {}
        for c, cam in enumerate(self.cameras):
            pending = self._read_pending.get(c)
            futs[c] = (pending if pending is not None
                       else self._pool.submit(cam.read_image))
        frames, pending = [], []
        for c in range(self.n_cams):
            f = futs[c]
            if self._stale_prev[c] and not f.done():
                self._read_pending[c] = f   # poll again next frame-set
                frames.append(None)
                pending.append(True)
                continue
            if not self._stale_prev[c] and self._last_frames is not None:
                # bounded wait only once the fleet is operational (a
                # degraded set exists to fall back on): before the first
                # complete frame-set, block like the reference's startup
                # — a bounded startup read would DROP slow first frames
                # and re-read, racing through the stream without ever
                # forming a set
                # floor of 5 s: boundedness is the contract (a hung
                # driver stalls the fleet once, then enters the
                # non-blocking outage path), but the floor must sit well
                # above a slow frame source (software-rendered synthetic
                # cameras take >1 s/frame on a loaded host) or healthy
                # cameras ping-pong in and out of outage
                budget = self.cameras[c].expected_frametime() or (1.0 / 30.0)
                try:
                    frame = f.result(timeout=max(2.0 * budget, 5.0))
                except FutTimeout:
                    # first failing read: transition to outage, leave the
                    # read in flight exactly like the stale path
                    self._read_pending[c] = f
                    frames.append(None)
                    pending.append(True)
                    continue
            else:
                frame = f.result()
            self._read_pending.pop(c, None)
            frames.append(frame)
            pending.append(False)
        return frames, pending

    def _device_inputs(self):
        jnp = self._jax.numpy
        packed = np.stack(
            [p.perspective.model.packed() for p in self.processors]
        ).astype(np.float32)
        scales = np.array(
            [p.perspective.field_scale for p in self.processors],
            dtype=np.float32,
        )
        offsets = np.stack([
            np.array([p.perspective.visible_field_extent[0],
                      p.perspective.visible_field_extent[2]], dtype=np.float32)
            for p in self.processors
        ])
        colors = np.stack([p.colors.packed() for p in self.processors])

        # frame-invariant sampling geometry, cached on calibration /
        # geometry / bot-height change; the key covers EVERY projection
        # input (per-camera scales and offsets included — a field-extent
        # shift must invalidate even when the flat shape rounds the same)
        from ..parallel.multicam import make_resample_grids

        maxh = float(self.processors[0].max_bot_height)
        grid_key = (self.mc_cfg.bm, packed.tobytes(), scales.tobytes(),
                    offsets.tobytes(), maxh)
        if getattr(self, "_grid_key", None) != grid_key:
            self._grids = make_resample_grids(
                self.mc_cfg, packed, maxh, scales, offsets
            )
            self._grid_key = grid_key

        # packed field markings for the in-graph finisher (leading cam
        # axis: same field, per-camera geometry tolerance), cached with
        # the grids
        if self.configs[0].device_finish:
            marks_key = (self.mc_cfg.bm,
                         tuple(p.perspective.geometry_version
                               for p in self.processors),
                         tuple(c.geometry_tolerance for c in self.configs))
            if getattr(self, "_marks_key", None) != marks_key:
                from ..models.device_finish import pack_field_marks

                per_cam = [
                    pack_field_marks(
                        p.perspective.field, c.geometry_tolerance
                    )
                    for p, c in zip(self.processors, self.configs)
                ]
                self._marks = self._jax.tree.map(
                    lambda *xs: jnp.asarray(np.stack(xs)), *per_cam
                )
                self._marks_key = marks_key
        else:
            self._marks = None

        return (jnp.asarray(packed), jnp.asarray(scales),
                jnp.asarray(offsets), jnp.asarray(colors), self._grids)

    def _fleet_params(self) -> dict:
        """Merged device params: per-camera tunables become (N,) arrays so
        every camera keeps its own thresholds (the reference's per-process
        configs, reference src/Resources.cpp:188-214); field-derived and
        GC-derived values stay shared scalars (same field, same GC)."""
        from ..parallel.multicam import _PER_CAMERA_PARAM_KEYS

        jnp = self._jax.numpy
        per = [p.params() for p in self.processors]
        out = dict(per[0])
        for k in _PER_CAMERA_PARAM_KEYS:
            out[k] = jnp.asarray(
                np.array([float(p[k]) for p in per], dtype=np.float32)
            )
        return out

    def dispatch_frames(self, frames, now: float):
        """Dispatch one batched device step (async). Returns the device
        output handles, or None while any camera is uncalibrated."""
        jnp = self._jax.numpy
        fmt = frames[0].fmt
        if not self._ensure_step(fmt, frames[0].data.shape):
            return None
        packed, scales, offsets, colors, grids = self._device_inputs()

        # fleet tracking state from the wire (all sockets see all cameras)
        tracked = TrackedArrays.build(
            self.sockets[0].get_tracked_objects(), now,
            self.processors[0].det_cfg.max_tracked,
        )
        refs = None
        if self._marks is not None:
            # device-carried batched color chain (the batched analogue of
            # Processor._colors_dev): pipelined dispatch keeps exact
            # serial color-evolution semantics
            if self._colors_dev is not None:
                colors = self._colors_dev
            refs = jnp.asarray(
                np.stack([p.colors.packed_refs() for p in self.processors])
            )
        if self.staggered:
            blobs, det, fin = self._dispatch_staggered(
                frames, packed, scales, offsets, colors, grids,
                tracked.as_dict(), self._fleet_params(), refs,
            )
        elif self._marks is not None:
            blobs, det, fin = self._step(
                jnp.asarray(np.stack([f.data for f in frames])), packed,
                scales, offsets, colors, tracked.as_dict(),
                self._fleet_params(), grids, refs, self._marks,
            )
        else:
            fin = None
            blobs, det = self._step(
                jnp.asarray(np.stack([f.data for f in frames])), packed,
                scales, offsets, colors, tracked.as_dict(),
                self._fleet_params(), grids,
            )
        if fin is not None:
            self._colors_dev = fin["colors7"]
        return blobs, det, fin

    def _dispatch_staggered(self, frames, packed, scales, offsets, colors,
                            grids, tracked, params, refs):
        """Per-camera core dispatch + one batched tail — semantically equal
        to the batched step (tests/test_staggered.py) but camera c's core
        starts as soon as ITS raw is on device: each upload overlaps the
        previous camera's compute instead of serializing ahead of one big
        dispatch, the latency shape bench.measure_staggered_serial
        measures."""
        jax, jnp = self._jax, self._jax.numpy
        from ..parallel.multicam import params_for_cam

        outs = []
        for c in range(self.n_cams):
            outs.append(self._core_step(
                jnp.asarray(frames[c].data), packed[c], scales[c],
                offsets[c], colors[c], tracked, params_for_cam(params, c),
                jax.tree.map(lambda x: x[c], grids),
            ))
        blobs, det = (
            jax.tree.map(lambda *xs: jnp.stack(xs), *grp)
            for grp in zip(*outs)
        )
        det, fin = self._tail_step(
            blobs, det, colors, packed, params, refs, self._marks,
        )
        return blobs, det, fin

    def finish_frames(self, out, now: float, frames, stale=None):
        """Per-camera host finishing for one dispatched frame-set —
        independent per camera (separate Processor state, separate
        sockets), fanned out on the reader pool; with the in-graph
        finisher it is protobuf assembly only. ``stale[c]`` marks a
        camera whose frame is a reused last-good one (outage): its
        per-camera state still advances, but nothing is sent for it and
        its slot in the returned list is None."""
        blobs, det, fin = out

        def finish_one(c):
            proc = self.processors[c]
            if fin is not None:
                per_cam = (
                    {k: v[c] for k, v in blobs.items()},
                    {k: v[c] for k, v in det.items()},
                    {k: v[c] for k, v in fin.items()},
                )
            else:
                per_cam = (
                    {k: v[c] for k, v in blobs.items()},
                    {k: v[c] for k, v in det.items()},
                )
            wrapper, _, _ = proc.finish_frame(
                per_cam, now, frames[c].timestamp
            )
            if stale is not None and stale[c]:
                return None   # outage: recomputed-stale detections stay off
                              # the wire (consumers would treat them as new)
            wrapper.detection.t_sent = self.cameras[c].get_time()
            self.sockets[c].send(wrapper)
            self.sockets[c].update_time()
            return wrapper

        return list(self._pool.map(finish_one, range(self.n_cams)))

    def step_frames(self, frames, now: float):
        """One frame-serial batched step (dispatch + finish)."""
        out = self.dispatch_frames(frames, now)
        if out is None:
            return None
        return self.finish_frames(out, now, frames)

    def _calibrate_uncalibrated(self, frames) -> None:
        """Auto-calibrate every camera that has field geometry but no calib
        yet (mirrors App._calibration_path). The broadcast calib rides the
        camera's own multicast socket and is adopted on the next
        geometry_check, after which the batched step compiles."""
        from ..calib.geometry import geometry_calibration
        from ..proto import SSL_SOURCE_VISION_PROCESSOR, SSL_WrapperPacket
        from ..ops.frame import quad2rgba, raw2quad

        jnp = self._jax.numpy
        for c, (cfg, proc, sock, frame) in enumerate(
            zip(self.configs, self.processors, self.sockets, frames)
        ):
            if proc.perspective.geometry_version or not sock.geometry_version:
                continue
            log.info("Calibrating camera %d ...", cfg.cam_id)
            planes = raw2quad(jnp.asarray(frame.data), frame.fmt)
            rgb = np.asarray(quad2rgba(planes, frame.fmt))
            model = geometry_calibration(cfg, sock.geometry.field, rgb)
            if model is None:
                continue
            wrapper = SSL_WrapperPacket()
            wrapper.source = SSL_SOURCE_VISION_PROCESSOR
            wrapper.geometry.CopyFrom(sock.geometry)
            wrapper.geometry.ClearField("calib")
            wrapper.geometry.calib.append(model.to_proto(cfg.cam_id))
            sock.send(wrapper)

    def _accumulate_height_obs(self, wrappers) -> None:
        """Dual-view robot observations for the pair height solver. The
        emitted field positions were unprojected at the robot height, so
        field2image at that height recovers the exact center pixels."""
        from ..calib.pair import observations_from_detections

        dets = {}
        for c, wrapper in enumerate(wrappers):
            if wrapper is None:   # camera outage: nothing was emitted
                continue
            det = wrapper.detection
            model = self.processors[c].perspective.model
            entries = []
            for team_off, robots in ((0, det.robots_yellow),
                                     (16, det.robots_blue)):
                for r in robots:
                    # vetoed robots are emitted with confidence 0.0 (the
                    # tracked-color veto zeroes the score but keeps the
                    # entry); a vetoed mis-constellation sharing an id with
                    # a real robot in the paired camera would corrupt the
                    # dual-view observation, so only trusted detections
                    # feed the one-shot rig-height fit
                    if r.confidence <= 0.0:
                        continue
                    px = model.field2image(
                        np.array([r.x, r.y, r.height], dtype=float)
                    )
                    entries.append(
                        (int(r.robot_id) + team_off, px, float(r.height))
                    )
            dets[c] = entries
        models = [p.perspective.model for p in self.processors]
        self._height_obs += observations_from_detections(dets, models)

    def _refine_rig_height(self) -> None:
        """One-shot: solve the rig height, move every camera along its
        plane-consistent manifold, broadcast the refined calibs (the
        geometry publisher absorbs them, like initial auto-calibration)."""
        from copy import deepcopy

        from ..calib.pair import apply_height, height_from_shared_objects
        from ..proto import SSL_SOURCE_VISION_PROCESSOR, SSL_WrapperPacket

        models = [p.perspective.model for p in self.processors]
        # trusted = an operator-MEASURED nonzero camera_height: those stay
        # FIXED in the cost (a trusted camera in an overlap pair pins h
        # even harder than two free ones) and are never rewritten
        free = free_height_cameras(self.configs)
        h = height_from_shared_objects(models, self._height_obs, free=free)
        self._height_obs.clear()
        if h is None:
            # keep collecting: a noisy startup window must not forfeit
            # the calibration the operator asked for
            log.warning("pair height calibration found no solution; "
                        "keeping current calibrations and retrying with "
                        "fresh observations")
            return
        self._pair_height_active = False
        refined = [deepcopy(models[i]) for i in sorted(free)]
        apply_height(refined, h)
        for i, model in zip(sorted(free), refined):
            cfg, sock = self.configs[i], self.sockets[i]
            wrapper = SSL_WrapperPacket()
            wrapper.source = SSL_SOURCE_VISION_PROCESSOR
            wrapper.geometry.CopyFrom(sock.geometry)
            wrapper.geometry.ClearField("calib")
            wrapper.geometry.calib.append(model.to_proto(cfg.cam_id))
            sock.send(wrapper)
        log.info("pair height calibration applied: rig height %.0f mm "
                 "broadcast for %d of %d cameras", h, len(free), self.n_cams)

    def _stream_and_snapshot(self, frames, frame_id: int, real_start: float):
        """Debug stream + snapshots, round-robin one camera per frame-set
        (reference src/main.cpp:377-403 per-process behavior adapted to
        the batched loop: each camera streams at frame_rate / n_cams)."""
        from .debug_io import emit_debug_views

        c = frame_id % self.n_cams
        proc = self.processors[c]
        if proc._bm_cfg is None:
            return
        self._last_snapshot[c] = emit_debug_views(
            proc, self.streamers[c], self.snapshots, self.configs[c],
            frames[c], self.cameras[c].get_time(), real_start,
            self._last_snapshot[c],
        )

    def _idle_views(self, frames, frame_id: int, real_start: float) -> None:
        """Before any geometry arrives: stream the raw demosaic so the
        operator can aim the cameras (single-camera App's idle path),
        round-robin one camera per frame-set."""
        from .debug_io import emit_idle_raw

        c = frame_id % self.n_cams
        if self.sockets[c].geometry_version:
            return
        cfg = self.configs[c]
        if not (self.streamers[c].active
                or cfg.debug_stream_interval_ms > 0):
            return
        self._last_snapshot[c] = emit_idle_raw(
            self.streamers[c], self.snapshots, cfg, frames[c], real_start,
            self._last_snapshot[c],
        )

    def _finish_pending(self):
        """Finish the in-flight frame-set, if any; returns its wrappers."""
        if self._pending is None:
            return None
        out, fnow, fframes, fstale = self._pending
        self._pending = None
        return self.finish_frames(out, fnow, fframes, fstale)

    def run(self):
        frame_id = 0
        while self.running:
            for cfg, proc in zip(self.configs, self.processors):
                if cfg.reload_if_changed():
                    proc.apply_tunables()
            frames, read_pending = self._read_all()
            alive = [f is not None for f in frames]
            if not any(alive):
                if any(read_pending):
                    # every camera momentarily stale but some reads are
                    # still in flight: not end-of-stream — wait a frame
                    # period and retry instead of exiting the fleet
                    # (in-flight slots marked stale so the retry polls
                    # them without blocking)
                    self._stale_prev = list(read_pending)
                    time.sleep(
                        min(self.cameras[0].expected_frametime() or 0.05,
                            0.05))
                    continue
                break   # every camera's read completed with None: EOF
            if not all(alive):
                # graceful degradation: one dead or hiccuping camera must
                # not take down the fleet (the reference's
                # process-per-camera model keeps the others alive). Reuse
                # the camera's last frame to keep the batched program's
                # shape and suppress its detections on the wire; a camera
                # that fails before the fleet delivered a single full
                # frame-set is fatal (no batch shape exists yet —
                # _last_frames holds only complete sets; startup reads
                # block unbounded, so a None here is a completed read)
                if self._last_frames is None:
                    break
                frames = [f if a else self._last_frames[c]
                          for c, (f, a) in enumerate(zip(frames, alive))]
            stale = [not a for a in alive]
            for c, s in enumerate(stale):
                if s and not self._stale_prev[c]:
                    log.warning(
                        "camera %d delivered no frame; reusing its last "
                        "frame and suppressing its detections", c)
                elif not s and self._stale_prev[c]:
                    log.info("camera %d recovered", c)
            self._stale_prev = stale
            self._last_frames = frames
            frame_id += 1
            now = self.cameras[0].get_time()
            real_start = get_real_time()
            for proc, frame in zip(self.processors, frames):
                proc.geometry_check(frame.width, frame.height)
            try:
                out = self.dispatch_frames(frames, now)
                if out is None:
                    # some camera is uncalibrated: finish any in-flight
                    # set, then bootstrap with the single-camera
                    # auto-calibration path instead of stalling (the
                    # reference's per-process loop calibrates any
                    # uncalibrated camera, reference src/main.cpp:404-406);
                    # cameras with no geometry at all stream their raw
                    # view so the operator can aim them
                    self._finish_pending()
                    self._calibrate_uncalibrated(frames)
                    self._idle_views(frames, frame_id, real_start)
                    continue
                if self.pipeline:
                    wrappers = self._finish_pending()
                    self._pending = (out, now, frames, stale)
                else:
                    wrappers = self.finish_frames(out, now, frames, stale)
            except Exception:
                log.exception("frame set %d failed, continuing", frame_id)
                self._pending = None
                continue
            if wrappers is not None and self._pair_height_active:
                try:
                    self._accumulate_height_obs(wrappers)
                    if len(self._height_obs) >= self._height_obs_target:
                        self._refine_rig_height()
                except Exception:
                    # a transient send/solver error must not take down
                    # the N-camera production loop
                    log.exception("pair height calibration step failed, "
                                  "continuing")
            try:
                self._stream_and_snapshot(frames, frame_id, real_start)
            except Exception:
                log.exception("debug stream failed, continuing")
            processing = get_real_time() - real_start
            budget = self.cameras[0].expected_frametime()
            if budget and processing > budget:
                log.info("frame time overrun: %.1f ms for %d cameras",
                         processing * 1e3, self.n_cams)
        try:
            self._finish_pending()
        except Exception:
            log.exception("final pending frame set failed")
        log.info("Stopping multi-camera vision_processor")
        self.close()

    def close(self):
        self._pool.shutdown(wait=False)
        for st in self.streamers:
            st.close()
        self.snapshots.close()
        for s in self.sockets:
            s.close()
        self.gc_socket.close()
        for c in self.cameras:
            c.close()
