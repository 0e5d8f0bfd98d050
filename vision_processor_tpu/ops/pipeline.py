"""The blob machine: one jitted graph from raw frame to compacted blobs.

Replaces the reference's event-chained OpenCL kernel sequence
(reference src/Resources.cpp:138-164, src/main.cpp:275-317) with a single
XLA program: Bayer split -> reprojection to the flat dRGB field grid ->
gradient ring response -> SAT -> quadrant circularity -> masked top-k blob
compaction. Geometry (shapes, radii, scale) is static per compile; camera
parameters, thresholds and bot height are runtime arguments so calibration
drift never recompiles.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.perspective import Perspective
from . import blob as B
from . import frame as F
from .blob_pallas import blob_response_fused
from .platform import use_gpu_kernels

_resample_grid_jit = jax.jit(
    F.resample_grid, static_argnames=("out_shape", "plane_shape")
)


@dataclass(frozen=True)
class BlobMachineConfig:
    """Static compile-time configuration of the per-frame graph."""

    fmt: str  # RGGB / GRBG / BGR
    raw_shape: tuple[int, ...]  # (2H, 2W) bayer or (H, W, 3) bgr
    flat_shape: tuple[int, int]  # (Hf, Wf) flat field grid
    field_scale: float  # [mm/px]
    field_offset: tuple[float, float]  # flat grid origin in field mm
    grad_offset: int
    sat_radius: int
    disc_radius: int
    max_blobs: int = 2000
    debug_images: bool = False
    # exact per-plane quarter-pixel bilinear (16 gathers) vs the packed
    # single-cell sampler (4 gathers, <=0.25 px boundary approximation)
    exact_resample: bool = False

    @property
    def plane_shape(self) -> tuple[int, int]:
        """Shape of the channel-packed half-resolution planes."""
        if self.fmt == F.BGR:
            return (self.raw_shape[0], self.raw_shape[1])
        return (self.raw_shape[0] // 2, self.raw_shape[1] // 2)

    def make_resample_grid(
        self, packed_cam, max_bot_height, field_scale=None, field_offset=None
    ):
        """Precompute the frame-invariant sampling geometry (device arrays).

        Call once per calibration / bot-height change and pass the result to
        ``blob_machine(..., rs_grid=...)``.
        """
        return _resample_grid_jit(
            jnp.asarray(packed_cam, dtype=jnp.float32),
            jnp.float32(max_bot_height),
            self.field_scale if field_scale is None else field_scale,
            self.field_offset if field_offset is None else field_offset,
            out_shape=self.flat_shape,
            plane_shape=self.plane_shape,
        )

    @classmethod
    def from_perspective(
        cls,
        perspective: Perspective,
        fmt: str,
        raw_shape: tuple[int, ...],
        max_blobs: int = 2000,
        debug_images: bool = False,
    ) -> "BlobMachineConfig":
        hf = int(perspective.reprojected_field_size[1])
        wf = int(perspective.reprojected_field_size[0])
        return cls(
            fmt=fmt,
            raw_shape=tuple(raw_shape),
            flat_shape=(hf, wf),
            field_scale=float(perspective.field_scale),
            field_offset=(
                float(perspective.visible_field_extent[0]),
                float(perspective.visible_field_extent[2]),
            ),
            grad_offset=B.gradient_offset(
                perspective.max_blob_radius, perspective.field_scale
            ),
            sat_radius=B.sat_radius(
                perspective.min_blob_radius, perspective.field_scale
            ),
            disc_radius=B.disc_radius(
                perspective.min_blob_radius, perspective.field_scale
            ),
            max_blobs=max_blobs,
            debug_images=debug_images,
        )


def blob_machine(
    cfg: BlobMachineConfig,
    raw: jnp.ndarray,
    packed_cam: jnp.ndarray,
    max_bot_height: jnp.ndarray,
    circ_threshold: jnp.ndarray,
    field_scale=None,
    field_offset=None,
    rs_grid=None,
):
    """Full frame -> blobs graph. Returns a dict of blob slots (+ debug maps).

    Blob positions are in field mm (flat2field applied in-graph).
    field_scale / field_offset default to the static config values; pass
    traced per-camera values to batch cameras with differing geometry.
    rs_grid: optional precomputed sampling geometry (F.resample_grid) —
    skips the per-pixel camera projection, which is frame-invariant.
    """
    if field_scale is None:
        field_scale = cfg.field_scale
    if field_offset is None:
        field_offset = cfg.field_offset
    if cfg.exact_resample:
        planes = F.raw2quad(raw, cfg.fmt)
        flat = F.resample_flat(
            planes,
            packed_cam,
            max_bot_height,
            field_scale,
            field_offset,
            cfg.flat_shape,
            cfg.fmt,
        )
    elif rs_grid is not None:
        flat = F.resample_flat_grid_raw(raw, rs_grid, cfg.fmt)
    else:
        packed_planes = F.raw2planes_packed(raw, cfg.fmt)
        flat = F.resample_flat_packed(
            packed_planes,
            packed_cam,
            max_bot_height,
            field_scale,
            field_offset,
            cfg.flat_shape,
            cfg.fmt,
        )
    import os

    score_first = os.environ.get("VPTPU_SCOREFIRST", "1") != "0"
    if score_first and not cfg.debug_images:
        # score-first extraction: the per-pixel response (masked score +
        # disc mean color) is computed map-wide — stencil kernels on the
        # GPU, span sums on the CPU — and compaction selects directly by
        # score, eliminating the candidate-local disc gathers and the
        # second ordering pass (the reference also scores every
        # surviving pixel, kernel/blobList.cl:48-94)
        if use_gpu_kernels():
            ms, circ, mean, count = blob_response_fused(
                flat, circ_threshold, cfg.grad_offset, cfg.sat_radius,
                cfg.disc_radius,
            )
        else:
            grad = B.gradient_dot(flat, cfg.grad_offset)
            circ = B.circularity(
                B.summed_area_table(grad), cfg.sat_radius
            )
            ms, mean, count = B.blob_response(
                flat, circ, circ_threshold, cfg.disc_radius
            )
        blobs = B.extract_blobs_scored(
            flat, circ, ms, mean, count, max_blobs=cfg.max_blobs
        )
    else:
        grad = B.gradient_dot(flat, cfg.grad_offset)
        sat = B.summed_area_table(grad)
        circ = B.circularity(sat, cfg.sat_radius)
        blobs = B.extract_blobs(
            flat,
            circ,
            circ_threshold,
            jnp.float32(0.0),
            radius=cfg.disc_radius,
            max_blobs=cfg.max_blobs,
        )

    # flat-grid px -> field mm
    offset = jnp.asarray(field_offset, dtype=jnp.float32)
    blobs["field_pos"] = blobs["pos"] * field_scale + offset

    if cfg.debug_images:
        blobs["flat"] = flat
        blobs["grad_dot"] = grad
        blobs["circ"] = circ
    return blobs


class BlobMachine:
    """Holds the jitted graph for a fixed geometry/config."""

    def __init__(self, cfg: BlobMachineConfig):
        self.cfg = cfg
        self._fn = jax.jit(partial(blob_machine, cfg))

    def __call__(self, raw, packed_cam, max_bot_height, circ_threshold):
        raw = jnp.asarray(raw)
        if raw.shape != self.cfg.raw_shape:
            raise ValueError(
                f"raw shape {raw.shape} != configured {self.cfg.raw_shape}"
            )
        return self._fn(
            raw,
            jnp.asarray(packed_cam, dtype=jnp.float32),
            jnp.float32(max_bot_height),
            jnp.float32(circ_threshold),
        )

    def debug(self, raw, packed_cam, max_bot_height, circ_threshold):
        """Run with debug maps regardless of the configured flag."""
        cfg = self.cfg
        if not cfg.debug_images:
            from dataclasses import replace

            cfg = replace(cfg, debug_images=True)
        out = blob_machine(
            cfg,
            jnp.asarray(raw),
            jnp.asarray(packed_cam, dtype=jnp.float32),
            jnp.float32(max_bot_height),
            jnp.float32(circ_threshold),
        )
        return jax.tree.map(np.asarray, out)
