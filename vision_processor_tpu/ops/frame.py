"""Frame-plane ops: Bayer splitting, plane sampling, reprojection to the flat
field grid, dRGB conversion.

Array-program equivalents of the reference's raw2quad / resampling / quad2rgba
OpenCL kernels (reference kernel/raw2quad.cl:21-39, kernel/resampling.cl:52-105,
kernel/quad2rgba.cl:23-53). Bayer splitting is pure strided slicing (free under
XLA fusion); reprojection computes the camera projection per output pixel as
elementwise math from packed camera parameters and bilinearly gathers the
four half-resolution Bayer planes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.camera import field2image_packed

# Supported raw formats
RGGB = "RGGB"
GRBG = "GRBG"
BGR = "BGR"


def raw2planes_packed(raw: jnp.ndarray, fmt: str) -> jnp.ndarray:
    """Split a raw frame into channel-packed half-resolution planes, f32.

    Bayer input (2H, 2W) uint8 -> (H, W, 4) with the Bayer cell unrolled
    row-major into the minor dimension. This is a pure reshape + transpose
    (one relayout) instead of four stride-2 slices. BGR input (H, W, 3) ->
    (H, W, 4) zero-padded.
    """
    if fmt == BGR:
        x = raw.astype(jnp.float32)
        return jnp.concatenate([x, jnp.zeros_like(x[..., :1])], axis=-1)
    h2, w2 = raw.shape[0] // 2, raw.shape[1] // 2
    x = raw.astype(jnp.float32).reshape(h2, 2, w2, 2)
    return x.transpose(0, 2, 1, 3).reshape(h2, w2, 4)


def raw2quad(raw: jnp.ndarray, fmt: str) -> jnp.ndarray:
    """Split a raw frame into 4 half-resolution planes, f32.

    Bayer input (2H, 2W) uint8 -> (4, H, W): one plane per Bayer cell
    position (row-major within the 2x2 cell). BGR input (H, W, 3) uint8 ->
    (4, H, W) with planes [B, G, R, zeros] to keep a uniform layout.
    """
    return jnp.moveaxis(raw2planes_packed(raw, fmt), -1, 0)


def bilinear_sample(plane: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample `plane` (H, W) at float pixel coords, clamp-to-edge.

    Texel centers sit at integer + 0.5 (OpenCL unnormalized LINEAR
    convention): sampling at exactly (i + 0.5, j + 0.5) returns plane[j, i].
    """
    h, w = plane.shape
    u = x - 0.5
    v = y - 0.5
    x0 = jnp.floor(u)
    y0 = jnp.floor(v)
    fx = u - x0
    fy = v - y0
    x0 = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)

    flatp = plane.reshape(-1)
    idx00 = y0 * w + x0
    idx01 = y0 * w + x1
    idx10 = y1 * w + x0
    idx11 = y1 * w + x1
    p00 = jnp.take(flatp, idx00)
    p01 = jnp.take(flatp, idx01)
    p10 = jnp.take(flatp, idx10)
    p11 = jnp.take(flatp, idx11)

    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy


def sample_rgb(planes: jnp.ndarray, px: jnp.ndarray, py: jnp.ndarray, fmt: str):
    """Reconstruct RGB at image positions (px, py) from the 4 planes.

    Positions are in the camera model's (half-resolution) pixel space; the
    quarter-pixel shifts compensate each channel's position inside the Bayer
    cell (reference kernel/resampling.cl:60-84).
    Returns (r, g, b) float arrays in [0, 255].
    """
    if fmt == BGR:
        b = bilinear_sample(planes[0], px, py)
        g = bilinear_sample(planes[1], px, py)
        r = bilinear_sample(planes[2], px, py)
        return r, g, b
    if fmt == RGGB:
        r = bilinear_sample(planes[0], px + 0.25, py + 0.25)
        g = 0.5 * bilinear_sample(planes[1], px - 0.25, py + 0.25) + 0.5 * (
            bilinear_sample(planes[2], px + 0.25, py - 0.25)
        )
        b = bilinear_sample(planes[3], px - 0.25, py - 0.25)
        return r, g, b
    if fmt == GRBG:
        r = bilinear_sample(planes[1], px - 0.25, py + 0.25)
        g = 0.5 * bilinear_sample(planes[0], px + 0.25, py + 0.25) + 0.5 * (
            bilinear_sample(planes[3], px - 0.25, py - 0.25)
        )
        b = bilinear_sample(planes[2], px + 0.25, py - 0.25)
        return r, g, b
    raise ValueError(f"unknown raw format {fmt}")


def rgb_to_drgb(r: jnp.ndarray, g: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Differential RGB color space, channels stacked last.

    dR = (2R - G - B + 510) / 4 etc., range [0, 255]
    (reference kernel/resampling.cl:88-94).
    """
    dr = (2 * r - g - b + 510) * 0.25
    dg = (2 * g - b - r + 510) * 0.25
    db = (2 * b - r - g + 510) * 0.25
    return jnp.stack([dr, dg, db], axis=-1)


def resample_flat(
    planes: jnp.ndarray,
    packed_cam: jnp.ndarray,
    max_bot_height: jnp.ndarray,
    field_scale,
    field_offset,
    out_shape: tuple[int, int],
    fmt: str,
) -> jnp.ndarray:
    """Reproject the camera planes onto the flat field grid in dRGB.

    Each output pixel (x, y) corresponds to field position
    (x * field_scale + offx, y * field_scale + offy, max_bot_height); its
    image position comes from the packed camera model. out_shape is (H, W)
    and static; field_scale / field_offset may be traced values (per-camera
    dynamic geometry for batched multi-camera runs).
    """
    hf, wf = out_shape
    field_offset = jnp.asarray(field_offset, dtype=jnp.float32)
    ys = jnp.arange(hf, dtype=jnp.float32) * field_scale + field_offset[1]
    xs = jnp.arange(wf, dtype=jnp.float32) * field_scale + field_offset[0]
    gx, gy = jnp.meshgrid(xs, ys)  # (hf, wf)
    fieldpos = jnp.stack(
        [gx, gy, jnp.full_like(gx, 1.0) * max_bot_height], axis=-1
    )
    img = field2image_packed(packed_cam, fieldpos)
    px, py = img[..., 0], img[..., 1]
    r, g, b = sample_rgb(planes, px, py, fmt)
    return rgb_to_drgb(r, g, b)


_PLANE_OFFSETS = {
    # per-channel quarter-pixel sample offsets within the Bayer cell
    # (reference kernel/resampling.cl:60-84); BGR needs none.
    RGGB: ((0.25, 0.25), (-0.25, 0.25), (0.25, -0.25), (-0.25, -0.25)),
    GRBG: ((0.25, 0.25), (-0.25, 0.25), (0.25, -0.25), (-0.25, -0.25)),
    BGR: ((0.0, 0.0),) * 4,
}


def corner_stack(packed: jnp.ndarray) -> jnp.ndarray:
    """(H, W, 4) planes -> (H, W, 16) uint8 with the 2x2 bilinear corner
    neighborhood pre-stacked into lanes ([self, right, down, down-right],
    clamp-to-edge). One cheap streaming pass per frame; it turns bilinear
    sampling into a single gather of 16-byte rows, and uint8 is exact for
    8-bit camera data — the framework contract is 8-bit sensor input
    (reference PixelFormat, src/opencl.h:30-56)."""
    p = packed.astype(jnp.uint8)
    right = jnp.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    down = jnp.concatenate([p[1:], p[-1:]], axis=0)
    down_right = jnp.concatenate([down[:, 1:], down[:, -1:]], axis=1)
    return jnp.concatenate([p, right, down, down_right], axis=-1)


def sample_planes_packed(packed, px, py, fmt: str):
    """Bilinearly sample all 4 packed planes with ONE gather.

    The 2x2 corner neighborhood is pre-stacked into 16 lanes
    (corner_stack), so each output pixel costs a single 16-wide gather;
    each plane applies its own quarter-pixel offset through per-plane
    fractional weights clamped to the shared 2x2 cell — a <=0.25 px
    approximation at cell boundaries, within the reference's own integer
    LINEAR-sampling ambiguity.
    Returns (..., 4) plane samples.
    """
    h, w = packed.shape[:2]
    u = px - 0.5
    v = py - 0.5
    x0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, h - 1)

    stacked = corner_stack(packed).reshape(-1, 16)
    g = jnp.take(stacked, y0 * w + x0, axis=0).astype(jnp.float32)
    # (uint8 rows widen to f32 after the gather; the lerp below is f32)
    g00, g01, g10, g11 = g[..., 0:4], g[..., 4:8], g[..., 8:12], g[..., 12:16]

    offs = jnp.asarray(_PLANE_OFFSETS[fmt], dtype=jnp.float32)  # (4, 2)
    fx = jnp.clip(u[..., None] + offs[:, 0] - x0[..., None], 0.0, 1.0)
    fy = jnp.clip(v[..., None] + offs[:, 1] - y0[..., None], 0.0, 1.0)

    top = g00 * (1 - fx) + g01 * fx
    bot = g10 * (1 - fx) + g11 * fx
    return top * (1 - fy) + bot * fy


def combine_planes(samples, fmt: str):
    """Per-plane samples (..., 4) -> (r, g, b) per the raw format."""
    if fmt == BGR:
        return samples[..., 2], samples[..., 1], samples[..., 0]
    if fmt == RGGB:
        r = samples[..., 0]
        g = 0.5 * samples[..., 1] + 0.5 * samples[..., 2]
        b = samples[..., 3]
        return r, g, b
    if fmt == GRBG:
        r = samples[..., 1]
        g = 0.5 * samples[..., 0] + 0.5 * samples[..., 3]
        b = samples[..., 2]
        return r, g, b
    raise ValueError(f"unknown raw format {fmt}")


def resample_flat_packed(
    packed: jnp.ndarray,
    packed_cam: jnp.ndarray,
    max_bot_height,
    field_scale,
    field_offset,
    out_shape: tuple[int, int],
    fmt: str,
) -> jnp.ndarray:
    """Fast path of resample_flat on channel-packed planes (H, W, 4)."""
    hf, wf = out_shape
    field_offset = jnp.asarray(field_offset, dtype=jnp.float32)
    ys = jnp.arange(hf, dtype=jnp.float32) * field_scale + field_offset[1]
    xs = jnp.arange(wf, dtype=jnp.float32) * field_scale + field_offset[0]
    gx, gy = jnp.meshgrid(xs, ys)
    fieldpos = jnp.stack([gx, gy, jnp.full_like(gx, 1.0) * max_bot_height], axis=-1)
    img = field2image_packed(packed_cam, fieldpos)
    samples = sample_planes_packed(packed, img[..., 0], img[..., 1], fmt)
    r, g, b = combine_planes(samples, fmt)
    return rgb_to_drgb(r, g, b)


def resample_grid(
    packed_cam,
    max_bot_height,
    field_scale,
    field_offset,
    out_shape: tuple[int, int],
    plane_shape: tuple[int, int],
):
    """Precompute the flat-grid -> packed-plane sampling geometry.

    The per-pixel camera projection (rotation, division, 8 distortion
    iterations — reference kernel/resampling.cl:29-48 runs it per output
    pixel per frame) depends only on calibration, bot height and the grid,
    none of which change frame to frame. Computing it once per calibration
    change and replaying the cached gather indices + bilinear weight bases
    takes the projection out of every frame.

    Returns {"idx": (Hf, Wf) i32 flat index into the (H*W, 16) corner
    stack, "ub"/"vb": (Hf, Wf) f32 fractional offsets u - x0 / v - y0}.
    """
    hf, wf = out_shape
    h, w = plane_shape
    field_offset = jnp.asarray(field_offset, dtype=jnp.float32)
    ys = jnp.arange(hf, dtype=jnp.float32) * field_scale + field_offset[1]
    xs = jnp.arange(wf, dtype=jnp.float32) * field_scale + field_offset[0]
    gx, gy = jnp.meshgrid(xs, ys)
    fieldpos = jnp.stack([gx, gy, jnp.full_like(gx, 1.0) * max_bot_height], axis=-1)
    img = field2image_packed(packed_cam, fieldpos)
    u = img[..., 0] - 0.5
    v = img[..., 1] - 0.5
    x0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, h - 1)
    return {
        "idx": y0 * w + x0,
        "ub": u - x0.astype(jnp.float32),
        "vb": v - y0.astype(jnp.float32),
    }


def _sample_lerp_stacked(stacked16: jnp.ndarray, grid: dict, fmt: str) -> jnp.ndarray:
    """Gather 16-lane u8 corner rows at the cached indices and bilinearly
    blend with the cached per-plane weight bases."""
    g = jnp.take(stacked16, grid["idx"], axis=0).astype(jnp.float32)
    g00, g01, g10, g11 = g[..., 0:4], g[..., 4:8], g[..., 8:12], g[..., 12:16]

    offs = jnp.asarray(_PLANE_OFFSETS[fmt], dtype=jnp.float32)  # (4, 2)
    fx = jnp.clip(grid["ub"][..., None] + offs[:, 0], 0.0, 1.0)
    fy = jnp.clip(grid["vb"][..., None] + offs[:, 1], 0.0, 1.0)

    top = g00 * (1 - fx) + g01 * fx
    bot = g10 * (1 - fx) + g11 * fx
    samples = top * (1 - fy) + bot * fy
    r, gg, b = combine_planes(samples, fmt)
    return rgb_to_drgb(r, gg, b)


def resample_flat_grid(packed: jnp.ndarray, grid: dict, fmt: str) -> jnp.ndarray:
    """resample_flat_packed with the projection replayed from ``grid``.

    Bit-identical to the uncached path: the per-plane quarter-pixel
    fractional weights are clip(ub + off, 0, 1) exactly as
    sample_planes_packed computes clip(u + off - x0, 0, 1).
    """
    return _sample_lerp_stacked(corner_stack(packed).reshape(-1, 16), grid, fmt)


def corner_stack_u32(raw: jnp.ndarray, fmt: str) -> jnp.ndarray:
    """corner_stack built at u32 lane granularity, straight from the raw
    frame: one Bayer cell = one u32 word (byte order == the packed-plane
    row-major cell order on this little-endian target), so the three
    neighbor shifts and the 4-way stack move 4x fewer lanes, and the final
    u32[4] -> u8[16] bitcast replaces the pathological u8 minor-dim
    concats; byte-identical output (tests assert equality)."""
    if fmt == BGR:
        p8 = jnp.concatenate(
            [raw.astype(jnp.uint8), jnp.zeros_like(raw[..., :1], dtype=jnp.uint8)],
            axis=-1,
        )  # (H, W, 4)
        w32 = jax.lax.bitcast_convert_type(p8, jnp.uint32)  # (H, W)
    else:
        h2, w2 = raw.shape[0] // 2, raw.shape[1] // 2
        r4 = raw.reshape(h2, 2, raw.shape[1])
        top16 = jax.lax.bitcast_convert_type(
            r4[:, 0].reshape(h2, w2, 2), jnp.uint16
        )
        bot16 = jax.lax.bitcast_convert_type(
            r4[:, 1].reshape(h2, w2, 2), jnp.uint16
        )
        w32 = top16.astype(jnp.uint32) | (bot16.astype(jnp.uint32) << 16)
    right = jnp.concatenate([w32[:, 1:], w32[:, -1:]], axis=1)
    down = jnp.concatenate([w32[1:], w32[-1:]], axis=0)
    down_right = jnp.concatenate([down[:, 1:], down[:, -1:]], axis=1)
    s32 = jnp.stack([w32, right, down, down_right], axis=-1)  # (H, W, 4) u32
    return jax.lax.bitcast_convert_type(s32, jnp.uint8).reshape(
        w32.shape[0], w32.shape[1], 16
    )


def resample_flat_grid_raw(raw: jnp.ndarray, grid: dict, fmt: str) -> jnp.ndarray:
    """Fastest per-frame resample: cached projection + u32-built corner
    stack straight from the raw frame. Bit-identical to resample_flat_grid."""
    stacked = corner_stack_u32(raw, fmt).reshape(-1, 16)
    return _sample_lerp_stacked(stacked, grid, fmt)


def quad2rgba(planes: jnp.ndarray, fmt: str) -> jnp.ndarray:
    """Demosaic the planes back to a half-resolution RGB image (H, W, 3) f32.

    Bayer planes are blended with the reference's quarter-pixel offsets
    (reference kernel/quad2rgba.cl:23-53); BGR input is a pure channel
    reorder (no resampling blur).
    """
    if fmt == BGR:
        return jnp.stack([planes[2], planes[1], planes[0]], axis=-1)
    h, w = planes.shape[1:]
    px, py = jnp.meshgrid(
        jnp.arange(w, dtype=jnp.float32), jnp.arange(h, dtype=jnp.float32)
    )
    r, g, b = sample_rgb(planes, px, py, fmt)
    return jnp.stack([r, g, b], axis=-1)
