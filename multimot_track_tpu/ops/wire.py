"""Wire codec: compact host->device serving formats.

These codecs cut the per-frame wire from 3.72 raw-f32 MB to 1.75 MB: 12-bit
fixed-point flow (1/8 px, +-256 px) at half resolution, 12-bit disparity,
4-bit instance labels.  The first device op of every consumer unpacks to
the same f32/i32 tensors the rest of the pipeline always used.  Shared by
the batched/streaming path (pipeline/batch) and the live loop
(pipeline/system + tracker.full_step).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def pack_flow12(flow: np.ndarray) -> np.ndarray:
    """(H, W, 2) float flow -> (H, W, 3) uint8 (two 12-bit values)."""
    q = np.clip(np.round(np.nan_to_num(flow) * 8.0), -2048, 2047).astype(np.int32) + 2048
    u, v = q[..., 0], q[..., 1]
    return np.stack(
        [(u >> 4), ((u & 15) << 4) | (v >> 8), v & 255], -1
    ).astype(np.uint8)


def unpack_flow12(p) -> jnp.ndarray:
    """(..., H, W, 3) uint8 -> (..., H, W, 2) float32 flow."""
    b = p.astype(jnp.int32)
    u = (b[..., 0] << 4) | (b[..., 1] >> 4)
    v = ((b[..., 1] & 15) << 8) | b[..., 2]
    return (jnp.stack([u, v], -1) - 2048).astype(jnp.float32) * 0.125


def pack_flow12_half(flow: np.ndarray) -> np.ndarray:
    """Half-resolution flow wire format: 2x2-mean downsample then 12-bit
    pack.  Flow is smooth away from object boundaries; the measured metric
    cost of bilinear re-upsampling on device is within the solver's seed
    noise (cam t-RPE 0.0458 -> 0.0460, object within the 0.056-0.073 seed
    band) while cutting the largest wire item 4x (1397 -> 349 KB/frame)."""
    H, W = flow.shape[:2]
    h, w = H - (H % 2), W - (W % 2)
    f = np.nan_to_num(flow[:h, :w]).reshape(h // 2, 2, w // 2, 2, 2).mean((1, 3))
    return pack_flow12(f)


def unpack_flow12_half(p, height: int, width: int) -> jnp.ndarray:
    """Inverse of pack_flow12_half: unpack 12-bit, bilinear-resize to
    (height, width, 2).  Batched leading axes supported."""
    f = unpack_flow12(p)
    out_shape = f.shape[:-3] + (height, width, 2)
    return jax.image.resize(f, out_shape, "linear")


def pack_depth12(raw: np.ndarray) -> np.ndarray:
    """uint16 disparity*256 -> 12-bit pairs, (H, W) -> (H, 3*W/2) uint8.

    Drops the 4 LSB = disparity quantisation step 1/16 px.  The resulting
    depth error at the pipeline's 40 m static ceiling (0.26 m) sits under
    the reference's own depth-noise model sigma = z^2*0.15/362.5 (0.66 m
    at 40 m, src/Frame.cc:1089), so the wire loses nothing the solver
    could use.  931 -> 699 KB/frame."""
    d = (np.asarray(raw).astype(np.uint16) >> 4).astype(np.uint16)  # 12 bit
    if d.shape[-1] % 2:
        d = np.concatenate([d, np.zeros_like(d[..., :1])], -1)
    a, b = d[..., 0::2].astype(np.uint32), d[..., 1::2].astype(np.uint32)
    packed = np.stack([a >> 4, ((a & 15) << 4) | (b >> 8), b & 255], -1)
    return packed.reshape(packed.shape[:-2] + (-1,)).astype(np.uint8)


def unpack_depth12(p, width: int) -> jnp.ndarray:
    """(..., 3*ceil(W/2)) uint8 -> (..., W) float32 disparity*256 values."""
    b = p.reshape(p.shape[:-1] + (-1, 3)).astype(jnp.int32)
    a = (b[..., 0] << 4) | (b[..., 1] >> 4)
    c = ((b[..., 1] & 15) << 8) | b[..., 2]
    full = jnp.stack([a, c], -1).reshape(p.shape[:-1] + (-1,))
    return (full[..., :width] << 4).astype(jnp.float32)


def pack_sem4(sem: np.ndarray) -> np.ndarray:
    """(H, W) labels 0..15 -> (H, ceil(W/2)) uint8 nibble pairs."""
    s = np.clip(sem, 0, 15).astype(np.uint8)
    if s.shape[-1] % 2:
        s = np.concatenate([s, np.zeros_like(s[..., :1])], -1)
    return (s[..., 0::2] << 4) | s[..., 1::2]


def unpack_sem4(p, width: int) -> jnp.ndarray:
    """(..., H, ceil(W/2)) uint8 -> (..., H, W) int32 labels."""
    b = p.astype(jnp.int32)
    full = jnp.stack([b >> 4, b & 15], -1).reshape(p.shape[:-1] + (2 * p.shape[-1],))
    return full[..., :width]


def _decode_flow(flow, height: int = 0, width: int = 0):
    """Accept int16 (x128 fixed point) or the packed 12-bit wire format
    (full- or half-resolution, told apart by the spatial dims)."""
    if flow.dtype == jnp.uint8 and flow.shape[-1] == 3:
        if height and flow.shape[-3] < height:
            return unpack_flow12_half(flow, height, width)
        return unpack_flow12(flow)
    return flow.astype(jnp.float32) * (1.0 / 128.0)


def _decode_depth(depth, width: int):
    """Accept uint16 raw disparity*256 or the packed 12-bit wire format."""
    if depth.dtype == jnp.uint8:
        return unpack_depth12(depth, width)
    return depth.astype(jnp.float32)


def _decode_sem(sem, width: int):
    """Accept uint8 labels or the packed 4-bit wire format."""
    if sem.shape[-1] != width:
        return unpack_sem4(sem, width)
    return sem.astype(jnp.int32)


