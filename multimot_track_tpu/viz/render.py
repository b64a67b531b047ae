"""Offline visualization — the Viewer/FrameDrawer/MapDrawer replacement.

The reference renders live OpenCV/Pangolin windows and dumps ``feat.png``,
``speed.png``, ``traj.png`` (src/Tracking.cc:684-878, src/FrameDrawer.cc,
src/MapDrawer.cc).  A batch pipeline has no display; the equivalents
here render the same artifacts to files with PIL — feature/flow overlays,
object bounding boxes with speed labels, the 2-D top-down trajectory
canvas, and the birds-eye scene-flow view (DrawSparseFlowBirdeye).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

_COLORS = [
    (255, 0, 0), (0, 200, 0), (60, 60, 255), (255, 200, 0),
    (200, 0, 200), (0, 200, 200), (255, 128, 64), (128, 255, 128),
]


def _to_rgb(gray: np.ndarray) -> Image.Image:
    g = np.clip(gray, 0, 255).astype(np.uint8)
    return Image.fromarray(np.stack([g, g, g], axis=-1))


def draw_features(
    gray: np.ndarray,
    uv: np.ndarray,
    valid: np.ndarray,
    flow: Optional[np.ndarray] = None,
    path=None,
    color=(0, 255, 0),
) -> Image.Image:
    """Keypoint (+ flow vector) overlay — FrameDrawer::Update + the flow
    illustration block (src/Tracking.cc:322-398)."""
    img = _to_rgb(gray)
    d = ImageDraw.Draw(img)
    for i in np.flatnonzero(valid):
        x, y = float(uv[i, 0]), float(uv[i, 1])
        d.ellipse([x - 1.5, y - 1.5, x + 1.5, y + 1.5], outline=color)
        if flow is not None:
            d.line([x, y, x + float(flow[i, 0]), y + float(flow[i, 1])], fill=(255, 0, 0))
    if path:
        img.save(path)
    return img


def draw_objects(
    gray: np.ndarray,
    bboxes: Sequence[np.ndarray],
    labels: Sequence[int],
    speeds: Optional[Sequence[float]] = None,
    path=None,
) -> Image.Image:
    """Bounding boxes + per-object speed annotation (``speed.png`` analog,
    src/Tracking.cc:786-878)."""
    img = _to_rgb(gray)
    d = ImageDraw.Draw(img)
    for k, (bb, lab) in enumerate(zip(bboxes, labels)):
        c = _COLORS[int(lab) % len(_COLORS)]
        d.rectangle([float(bb[0]), float(bb[1]), float(bb[2]), float(bb[3])], outline=c, width=2)
        txt = f"#{int(lab)}"
        if speeds is not None:
            txt += f" {speeds[k]:.1f} km/h"
        d.text((float(bb[0]), max(float(bb[1]) - 12, 0)), txt, fill=c)
    if path:
        img.save(path)
    return img


def draw_trajectory(
    poses_Twc: Iterable[np.ndarray],
    object_centres: Optional[Sequence[tuple]] = None,
    size: int = 800,
    scale: float = 6.0,
    path=None,
) -> Image.Image:
    """Top-down x-z trajectory canvas (``traj.png`` / imTraj analog)."""
    img = Image.new("RGB", (size, size), (255, 255, 255))
    d = ImageDraw.Draw(img)
    cx, cz = size // 2, int(size * 0.8)
    prev = None
    for T in poses_Twc:
        x = cx + int(T[0, 3] * scale)
        z = cz - int(T[2, 3] * scale)
        if prev is not None:
            d.line([prev, (x, z)], fill=(0, 0, 255), width=2)
        prev = (x, z)
    if object_centres:
        for (pt, lab) in object_centres:
            c = _COLORS[int(lab) % len(_COLORS)]
            x = cx + int(pt[0] * scale)
            z = cz - int(pt[2] * scale)
            d.ellipse([x - 3, z - 3, x + 3, z + 3], fill=c)
    if path:
        img.save(path)
    return img


def draw_birdeye_flow(
    pts: np.ndarray,        # (N, 3) last-frame world points
    vel: np.ndarray,        # (N, 3) 3-D scene flow
    valid: np.ndarray,
    x_range=(-15.0, 15.0),
    z_range=(0.0, 30.0),
    size: int = 600,
    path=None,
) -> Image.Image:
    """Birds-eye sparse scene flow (Tracking::DrawSparseFlowBirdeye)."""
    img = Image.new("RGB", (size, size), (0, 0, 0))
    d = ImageDraw.Draw(img)
    sx = size / (x_range[1] - x_range[0])
    sz = size / (z_range[1] - z_range[0])
    for i in np.flatnonzero(valid):
        x = (pts[i, 0] - x_range[0]) * sx
        z = size - (pts[i, 2] - z_range[0]) * sz
        d.point((x, z), fill=(0, 255, 0))
        d.line([x, z, x + vel[i, 0] * sx, z - vel[i, 2] * sz], fill=(255, 0, 0))
    if path:
        img.save(path)
    return img
