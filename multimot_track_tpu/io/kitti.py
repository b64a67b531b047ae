"""KITTI-format sequence loading (the reference driver's LoadData/LoadMask,
Examples/RGB-D/rgbd_tum.cc:213-513), as NumPy arrays ready for device upload.

Layout of a sequence directory (reference kitti_sample/):
  image/%06d.png     RGB frames
  depth/%06d.png     uint16 disparity*256 (converted downstream via bf/(v/256))
  flow/%06d.flo      dense optical flow frame k -> k+1
  semantic/%06d.txt  per-pixel integer instance labels, whitespace rows
  pose_gt.txt        frame_id + row-major 4x4 camera-to-world pose
  object_pose.txt    frame objID x1 y1 x2 y2 tx ty tz yaw  (KITTI tracking)
  times.txt          timestamps
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, List

import numpy as np

from multimot_track_tpu.io.flowio import read_flo


def read_image(path) -> np.ndarray:
    """PNG/JPEG file -> array.  PIL is imported here, not at module top,
    so the tracking path imports without it."""
    from PIL import Image

    return np.asarray(Image.open(path))


@dataclasses.dataclass
class FrameData:
    """Raw per-frame inputs (host arrays)."""

    index: int
    timestamp: float
    gray: np.ndarray          # (H, W) float32 grayscale in [0, 255]
    depth_raw: np.ndarray     # (H, W) float32 raw png values (disparity*256)
    flow: np.ndarray          # (H, W, 2) float32 flow to next frame
    sem_mask: np.ndarray      # (H, W) int32 instance labels (0 = background)
    pose_gt: np.ndarray       # (4, 4) float32 camera-to-world (as stored on disk)
    obj_ids_gt: np.ndarray    # (M,) int32 ground-truth object ids this frame
    obj_poses_gt: np.ndarray  # (M, 4, 4) float32 camera-frame object poses L
    obj_bboxes_gt: np.ndarray  # (M, 4) float32 [x1 y1 x2 y2]


def _rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """OpenCV RGB2GRAY weights (the reference converts with cvtColor,
    src/Tracking.cc:459-472)."""
    if img.ndim == 2:
        return img.astype(np.float32)
    w = np.asarray([0.299, 0.587, 0.114], np.float32)
    return (img[..., :3].astype(np.float32) @ w).astype(np.float32)


def load_mask_txt(path, height: int, width: int, max_label: int = 4) -> np.ndarray:
    """Whitespace-int per-pixel labels; only labels in (0, max_label) are
    kept, everything else is background 0 (rgbd_tum.cc:335 ``tmp!=0 && tmp<4``)."""
    data = np.loadtxt(path, dtype=np.int32)
    data = np.atleast_2d(data)
    if data.shape != (height, width):
        data = data.reshape(height, width)
    keep = (data != 0) & (data < max_label) & (data > 0)
    return np.where(keep, data, 0).astype(np.int32)


def load_pose_gt(path) -> Dict[int, np.ndarray]:
    out: Dict[int, np.ndarray] = {}
    for line in pathlib.Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        fid = int(float(parts[0]))
        T = np.asarray([float(x) for x in parts[1:17]], np.float32).reshape(4, 4)
        out[fid] = T
    return out


def load_object_pose(path) -> Dict[int, List[np.ndarray]]:
    """frame -> list of raw 10-float rows."""
    out: Dict[int, List[np.ndarray]] = {}
    for line in pathlib.Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        row = np.asarray([float(x) for x in parts], np.float32)
        out.setdefault(int(row[0]), []).append(row)
    return out


def obj_pose_row_to_T(row: np.ndarray) -> np.ndarray:
    """Raw row -> camera-frame SE(3) object pose.

    t = fields 6..8, R = Ry(yaw + pi/2) with x=z=0 Euler — replicating
    Tracking::ObjPoseParsing (src/Tracking.cc:4997-5104).
    """
    t = row[6:9]
    y = row[9] + np.pi / 2
    cy, sy = np.cos(y), np.sin(y)
    R = np.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


class KittiSequence:
    """Lazy per-frame loader over a sequence directory.

    Unlike the reference driver, which aborts without precomputed .flo
    files (Examples/RGB-D/rgbd_tum.cc:129 hard-requires them), a missing
    flow file falls back to on-device dense optical flow
    (frontend/optical_flow.dense_flow) when ``estimate_flow`` is set —
    the framework is self-contained on images+depth alone.
    """

    def __init__(self, root, max_label: int = 4, estimate_flow: bool = True):
        self.root = pathlib.Path(root)
        self.max_label = max_label
        self.estimate_flow = estimate_flow
        self.n_flow_estimated = 0
        times = self.root / "times.txt"
        self.timestamps = (
            [float(s.split()[0]) for s in times.read_text().splitlines() if s.strip()]
            if times.exists()
            else []
        )
        pose = self.root / "pose_gt.txt"
        self.poses_gt = load_pose_gt(pose) if pose.exists() else {}
        objp = self.root / "object_pose.txt"
        self.obj_rows = load_object_pose(objp) if objp.exists() else {}
        n_img = len(list((self.root / "image").glob("*.png")))
        self.n_frames = min(len(self.timestamps), n_img) if self.timestamps else n_img

    def __len__(self) -> int:
        return self.n_frames

    def frame_paths(self, i: int):
        stem = f"{i:06d}"
        return {
            "image": self.root / "image" / f"{stem}.png",
            "depth": self.root / "depth" / f"{stem}.png",
            "flow": self.root / "flow" / f"{stem}.flo",
            "semantic": self.root / "semantic" / f"{stem}.txt",
        }

    def _load_gray(self, i: int) -> np.ndarray:
        return _rgb_to_gray(read_image(self.frame_paths(i)["image"]))

    def _flow_or_estimate(self, i: int, gray: np.ndarray) -> np.ndarray:
        """Read .flo if present, else estimate k -> k+1 flow on device."""
        p = self.frame_paths(i)
        if p["flow"].exists():
            return read_flo(p["flow"])
        if self.estimate_flow and i + 1 < self.n_frames:
            import jax.numpy as jnp

            from multimot_track_tpu.frontend.optical_flow import dense_flow

            nxt = self._load_gray(i + 1)
            self.n_flow_estimated += 1
            return np.asarray(dense_flow(jnp.asarray(gray), jnp.asarray(nxt)))
        return np.zeros(gray.shape + (2,), np.float32)

    def load_frame(self, i: int) -> FrameData:
        p = self.frame_paths(i)
        img = read_image(p["image"])
        gray = _rgb_to_gray(img)
        depth_raw = read_image(p["depth"]).astype(np.float32)
        H, W = gray.shape
        flow = self._flow_or_estimate(i, gray)
        # missing masks degrade to background-only (pair with the system's
        # discover_objects mode for mask-free tracking); the reference
        # aborts instead (rgbd_tum.cc:316)
        sem = (
            load_mask_txt(p["semantic"], H, W, self.max_label)
            if p["semantic"].exists()
            else np.zeros((H, W), np.int32)
        )
        rows = self.obj_rows.get(i, [])
        obj_ids = np.asarray([int(r[1]) for r in rows], np.int32)
        obj_poses = (
            np.stack([obj_pose_row_to_T(r) for r in rows])
            if rows
            else np.zeros((0, 4, 4), np.float32)
        )
        obj_boxes = (
            np.stack([r[2:6] for r in rows]).astype(np.float32)
            if rows
            else np.zeros((0, 4), np.float32)
        )
        return FrameData(
            index=i,
            timestamp=self.timestamps[i] if i < len(self.timestamps) else float(i),
            gray=gray,
            depth_raw=depth_raw,
            flow=flow,
            sem_mask=sem,
            pose_gt=self.poses_gt.get(i, np.eye(4, dtype=np.float32)),
            obj_ids_gt=obj_ids,
            obj_poses_gt=obj_poses,
            obj_bboxes_gt=obj_boxes,
        )
