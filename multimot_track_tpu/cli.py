"""Command-line driver — the ``rgbd_mmt`` executable's role
(Examples/RGB-D/rgbd_tum.cc): load a sequence, run multi-motion tracking,
print per-frame metrics, dump trajectories/results/visualisations.

  python -m multimot_track_tpu.cli <sequence_dir> [--settings kitti03.yaml]
      [--frames N] [--out DIR] [--viz] [--profile]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="Multi-motion visual odometry / tracking")
    ap.add_argument("sequence", help="KITTI-format sequence directory")
    ap.add_argument("--settings", help="OpenCV-YAML settings (e.g. kitti03.yaml)")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default=None, help="results output directory")
    ap.add_argument("--viz", action="store_true", help="render overlays per frame")
    ap.add_argument("--profile", action="store_true", help="print stage timing")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument(
        "--stereo", action="store_true",
        help="sequence has image_2/image_3 stereo pairs instead of depth/",
    )
    ap.add_argument(
        "--quad-stereo", action="store_true",
        help="with --stereo: gate/overwrite flow correspondences with "
             "quad-consistent (last-L/R, cur-L/R) descriptor matches "
             "before the ego solve (ORBmatcher::SearchByQuad role)",
    )
    ap.add_argument(
        "--mono", action="store_true",
        help="monocular ego-only odometry from image_0/ grays "
             "(mono_kitti driver role; up-to-scale trajectory + Sim3 ATE)",
    )
    ap.add_argument(
        "--no-loop-closing", action="store_true",
        help="disable keyframe loop detection + pose-graph correction",
    )
    ap.add_argument(
        "--no-keyframes", action="store_true",
        help="disable the keyframe store (also disables loop closing/reloc)",
    )
    ap.add_argument("--keyframe-gap", type=int, default=5)
    ap.add_argument(
        "--no-local-map", action="store_true",
        help="disable per-frame TrackLocalMap pose refinement against "
             "the keyframe map points",
    )
    ap.add_argument(
        "--no-estimate-flow", action="store_true",
        help="do not estimate dense flow when .flo files are missing",
    )
    ap.add_argument(
        "--discover-objects", action="store_true",
        help="mask-free mode: synthesize instance masks from motion "
             "segmentation instead of reading semantic/",
    )
    ap.add_argument(
        "--euroc", action="store_true",
        help="sequence is an EuRoC MAV download (mav0/cam0 + sensor.yaml); "
             "implies --mono; intrinsics+distortion from the dataset's own "
             "metadata (mono_euroc driver role)",
    )
    ap.add_argument(
        "--tum", action="store_true",
        help="sequence is a TUM RGB-D download (rgb.txt/depth.txt/"
             "groundtruth.txt); intrinsics auto-detected, flow estimated "
             "on device (the reference's rgbd_tum driver cannot run these)",
    )
    args = ap.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from multimot_track_tpu.config import DEFAULT_CONFIG
    from multimot_track_tpu.io.native_loader import get_sequence
    from multimot_track_tpu.pipeline.system import MultiMotSystem

    cfg = DEFAULT_CONFIG
    settings = args.settings or pathlib.Path(args.sequence) / "kitti03.yaml"
    if args.settings or settings.exists():
        from multimot_track_tpu.io.yamlcfg import config_from_yaml

        cfg = config_from_yaml(settings, cfg)
    if args.viz:
        from multimot_track_tpu.viz import render

    if args.mono or args.euroc:
        return run_mono(args, cfg)

    if args.tum:
        import dataclasses

        from multimot_track_tpu.io.tum import TumRGBDSequence

        seq = TumRGBDSequence(args.sequence)
        cfg = dataclasses.replace(cfg, camera=seq.camera_config())
    elif args.stereo:
        from multimot_track_tpu.io.stereo_seq import StereoKittiSequence

        seq = StereoKittiSequence(args.sequence, quad_gate=args.quad_stereo)
    else:
        seq = get_sequence(args.sequence)
    if args.no_estimate_flow and hasattr(seq, "estimate_flow"):
        seq.estimate_flow = False
    if args.no_local_map:
        import dataclasses

        cfg = dataclasses.replace(
            cfg, backend=dataclasses.replace(cfg.backend, track_local_map=False)
        )
    n = len(seq) if args.frames is None else min(args.frames, len(seq))
    sys_ = MultiMotSystem(
        cfg,
        enable_keyframes=not args.no_keyframes,
        keyframe_gap=args.keyframe_gap,
        enable_loop_closing=not args.no_loop_closing,
        discover_objects=args.discover_objects,
    )
    out = pathlib.Path(args.out) if args.out else None
    if out:
        out.mkdir(parents=True, exist_ok=True)

    # prefetch thread: frame i+1's disk load + wire packing + transfer
    # enqueue overlap frame i's solve (pipeline/system.run_sequence note)
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(1)

    def _prep(i):
        fd = seq.load_frame(i)
        return fd, sys_.upload(fd)

    fut = pool.submit(_prep, 0)
    for i in range(n):
        fd, handles = fut.result()
        if i + 1 < n:
            fut = pool.submit(_prep, i + 1)
        r = sys_.track_rgbd(fd, uploaded=handles)
        if r is None:
            print(f"frame {i}: initialised")
            continue
        ob = r.objects
        active = np.asarray(ob.active)
        print(
            f"frame {i}: cam RPE t={float(r.cam_t_rpe_rel)*100:.4f}% "
            f"R={float(r.cam_r_rpe_rel):.4f}deg/m "
            f"inliers={int(r.n_static_inliers)}/{int(r.n_static)} "
            f"objects={int(active.sum())} state={sys_.state}"
        )
        for slot in np.flatnonzero(active):
            print(
                f"  obj label={slot+1}: speed {float(ob.speed_est[slot]):.1f}"
                f"/{float(ob.speed_gt[slot]):.1f} km/h  "
                f"RPE t={float(ob.t_rpe_rel[slot])*100:.2f}% "
                f"R={float(ob.r_rpe_rel[slot]):.4f}deg/m"
            )
        if args.viz and out:
            bbs = [np.asarray(ob.bbox[s]) for s in np.flatnonzero(active)]
            labs = [int(s) + 1 for s in np.flatnonzero(active)]
            spds = [float(ob.speed_est[s]) for s in np.flatnonzero(active)]
            render.draw_objects(fd.gray, bbs, labs, spds, path=out / f"speed_{i:06d}.png")

    summary = sys_.summary()
    if getattr(seq, "quad_gate", False):
        summary["n_quad_matched"] = int(seq.n_quad_matched)
    print("\nsummary:", json.dumps(summary, indent=2))
    if out:
        sys_.save_results(out)
        if args.viz:
            obj_pts = [
                (o.centre3d, o.track_id)
                for o in sys_.map.obj_records
                if np.all(np.isfinite(o.centre3d))
            ]
            render.draw_trajectory(
                [np.asarray(p) for p in sys_.map.camera_poses],
                object_centres=obj_pts,
                path=out / "traj.png",
            )
        print(f"results written to {out}")
    if hasattr(seq, "close"):
        seq.close()
    return 0


def run_mono(args, cfg):
    """Monocular ego-only drive (Examples/Monocular/mono_kitti.cc role):
    grayscale frames -> MonoTracker -> up-to-scale trajectory, Sim3-aligned
    ATE against GT poses when the sequence provides them."""
    import jax.numpy as jnp

    import dataclasses

    from multimot_track_tpu.eval import metrics
    from multimot_track_tpu.io.native_loader import get_sequence
    from multimot_track_tpu.pipeline.mono import MonoTracker

    if args.euroc:
        from multimot_track_tpu.io.euroc import EurocSequence

        seq = EurocSequence(args.sequence)
        cfg = dataclasses.replace(cfg, camera=seq.camera_config())
    elif args.tum:
        from multimot_track_tpu.io.tum import TumRGBDSequence

        seq = TumRGBDSequence(args.sequence)
        cfg = dataclasses.replace(cfg, camera=seq.camera_config())
    else:
        seq = get_sequence(args.sequence)
    n = len(seq) if args.frames is None else min(args.frames, len(seq))
    tracker = MonoTracker(cfg)
    gt_list = []
    for i in range(n):
        fd = seq.load_frame(i)
        Tcw = tracker.track(np.asarray(fd.gray, np.float32))
        if fd.pose_gt is not None:
            gt_list.append(np.asarray(fd.pose_gt, np.float32))
        t = np.linalg.inv(Tcw)[:3, 3]
        state = "init" if not tracker.initialized else "track"
        print(f"frame {i}: [{state}] twc=({t[0]:.3f}, {t[1]:.3f}, {t[2]:.3f})")

    Twc_est = np.stack([np.linalg.inv(T) for T in tracker.poses])
    out = pathlib.Path(args.out) if args.out else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "mono_trajectory.txt", "w") as f:
            for T in Twc_est:
                f.write(" ".join(f"{v:.6f}" for v in T[:3].reshape(-1)) + "\n")
        print(f"trajectory written to {out / 'mono_trajectory.txt'}")

    summary = {"n_frames": n, "initialized": tracker.initialized}
    if len(gt_list) == len(tracker.poses) and tracker.initialized:
        gt_Twc = np.stack(gt_list)  # disk poses are Twc already
        rmse, _ = metrics.absolute_trajectory_error(
            jnp.asarray(Twc_est), jnp.asarray(gt_Twc), with_scale=True
        )
        summary["ego_ate_sim3_rmse_m"] = float(rmse)
    print("\nsummary:", json.dumps(summary, indent=2))
    if hasattr(seq, "close"):
        seq.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
