"""Dense-traffic k_obj_solve A/B (VERDICT r4 #4).

The reference solves EVERY detected object sequentially each frame, with
association tables sized for ~12 concurrent movers
(/root/reference/src/Tracking.cc:1658-2253, 704-748).  Our vmapped
ensemble solves a top-``k_obj_solve`` batch; movers beyond it are demoted
to inactive for that frame (tracker.py ``active &= solved``).  This tool
measures what the cap COSTS in accuracy and ID stability on a scene with 7+
concurrent distinct-label movers (io/synth.make_junction_frames), so the
default is picked from data rather than assumption.

For each k in {4, 6, 8}: per-label record coverage (frames with a
GT-matched estimate / frames the label was visible), translation +
speed accuracy, and the count of coverage gaps (frames where a previously
tracked label produced no record — the demotion dropouts).

Writes KOBJ_AB.json and prints one row per k.

  python tools/measure_kobj_ab.py [--frames 60] [--kitti]
"""

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def run_one(frames, cfg, k_solve):
    from multimot_track_tpu.pipeline.system import MultiMotSystem

    cfg = dataclasses.replace(
        cfg,
        padding=dataclasses.replace(
            cfg.padding, k_obj_max=8, k_obj_solve=k_solve
        ),
    )
    sys_ = MultiMotSystem(cfg)
    t0 = time.perf_counter()
    for fd in frames:
        sys_.track_rgbd(fd)
    wall = time.perf_counter() - t0

    # visibility: frames where each GT label has enough mask pixels to be
    # estimable at all (mirrors the tracker's min-point gate)
    vis = {}
    for fd in frames:
        lab, cnt = np.unique(fd.sem_mask[fd.sem_mask > 0], return_counts=True)
        for l, c in zip(lab.tolist(), cnt.tolist()):
            if c >= 150:
                vis.setdefault(l, set()).add(fd.index)

    recs = [r for r in sys_.map.obj_records if r.has_gt]
    by_sem = {}
    for r in recs:
        by_sem.setdefault(int(r.sem_label), []).append(r)

    per_label = {}
    total_gaps = 0
    for l, frames_vis in sorted(vis.items()):
        rs = by_sem.get(l, [])
        got = sorted(int(r.frame) for r in rs)
        # coverage gaps: visible frames AFTER first acquisition with no
        # record — the demotion dropout signature
        gaps = 0
        if got:
            lo = got[0]
            have = set(got)
            gaps = sum(
                1 for f in frames_vis if lo < f <= max(got) and f not in have
            )
        total_gaps += gaps
        per_label[l] = {
            "n_visible": len(frames_vis),
            "n_records": len(rs),
            "coverage": round(len(rs) / max(len(frames_vis), 1), 3),
            "gaps": gaps,
            "t_rpe_centred_med": round(float(np.nanmedian(
                [r.t_rpe_centred for r in rs]
            )), 4) if rs else None,
            "speed_err_med": round(float(np.nanmedian(
                [r.speed_err_rel for r in rs
                 if np.isfinite(r.speed_err_rel)] or [np.nan]
            )), 4) if rs else None,
        }

    tracked = [l for l, d in per_label.items() if d["n_records"] >= 5]
    tc = [per_label[l]["t_rpe_centred_med"] for l in tracked
          if per_label[l]["t_rpe_centred_med"] is not None]
    return {
        "k_obj_solve": k_solve,
        "wall_s": round(wall, 1),
        "n_labels_visible": len(vis),
        "n_labels_tracked": len(tracked),
        "n_records": len(recs),
        "total_gaps": total_gaps,
        "mean_coverage": round(float(np.mean(
            [d["coverage"] for d in per_label.values()]
        )), 3),
        "t_rpe_centred_med_over_labels": round(float(np.median(tc)), 4)
        if tc else None,
        "cam_t_rpe": sys_.summary()["cam_t_rpe_rel_mean"],
        "per_label": per_label,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--kitti", action="store_true",
                    help="KITTI resolution/camera (device run) instead of "
                    "the 640x384 host-sized camera")
    args = ap.parse_args()

    from multimot_track_tpu.config import DEFAULT_CONFIG
    from multimot_track_tpu.io import synth

    if args.kitti:
        cam = dict(synth.KITTI_SYNTH_CAM)
        cfg = DEFAULT_CONFIG
    else:
        cam = dict(synth.SYNTH_CAM)
        # obj_sample_step 2: restores the reference's world-space sample
        # density at the quick camera's lower resolution (see
        # tests/test_kobj_demotion.py CFG note)
        cfg = dataclasses.replace(
            DEFAULT_CONFIG, camera=synth.synth_camera_config(),
            frontend=dataclasses.replace(
                DEFAULT_CONFIG.frontend, obj_sample_step=2
            ),
            padding=dataclasses.replace(
                DEFAULT_CONFIG.padding, n_static_max=1024, n_obj_pts_max=8192
            ),
            solver=dataclasses.replace(
                DEFAULT_CONFIG.solver, ransac_iters=200, cam_lm_iters=60,
                obj_lm_iters=100,
            ),
        )

    print(f"[kobj_ab] rendering junction ({args.frames} frames) ...",
          flush=True)
    frames = synth.make_junction_frames(n_frames=args.frames, cam=cam)

    rows = []
    for k in (4, 6, 8):
        r = run_one(frames, cfg, k)
        print(json.dumps({k2: v for k2, v in r.items() if k2 != "per_label"}),
              flush=True)
        rows.append(r)

    root = pathlib.Path(__file__).resolve().parent.parent
    (root / "KOBJ_AB.json").write_text(json.dumps(rows, indent=1))
    print("wrote KOBJ_AB.json")


if __name__ == "__main__":
    main()
