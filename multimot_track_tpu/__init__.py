"""multimot_track_tpu — a multi-motion visual odometry framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
MultMotTracking reference system (IROS 2020 "Robust Ego and Object 6-DoF
Motion Estimation and Tracking"): per-frame ego SE(3) pose, per-object rigid
SE(3) motions of dynamic objects, sparse scene flow, motion segmentation and
online ground-truth evaluation — expressed as batched, statically-shaped,
jit-compiled device programs instead of a threaded C++/g2o pipeline.

Layer map (bottom-up):
  geometry/  pure-jnp SE(3) + pinhole camera math
  io/        dataset loaders (KITTI-format images, .flo flow, masks, poses)
  frontend/  feature sampling (FAST corners, dense object grids, flow shift)
  solvers/   batched LM flow-BA (Schur-reduced), Horn/PnP RANSAC
  pipeline/  per-frame-pair tracking step, object association, system facade
  parallel/  device-mesh sharding of frame-pair batches + windowed BA
  eval/      relative-pose-error / speed / segmentation metrics
"""

import os as _os

import jax as _jax

# Geometry/solver math is precision-sensitive (chi2 gates at 0.04 px^2,
# SURVEY.md §7 "Hard parts"): an f32 matmul on a GPU would otherwise run
# in TF32 (~3 decimal digits).  Make full f32 the package default;
# throughput-bound call sites opt into lower precision explicitly.
_jax.config.update("jax_default_matmul_precision", "float32")


def _host_fingerprint() -> str:
    """CPU-feature fingerprint.  XLA:CPU AOT executables are machine-
    feature-specific: loading one cached by a host with different
    features SIGSEGVs inside cpu_aot_loader, so CPU entries are
    partitioned per feature set."""
    try:
        import hashlib

        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha1(line.encode()).hexdigest()[:10]
    except OSError:
        pass
    return "generic"


def compilation_cache_dir() -> "str | None":
    """Where this package keeps JAX's persistent compilation cache.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and wins
    (None: the package sets nothing).  Otherwise one fixed directory
    inside the checkout, ``.jax_cache`` (the path is part of the cache's
    key, so it must not move between runs), with a per-CPU-feature
    subdirectory when the platform is the CPU."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    root = _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )
    platforms = _jax.config.jax_platforms or _os.environ.get("JAX_PLATFORMS", "")
    if platforms.split(",")[0].strip() == "cpu":
        return _os.path.join(root, "cpu-" + _host_fingerprint())
    return root


_cache_dir = compilation_cache_dir()
if _cache_dir is not None:
    try:
        _os.makedirs(_cache_dir, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", _cache_dir)
    except OSError:  # a read-only checkout runs uncached
        pass
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

__version__ = "0.1.0"
