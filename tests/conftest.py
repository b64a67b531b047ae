"""Test harness: force an 8-device virtual CPU mesh so sharding paths are
exercised without accelerator hardware (SURVEY.md §4: multi-host tests on a
simulated mesh).  The platform is pinned through the config knob after
importing jax, so the suite runs on the CPU whatever JAX_PLATFORMS says.
Checks that need the GPU carry the ``gpu`` marker and run through the
``gpu_device`` fixture; chip_smoke.py runs the same comparisons on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_max_isa" not in flags:
    # some VMs advertise AVX512/AMX the LLVM JIT miscompiles against
    # (XLA:CPU segfaults intermittently while compiling large programs);
    # AVX2 codegen is reliable and plenty for tests
    flags = (flags + " --xla_cpu_max_isa=AVX2").strip()
os.environ["XLA_FLAGS"] = flags
import jax

jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

REFERENCE_SAMPLE = pathlib.Path("/root/reference/kitti_sample")


@pytest.fixture
def gpu_device():
    """The first GPU, decided when a test asks for it (never at import:
    every xdist worker must collect the same tests)."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU: the compiled kernel has no CPU form "
                    "(chip_smoke.py runs this check on the card)")
    return gpus[0]


@pytest.fixture(scope="session")
def kitti_sample_dir():
    if not REFERENCE_SAMPLE.exists():
        pytest.skip("kitti_sample fixture not available")
    return REFERENCE_SAMPLE


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Free compiled executables after each test module.

    With 120+ tests compiling hundreds of distinct XLA:CPU programs in one
    process, the accumulated live-executable state deterministically
    segfaults the ~114th test's compile (LLVM JIT arena exhaustion; the
    crash needs the long prefix — any suffix subset passes).  Bounding the
    live set per module removes the crash; the persistent on-disk cache
    keeps re-loads cheap."""
    yield
    import jax

    jax.clear_caches()
