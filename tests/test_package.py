"""Package-level setup: compile-cache placement and the main path's
imports, each checked in a fresh interpreter pinned to the CPU."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

PROBE = """
import jax
import multimot_track_tpu as m
print(jax.config.jax_compilation_cache_dir)
"""


def _run(code, **env_over):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORMS")}
    env.update(env_over)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()


@pytest.mark.parametrize("case", ["env_set", "cpu_default", "gpu_default"])
def test_compile_cache_placement(case, tmp_path):
    if case == "env_set":
        # JAX's own variable wins; the package sets no other directory
        got = _run(PROBE, JAX_PLATFORMS="cpu",
                   JAX_COMPILATION_CACHE_DIR=str(tmp_path))[-1]
        assert got == str(tmp_path)
    elif case == "cpu_default":
        got = pathlib.Path(_run(PROBE, JAX_PLATFORMS="cpu")[-1])
        assert got.parent == REPO / ".jax_cache"
        assert got.name.startswith("cpu-")
    else:
        # nothing initialises a backend at import, so naming the GPU
        # platform needs no card: one fixed path inside the checkout
        got = _run(PROBE, JAX_PLATFORMS="cuda")[-1]
        assert got == str(REPO / ".jax_cache")


def test_main_path_imports_without_pil_or_yaml():
    code = """
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("PIL", "yaml"):
            raise ImportError("blocked " + name)

sys.meta_path.insert(0, Block())
import multimot_track_tpu.pipeline.system
import multimot_track_tpu.pipeline.batch
import multimot_track_tpu.io.stream
import multimot_track_tpu.io.synth
import multimot_track_tpu.cli
import chip_smoke
print(sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "yaml")))
"""
    assert _run(code, JAX_PLATFORMS="cpu")[-1] == "[]"
