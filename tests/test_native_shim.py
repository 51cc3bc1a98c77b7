"""Builds and runs the C ABI shim smoke test (native/test_shim.c)."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(shutil.which("cc") is None,
                                reason="no C compiler")


@pytest.fixture(scope="module")
def shim():
    r = subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        pytest.fail(f"shim build failed:\n{r.stderr[-2000:]}")
    return os.path.join(REPO, "native", "test_shim")


def run_shim(shim, args, tmp_path):
    env = dict(os.environ)
    env.update(MLIS_PY_PATH=REPO, MLIS_TINY_MODELS="1", JAX_PLATFORMS="cpu")
    return subprocess.run([shim] + args, capture_output=True, text=True,
                          env=env, cwd=str(tmp_path), timeout=600)


def test_shim_no_model(shim, tmp_path):
    r = run_shim(shim, [], tmp_path)
    assert "TEST OK" in r.stdout, r.stdout + r.stderr
    assert "FAIL" not in r.stdout


def test_shim_generate(shim, tmp_path):
    from helpers import write_tiny_checkpoint
    ckpt = tmp_path / "tiny.safetensors"
    write_tiny_checkpoint(ckpt)
    r = run_shim(shim, [str(ckpt)], tmp_path)
    assert "TEST OK" in r.stdout, r.stdout + r.stderr
    assert "ok: generate" in r.stdout
    assert "ok: per-step callbacks" in r.stdout


REF_DEMO = "/root/reference/src/demo_mlimgsynth.c"


@pytest.mark.skipif(not os.path.exists(REF_DEMO),
                    reason="reference checkout not available")
def test_reference_demo_compiles_unchanged(shim):
    """ABI completeness: the reference project's own demo_mlimgsynth.c must
    compile and link UNCHANGED against include/mlimgsynth.h +
    lib/libmlimgsynth.so (it uses mlis_tensor_for, mlis_stage_str, varargs
    options, tensor slots — reference: src/demo_mlimgsynth.c:44-99)."""
    r = subprocess.run(["make", "-C", os.path.join(REPO, "native"),
                        "ref_demo"], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.path.exists(os.path.join(REPO, "native", "ref_demo"))
