"""chip_smoke.py's phases on tiny models on the CPU (the card runs them at
full width); its main() must refuse a machine without a GPU."""
import json
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
from helpers import patch_tiny_model_types  # noqa: E402
from mlimgsynth_tpu import testing as T  # noqa: E402

TINY = {"sd1": T.TINY_MODEL_TYPE, "sdxl": T.TINY_MODEL_TYPE_XL,
        "sd3": T.TINY_MODEL_TYPE_SD3, "flux_schnell": T.TINY_MODEL_TYPE_FLUX}


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and "[device] platform cpu" in out


def test_main_refuses_outside_repo(tmp_path):
    """Alone in a directory, the script finds no package and prints no
    result."""
    import shutil
    shutil.copy(chip_smoke.__file__, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_phase_device_reports_platform():
    dev = chip_smoke.phase_device(require_gpu=False)
    assert dev["platform"] == "cpu" and dev["count"] >= 1
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.phase_device(require_gpu=True)


def test_phase_kernels_tiny():
    shapes = [("d40 self", (2, 64, 64, 2, 40)),
              ("d40 cross", (2, 64, 77, 2, 40)),
              ("d128 joint", (1, 80, 80, 2, 128)),
              ("d512 vae", (1, 64, 64, 1, 512))]
    routes = chip_smoke.phase_kernels(shapes, qlin_shape=(64, 256, 384))
    assert set(routes.values()) == {"xla"}       # no cuDNN on the CPU


def test_phase_session_and_server_tiny(tmp_path, monkeypatch):
    patch_tiny_model_types(monkeypatch, TINY)
    # make_server sets this process-wide default; keep it inside this test
    # (subprocess tests in the same worker inherit os.environ)
    monkeypatch.setenv("MLIS_PROGRESS_CHUNK", "4")
    s, summary = chip_smoke.phase_session(
        "sd1", mt=TINY["sd1"], size=64, steps=2, workdir=str(tmp_path))
    assert summary["identical"]
    assert summary["step_rel_l2"] <= chip_smoke.STEP_TOL
    chip_smoke.phase_server(s, 64, 2, 7.0, n_req=2)


def test_sd15_path_imports_neither_pillow_nor_safetensors(tmp_path):
    """generate() + a PNG on disk + a server txt2img request, in a fresh
    interpreter, leave PIL and safetensors unimported."""
    code = f"""
import sys, json
sys.path.insert(0, {os.path.dirname(os.path.dirname(__file__))!r})
sys.path.insert(0, {os.path.dirname(__file__)!r})
import chip_smoke
from mlimgsynth_tpu import api, testing as T
from mlimgsynth_tpu.utils.compcache import enable
enable(host_subdir=True)
api._model_types = lambda: {{"sd1": T.TINY_MODEL_TYPE}}
s, _ = chip_smoke.phase_session("sd1", mt=T.TINY_MODEL_TYPE, size=64,
                                steps=2, workdir={str(tmp_path)!r})
chip_smoke.phase_server(s, 64, 2, 7.0, n_req=1)
print(json.dumps([m for m in ("PIL", "safetensors") if m in sys.modules]))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_head_dims():
    from mlimgsynth_tpu.api import _model_types
    mts = _model_types()
    assert chip_smoke.head_dims(mts["sd1"].unet_p) == {40, 80, 160}
    assert chip_smoke.head_dims(mts["sdxl"].unet_p) == {64}
    assert chip_smoke.head_dims(mts["sd3"].unet_p) == {64}
    assert chip_smoke.head_dims(mts["flux_schnell"].unet_p) == {128}
