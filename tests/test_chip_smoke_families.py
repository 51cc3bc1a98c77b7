"""chip_smoke.py's session phase for the other families and its mesh
phase, on tiny models on the CPU (split from test_chip_smoke.py so the
test workers share the load)."""
import dataclasses
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
from helpers import patch_tiny_model_types  # noqa: E402
from test_chip_smoke import TINY  # noqa: E402


@pytest.mark.parametrize("family", ["sdxl", "sd3", "flux-schnell"])
def test_phase_session_tiny(family, tmp_path, monkeypatch):
    patch_tiny_model_types(monkeypatch, TINY)
    mt_name = chip_smoke.FAMILIES[family][0]
    _, summary = chip_smoke.phase_session(
        family, mt=TINY[mt_name], size=64, steps=2, workdir=str(tmp_path))
    assert summary["identical"]
    assert summary["step_rel_l2"] <= chip_smoke.STEP_TOL


# tiny SD3 at 64px: 16 latent + 77 text tokens, which sp4 pads to 96
# (the padded ring); depth 4 so that pp4 has one block per stage
TINY_MESH = {**TINY, "sd3": dataclasses.replace(
    TINY["sd3"], unet_p=dataclasses.replace(
        TINY["sd3"].unet_p, depth=4, d_model=TINY["sd3"].unet_p.width,
        n_head=TINY["sd3"].unet_p.heads))}


@pytest.mark.parametrize("family,name,opts", [
    ("sd1", "sd1 dp2 x tp2", {"dp": 2, "tp": 2}),
    ("sd3", "sd3 sp4", {"sp": 4}),
    ("sd3", "sd3 pp4", {"pp": 4})])
def test_phase_mesh_tiny(family, name, opts, tmp_path):
    """The mesh legs against one device, with the tiny type handed to the
    sessions explicitly (the process-wide type table stays as it is)."""
    from mlimgsynth_tpu import api
    table = api._model_types
    res = chip_smoke.phase_mesh(legs=[(family, 64, 2, [(name, opts)])],
                                workdir=str(tmp_path), mts=TINY_MESH)
    assert [r[0] for r in res] == [name]
    assert api._model_types is table


def test_mesh_model_types_keep_widths():
    from mlimgsynth_tpu.api import _model_types
    full, cut = _model_types(), chip_smoke.mesh_model_types()
    assert cut["sd3"].unet_p.width == full["sd3"].unet_p.width == 1536
    assert cut["sd3"].unet_p.heads == full["sd3"].unet_p.heads == 24
    assert cut["sd3"].unet_p.depth == 8
    assert cut["sdxl"].unet_p.n_ch == full["sdxl"].unet_p.n_ch
    assert cut["sdxl"].unet_p.transf_depth == (1, 1, 1)
    assert cut["sd1"] == full["sd1"]
