"""tools/repro_check.py on a tiny model on the CPU (the card runs it at the
families' bench sizes)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import chip_smoke  # noqa: E402
import repro_check  # noqa: E402
from helpers import TINY_MODEL_TYPE, patch_tiny_model_types  # noqa: E402
from mlimgsynth_tpu.ops import attention as A  # noqa: E402


def test_main_refuses_cpu(tmp_path, capsys):
    assert repro_check.main(["--workdir", str(tmp_path / "w")]) != 0
    assert "[repro]" not in capsys.readouterr().out
    assert not (tmp_path / "w").exists()


@pytest.mark.parametrize("routes", [("rule",), ("xla",), ("rule", "xla")])
def test_image_digests_tiny(routes, tmp_path, monkeypatch):
    """One session across the routes, as main() runs them."""
    patch_tiny_model_types(monkeypatch)
    paths = repro_check.checkpoint("sd1", str(tmp_path))
    s = chip_smoke.make_session(paths, TINY_MODEL_TYPE, 64, 2, 7.0, 0)
    real = A.attention_route
    digests = set()
    for route in routes:
        with repro_check.forced_route(route):
            assert A.attention_route(40, "bfloat16", "gpu") == (
                "cudnn" if route == "rule" else route)
            forced, calls = A.attention_route, []
            A.attention_route = lambda *a: calls.append(a) or forced(*a)
            d, dt = repro_check.image_digests(s, n=2)
        assert A.attention_route is real
        assert calls, "the session's programs were not traced again"
        assert len(d) == 2 and dt > 0
        digests |= set(d)
    assert len(digests) == 1          # the CPU is deterministic


def test_checkpoint_written_once(tmp_path, monkeypatch):
    patch_tiny_model_types(monkeypatch)
    paths = repro_check.checkpoint("sd1", str(tmp_path))
    mtimes = {p: os.stat(p).st_mtime_ns for p in paths.values()}
    assert repro_check.checkpoint("sd1", str(tmp_path)) == paths
    assert {p: os.stat(p).st_mtime_ns for p in paths.values()} == mtimes
