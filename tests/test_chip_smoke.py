"""chip_smoke.py on the CPU: it refuses to run without a GPU, ``--multi``
selects only the four-card phase, and every phase passes at a tiny size
with the Triton kernel in the Pallas interpreter (a rehearsal of the chip
run; the real run is ``python chip_smoke.py`` on the card)."""

import json
import os
import shutil
import subprocess
import sys
from functools import partial

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("args", [[], ["--multi"]])
def test_exits_nonzero_without_gpu(args):
    out = _run(args, REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run([], tmp_path)
    assert out.returncode != 0 and '"ok": true' not in out.stdout


def test_multi_selects_only_its_phase():
    assert chip_smoke.selected_phases(True) == [chip_smoke.phase_multi]
    single = chip_smoke.selected_phases(False)
    assert len(single) == 6 and chip_smoke.phase_multi not in single


def test_phase_failure_is_reported(capsys):
    ph = chip_smoke.Phase("x")
    ph.check("inside", 1e-5, 1e-4)
    ph.check("outside", 2e-4, 1e-4)
    ph.check("nan", float("nan"), 1.0)
    with pytest.raises(chip_smoke.PhaseFailed, match="outside"):
        ph.finish()
    record = json.loads(capsys.readouterr().out)
    assert record["ok"] is False
    assert record["inside"] == {"value": 1e-5, "limit": 1e-4}


@pytest.fixture()
def tiny(monkeypatch):
    """Shrink every phase to CPU size; interpret the Triton kernel."""
    from watermarking_gpu_tpu.ops import gram_triton

    monkeypatch.setattr(gram_triton, "gram_p3_triton",
                        partial(gram_triton.gram_p3_triton, interpret=True))
    monkeypatch.setattr(chip_smoke, "ROWS", 64)
    monkeypatch.setattr(chip_smoke, "COLS", 96)
    monkeypatch.setattr(chip_smoke, "SIZES_4K", ((64, 128), (64, 136)))
    monkeypatch.setattr(chip_smoke, "N_CANDIDATES", 8)
    monkeypatch.setattr(chip_smoke, "VIDEO_FRAMES", 4)


@pytest.mark.parametrize("phase", ["phase_a", "phase_b", "phase_c",
                                   "phase_d", "phase_e", "phase_f",
                                   "phase_multi"])
def test_phase_passes_at_tiny_size(tiny, phase, capsys):
    getattr(chip_smoke, phase)()
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["ok"] is True
