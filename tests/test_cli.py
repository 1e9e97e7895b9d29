"""CLI smoke tests on the CPU backend (tiny loops)."""

import os
import shutil

import numpy as np
import pytest

from watermarking_gpu_tpu.cli import main as cli
from watermarking_gpu_tpu.io.matfile import save_watermark

SAMPLES = "/root/reference/Watermark_GPU/samples"


@pytest.fixture()
def ini(tmp_path, rng):
    """A settings.ini over a small generated image + watermark."""
    from PIL import Image
    img = np.clip(rng.normal(128, 40, (96, 128, 3)), 0, 255).astype(np.uint8)
    img_path = tmp_path / "img.png"
    Image.fromarray(img).save(img_path)
    wm_path = tmp_path / "w.dat"
    save_watermark(wm_path, rng.normal(size=(96, 128)).astype(np.float32))
    path = tmp_path / "settings.ini"
    path.write_text(f"""
[paths]
image = {img_path}
watermark = {wm_path}

[options]
opencl_device = 0
save_watermarked_files_to_disk = true
execution_time_in_fps = false

[parameters]
p = 3
psnr = 40.0
loops_for_test = 1
""")
    return str(path), str(img_path)


def test_cli_image_flow(ini, capsys):
    path, img_path = ini
    assert cli.main([path]) == 0
    out = capsys.readouterr().out
    assert "Correlation [NVF]:" in out
    assert "Correlation [ME]:" in out
    assert "Watermark strength (parameter a):" in out
    root, ext = os.path.splitext(img_path)
    assert os.path.exists(f"{root}_W_NVF{ext}")
    assert os.path.exists(f"{root}_W_ME{ext}")


def test_cli_invalid_device_falls_back(tmp_path, ini, capsys):
    """opencl_device beyond the device count falls back to 0 with a NOTE
    (reference: af::setDevice fallback, main.cpp:72-78)."""
    path, _ = ini
    text = open(path).read().replace("opencl_device = 0",
                                     "opencl_device = 99")
    bad = tmp_path / "dev99.ini"
    bad.write_text(text)
    assert cli.main([str(bad)]) == 0
    out = capsys.readouterr().out
    assert "NOTE: Invalid device specified, using default 0" in out
    assert "Correlation [ME]:" in out


def test_compilation_cache_setting(tmp_path, ini, capsys, monkeypatch):
    """compilation_cache_dir wires up JAX's persistent executable cache
    when JAX_COMPILATION_CACHE_DIR is unset."""
    import jax

    from watermarking_gpu_tpu.io.config import load_settings
    from watermarking_gpu_tpu.utils import enable_compilation_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    previous = jax.config.jax_compilation_cache_dir
    path, _ = ini
    cache = tmp_path / "cache"
    text = open(path).read().replace(
        "[options]", f"[options]\ncompilation_cache_dir = {cache}")
    cached_ini = tmp_path / "cache.ini"
    cached_ini.write_text(text)
    assert load_settings(cached_ini).compilation_cache_dir == str(cache)

    try:
        got = enable_compilation_cache(cache)
        assert got == str(cache) and cache.is_dir()
        assert jax.config.jax_compilation_cache_dir == str(cache)
    finally:
        jax.config.update("jax_compilation_cache_dir", previous)


def test_cli_missing_settings(capsys):
    assert cli.main(["/nonexistent/settings.ini"]) == 1
    assert "Could not load" in capsys.readouterr().out


def test_cli_bad_p(tmp_path, ini, capsys):
    path, _ = ini
    text = open(path).read().replace("p = 3", "p = 4")
    bad = tmp_path / "bad.ini"
    bad.write_text(text)
    assert cli.main([str(bad)]) == 1
    assert "p parameter must be one of 3, 5, 7, 9" in capsys.readouterr().out


def test_cli_p5_runs_generalized_me(tmp_path, ini, capsys):
    """p in {5,7,9} runs BOTH masks: NVF with the wide fused window, ME with
    the generalized (p*p-1)-tap predictor the reference TODO'd away
    (main.cpp:88-89) — with a NOTE announcing the extension."""
    path, img_path = ini
    text = open(path).read().replace("p = 3", "p = 5")
    ini5 = tmp_path / "p5.ini"
    ini5.write_text(text)
    assert cli.main([str(ini5)]) == 0
    out = capsys.readouterr().out
    assert "generalized 24-tap predictor" in out
    assert "Correlation [NVF]:" in out
    assert "Correlation [ME]:" in out
    root, ext = os.path.splitext(img_path)
    assert os.path.exists(f"{root}_W_NVF{ext}")
    assert os.path.exists(f"{root}_W_ME{ext}")


def test_cli_video_p5(tmp_path, rng, capsys):
    """Video mode (ME mask) works at p=5 through the generalized predictor."""
    from watermarking_gpu_tpu.video import synthesize
    clip = tmp_path / "clip.yuv"
    clip.write_bytes(synthesize(128, 96, 2, seed=1))
    wm = tmp_path / "w.dat"
    save_watermark(wm, rng.normal(size=(96, 128)).astype(np.float32))
    ini = tmp_path / "v.ini"
    ini.write_text(f"""
[paths]
video = {clip}
watermark = {wm}

[parameters]
p = 5
psnr = 40.0

[parameters_video]
watermark_detection = true
watermark_interval = 1
raw_video_size = 128x96
""")
    assert cli.main([str(ini)]) == 0
    out = capsys.readouterr().out
    assert "Correlation for frame: 0:" in out
    assert "Correlation for frame: 1:" in out


def test_cli_bad_psnr(tmp_path, ini, capsys):
    path, _ = ini
    text = open(path).read().replace("psnr = 40.0", "psnr = -1")
    bad = tmp_path / "bad.ini"
    bad.write_text(text)
    assert cli.main([str(bad)]) == 1
    assert "PSNR must be a positive number" in capsys.readouterr().out


def test_cli_small_image(tmp_path, ini, capsys, rng):
    """Images below 64px per side are rejected (main.cpp:161)."""
    from PIL import Image
    img = np.zeros((32, 32, 3), dtype=np.uint8)
    small = tmp_path / "small.png"
    Image.fromarray(img).save(small)
    save_watermark(tmp_path / "w32.dat",
                   rng.normal(size=(32, 32)).astype(np.float32))
    path, _ = ini
    text = open(path).read()
    text = text.replace(text.split("image = ")[1].split("\n")[0], str(small))
    text = text.replace(text.split("watermark = ")[1].split("\n")[0],
                        str(tmp_path / "w32.dat"))
    bad = tmp_path / "small.ini"
    bad.write_text(text)
    assert cli.main([str(bad)]) == 1
    assert "Image dimensions too low" in capsys.readouterr().out


def test_cli_synthetic_inputs_from_seeds(tmp_path, capsys):
    """``image = synthetic:WxH:SEED`` and an integer watermark seed need no
    input files; saving is skipped with a NOTE for a synthetic image."""
    ini = tmp_path / "seed.ini"
    ini.write_text("""
[paths]
image = synthetic:128x96:7
watermark = 28390211

[options]
save_watermarked_files_to_disk = true

[parameters]
p = 3
psnr = 40.0
loops_for_test = 1
""")
    assert cli.main([str(ini)]) == 0
    out = capsys.readouterr().out
    assert "96 rows and 128 columns" in out
    assert "Correlation [ME]:" in out
    assert "NOTE: synthetic input image, nothing saved" in out


def test_repo_settings_use_seeded_inputs():
    """The bundled settings.ini runs anywhere: its inputs come from seeds."""
    from watermarking_gpu_tpu.io.config import load_settings

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    settings = load_settings(os.path.join(repo, "settings.ini"))
    assert settings.image.startswith("synthetic:")
    assert settings.watermark.isdigit()


def test_cli_video_dispatch(tmp_path, rng, capsys):
    """[paths] video selects the video pipeline (detect mode)."""
    from watermarking_gpu_tpu.video import synthesize
    clip = tmp_path / "clip.yuv"
    clip.write_bytes(synthesize(128, 96, 4, seed=1))
    wm = tmp_path / "w.dat"
    save_watermark(wm, rng.normal(size=(96, 128)).astype(np.float32))
    ini = tmp_path / "v.ini"
    ini.write_text(f"""
[paths]
video = {clip}
watermark = {wm}

[parameters]
p = 3
psnr = 40.0

[parameters_video]
watermark_interval = 2
watermark_detection = true
raw_video_size = 128x96
""")
    assert cli.main([str(ini)]) == 0
    out = capsys.readouterr().out
    assert "Correlation for frame: 0:" in out
    assert "Correlation for frame: 2:" in out
    assert "Watermark detection total execution time" in out


def test_display_array(tmp_path, rng):
    from watermarking_gpu_tpu.utils import display_array
    arr = rng.normal(size=(32, 48))
    path = display_array(arr, path=str(tmp_path / "dbg.png"))
    assert os.path.exists(path)
    from PIL import Image
    assert Image.open(path).size == (48, 32)


def test_profiling_trace(tmp_path, rng):
    """trace() captures a profiler dump into the target dir; None no-ops."""
    import jax.numpy as jnp

    from watermarking_gpu_tpu.utils import annotate, trace
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)):
        with annotate("embed-section"):
            jnp.square(jnp.arange(8.0)).block_until_ready()
    assert any(log_dir.rglob("*"))   # plugin wrote profile artifacts
    with trace(None):                # no-op path
        pass
    assert not (tmp_path / "none").exists()


def test_robustness_tool(tmp_path, rng, capsys):
    import sys
    sys.path.insert(0, "tools")
    from PIL import Image
    img = np.clip(rng.normal(128, 40, (96, 128)), 0, 255).astype(np.uint8)
    path = tmp_path / "img.png"
    Image.fromarray(img).save(path)
    import evaluate_robustness
    assert evaluate_robustness.main.__module__  # imported fine
    old_argv = sys.argv
    sys.argv = ["evaluate_robustness.py", str(path), "--psnr", "35"]
    try:
        assert evaluate_robustness.main() == 0
    finally:
        sys.argv = old_argv
    out = capsys.readouterr().out
    assert "gaussian noise" in out and "jpeg q=90" in out
    # the unattacked mark must correlate far above the clean image
    lines = {l.rsplit(None, 1)[0].strip(): float(l.rsplit(None, 1)[1])
             for l in out.splitlines() if l.strip().endswith(tuple("0123456789"))
             and ("+" in l or "-" in l.rsplit(None, 1)[-1])}
    assert lines["none"] > lines["clean image (no mark)"] + 0.1
