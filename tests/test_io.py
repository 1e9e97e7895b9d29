"""IO tests: .dat files, images, settings.ini parsing."""

import os

import numpy as np
import pytest

from watermarking_gpu_tpu.io import (WatermarkFileError,
                                     add_suffix_before_extension,
                                     generate_watermark, load_image_gray,
                                     load_image_rgb, load_settings,
                                     load_watermark, save_image_u8,
                                     save_watermark)

REFERENCE_SAMPLES = "/root/reference/Watermark_GPU/samples"


def test_dat_roundtrip(tmp_path, rng):
    m = rng.normal(size=(17, 23)).astype(np.float32)
    path = tmp_path / "w.dat"
    save_watermark(path, m)
    got = load_watermark(path, 17, 23)
    np.testing.assert_array_equal(got, m)


def test_dat_size_validation(tmp_path):
    path = tmp_path / "w.dat"
    save_watermark(path, np.zeros((4, 4), dtype=np.float32))
    with pytest.raises(WatermarkFileError):
        load_watermark(path, 5, 5)


@pytest.mark.skipif(not os.path.isdir(REFERENCE_SAMPLES),
                    reason="reference samples unavailable")
def test_load_bundled_reference_watermarks():
    w512 = load_watermark(f"{REFERENCE_SAMPLES}/w_512.dat", 512, 512)
    assert w512.shape == (512, 512)
    # N(0,1)-ish
    assert abs(w512.mean()) < 0.05
    assert 0.9 < w512.std() < 1.1


@pytest.mark.skipif(not os.path.isdir(REFERENCE_SAMPLES),
                    reason="reference samples unavailable")
def test_reference_watermarks_share_seed_prefix():
    """All bundled .dat files were generated with seed 28390211
    (samples/make_w.bat:1-7), so they share identical leading floats."""
    w512 = load_watermark(f"{REFERENCE_SAMPLES}/w_512.dat", 512, 512).ravel()
    w480 = load_watermark(f"{REFERENCE_SAMPLES}/w_480p.dat", 480, 720).ravel()
    w720 = load_watermark(f"{REFERENCE_SAMPLES}/w_720p.dat", 720, 1280).ravel()
    np.testing.assert_array_equal(w512[:1024], w480[:1024])
    np.testing.assert_array_equal(w512[:1024], w720[:1024])


def test_generate_watermark_stats_and_quirk():
    w = generate_watermark(64, 96, seed=123)
    assert w.shape == (64, 96)
    assert abs(w.mean()) < 0.1
    w2 = generate_watermark(64, 96, seed=123)
    np.testing.assert_array_equal(w, w2)  # deterministic
    q = generate_watermark(64, 64, seed=5, repeat_blocks=4)
    np.testing.assert_array_equal(q.ravel()[:1024], q.ravel()[1024:2048])
    with pytest.raises(ValueError):
        generate_watermark(0, 10, 1)
    with pytest.raises(ValueError):
        generate_watermark(40000, 10, 1)


def test_image_roundtrip(tmp_path, rng):
    img = rng.integers(0, 256, size=(20, 30, 3)).astype(np.float32)
    path = tmp_path / "img.png"
    save_image_u8(path, img)
    got = load_image_rgb(path)
    np.testing.assert_array_equal(got, np.floor(img))
    gray = load_image_gray(path)
    assert gray.shape == (20, 30)


def test_synthetic_image_from_seed():
    got = load_image_rgb("synthetic:64x48:3")
    assert got.shape == (48, 64, 3) and got.dtype == np.float32
    assert 0.0 <= got.min() and got.max() <= 255.0 and got.std() > 10.0
    np.testing.assert_array_equal(got, load_image_rgb("synthetic:64x48:3"))
    assert not np.array_equal(got, load_image_rgb("synthetic:64x48:4"))
    with pytest.raises(ValueError, match="WxH:SEED"):
        load_image_rgb("synthetic:64x48")


def test_package_import_needs_no_pillow():
    """Importing the package and running an engine needs only JAX and
    NumPy; Pillow loads only when an image file is read or written."""
    import subprocess
    import sys

    code = ("import sys; import watermarking_gpu_tpu as w; "
            "e = w.Watermark(64, 64, 7); e.detect(e.embed("
            "w.io.load_image_gray('synthetic:64x64:1'))[0]); "
            "assert 'PIL' not in sys.modules, 'PIL imported'")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                   check=True, timeout=300)


def test_add_suffix():
    assert add_suffix_before_extension("a/b.png", "_W_ME") == "a/b_W_ME.png"
    assert add_suffix_before_extension("noext", "_X") == "noext_X"


def test_settings_parse(tmp_path):
    ini = tmp_path / "settings.ini"
    ini.write_text("""
[paths]
image = samples/images/512.png
watermark = samples/w_512.dat
; video = off

[options]
opencl_device = 1
execution_time_in_fps = true

[parameters]
p = 3
psnr = 40.0
loops_for_test = 7

[parameters_video]
watermark_interval = 15
watermark_detection = true
embed_batch = 4
detect_batch = 16
strict_pixel_format = true
""")
    s = load_settings(ini)
    assert s.image.endswith("512.png")
    assert s.video == "" and not s.is_video_mode
    assert s.device == 1
    assert s.execution_time_in_fps is True
    assert s.p == 3 and s.psnr == 40.0 and s.loops_for_test == 7
    assert s.watermark_interval == 15 and s.watermark_detection is True
    assert s.encode_options == "-c:v libx265 -preset fast -crf 23"
    assert s.embed_batch == 4 and s.detect_batch == 16
    assert s.strict_pixel_format is True
    assert s.compilation_cache_dir == ""   # extension defaults off


def test_settings_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_settings(tmp_path / "nope.ini")
