"""Debug array viewer.

Parity with ``Watermark::displayArray`` (``/root/reference/Watermark_GPU/
Watermark.cpp:253-258``), which opens an ``af::Window`` GUI loop. Headless
accelerator hosts have no display, so this renders the array to
a PNG (auto-scaled to 0..255 when needed) and optionally hands it to PIL's
viewer when one exists.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def display_array(array, path: str | None = None, show: bool = False) -> str:
    """Render a 2D/3D array to a PNG for inspection. Returns the path."""
    from PIL import Image

    arr = np.asarray(array, dtype=np.float32)
    lo, hi = float(arr.min()), float(arr.max())
    if hi <= 1.0 and lo >= 0.0:
        arr = arr * 255.0
    elif hi > 255.0 or lo < 0.0:
        arr = (arr - lo) / max(hi - lo, 1e-12) * 255.0
    img = Image.fromarray(arr.astype(np.uint8))
    if path is None:
        fd, path = tempfile.mkstemp(suffix=".png", prefix="wm_display_")
        os.close(fd)
    img.save(path)
    if show:  # pragma: no cover - needs a display
        img.show()
    return path
