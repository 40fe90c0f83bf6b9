"""Best-effort live display windows (port of
``depth_estimation_tpu.utils.viewer``).

The tools write panels, GIFs and videos to disk; their `--show` flags also
show them live when a display exists. A missing display is the only thing
that makes the viewer a no-op: the device the program runs on plays no
part.

Backend probe order (never raises; every failure degrades to the no-op
headless backend so the pipelines are unchanged):
  * cv2 — `cv2.imshow` if OpenCV is importable and a display is present;
  * matplotlib — an interactive figure if a GUI backend initializes;
  * none — silent no-op (also forced by DE_TPU_HEADLESS=1 or a missing
    DISPLAY/WAYLAND_DISPLAY, which is how the tests pin the fallback).
"""

from __future__ import annotations

import os

import numpy as np


def _display_available() -> bool:
    if os.environ.get("DE_TPU_HEADLESS"):
        return False
    return bool(os.environ.get("DISPLAY")
                or os.environ.get("WAYLAND_DISPLAY"))


class LiveViewer:
    """One named window; `show(img)` accepts float [0,1] (H, W) or
    (H, W, 3) arrays. `backend` reports what was picked ('cv2',
    'matplotlib', 'none') — callers can log it but never need to branch."""

    def __init__(self, title: str = "depth_estimation_tpu_torch",
                 enabled: bool = True):
        self.title = title
        self.backend = "none"
        self._fig = self._im = None
        if not (enabled and _display_available()):
            return
        try:
            import cv2  # noqa: F401
            self._cv2 = cv2
            self.backend = "cv2"
            return
        except Exception:
            pass
        try:
            import matplotlib
            import matplotlib.pyplot as plt
            if matplotlib.get_backend().lower() == "agg":
                raise RuntimeError("no interactive matplotlib backend")
            plt.ion()
            self._plt = plt
            self.backend = "matplotlib"
        except Exception:
            self.backend = "none"

    def show(self, img: np.ndarray) -> None:
        if self.backend == "none":
            return
        from .device import host
        img = np.clip(host(img), 0.0, 1.0)
        try:
            if self.backend == "cv2":
                bgr = img[..., ::-1] if img.ndim == 3 else img
                self._cv2.imshow(self.title, (bgr * 255).astype(np.uint8))
                self._cv2.waitKey(1)
            else:
                if self._im is None:
                    self._fig, ax = self._plt.subplots(num=self.title)
                    self._im = ax.imshow(img, cmap=None if img.ndim == 3
                                         else "gray", vmin=0, vmax=1)
                    ax.axis("off")
                else:
                    self._im.set_data(img)
                self._fig.canvas.draw_idle()
                self._fig.canvas.flush_events()
        except Exception:
            # a window manager dying mid-stream must not kill the pipeline
            self.backend = "none"

    def close(self) -> None:
        try:
            if self.backend == "cv2":
                self._cv2.destroyWindow(self.title)
            elif self.backend == "matplotlib" and self._fig is not None:
                self._plt.close(self._fig)
        except Exception:
            pass
        self.backend = "none"
