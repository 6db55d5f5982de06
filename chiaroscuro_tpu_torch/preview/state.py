"""Preview input/state machine — the testable core of the interactive viewer.

Mirrors ``OpenGLPreview::processInputs`` + callbacks
(``src/openglPreview.cpp:102-197``) without any window system:

- ``R``      → show the path-traced frame and request one progressive layer
  (repeated R from the same camera accumulates — ``rayTracer.cpp:18-33``);
- ``TAB``    → toggle between the ray-traced frame and the raster walk-through
  (``openglPreview.cpp:150-156``);
- ``=``/``-``→ exposure ± 0.2 and re-tonemap only (``openglPreview.cpp:157-173``);
- WASD/E/Q   → fly the camera (E=UPWARD, Q=DOWNWARD per
  ``openglPreview.cpp:181-191``), shift = fast (``openglPreview.cpp:192-195``);
- mouse move / scroll → look / zoom — **ignored while the render is shown**,
  exactly like the reference's callbacks (``openglPreview.cpp:108-110,131-133``).

The GUI layer (``viewer.py``) only forwards events here and blits
``display_image()``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from chiaroscuro_tpu_torch.preview import flycam
from chiaroscuro_tpu_torch.preview.flycam import FlyCamera

_MOVE_KEYS = {
    "w": flycam.FORWARD,
    "s": flycam.BACKWARD,
    "a": flycam.LEFT,
    "d": flycam.RIGHT,
    "e": flycam.UPWARD,     # openglPreview.cpp:188-189
    "q": flycam.DOWNWARD,   # openglPreview.cpp:190-191
}


class PreviewState:
    """Holds the fly camera, mode flag and exposure; drives a ``Renderer``."""

    def __init__(self, renderer, raster_fn=None):
        """``renderer``: render/renderer.Renderer (or a stub with the same
        surface: ``ray_trace``, ``normalize_image``, ``cfg``).
        ``raster_fn``: optional ``(camera) -> (H, W, 3) float`` walk-through
        frame (``preview/raster.py``); None → black frames in raster mode."""
        self.renderer = renderer
        self.raster_fn = raster_fn
        cfg = renderer.cfg
        self.camera = FlyCamera(cfg.vp, cfg.la, cfg.up, cfg.yview)
        self.exposure = float(cfg.exposure)
        self.show_render = False
        self.should_close = False
        self._render_px: Optional[np.ndarray] = None  # tone-mapped u8 cache
        self._raster_px: Optional[np.ndarray] = None

    # -- events -------------------------------------------------------------

    def press_r(self) -> None:
        """``R``: request one progressive layer from the current camera and
        show it (``openglPreview.cpp:140-148`` → ``Screen::requestRender``)."""
        self.show_render = True
        eye, center, up, yview = self.camera.render_args()
        self.renderer.ray_trace(eye, center, up, yview)
        self._update_screen()

    def press_tab(self) -> None:
        """``TAB``: toggle raster walk-through vs last render
        (``openglPreview.cpp:150-156``)."""
        self.show_render = not self.show_render
        if not self.show_render:
            self._raster_px = None  # camera may move; re-rasterize lazily

    def adjust_exposure(self, delta: float = 0.2) -> float:
        """``=``/``-``: exposure step + re-tonemap (``openglPreview.cpp:157-173``).
        Re-tonemaps the *existing* pixels; no new samples are traced."""
        self.exposure += delta
        print(f"Scene exposure is now {self.exposure}")
        self._update_screen()
        return self.exposure

    def mouse_move(self, xoffset: float, yoffset: float) -> bool:
        """Mouse look; inert while the render is shown
        (``openglPreview.cpp:108-110``).  Returns True if the camera moved."""
        if self.show_render:
            return False
        self.camera.process_mouse_movement(xoffset, yoffset)
        self._raster_px = None
        return True

    def scroll(self, yoffset: float) -> bool:
        """Scroll zoom; inert while the render is shown
        (``openglPreview.cpp:131-133``)."""
        if self.show_render:
            return False
        self.camera.process_mouse_scroll(yoffset)
        self._raster_px = None
        return True

    def move_key(self, key: str, delta_time: float, fast: bool = False) -> bool:
        """WASDEQ movement; inert while the render is shown
        (``openglPreview.cpp:179-191``)."""
        if self.show_render or key not in _MOVE_KEYS:
            return False
        self.camera.movement_speed = (
            flycam.FAST_SPEED if fast else flycam.SPEED
        )
        self.camera.process_keyboard(_MOVE_KEYS[key], delta_time)
        self._raster_px = None
        return True

    def press_escape(self) -> None:
        self.should_close = True

    # -- frames -------------------------------------------------------------

    def _update_screen(self) -> None:
        """Re-tonemap the renderer's pixels (``Screen::updateScreen``)."""
        self._render_px = self.renderer.normalize_image(self.exposure)

    def display_image(self) -> np.ndarray:
        """The (H, W, 3) uint8 frame the window should show right now."""
        if self.show_render:
            if self._render_px is None:
                self._update_screen()
            return self._render_px
        if self._raster_px is None:
            cfg = self.renderer.cfg
            if self.raster_fn is not None:
                frame = np.clip(self.raster_fn(self.camera), 0.0, 1.0)
                self._raster_px = (frame * 255.0 + 0.5).astype(np.uint8)
            else:
                self._raster_px = np.zeros(
                    (cfg.yres, cfg.xres, 3), np.uint8
                )
        return self._raster_px
