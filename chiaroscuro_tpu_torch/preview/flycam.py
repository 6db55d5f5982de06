"""Euler-angle fly camera — parity with the reference's LearnOpenGL camera.

Mirrors ``src/camera.cpp`` / ``include/camera.hpp``: yaw/pitch Euler angles in
degrees, WASD+EQ keyboard movement, mouse-look with sensitivity 0.1 and the
±89° pitch clamp (``camera.cpp:48-62``), scroll zoom clamped to [1°, 90°]
(``camera.cpp:64-70``), and the preview's zoom↔yview conversions
(``openglPreview.cpp:42`` seeds zoom from the scene's yview;
``openglPreview.cpp:248`` converts back when requesting a render).

Reference quirks, preserved or consciously diverged (documented per method):

- ``ProcessKeyboard``'s UPWARD/DOWNWARD signs are inverted in the reference
  (``camera.cpp:41-44``: UPWARD does ``Position -= Up``).  **Preserved** —
  the keybinding layer maps E→UPWARD/Q→DOWNWARD exactly like
  ``openglPreview.cpp:188-191``, so E/Q behave identically to the reference.
- The reference's vec3 constructor (``camera.cpp:11-19``) computes yaw/pitch
  in *radians* (plus a π/2 pitch offset) from ``position - lookAt`` but
  ``updateCameraVectors`` interprets them as *degrees* — the seeded camera
  never actually faces the scene's LA point.  **Diverged**: we seed yaw/pitch
  in degrees from ``lookAt - position`` so the fly camera starts facing the
  configured look-at target (the obviously intended behavior).
"""

from __future__ import annotations

import math

import numpy as np

# Default camera option values (camera.hpp:16-20).
YAW = -90.0
PITCH = 0.0
SPEED = 2.5
FAST_SPEED = 30.0        # held-shift speed (openglPreview.cpp:192-195)
SENSITIVITY = 0.1
ZOOM = 90.0

FORWARD, BACKWARD, LEFT, RIGHT, UPWARD, DOWNWARD = range(6)


def yview_to_zoom(yview: float) -> float:
    """Vertical view extent at z=1 → FOV-y degrees (``openglPreview.cpp:42``:
    ``camera.Zoom = glm::degrees(2 * atan(0.5 * yview))``)."""
    return math.degrees(2.0 * math.atan(0.5 * yview))


def zoom_to_yview(zoom: float) -> float:
    """FOV-y degrees → yview (``openglPreview.cpp:248``:
    ``2 * tan(Zoom * M_PI / 360)``)."""
    return 2.0 * math.tan(zoom * math.pi / 360.0)


class FlyCamera:
    """FPS camera with the reference's update rules (``camera.cpp:32-88``)."""

    def __init__(self, position, look_at, up, yview: float = 1.0):
        self.position = np.asarray(position, np.float64).copy()
        self.world_up = np.asarray(up, np.float64).copy()
        self.movement_speed = SPEED
        self.mouse_sensitivity = SENSITIVITY
        self.zoom = yview_to_zoom(yview)

        # Seed yaw/pitch (degrees) so front faces look_at — see module
        # docstring for the divergence from camera.cpp:11-19.
        d = np.asarray(look_at, np.float64) - self.position
        n = np.linalg.norm(d)
        d = d / n if n > 0 else np.array([0.0, 0.0, -1.0])
        self.pitch = math.degrees(math.asin(np.clip(d[1], -1.0, 1.0)))
        cp = math.cos(math.radians(self.pitch))
        if cp > 1e-12:
            self.yaw = math.degrees(math.atan2(d[2] / cp, d[0] / cp))
        else:
            self.yaw = YAW
        self._update_vectors()

    # -- camera.cpp:76-88 ---------------------------------------------------
    def _update_vectors(self) -> None:
        yaw = math.radians(self.yaw)
        pitch = math.radians(self.pitch)
        front = np.array(
            [
                math.cos(yaw) * math.cos(pitch),
                math.sin(pitch),
                math.sin(yaw) * math.cos(pitch),
            ]
        )
        self.front = front / np.linalg.norm(front)
        right = np.cross(self.front, self.world_up)
        self.right = right / np.linalg.norm(right)
        up = np.cross(self.right, self.front)
        self.up = up / np.linalg.norm(up)

    # -- camera.cpp:32-46 ---------------------------------------------------
    def process_keyboard(self, direction: int, delta_time: float) -> None:
        v = self.movement_speed * delta_time
        if direction == FORWARD:
            self.position += self.front * v
        elif direction == BACKWARD:
            self.position -= self.front * v
        elif direction == LEFT:
            self.position -= self.right * v
        elif direction == RIGHT:
            self.position += self.right * v
        elif direction == UPWARD:
            # Reference quirk preserved: UPWARD subtracts Up (camera.cpp:41-42).
            self.position -= self.up * v
        elif direction == DOWNWARD:
            self.position += self.up * v

    # -- camera.cpp:48-62 ---------------------------------------------------
    def process_mouse_movement(
        self, xoffset: float, yoffset: float, constrain_pitch: bool = True
    ) -> None:
        self.yaw += xoffset * self.mouse_sensitivity
        self.pitch += yoffset * self.mouse_sensitivity
        if constrain_pitch:
            self.pitch = min(89.0, max(-89.0, self.pitch))
        self._update_vectors()

    # -- camera.cpp:64-70 ---------------------------------------------------
    def process_mouse_scroll(self, yoffset: float) -> None:
        if 1.0 <= self.zoom <= 90.0:
            self.zoom -= yoffset
        self.zoom = min(90.0, max(1.0, self.zoom))

    # -- render-request parameters (openglPreview.cpp:246-250) --------------
    @property
    def yview(self) -> float:
        return zoom_to_yview(self.zoom)

    def render_args(self):
        """(eye, center, up, yview) for ``Renderer.ray_trace`` — the exact
        arguments of ``Screen::requestRender`` (``openglPreview.cpp:247-249``:
        ``rayTrace(Position, Front + Position, Up, 2 tan(Zoom π/360))``)."""
        return (
            self.position.astype(np.float32).copy(),
            (self.position + self.front).astype(np.float32),
            self.up.astype(np.float32).copy(),
            float(self.yview),
        )
