"""Flythrough camera controller: WASD/SPACE/CTRL movement with
altitude-scaled speed, drag rotation, up-vector alignment (port of
digital_earth_tpu/app/camera_controller.py; numpy only).

Semantics match the reference Camera (earth_viewer.py:23-163), decoupled from
any window system: the viewer feeds it key/mouse state each frame.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..ops.math_utils import np_normalize, np_rotate_matrix


class CameraController:
    def __init__(
        self,
        position=(-15000000.0, 0.0, 15000000.0),
        look_at=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0),
    ):
        self._camera_pos = np.array(position, dtype=np.float64)
        self._lookat_pos = np.array(look_at, dtype=np.float64)
        self._up = np_normalize(np.array(up, dtype=np.float64))

    # --- state ----------------------------------------------------------
    @property
    def position(self):
        return self._camera_pos

    @property
    def look_at(self):
        return self._lookat_pos

    @property
    def up(self):
        return self._up

    @property
    def target_dir(self):
        return np_normalize(self._lookat_pos - self._camera_pos)

    def set_up(self, new_up):
        self._up = np_normalize(np.asarray(new_up, dtype=np.float64))

    def set_pose(self, position, look_at, up):
        self._camera_pos = np.array(position, dtype=np.float64)
        self._lookat_pos = np.array(look_at, dtype=np.float64)
        self.set_up(up)

    def _cam_r(self):
        return float(np.sqrt(np.sum(self._camera_pos**2)))

    def _left_dir(self, tgtdir):
        # reference earth_viewer.py:159-163
        if abs(float(np.dot(self._up, tgtdir))) > 0.999:
            return np.array([-1.0, 0.0, 0.0])
        return np.cross(self._up, tgtdir)

    # --- input handling ---------------------------------------------------
    def update_keys(self, keys, elapsed_time: float) -> bool:
        """Apply one frame of movement keys. ``keys`` is a set of lowercase
        key names: w/a/s/d, 'space', 'ctrl', 'shift', 'q', 'e'
        (reference earth_viewer.py:73-145). Returns True if the pose changed.
        """
        tgtdir = self.target_dir
        leftdir = self._left_dir(tgtdir)
        lut = {
            "w": tgtdir,
            "a": leftdir,
            "s": -tgtdir,
            "d": -leftdir,
            "ctrl": -self._up,
            "space": self._up,
        }
        direction = np.zeros(3)
        pressed = False
        for key, d in lut.items():
            if key in keys:
                pressed = True
                direction = direction + d
        if "q" in keys:
            pressed = True
            self.set_up(np_normalize(self._camera_pos))
        if "e" in keys:
            pressed = True
            self.set_up(np.array([0.0, 1.0, 0.0]))
        if not pressed:
            return False

        direction *= 0.05
        # altitude-scaled speed, clamped (reference earth_viewer.py:133-141)
        speed = 30.0 * max(min(self._cam_r() - C.PLANET_R, C.PLANET_R * 0.5), 0.0)
        if "shift" in keys:
            speed *= 3.0
        cam_step = direction * speed * elapsed_time
        self._lookat_pos = self._lookat_pos + cam_step
        self._camera_pos = self._camera_pos + cam_step
        if self._cam_r() < C.PLANET_R:
            self._lookat_pos = self._lookat_pos - cam_step * 2
            self._camera_pos = self._camera_pos - cam_step * 2
        return True

    def rotate(self, dx: float, dy: float, scale: float = 3.0) -> bool:
        """Drag rotation by normalized cursor deltas
        (reference earth_viewer.py:43-67)."""
        if dx == 0.0 and dy == 0.0:
            return False
        out_dir = self._lookat_pos - self._camera_pos
        leftdir = self._left_dir(np_normalize(out_dir))
        rotx = np_rotate_matrix(self._up, dx * scale)
        roty = np_rotate_matrix(leftdir, dy * scale)
        out_dir_homo = np.array(list(out_dir) + [0.0])
        new_out_dir = (roty @ rotx @ out_dir_homo)[:3]
        self._lookat_pos = self._camera_pos + new_out_dir
        return True

    def push_to(self, renderer) -> None:
        renderer.set_camera_pos(*self._camera_pos)
        renderer.set_look_at(*self._lookat_pos)
        renderer.set_up(*self._up)
