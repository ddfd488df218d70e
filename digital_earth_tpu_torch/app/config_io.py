"""Scene persistence: the reference's 10-line plain-text config format (a
copy of digital_earth_tpu/app/config_io.py, so the port imports nothing of
the JAX package). ``apply_config`` drives any object with the ``set_*``
methods of ``render.renderer.Renderer``.

Byte-compatible with the shipped scenes ("config - Apollo 11.txt" etc.):
lines 1-3 are camera position / look-at / up (three floats each, written by
the reference Camera at earth_viewer.py:100-105), lines 4-10 are fov,
aspect_scale, exposure, crf index, gamma, sun_angle, sun_path_rot (written by
the viewer at earth_viewer.py:213-222).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SceneConfig:
    camera_pos: tuple = (-15000000.0, 0.0, 15000000.0)
    look_at: tuple = (0.0, 0.0, 0.0)
    up: tuple = (0.0, 1.0, 0.0)
    fov: float = 0.23561944901923448  # radians(27)/2
    aspect_scale: float = 1.0
    exposure: float = 2.5
    crf_index: int = 0
    gamma: float = 1.0
    sun_angle: float = 1.0471975511965976  # radians(60)
    sun_path_rot: float = -0.7853981633974483  # radians(-45)


def save_config(path: str, cfg: SceneConfig) -> None:
    """Write the 10-line format (reference earth_viewer.py:100-105,213-222)."""
    with open(path, "w") as f:
        for vec in (cfg.camera_pos, cfg.look_at, cfg.up):
            f.write(f"{vec[0]} {vec[1]} {vec[2]}\n")
        f.write(f"{cfg.fov}\n")
        f.write(f"{cfg.aspect_scale}\n")
        f.write(f"{cfg.exposure}\n")
        f.write(f"{cfg.crf_index}\n")
        f.write(f"{cfg.gamma}\n")
        f.write(f"{cfg.sun_angle}\n")
        f.write(f"{cfg.sun_path_rot}")


def load_config(path: str) -> SceneConfig:
    """Read the 10-line format (reference earth_viewer.py:107-126,224-236)."""
    with open(path) as f:
        def vec3():
            return tuple(float(x) for x in f.readline().split()[:3])

        camera_pos = vec3()
        look_at = vec3()
        up = vec3()
        fov = float(f.readline())
        aspect_scale = float(f.readline())
        exposure = float(f.readline())
        crf_index = int(float(f.readline()))
        gamma = float(f.readline())
        sun_angle = float(f.readline())
        sun_path_rot = float(f.readline())
    return SceneConfig(
        camera_pos, look_at, up, fov, aspect_scale, exposure, crf_index,
        gamma, sun_angle, sun_path_rot,
    )


def apply_config(renderer, cfg: SceneConfig) -> None:
    """Push a SceneConfig into a Renderer (the viewer 'o' handler)."""
    renderer.set_camera_pos(*cfg.camera_pos)
    renderer.set_look_at(*cfg.look_at)
    renderer.set_up(*cfg.up)
    renderer.set_fov(cfg.fov)
    renderer.set_aspect_scale(cfg.aspect_scale)
    renderer.set_exposure(cfg.exposure)
    renderer.set_crf(cfg.crf_index)
    renderer.set_gamma(cfg.gamma)
    renderer.set_sun_angle(cfg.sun_angle)
    renderer.set_sun_path_rot(cfg.sun_path_rot)
    renderer.reset_framebuffer()


def snapshot_config(renderer, camera=None) -> SceneConfig:
    """Collect the current renderer (and optional camera controller) state."""
    if camera is not None:
        pos, look, up = camera.position, camera.look_at, camera.up
    else:
        pos, look, up = renderer.camera_pos, renderer.look_at, renderer.up
    return SceneConfig(
        camera_pos=tuple(float(x) for x in pos),
        look_at=tuple(float(x) for x in look),
        up=tuple(float(x) for x in up),
        fov=float(renderer.fov),
        aspect_scale=float(renderer.aspect_scale),
        exposure=float(renderer.exposure),
        crf_index=int(renderer.selected_crf),
        gamma=float(renderer.gamma),
        sun_angle=float(renderer.sun_angle),
        sun_path_rot=float(renderer.sun_path_rot),
    )
