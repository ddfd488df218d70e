"""Scripted, windowless rendering of a scene config (port of
``render_offline``, digital_earth_tpu/app/viewer.py:492). The interactive
web viewer is not ported yet."""

from __future__ import annotations

import time

from ..render.renderer import Renderer
from .config_io import SceneConfig, apply_config


def render_offline(
    scene_config: SceneConfig,
    device,
    spp: int = 64,
    image_res=(1920, 1080),
    out_path: str = "render.png",
    renderer: Renderer = None,
    progress_every: int = 0,
    **renderer_kwargs,
) -> Renderer:
    """Render ``spp`` samples of ``scene_config`` on ``device`` and write the
    post-processed frame to ``out_path`` (skipped when falsy); returns the
    Renderer."""
    if renderer is None:
        renderer = Renderer(device, image_res=image_res, **renderer_kwargs)
    apply_config(renderer, scene_config)
    w, h = renderer.image_res
    t0 = time.time()
    for i in range(spp):
        renderer.accumulate()
        if progress_every and (i + 1) % progress_every == 0:
            renderer.color_buffer.sum().item()  # wait for the device
            rate = (i + 1) * w * h / (time.time() - t0)
            print(f"spp {i + 1}/{spp}  {rate:.3e} paths/s")
    if out_path:
        from PIL import Image

        Image.fromarray(renderer.fetch_image_np()).save(out_path)
    return renderer
