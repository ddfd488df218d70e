"""Entry point: serve the interactive Earth viewer at 1920x1080 on a CUDA
card (counterpart of the JAX package's main.py).

    python -m digital_earth_tpu_torch [--port 8000] [--adaptive] [--multichip]

``--adaptive`` makes idle frames adaptive passes over the noisiest quarter
of the pixel tiles (``EarthViewer(adaptive_frac=0.25)``, as main.py:20
does). ``--multichip`` renders over every CUDA card through the ("px", "spp")
device mesh (``parallel/mesh.MultiChipRenderer``, as main.py:21-31 does):
the same image bit for bit, one accumulate adding one spp per "spp" device;
with ``--adaptive`` each px row refines its own noisiest tiles. On one card
the mesh is (1, 1).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m digital_earth_tpu_torch")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--adaptive", action="store_true",
                        help="adaptive tile sampling when idle (a quarter of the tiles per pass)")
    parser.add_argument("--multichip", action="store_true",
                        help="render over every CUDA card (the px/spp device mesh)")
    args = parser.parse_args(argv)

    from .app.viewer import EarthViewer

    image_res = (1920, 1080)
    adaptive_frac = 0.25 if args.adaptive else 0.0
    if args.multichip:
        from .parallel.mesh import MultiChipRenderer, make_render_mesh

        renderer = MultiChipRenderer(make_render_mesh(), image_res)
        EarthViewer(renderer=renderer, port=args.port, adaptive_frac=adaptive_frac).start()
    else:
        EarthViewer(device="cuda", image_res=image_res, port=args.port,
                    adaptive_frac=adaptive_frac).start()
    return 0


if __name__ == "__main__":
    sys.exit(main())
