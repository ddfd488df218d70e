"""Entry point: serve the interactive Earth viewer at 1920x1080 on a CUDA
card (counterpart of the JAX package's main.py).

    python -m digital_earth_tpu_torch [--port 8000] [--adaptive]

``--adaptive`` makes idle frames adaptive passes over the noisiest quarter
of the pixel tiles (``EarthViewer(adaptive_frac=0.25)``, as main.py:20
does). ``--multichip`` (rendering over several cards) is not ported yet and
exits with an error that names its ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import sys

MULTICHIP_TODO = "multi-GPU rendering is not ported yet (ROADMAP.md, queue A #12 and B #14)"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m digital_earth_tpu_torch")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--adaptive", action="store_true",
                        help="adaptive tile sampling when idle (a quarter of the tiles per pass)")
    parser.add_argument("--multichip", action="store_true", help="not ported yet")
    args = parser.parse_args(argv)
    if args.multichip:
        print(f"--multichip: {MULTICHIP_TODO}", file=sys.stderr)
        return 2

    from .app.viewer import EarthViewer

    EarthViewer(device="cuda", image_res=(1920, 1080), port=args.port,
                adaptive_frac=0.25 if args.adaptive else 0.0).start()
    return 0


if __name__ == "__main__":
    sys.exit(main())
