"""Entry point: serve the interactive Earth viewer at 1920x1080 on a CUDA
card (counterpart of the JAX package's main.py).

    python -m digital_earth_tpu_torch [--port 8000]

``--adaptive`` (adaptive tile sampling) and ``--multichip`` (rendering over
several cards) are not ported yet and exit with an error that names their
ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import sys

NOT_PORTED = {
    "--adaptive": "adaptive tile sampling is not ported yet (ROADMAP.md, queue A #10 and B #13)",
    "--multichip": "multi-GPU rendering is not ported yet (ROADMAP.md, queue A #12 and B #14)",
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m digital_earth_tpu_torch")
    parser.add_argument("--port", type=int, default=8000)
    for flag in NOT_PORTED:
        parser.add_argument(flag, action="store_true", help="not ported yet")
    args = parser.parse_args(argv)
    for flag, why in NOT_PORTED.items():
        if getattr(args, flag.lstrip("-")):
            print(f"{flag}: {why}", file=sys.stderr)
            return 2

    from .app.viewer import EarthViewer

    EarthViewer(device="cuda", image_res=(1920, 1080), port=args.port).start()
    return 0


if __name__ == "__main__":
    sys.exit(main())
