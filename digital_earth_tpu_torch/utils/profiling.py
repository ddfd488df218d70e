"""The samples-per-frame controller (port of
digital_earth_tpu/utils/profiling.py:58-74). The reference's ``FrameTimer``
has no caller there or here (the viewer times its frames itself), and its
``profiler_trace`` wraps ``jax.profiler``: ``torch.profiler`` is used
directly where a trace is needed.
"""


class AdaptiveSpp:
    """Samples-per-frame controller targeting a frame rate (the viewer's
    ``adaptive_fps``): above the frame budget it cuts the count in
    proportion, below it adds one, within [1, ``max_spp``]."""

    def __init__(self, target_fps: float = 30.0, max_spp: int = 64):
        self.target_fps = target_fps
        self.max_spp = max_spp
        self.spp = 1

    def update(self, elapsed_s: float) -> int:
        if elapsed_s * self.target_fps > 1.0:
            self.spp = max(int(self.spp / (elapsed_s * self.target_fps)) - 1, 1)
        else:
            self.spp = min(self.spp + 1, self.max_spp)
        return self.spp
