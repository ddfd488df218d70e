"""digital_earth_tpu_torch — the PyTorch + CUDA port of the spectral
volumetric path tracer in ``digital_earth_tpu``.

Layout mirrors the JAX package (``ops/``, ``models/``, ``assets/``,
``render/``, ``app/``) so that every module's counterpart is easy to find;
``csrc/`` holds the hand-written CUDA kernels for Hopper (``sm_90a``) and
``kernels/`` builds and binds them. The package imports ``torch`` and never
``jax``: the JAX package stays the reference the port is tested against.

Every public entry takes an explicit ``device``; a wrapper of a CUDA kernel
runs its plain PyTorch twin only for tensors that lie on the CPU.
"""

__version__ = "0.1.0"
