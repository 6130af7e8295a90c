"""er3t_tpu_torch — the PyTorch/CUDA port of er3t_tpu's photon transport.

The package mirrors ``er3t_tpu``'s layout (``er3t_tpu_torch.rtm.<module>`` is
the counterpart of ``er3t_tpu.rtm.<module>``) and imports ``torch``, never
``jax``, and nothing of ``er3t_tpu``: the NumPy preprocessing, physics,
I/O, satellite readers and applications it needs (``pre``, ``physics``,
``util``, ``sat``, ``apps``, ``common``) are its own copies of the
reference's modules, each docstring naming the lines it copies.

Hand-written Hopper kernels live in ``csrc/`` and are built with ``nvcc`` at
first use by :mod:`er3t_tpu_torch._build`.
"""

from . import common  # noqa: F401

__version__ = '0.1.0'
