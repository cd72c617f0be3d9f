"""The platform decision: which implementation a decode runs.

Every choice between a hand-written GPU kernel and the plain XLA version is
made here, from the platform JAX runs on, and never from a user option.
"""

from __future__ import annotations

import jax


def on_gpu() -> bool:
    """True when JAX's default backend is a GPU.

    The wide peel runs the Triton replay kernel (ops/peel_replay.py) where
    this holds and ``peel_decode_wide`` elsewhere: the kernel has no CPU
    lowering, and on the GPU it beat the XLA sweeps end to end for binary
    and GF(256) symbols (PERF.md).
    """
    return jax.default_backend() == "gpu"

