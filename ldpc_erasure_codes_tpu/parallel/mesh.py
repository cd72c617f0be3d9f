"""Mesh construction and the sharded Monte-Carlo step.

Two sharding styles, both over a ``jax.sharding.Mesh``:

* :func:`shard_sim_step` — explicit SPMD via ``shard_map``: every device runs
  the per-shard simulation step on its own fold of the PRNG key and the
  statistics are ``psum``-reduced over the batch axis (NVLink between the cards of one host). This is
  the production Monte-Carlo path.
* plain ``jit`` + ``NamedSharding`` on inputs (used by ``__graft_entry__``'s
  multi-chip dry run) — compiler-driven: XLA inserts the all-reduces for the
  statistic sums itself.

Multi-host: call ``jax.distributed.initialize()`` before building the mesh and
``jax.devices()`` spans all hosts; nothing else changes (stats are scalars, so
DCN traffic is negligible — the ≥80% multi-host scaling target is an input-
pipeline property, and the simulation generates its inputs on device).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "data"  # codeword-batch axis (DP analog)
LANE_AXIS = "lane"  # packed symbol-word axis (the reference's bit-plane axis)


def make_mesh(
    shape: Sequence[int],
    axis_names: Sequence[str] = (BATCH_AXIS,),
    devices: Sequence[jax.Device] | None = None,
) -> Mesh:
    """Build a Mesh of the given shape from the given (or all) devices."""
    devices = list(devices) if devices is not None else jax.devices()
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(tuple(shape))
    return Mesh(dev, tuple(axis_names))


def default_mesh(devices: Sequence[jax.Device] | None = None) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    devices = list(devices) if devices is not None else jax.devices()
    return make_mesh((len(devices),), (BATCH_AXIS,), devices)


def shard_sim_step(
    step_fn: Callable[[jax.Array, Any], Any],
    mesh: Mesh,
    axis_name: str = BATCH_AXIS,
) -> Callable[[jax.Array, Any], Any]:
    """Lift a per-shard sim step ``step(key, *args) -> stats`` onto the mesh.

    Each device folds the mesh position into the key (independent Monte-Carlo
    streams), runs the local batch, and the stats pytree is psum-reduced over
    the batch axis; the result is replicated. Non-key args are broadcast
    (e.g. the PER operating point).
    """

    def local(key: jax.Array, *args):
        idx = jax.lax.axis_index(axis_name)
        stats = step_fn(jax.random.fold_in(key, idx), *args)
        return jax.tree.map(lambda x: jax.lax.psum(x, axis_name), stats)

    @functools.wraps(step_fn)
    def run(key: jax.Array, *args):
        mapped = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(),) * (1 + len(args)),
            out_specs=P(),
            check_vma=False,
        )
        return mapped(key, *args)

    return run


def batch_sharding(mesh: Mesh, ndim: int, lane_axis_dim: int | None = None) -> NamedSharding:
    """NamedSharding for a (B, n[, W]) array: batch over BATCH_AXIS, and when
    the mesh has a LANE_AXIS, the trailing word axis over it."""
    spec = [None] * ndim
    spec[0] = BATCH_AXIS
    if LANE_AXIS in mesh.axis_names and lane_axis_dim is not None:
        spec[lane_axis_dim] = LANE_AXIS
    return NamedSharding(mesh, P(*spec))
