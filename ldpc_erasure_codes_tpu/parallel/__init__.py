"""Device-mesh parallelism for the codeword batch.

The reference has no distributed layer (single FPGA; SURVEY §2.7) — its
parallelism is bit-plane lanes + frame streaming. Here the codeword batch is
the scaling axis: decode is embarrassingly parallel per codeword, so the mesh
shards the batch (and optionally the packed symbol-lane axis for very wide
symbols), and collectives only aggregate statistics — the
replacement for the FPGA's `ERROR_STAT` channel
(OpenCL/device/ldpc_erasure_decoder_top.cl:55,124-158).
"""

from ldpc_erasure_codes_tpu.parallel.mesh import (
    BATCH_AXIS,
    LANE_AXIS,
    default_mesh,
    make_mesh,
    shard_sim_step,
)
from ldpc_erasure_codes_tpu.parallel import multihost
from ldpc_erasure_codes_tpu.parallel.scaling import ScalePoint, measure_scaling

__all__ = [
    "BATCH_AXIS",
    "LANE_AXIS",
    "default_mesh",
    "make_mesh",
    "ScalePoint",
    "measure_scaling",
    "multihost",
    "shard_sim_step",
]
