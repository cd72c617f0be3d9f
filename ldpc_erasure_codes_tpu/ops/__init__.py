"""Device kernels: encode, peeling decode, Gaussian elimination, arrays."""

from ldpc_erasure_codes_tpu.ops.arrays import CodeArrays, device_arrays
from ldpc_erasure_codes_tpu.ops.compact import compact_ge_rank, compact_ge_solve
from ldpc_erasure_codes_tpu.ops.encode import (
    encode,
    encode_nb,
    encode_packed,
    encode_scan,
    encode_wide,
    make_packed_encoder,
)
from ldpc_erasure_codes_tpu.ops.ge import ge_rank_check, ge_solve
from ldpc_erasure_codes_tpu.ops.hybrid import (
    hybrid_decode,
    hybrid_decode_escalated,
)
from ldpc_erasure_codes_tpu.ops.peel_replay import peel_decode_replay
from ldpc_erasure_codes_tpu.ops.peel_wide import (
    peel_decode_packed,
    peel_decode_wide,
)
from ldpc_erasure_codes_tpu.ops.peel import (
    peel_decode,
    peel_decode_mask,
    peel_decode_with_history,
    peel_step_gather,
    peel_step_matmul,
)

__all__ = [
    "CodeArrays",
    "compact_ge_rank",
    "compact_ge_solve",
    "device_arrays",
    "encode",
    "encode_nb",
    "encode_packed",
    "encode_scan",
    "encode_wide",
    "ge_rank_check",
    "ge_solve",
    "hybrid_decode",
    "hybrid_decode_escalated",
    "make_packed_encoder",
    "peel_decode",
    "peel_decode_mask",
    "peel_decode_packed",
    "peel_decode_replay",
    "peel_decode_wide",
    "peel_decode_with_history",
    "peel_step_gather",
    "peel_step_matmul",
]
