"""RS encode/decode kernels — thin wrappers over the shared GF(256) machinery.

The decode is the framework's batched Gauss-Jordan erasure solver applied to
the RS parity-check system; mathematically identical to the reference's
G-side solve (Matlab/My_RS_Decode_Optimize_With_GFTables.m:55-91 — both solve
for the erased source symbols from the k received ones; the H-side form skips
the explicit column-permutation bookkeeping the MATLAB version needs,
:33-48, :110-116).
"""

from __future__ import annotations

import jax

from ldpc_erasure_codes_tpu.ops.arrays import CodeArrays
from ldpc_erasure_codes_tpu.ops.encode import encode_nb, encode_packed
from ldpc_erasure_codes_tpu.ops.ge import ge_solve, ge_solve_wide_nb


def rs_encode(arrays: CodeArrays, source: jax.Array) -> jax.Array:
    """Systematic RS encode: (..., k) uint8 -> (..., n) uint8 (bit-image
    matmul), or (B, k, W) packed -> (B, n, W) via the scan encoder."""
    if source.ndim == 3:
        return encode_packed(arrays, source, gf_order=256)
    return encode_nb(arrays, source)


def rs_decode(
    arrays: CodeArrays,
    values: jax.Array,
    erased: jax.Array,
    *,
    emax: int | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Erasure-only RS decode of a batch.

    Returns (values, erased, failed); ``failed`` marks codewords with more
    than n - k erasures (MDS bound) — rank deficiency cannot otherwise occur.
    """
    m = arrays.h.shape[0]
    if emax is None:
        emax = m
    return ge_solve(arrays, values, erased, emax=emax, gf_order=256)


def rs_decode_wide(
    arrays: CodeArrays,
    values: jax.Array,
    erased: jax.Array,
    *,
    emax: int | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Wide-symbol (packet-FEC) RS erasure decode: (B, n, W) uint8 payloads.

    The production formulation for packet payloads: the k x k GF(256)
    system is solved ONCE per erasure pattern on narrow bytes (with row-op tracking), and the accumulated transform is
    applied to the W-byte payloads as a bit-image int8 matmul
    (:func:`ops.ge.ge_solve_wide_nb`) — decode cost is flat in the payload
    width where the reference's per-symbol formulation scales as
    O(k (k - N_sys)^2) per payload byte
    (Matlab/ReedSolomonErasureCodes.m:83-91,
    My_RS_Decode_Optimize_With_GFTables.m:55-91).

    Returns (values, erased, failed) — failed marks > n-k erasures (the MDS
    bound; rank deficiency cannot otherwise occur for RS).
    """
    m = arrays.h.shape[0]
    if emax is None:
        emax = m
    return ge_solve_wide_nb(arrays, values, erased, emax=emax)
