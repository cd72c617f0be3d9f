"""Residual-frame compaction for the Gauss-Jordan fallback.

After peeling, only the rare frames stuck in a stopping set need Gaussian
elimination — at production operating points that is a few percent of the
batch. Running the GE cube over the whole batch wastes O(B * (m+emax) * emax^2)
byte-ops on frames whose residual is empty. Compaction gathers the frames
with residual erasures into a small static bucket (``f_max``), solves there,
and scatters flags/values back; frames beyond the bucket are flagged failed
(detectable overflow, same contract as the ``emax`` column bucket).

This is the batch-axis analog of the reference's control flow — the MATLAB
hybrid only enters its GE when peeling leaves erasures
(My_LDPC_HybridML_Erasure_Decoder.m:48) — expressed with static shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ldpc_erasure_codes_tpu.ops.arrays import CodeArrays
from ldpc_erasure_codes_tpu.ops.ge import ge_rank_check, ge_solve, ge_solve_packed


def residual_order(erased: jax.Array, f_max: int) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Indices of residual frames, padded to ``f_max``.

    Returns (sel (f_max,) int32 frame indices — residual frames first in
    ascending index order, then non-residual fillers; is_resid (f_max,) bool;
    overflow (B,) bool frames with residual that did not fit)."""
    resid = jnp.any(erased, axis=1)  # (B,)
    order = jnp.argsort(~resid, stable=True).astype(jnp.int32)
    sel = order[:f_max]
    is_resid = resid[sel]
    rank = jnp.cumsum(resid.astype(jnp.int32)) - 1  # position among residuals
    overflow = resid & (rank >= f_max)
    return sel, is_resid, overflow


def compact_ge_rank(
    arrays: CodeArrays,
    erased: jax.Array,
    *,
    emax: int,
    f_max: int,
    gf_order: int = 2,
) -> jax.Array:
    """``ge_rank_check`` on the residual sub-batch only; returns failed (B,)."""
    b = erased.shape[0]
    sel, is_resid, overflow = residual_order(erased, f_max)
    failed_sub = ge_rank_check(
        arrays, erased[sel], emax=emax, gf_order=gf_order
    )
    failed = jnp.zeros((b,), bool).at[sel].set(failed_sub & is_resid)
    return failed | overflow


def compact_ge_solve(
    arrays: CodeArrays,
    values: jax.Array,
    erased: jax.Array,
    *,
    emax: int,
    f_max: int,
    gf_order: int = 2,
    ge_impl: str = "auto",
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """``ge_solve`` on the residual sub-batch; scatters solved values back.

    Same contract as ge_solve: returns (values, erased, failed). ``ge_impl``:
    ``"auto"`` picks the packed-bit elimination (:func:`ge_solve_packed`,
    ~10x less per-pivot memory traffic + matmul value apply) for wide binary
    uint32 frames and the byte path otherwise; ``"bytes"`` forces the
    original formulation."""
    b = erased.shape[0]
    sel, is_resid, overflow = residual_order(erased, f_max)
    packed = (
        ge_impl == "packed"
        or (
            ge_impl == "auto"
            and gf_order == 2
            and values.ndim == 3
            and values.dtype == jnp.uint32
        )
    )
    if packed:
        v_sub, e_sub, failed_sub = ge_solve_packed(
            arrays, values[sel], erased[sel], emax=emax
        )
    else:
        v_sub, e_sub, failed_sub = ge_solve(
            arrays, values[sel], erased[sel], emax=emax, gf_order=gf_order
        )
    # v_sub rows of non-residual filler frames are IDENTICAL to their
    # inputs (the GE writes only erased slots, and fillers have none), so
    # the whole sub-batch scatters back directly — the old
    # where(is_resid, v_sub, values[sel]) guard re-gathered the 935 MB
    # wide cube a second time and added a select pass for nothing
    # (failed residual frames legitimately carry garbage in erased slots
    # either way; both contracts gate on `failed`).
    values = values.at[sel].set(v_sub)
    erased = erased.at[sel].set(
        jnp.where(is_resid[:, None], e_sub, erased[sel])
    )
    failed = jnp.zeros((b,), bool).at[sel].set(failed_sub & is_resid)
    return values, erased, failed | overflow
