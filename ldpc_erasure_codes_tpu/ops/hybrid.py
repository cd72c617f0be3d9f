"""Hybrid MPA + ML decoder: peel first, Gauss-Jordan the residual.

Batched re-design of the reference's hybrid decoders
(Matlab/My_LDPC_HybridML_Erasure_Decoder.m:3-91,
Matlab/My_LDPC_HybridML_NonBinary_Erasure_Decoder.m:4-131): cheap iterative
peeling removes the bulk of erasures; the rare residual stopping set is solved
exactly by the batched GE kernel. This combination beats the equivalent-rate
Reed-Solomon code at every tested erasure rate (paper tex:164).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ldpc_erasure_codes_tpu.ops.arrays import CodeArrays
from ldpc_erasure_codes_tpu.ops.compact import (
    compact_ge_solve,
    residual_order,
)
from ldpc_erasure_codes_tpu.ops.ge import ge_solve, ge_solve_packed
from ldpc_erasure_codes_tpu.ops.peel import peel_decode
from ldpc_erasure_codes_tpu.ops.peel_wide import peel_decode_packed


@functools.partial(
    jax.jit,
    static_argnames=(
        "gf_order", "peel_iters", "emax", "impl", "ge_subbatch", "ge_impl",
        "return_overflow",
    ),
)
def hybrid_decode(
    arrays: CodeArrays,
    values: jax.Array,
    erased: jax.Array,
    *,
    gf_order: int = 2,
    peel_iters: int = 10,
    emax: int = 128,
    impl: str = "gather",
    ge_subbatch: int = 0,
    ge_impl: str = "auto",
    return_overflow: bool = False,
) -> tuple[jax.Array, ...]:
    """Peel up to ``peel_iters`` sweeps, then GE-solve the residual.

    The reference runs 10 peeling iterations before falling back
    (My_LDPC_HybridML_Erasure_Decoder.m:9). ``emax`` buckets the residual GE
    width; codewords whose residual exceeds it are flagged failed.
    ``ge_subbatch`` > 0 additionally compacts the frames that still hold
    erasures into a bucket of that size before the elimination (overflow →
    failed) — the production setting at low FER, where stopping sets are
    rare. Wide (B, n, W) values with ``impl="gather"`` take the platform's
    wide peel (``ops.peel_wide.peel_decode_packed``); other values and
    impls take ``peel_decode``.

    Returns (values, erased, iters, failed); with ``return_overflow=True``
    a 5th (B,) bool marks frames failed by BUCKET CONFIGURATION (residual
    wider than ``emax`` or spilled past the ``ge_subbatch`` frame bucket)
    rather than genuine rank deficiency — exactly the frames
    :func:`hybrid_decode_escalated` re-dispatches, and the count the sim
    driver reports as ``SimStats.escalations``.
    """
    if values.ndim == 3 and impl == "gather":
        values, erased, iters = peel_decode_packed(
            arrays, values, erased, max_iters=peel_iters, gf_order=gf_order
        )
    else:
        values, erased, iters = peel_decode(
            arrays, values, erased, gf_order=gf_order, max_iters=peel_iters,
            impl=impl,
        )
    any_residual = jnp.any(erased)

    def ge_flat(v, e):
        if ge_subbatch > 0:
            return compact_ge_solve(
                arrays, v, e, emax=emax, f_max=ge_subbatch, gf_order=gf_order,
                ge_impl=ge_impl,
            )
        packed = ge_impl == "packed" or (
            ge_impl == "auto"
            and gf_order == 2
            and v.ndim == 3
            and v.dtype == jnp.uint32
        )
        if packed:
            return ge_solve_packed(arrays, v, e, emax=emax)
        return ge_solve(arrays, v, e, emax=emax, gf_order=gf_order)

    n_sym = erased.shape[1]

    def bucket_overflow(e):
        ov = jnp.sum(e, axis=1) > min(emax, n_sym)
        if ge_subbatch > 0:
            _, _, frame_ov = residual_order(e, ge_subbatch)
            ov = ov | frame_ov
        return ov

    def with_ge(args):
        v, e = args
        return (*ge_flat(v, e), bucket_overflow(e))

    def without_ge(args):
        v, e = args
        z = jnp.zeros(e.shape[0], dtype=bool)
        return v, e, z, z

    # Skip the GE cube entirely when the whole batch peeled clean (the common
    # case at low PER).
    values, erased, failed, overflow = jax.lax.cond(
        any_residual, with_ge, without_ge, (values, erased)
    )
    if return_overflow:
        return values, erased, iters, failed, overflow
    return values, erased, iters, failed


def hybrid_decode_escalated(
    arrays: CodeArrays,
    values: jax.Array,
    erased: jax.Array,
    *,
    gf_order: int = 2,
    peel_iters: int = 10,
    emax: int = 128,
    impl: str = "gather",
    ge_subbatch: int = 0,
    ge_impl: str = "auto",
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array, int]:
    """:func:`hybrid_decode` with bucket-overflow ESCALATION (host wrapper).

    The reference's hybrid GE attempts the residual
    system at whatever width peeling left — its only failure mode is
    genuine singularity (My_LDPC_HybridML_Erasure_Decoder.m:52-62) —
    whereas this decoder's buckets (``emax`` columns, ``ge_subbatch`` frames) are
    static, so a decodable frame could be declared failed purely by
    configuration. This wrapper makes bucket sizing a performance knob,
    never a correctness knob: frames flagged failed that still hold
    erasures are re-decoded HOST-SIDE in a second dispatch whose buckets
    are computed from the actual residuals (rounded up for jit-cache
    reuse). Overflow is rare by construction at production operating
    points, so the escalation dispatch (and its one-off compile) is off
    the hot path entirely; genuinely rank-deficient frames re-fail in the
    wide bucket and stay failed.

    Not jittable (host sync on the failure flags); flat layout only.
    Returns (values, erased, iters, failed, n_escalated) where
    n_escalated counts frames that entered the second dispatch.
    """
    import numpy as np

    from ldpc_erasure_codes_tpu.ops.ge import ge_solve_wide_nb

    values, erased, iters, failed = hybrid_decode(
        arrays, values, erased, gf_order=gf_order, peel_iters=peel_iters,
        emax=emax, impl=impl, ge_subbatch=ge_subbatch, ge_impl=ge_impl,
    )
    failed_np = np.asarray(failed)
    if not failed_np.any():
        return values, erased, iters, failed, 0
    e_np = np.asarray(erased)
    resid = e_np.sum(axis=1)
    # Candidates: failed frames still holding erasures (bucket overflow OR
    # rank deficiency — indistinguishable from the flag alone; the latter
    # simply re-fail). Frames failed with zero residual cannot exist (the
    # mask is only cleared on success), but guard anyway.
    cand = np.where(failed_np & (resid > 0))[0]
    if cand.size == 0:
        return values, erased, iters, failed, 0
    n = erased.shape[1]
    # Buckets computed from the actual residuals, rounded up so repeated
    # escalations at similar sizes reuse the jit cache.
    emax2 = min(n, int(-(-int(resid[cand].max()) // 128) * 128))
    b2 = max(8, 1 << int(np.ceil(np.log2(cand.size))))
    sel = np.pad(cand, (0, b2 - cand.size), constant_values=cand[0])
    v_sub = values[jnp.asarray(sel)]
    e_sub = erased[jnp.asarray(sel)]
    # Failed frames' erased slots may hold first-dispatch garbage (the GE
    # writes partial solutions); restore the erased-slots-zero invariant
    # the syndrome relies on.
    v_sub = jnp.where(e_sub[..., None] if v_sub.ndim == 3 else e_sub,
                      jnp.zeros((), v_sub.dtype), v_sub)
    if gf_order == 256:
        v2, e2, f2 = ge_solve_wide_nb(arrays, v_sub, e_sub, emax=emax2)
    elif v_sub.ndim == 3 and v_sub.dtype == jnp.uint32:
        v2, e2, f2 = ge_solve_packed(arrays, v_sub, e_sub, emax=emax2)
    else:
        v2, e2, f2 = ge_solve(
            arrays, v_sub, e_sub, emax=emax2, gf_order=gf_order
        )
    # Merge the real frames back (duplicated pad frames write the same
    # values; the scatter keeps the last, which is identical).
    keep = jnp.asarray(cand)
    values = values.at[keep].set(v2[: cand.size])
    erased = erased.at[keep].set(e2[: cand.size])
    failed = failed.at[keep].set(f2[: cand.size])
    return values, erased, iters, failed, int(cand.size)
