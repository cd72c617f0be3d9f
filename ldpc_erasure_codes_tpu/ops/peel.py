"""Peeling (message-passing) erasure decoder — the framework's centerpiece.

Algorithm: per iteration, every check with exactly one erased neighbor solves
it (binary: XOR of its other neighbors; GF(256): table-MAC of the others times
the inverse of the erased coefficient). The reference sweeps checks
*sequentially* within an iteration (Matlab/My_LDPC_Erasure_Decoder.m:24-37);
this design runs all checks *in parallel* (Jacobi sweep) — both
schedules peel to the same unique maximal stopping set, so results agree at
convergence (the reference itself ships a schedule-variant decoder: the 2-way
check-split FPGA kernel, OpenCL/device/ldpc_erasure_decoder_perf_tests.cl:95-203,
paper tex:183). Jacobi may need more iterations; iteration statistics are
reported per schedule, not compared across schedules.

Two implementations:

* ``impl="gather"`` — sparse: neighbor gathers along the Vlist/Clist index
  matrices, XOR/table-MAC reductions. Handles binary and GF(256),
  scalar and wide (packed multi-word) symbols. Work scales with edges.
* ``impl="matmul"`` — dense: erasure counts, parities and the solve scatter
  are three int8 matmuls against the dense H mask. Binary scalar symbols
  only; wins for large batches where the int8 matmul throughput beats gather
  overheads despite the ~150x density waste.

Early stop: per-codeword "done" is zero residual erasures, or optionally
"first k symbols known" exactly as the FPGA's early exit
(decoder_perf_tests.cl:86-88, :205-210). The iteration loop is a
``lax.while_loop`` that exits when every codeword in the batch is done or no
global progress was made (stopping set reached everywhere).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ldpc_erasure_codes_tpu import gf
from ldpc_erasure_codes_tpu.ops.arrays import CodeArrays


def _xor_reduce(x: jax.Array, axis: int) -> jax.Array:
    return jax.lax.reduce(x, x.dtype.type(0), jax.lax.bitwise_xor, (axis,))


def _or_reduce(x: jax.Array, axis: int) -> jax.Array:
    return jax.lax.reduce(x, x.dtype.type(0), jax.lax.bitwise_or, (axis,))


class PeelState(NamedTuple):
    values: jax.Array  # (B, n) uint8 or (B, n, W) packed wide symbols
    erased: jax.Array  # (B, n) bool
    iters: jax.Array  # (B,) int32 — iteration at which the codeword finished
    it: jax.Array  # () int32 — global iteration counter
    prev_unresolved: jax.Array  # () int32 — for global progress detection


def _pad_n(x: jax.Array, axis: int) -> jax.Array:
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, 1)
    return jnp.pad(x, pad)


def peel_step_gather(
    arrays: CodeArrays,
    values: jax.Array,
    erased: jax.Array,
    gf_order: int,
) -> tuple[jax.Array, jax.Array]:
    """One Jacobi peeling sweep via neighbor gathers.

    ``values`` is (B, n[, W]); erased slots must be zero (channel invariant).
    """
    wide = values.ndim == 3
    idx = arrays.vlist_idx  # (m, dmax), pad = n
    values_p = _pad_n(values, 1)
    erased_p = _pad_n(erased, 1)
    yv = jnp.take(values_p, idx, axis=1)  # (B, m, dmax[, W])
    ev = jnp.take(erased_p, idx, axis=1)  # (B, m, dmax)
    cnt = jnp.sum(ev, axis=2, dtype=jnp.int32)  # (B, m)
    deg1 = cnt == 1

    if gf_order == 2:
        # Erased slots are zero, so the XOR of all neighbors IS the erased
        # symbol's value when exactly one neighbor is erased.
        val_c = _xor_reduce(yv, axis=2)  # (B, m[, W])
    else:
        coeff = arrays.vlist_val[None, :, :, None] if wide else arrays.vlist_val[None]
        prod = gf.gf_mul(coeff, yv)
        syn = _xor_reduce(prod, axis=2)  # (B, m[, W])
        # XOR-select the erased neighbor's inverse coefficient (exactly one
        # term is nonzero for degree-1 checks; junk elsewhere is masked off).
        inv_sel = jnp.where(ev, arrays.vlist_inv_val[None], jnp.uint8(0))
        coef_inv = _xor_reduce(inv_sel, axis=2)  # (B, m)
        if wide:
            coef_inv = coef_inv[..., None]
        val_c = gf.gf_mul(syn, coef_inv)

    # Scatter: each erased symbol takes the value from any of its degree-1
    # checks (all agree on a valid codeword), via Clist gathers + OR-fold.
    cidx = arrays.clist_idx  # (n, cmax), pad = m
    val_cp = _pad_n(val_c, 1)
    deg1_p = _pad_n(deg1, 1)
    vs = jnp.take(val_cp, cidx, axis=1)  # (B, n, cmax[, W])
    ds = jnp.take(deg1_p, cidx, axis=1)  # (B, n, cmax)
    solved = jnp.any(ds, axis=2) & erased  # (B, n)
    ds_b = ds[..., None] if wide else ds
    newval = _or_reduce(jnp.where(ds_b, vs, jnp.zeros((), vs.dtype)), axis=2)
    sel = solved[..., None] if wide else solved
    values = jnp.where(sel, newval, values)
    erased = erased & ~solved
    return values, erased


def peel_step_matmul(
    arrays: CodeArrays, values: jax.Array, erased: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """One Jacobi peeling sweep as three int8 matmuls (binary, scalar).

    cnt = e @ H^T counts erased neighbors per check; par = y @ H^T mod 2 is
    each check's XOR of known neighbors (= the solved value for degree-1
    checks); votes = (deg1 & par) @ H scatters values back. All degree-1
    checks solving a symbol agree, so votes > 0 recovers the bit.
    """
    e8 = erased.astype(jnp.int8)
    y8 = values.astype(jnp.int8)
    cnt = gf.int_matmul(e8, arrays.h_t)  # (B, m)
    par = gf.int_matmul(y8, arrays.h_t) & 1  # (B, m)
    deg1 = cnt == 1
    nsolv = gf.int_matmul(deg1.astype(jnp.int8), arrays.h)  # (B, n)
    votes = gf.int_matmul((deg1 & (par == 1)).astype(jnp.int8), arrays.h)
    solved = (nsolv > 0) & erased
    values = jnp.where(solved, (votes > 0).astype(values.dtype), values)
    erased = erased & ~solved
    return values, erased


@functools.partial(
    jax.jit,
    static_argnames=(
        "gf_order", "max_iters", "early_stop_k", "impl", "worklist_size", "seq_blocks",
    ),
)
def peel_decode(
    arrays: CodeArrays,
    values: jax.Array,
    erased: jax.Array,
    *,
    gf_order: int = 2,
    max_iters: int = 50,
    early_stop_k: int | None = None,
    impl: str = "gather",
    worklist_size: int = 128,
    seq_blocks: int = 1,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Iterative peeling decode of a codeword batch.

    Args:
      values: (B, n) uint8 symbols, or (B, n, W) packed wide symbols; erased
        slots zero.
      erased: (B, n) bool erasure mask.
      gf_order: 2 or 256.
      max_iters: iteration cap (reference uses 50 standalone, 10 in hybrid —
        My_LDPC_Erasure_Decoder.m:10, My_LDPC_HybridML_Erasure_Decoder.m:9).
      early_stop_k: when set, a codeword counts as done once its first k
        symbols are known (FPGA semantics, decoder_perf_tests.cl:205-210).
      impl: "gather" (dense neighbor sweeps), "matmul" (binary scalar only),
        or "worklist" (compacted degree-1 sweeps — the fast path for wide
        symbols; ``worklist_size`` bounds solves per sweep per codeword).
      seq_blocks: > 1 splits each iteration into that many *sequential*
        check-block sweeps (Gauss-Seidel between blocks; == m reproduces the
        MATLAB reference's schedule and its exact iteration counts).

    Returns:
      (values, erased, iters) — iters (B,) is the iteration at which each
      codeword finished (max_iters when it never did).
    """
    if impl not in ("gather", "matmul", "worklist"):
        # Rejecting typos here prevents a silent fall-through to the
        # gather path.
        raise ValueError(
            f"unknown impl {impl!r}: expected gather | matmul | worklist"
        )
    if impl == "matmul" and (gf_order != 2 or values.ndim == 3):
        raise ValueError("matmul impl supports binary scalar symbols only")

    def done_mask(er):
        if early_stop_k is not None:
            er = er[:, :early_stop_k]
        return ~jnp.any(er, axis=1)

    def cond(s: PeelState):
        unresolved = jnp.sum(s.erased, dtype=jnp.int32)
        if early_stop_k is not None:
            active = ~done_mask(s.erased)
        else:
            active = jnp.any(s.erased, axis=1)
        progress = unresolved < s.prev_unresolved
        return (s.it < max_iters) & jnp.any(active) & progress

    def body(s: PeelState):
        if seq_blocks > 1:
            values, erased = peel_step_seq_blocks(
                arrays, s.values, s.erased, gf_order, seq_blocks
            )
        elif impl == "matmul":
            values, erased = peel_step_matmul(arrays, s.values, s.erased)
        elif impl == "worklist":
            values, erased = peel_step_worklist(
                arrays, s.values, s.erased, gf_order, worklist_size
            )
        else:
            values, erased = peel_step_gather(arrays, s.values, s.erased, gf_order)
        it = s.it + 1
        newly_done = done_mask(erased) & (s.iters == 0)
        iters = jnp.where(newly_done, it, s.iters)
        return PeelState(
            values, erased, iters, it, jnp.sum(s.erased, dtype=jnp.int32)
        )

    b = values.shape[0]
    # Reference semantics: even an erasure-free word runs (and counts) one
    # sweep; we pre-mark already-done words with iters=1 after the first body
    # run, so seed iters with 0 and let the loop assign.
    init = PeelState(
        values,
        erased,
        jnp.zeros((b,), jnp.int32),
        jnp.zeros((), jnp.int32),
        jnp.iinfo(jnp.int32).max * jnp.ones((), jnp.int32),
    )
    final = jax.lax.while_loop(cond, body, init)
    iters = jnp.where(final.iters == 0, jnp.int32(max_iters), final.iters)
    # Erasure-free inputs never enter the loop; they finish in "1 iteration"
    # to match the reference's accounting (the while loop always runs once).
    iters = jnp.where(done_mask(erased), jnp.int32(1), iters)
    return final.values, final.erased, iters


def peel_step_seq_blocks(
    arrays: CodeArrays,
    values: jax.Array,
    erased: jax.Array,
    gf_order: int,
    seq_blocks: int,
) -> tuple[jax.Array, jax.Array]:
    """One iteration as ``seq_blocks`` sequential check-block sweeps.

    Schedule-parity knob: the MATLAB reference sweeps checks *sequentially*
    within an iteration, so in-sweep updates propagate
    (My_LDPC_Erasure_Decoder.m:24-37 — Gauss-Seidel); the FPGA's 2-way split
    runs both halves on the start-of-iteration state and merges (Jacobi,
    decoder_perf_tests.cl:95-203). This step interpolates: Jacobi within a
    block, sequential between blocks. ``seq_blocks == m`` reproduces the
    MATLAB schedule exactly (bit-exact iteration counts vs the oracle);
    ``seq_blocks == 1`` is the production Jacobi sweep. All schedules peel
    to the same fixed point.
    """
    wide = values.ndim == 3
    m, dmax = arrays.vlist_idx.shape
    n = erased.shape[1]
    mb = -(-m // seq_blocks)
    pad_rows = seq_blocks * mb - m
    idx_b = jnp.concatenate(
        [arrays.vlist_idx, jnp.full((pad_rows, dmax), n, jnp.int32)]
    ).reshape(seq_blocks, mb, dmax)
    val_b = jnp.concatenate(
        [arrays.vlist_val, jnp.zeros((pad_rows, dmax), jnp.uint8)]
    ).reshape(seq_blocks, mb, dmax)
    inv_b = jnp.concatenate(
        [arrays.vlist_inv_val, jnp.zeros((pad_rows, dmax), jnp.uint8)]
    ).reshape(seq_blocks, mb, dmax)

    values_p = _pad_n(values, 1)
    erased_p = _pad_n(erased, 1)
    b = erased.shape[0]
    bi2 = jnp.arange(b, dtype=jnp.int32)[:, None]

    def block(carry, xs):
        values_p, erased_p = carry
        idx, val, inv = xs  # (mb, dmax)
        yv = jnp.take(values_p, idx, axis=1)  # (B, mb, dmax[, W])
        ev = jnp.take(erased_p, idx, axis=1)  # (B, mb, dmax)
        deg1 = jnp.sum(ev, axis=2, dtype=jnp.int32) == 1
        if gf_order == 2:
            solved_val = _xor_reduce(yv, axis=2)
        else:
            coeff = val[None, :, :, None] if wide else val[None]
            syn = _xor_reduce(gf.gf_mul(coeff, yv), axis=2)
            ci = _xor_reduce(jnp.where(ev, inv[None], jnp.uint8(0)), axis=2)
            solved_val = gf.gf_mul(syn, ci[..., None] if wide else ci)
        target = jnp.sum(jnp.where(ev, idx[None], 0), axis=2, dtype=jnp.int32)
        safe_target = jnp.where(deg1, target, n)
        vmask = deg1[..., None] if wide else deg1
        values_p = values_p.at[bi2, safe_target].set(
            jnp.where(vmask, solved_val, jnp.zeros((), solved_val.dtype))
        )
        erased_p = erased_p.at[bi2, safe_target].set(False)
        return (values_p, erased_p), None

    (values_p, erased_p), _ = jax.lax.scan(
        block, (values_p, erased_p), (idx_b, val_b, inv_b)
    )
    return values_p[:, :n], erased_p[:, :n]


def peel_step_worklist(
    arrays: CodeArrays,
    values: jax.Array,
    erased: jax.Array,
    gf_order: int,
    worklist: int,
) -> tuple[jax.Array, jax.Array]:
    """One peeling sweep over a compacted degree-1-check work list.

    The dense sweep (`peel_step_gather`) XOR-reduces every check's neighbors
    across all W lanes even though only degree-1 checks produce a solution
    and only their single erased neighbor gets written. This sweep computes
    check degrees on the mask alone (int8 matmul), compacts up to
    ``worklist`` degree-1 checks per codeword (argsort), and runs the wide
    gather-XOR/scatter only for those. Wide-lane traffic drops from
    O(m·dmax·W) per sweep to O(worklist·dmax·W), and total wide work across
    a decode approaches the information-theoretic minimum of one neighbor
    MAC per solved erasure.

    Degree-1 checks beyond the work-list bound wait for the next sweep —
    the fixed point is unchanged (another schedule variant, like the FPGA's
    2-way split, decoder_perf_tests.cl:95-203); only iteration counts shift
    when the bound binds.

    The data-dependent (argsort-derived) gather/scatter indices defeat XLA's
    constant-topology gather lowering, which already streams only the real
    edges. Retained as the reference implementation of work-list
    scheduling; production decode uses ``impl="gather"``.
    """
    wide = values.ndim == 3
    b, n = erased.shape
    cnt = gf.int_matmul(erased.astype(jnp.int8), arrays.h_t)  # (B, m)
    deg1 = cnt == 1
    order = jnp.argsort(~deg1, axis=1, stable=True).astype(jnp.int32)[:, :worklist]
    valid = jnp.take_along_axis(deg1, order, axis=1)  # (B, A)
    idx_nb = arrays.vlist_idx[order]  # (B, A, dmax), pad = n

    values_p = _pad_n(values, 1)
    erased_p = _pad_n(erased, 1)
    bidx = jnp.arange(b, dtype=jnp.int32)[:, None, None]
    yv = values_p[bidx, idx_nb]  # (B, A, dmax[, W])
    ev = erased_p[jnp.arange(b)[:, None, None], idx_nb]  # (B, A, dmax)

    if gf_order == 2:
        val = _xor_reduce(yv, axis=2)  # (B, A[, W])
    else:
        coeff = arrays.vlist_val[order]  # (B, A, dmax)
        cc = coeff[..., None] if wide else coeff
        val = _xor_reduce(gf.gf_mul(cc, yv), axis=2)
        inv_sel = jnp.where(ev, arrays.vlist_inv_val[order], jnp.uint8(0))
        coef_inv = _xor_reduce(inv_sel, axis=2)  # (B, A)
        val = gf.gf_mul(val, coef_inv[..., None] if wide else coef_inv)

    # The degree-1 check's single erased neighbor is the write target.
    target = jnp.sum(jnp.where(ev, idx_nb, 0), axis=2, dtype=jnp.int32)
    safe_target = jnp.where(valid, target, n)  # invalid slots hit the pad
    bi2 = jnp.arange(b, dtype=jnp.int32)[:, None]
    vmask = valid[..., None] if wide else valid
    # Write targets are erased slots, which hold zero by invariant, and
    # invalid slots land on the pad column — a plain masked set suffices.
    values_p = values_p.at[bi2, safe_target].set(
        jnp.where(vmask, val, jnp.zeros((), val.dtype))
    )
    erased_p = erased_p.at[bi2, safe_target].set(False)
    return values_p[:, :n], erased_p[:, :n]


@functools.partial(
    jax.jit, static_argnames=("max_iters", "early_stop_k")
)
def peel_decode_mask(
    arrays: CodeArrays,
    erased: jax.Array,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Pattern-only peeling: evolve just the erasure mask, no symbol values.

    Whether peeling succeeds depends only on the erasure pattern, never on
    the transmitted values — the same structural fact the reference exploits
    to score RS without an RS decoder (paper tex:220,
    decoder_perf_tests.cl:74-81). Two int8 matmuls per sweep: erased
    neighbor counts per check, then a degree-1-check scatter. Used by the
    FER simulation fast path; value decoding uses :func:`peel_decode`.

    Returns (residual mask, per-codeword finish iterations).
    """

    def done_mask(er):
        if early_stop_k is not None:
            er = er[:, :early_stop_k]
        return ~jnp.any(er, axis=1)

    def cond(s):
        erased, iters, it, prev = s
        unresolved = jnp.sum(erased, dtype=jnp.int32)
        return (it < max_iters) & jnp.any(~done_mask(erased)) & (unresolved < prev)

    def body(s):
        erased, iters, it, _ = s
        prev = jnp.sum(erased, dtype=jnp.int32)
        cnt = gf.int_matmul(erased.astype(jnp.int8), arrays.h_t)  # (B, m)
        deg1 = (cnt == 1).astype(jnp.int8)
        nsolv = gf.int_matmul(deg1, arrays.h)  # (B, n)
        erased = erased & ~(nsolv > 0)
        it = it + 1
        newly = done_mask(erased) & (iters == 0)
        iters = jnp.where(newly, it, iters)
        return erased, iters, it, prev

    b = erased.shape[0]
    init = (
        erased,
        jnp.zeros((b,), jnp.int32),
        jnp.zeros((), jnp.int32),
        jnp.iinfo(jnp.int32).max * jnp.ones((), jnp.int32),
    )
    erased_f, iters, _, _ = jax.lax.while_loop(cond, body, init)
    iters = jnp.where(iters == 0, jnp.int32(max_iters), iters)
    iters = jnp.where(done_mask(erased), jnp.int32(1), iters)
    return erased_f, iters


def peel_decode_with_history(
    arrays: CodeArrays,
    values: jax.Array,
    erased: jax.Array,
    *,
    gf_order: int = 2,
    max_iters: int = 50,
    impl: str = "gather",
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Fixed-iteration peeling that also returns the per-iteration residual
    erasure counts (B, max_iters) — the reference's ``erasure_hist``
    (My_LDPC_Erasure_Decoder.m:16,45). Runs exactly max_iters sweeps under
    ``lax.scan`` (no early exit), for diagnostics and iteration histograms.
    """

    def step(carry, _):
        values, erased = carry
        if impl == "matmul":
            values, erased = peel_step_matmul(arrays, values, erased)
        else:
            values, erased = peel_step_gather(arrays, values, erased, gf_order)
        return (values, erased), jnp.sum(erased, axis=1, dtype=jnp.int32)

    (values, erased), hist = jax.lax.scan(
        step, (values, erased), None, length=max_iters
    )
    return values, erased, hist.T
