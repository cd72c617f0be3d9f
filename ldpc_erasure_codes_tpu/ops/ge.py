"""Batched Gaussian elimination over GF(2) / GF(256) — the ML erasure solver.

The reference's maximum-likelihood fallback solves ``H_erased . x = H_known .
y_known`` by sequential row-reduction with row swaps per codeword
(Matlab/My_LDPC_HybridML_Erasure_Decoder.m:48-88 binary,
Matlab/My_LDPC_HybridML_NonBinary_Erasure_Decoder.m:61-128 GF(256)).

Batched re-design: fixed shapes + full batching.

* The per-codeword erased-column set (data-dependent size) is padded to a
  static bucket ``emax``; pad slots get **virtual unit columns** in an extra
  block of ``emax`` appended rows, so padded columns pivot trivially on their
  own private row and never disturb the real system. No dynamic shapes, no
  per-codeword control flow.
* One ``fori_loop`` over pivot columns; each step does the pivot search
  (argmax of a masked column), a masked row swap, and a full Gauss-Jordan
  elimination (all rows at once) — vectorized across the batch so many
  codewords share each pivot step. Pivot order matches the reference
  (ascending erased index, first nonzero row at-or-below the diagonal).
* Singularity (a real column with no pivot) sets a per-codeword failure flag —
  the reference's ``dont_do_jordan`` (My_LDPC_HybridML_Erasure_Decoder.m:59-62).
  Like the reference, solved values are still written back; callers must gate
  on the flag.

Work is O(B . (m+emax) . emax^2) byte-ops; the hybrid decoder only
reaches this kernel for codewords the peeler could not finish, and ``emax``
buckets keep the cube small.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ldpc_erasure_codes_tpu import gf
from ldpc_erasure_codes_tpu.gf.ops import _xtime_packed
from ldpc_erasure_codes_tpu.gf.tables import DEFAULT_PRIM_POLY
from ldpc_erasure_codes_tpu.ops.arrays import CodeArrays
from ldpc_erasure_codes_tpu.ops.peel import _pad_n, _xor_reduce


def _xtime_packed_u32(v: jax.Array) -> jax.Array:
    """SWAR multiply-by-x of four packed GF(256) bytes per uint32 lane."""
    return _xtime_packed(v, DEFAULT_PRIM_POLY)


def erased_indices(erased: jax.Array, emax: int) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Per-codeword erased symbol indices, ascending, padded to emax.

    Returns (er_idx (B, emax) int32, real (B, emax) bool, nreal (B,) int32).
    Stable argsort of the inverted mask lists erased positions first in
    ascending index order — matching the reference's ``find`` pivot order.
    """
    order = jnp.argsort(~erased, axis=1, stable=True).astype(jnp.int32)
    er_idx = order[:, :emax]
    nreal = jnp.sum(erased, axis=1, dtype=jnp.int32)
    real = jnp.arange(emax, dtype=jnp.int32)[None, :] < nreal[:, None]
    return er_idx, real, nreal


def _syndrome_known(
    arrays: CodeArrays, values: jax.Array, gf_order: int
) -> jax.Array:
    """rhs = H . y_known ((B, m[, W])): erased slots are zero so a plain
    neighbor MAC over all neighbors is the known-only sum."""
    wide = values.ndim == 3
    values_p = _pad_n(values, 1)
    yv = jnp.take(values_p, arrays.vlist_idx, axis=1)  # (B, m, dmax[, W])
    if gf_order == 2:
        return _xor_reduce(yv, axis=2)
    coeff = arrays.vlist_val[None, :, :, None] if wide else arrays.vlist_val[None]
    return _xor_reduce(gf.gf_mul(coeff, yv), axis=2)


@functools.partial(jax.jit, static_argnames=("emax", "gf_order"))
def ge_rank_check(
    arrays: CodeArrays,
    erased: jax.Array,
    *,
    emax: int,
    gf_order: int = 2,
) -> jax.Array:
    """Pattern-only solvability: would Gauss-Jordan on the residual succeed?

    Runs the same pivot loop as :func:`ge_solve` on the erased-column matrix
    alone (no right-hand side, no value updates) — solvability depends only
    on the erasure pattern (and, over GF(256), on the fixed H coefficients),
    never on the transmitted values.

    Returns ``failed`` (B,) bool (rank-deficient or bucket overflow).
    """
    b, n = erased.shape
    # A bucket wider than the code covers every pattern; clamping (trace-time,
    # emax is static) keeps short codes working with the default emax=128.
    emax = min(emax, n)
    m = arrays.h.shape[0]
    er_idx, real, nreal = erased_indices(erased, emax)
    overflow = nreal > emax

    h_src = arrays.h_nb if gf_order == 256 else arrays.h.astype(jnp.uint8)
    a_top = jnp.take(h_src, er_idx, axis=1)
    a_top = jnp.transpose(a_top, (1, 0, 2)) * real[:, None, :].astype(jnp.uint8)
    eye = jnp.eye(emax, dtype=jnp.uint8)[None] * (~real)[:, None, :].astype(jnp.uint8)
    a = jnp.concatenate([a_top, eye], axis=1)  # (B, M, emax)
    mm = m + emax
    row_iota = jnp.arange(mm, dtype=jnp.int32)[None, :]

    def step(col, carry):
        a, failed = carry
        colv = jax.lax.dynamic_index_in_dim(a, col, axis=2, keepdims=False)
        cand = (colv != 0) & (row_iota >= col)
        has = jnp.any(cand, axis=1)
        piv = jnp.argmax(cand, axis=1).astype(jnp.int32)
        piv = jnp.where(has, piv, col)
        is_piv = row_iota == piv[:, None]
        is_col = row_iota == col
        row_piv = jnp.take_along_axis(a, piv[:, None, None], axis=1)
        row_col = jax.lax.dynamic_slice_in_dim(a, col, 1, axis=1)
        a = jnp.where(is_piv[:, :, None], row_col, a)
        a = jnp.where(is_col[:, :, None], row_piv, a)
        prow = jax.lax.dynamic_slice_in_dim(a, col, 1, axis=1)
        if gf_order == 256:
            pivot_el = jax.lax.dynamic_index_in_dim(
                prow[:, 0, :], col, axis=1, keepdims=False
            )
            prow = gf.gf_mul(gf.gf_inv(pivot_el)[:, None, None], prow)
            a = jnp.where(is_col[:, :, None], prow, a)
            colv2 = jax.lax.dynamic_index_in_dim(a, col, axis=2, keepdims=False)
            factor = jnp.where((row_iota != col) & has[:, None], colv2, 0)
            a = a ^ gf.gf_mul(factor[:, :, None], prow)
        else:
            colv2 = jax.lax.dynamic_index_in_dim(a, col, axis=2, keepdims=False)
            elim = ((colv2 != 0) & (row_iota != col) & has[:, None]).astype(jnp.uint8)
            a = a ^ elim[:, :, None] * prow
        failed = failed | (~has & (col < nreal))
        return a, failed

    _, failed = jax.lax.fori_loop(0, emax, step, (a, overflow))
    return failed


def _words_to_bits(x: jax.Array) -> jax.Array:
    """Unpack uint32 (..., W) -> int8 bits (..., 32W), LSB-first per word."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (x[..., :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(*x.shape[:-1], x.shape[-1] * 32).astype(jnp.int8)


def _bits_to_words(bits: jax.Array) -> jax.Array:
    """Pack int bits (..., 32W) -> uint32 (..., W), LSB-first per word."""
    nw = bits.shape[-1] // 32
    b = bits.reshape(*bits.shape[:-1], nw, 32).astype(jnp.uint32)
    weights = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b * weights, axis=-1, dtype=jnp.uint32)


@functools.partial(jax.jit, static_argnames=("emax",))
def ge_solve_packed(
    arrays: CodeArrays,
    values: jax.Array,
    erased: jax.Array,
    *,
    emax: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Binary wide-symbol GE with packed-bit elimination + one matmul apply.

    Returns (values, erased, failed).

    Same contract and results as :func:`ge_solve` (gf_order=2, wide uint32
    values), restructured for the memory hierarchy: :func:`ge_solve` streams
    the (B, m+emax, W)-word right-hand side through device memory once per pivot
    (~W*4 bytes per row per pivot — the dominant cost at GE-hot operating
    points). Here the pivot loop carries only the packed
    coefficient matrix [A | T] — m rows of A's emax columns plus an identity
    block T tracking the accumulated row ops, ceil((emax+m)/32) uint32 words
    per row, ~30x less per-pivot traffic at the production shapes — and the
    wide values are touched exactly once at the end: the solved symbols are
    ``x = T_top . rhs`` over GF(2), computed as a bit-plane int8 matmul
    (chunked over the symbol width to bound the unpacked intermediate).

    Pivot order, failure flags, and solved values are identical to
    ``ge_solve`` (asserted in tests); garbage values of *failed* frames may
    differ (both contracts say callers must gate on ``failed``).

    Reference: Matlab/My_LDPC_HybridML_Erasure_Decoder.m:48-88 (the GF(2)
    elimination this solves); the row-op-tracking formulation mirrors
    My_RS_Decode's G_c^-1 construction (Matlab/My_RS_Decode.m:74-108) lifted
    to the H-side system.
    """
    b, n = erased.shape
    emax = min(emax, n)
    m = arrays.h.shape[0]
    if values.ndim != 3 or values.dtype != jnp.uint32:
        raise ValueError("ge_solve_packed needs wide (B, n, W) uint32 values")
    er_idx, real, nreal = erased_indices(erased, emax)
    overflow = nreal > emax
    wa = -(-emax // 32)
    wt = -(-m // 32)

    # [A | T]: A = erased columns of H (pad slots are all-zero columns);
    # T = I tracking the row ops. Unlike ge_solve, NO virtual unit rows are
    # carried for the pad slots: a pad column simply finds no pivot (its
    # candidates are empty), which `failed` already ignores (col >= nreal)
    # and `writable` masks out of the scatter. Virtual rows are zero in
    # every real column and real pivots never touch them, so dropping them
    # changes no pivot choice, no failure flag, and no solved value — it
    # just removes emax dead rows (and halves T) from every elimination
    # pass: (m+emax) x (wa + ceil((m+emax)/32)) -> m x (wa + ceil(m/32))
    # words per frame per pivot (~3x less traffic at the GE-hot shapes).
    # Batch-minor layout (as in ge_solve_wide_nb): the packed [A | T] rows
    # live as (m, C, B) with the BATCH on the minor axis, since C is only
    # ~32 packed words. Pivot choices, failure flags, and solved values
    # are unchanged (asserted vs ge_solve).
    a_top = jnp.take(arrays.h.astype(jnp.uint8), er_idx, axis=1)  # (m, B, E)
    a_mb = jnp.transpose(a_top, (0, 2, 1)) * jnp.transpose(real)[
        None
    ].astype(jnp.uint8)  # (m, emax, B)
    a_pad = jnp.pad(a_mb, ((0, 0), (0, wa * 32 - emax), (0, 0)))
    bitw = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    a_pk = jnp.sum(
        a_pad.reshape(m, wa, 32, b).astype(jnp.uint32)
        * bitw[None, None, :, None],
        axis=2,
        dtype=jnp.uint32,
    )  # (m, wa, B)
    t_pk = _bits_to_words(
        jnp.pad(jnp.eye(m, dtype=jnp.uint8), ((0, 0), (0, wt * 32 - m)))
    )  # (m, wt)
    r = jnp.concatenate(
        [a_pk, jnp.broadcast_to(t_pk[:, :, None], (m, wt, b))], axis=1
    )  # (m, wa+wt, B) uint32

    row_iota = jnp.arange(m, dtype=jnp.int32)[:, None]  # (m, 1)

    # Swap-free elimination: instead of physically moving the pivot row to
    # position `col` (a row gather + TWO full-matrix select passes per
    # pivot), rows stay put — a `used` mask excludes consumed pivots and a
    # per-column pivot-row index is recorded so the solution can be gathered
    # at the end. Rank-failure semantics are identical (a real column with
    # no unused nonzero row is rank deficiency either way), and the solution
    # of every solvable frame is the same (tested vs ge_solve). Cuts the
    # per-pivot full-matrix passes from ~5 to ~2.
    used0 = jnp.zeros((m, b), dtype=bool)
    pivrow0 = jnp.zeros((b, emax), dtype=jnp.int32)

    def step(col, carry):
        r, used, pivrow, failed = carry
        colw = jax.lax.dynamic_index_in_dim(
            r, col >> 5, axis=1, keepdims=False
        )  # (m, B)
        colv = (colw >> (col & 31).astype(jnp.uint32)) & jnp.uint32(1)
        cand = (colv != 0) & ~used
        has = jnp.any(cand, axis=0)  # (B,)
        piv = jnp.argmax(cand, axis=0).astype(jnp.int32)  # first row
        is_piv = row_iota == piv[None, :]  # (m, B)
        used = used | (is_piv & has[None, :])
        pivrow = pivrow.at[:, col].set(jnp.where(has, piv, 0))
        sel = is_piv[:, None, :].astype(jnp.uint32)
        prow = jnp.sum(r * sel, axis=0)  # (C, B): exactly one row selected
        elim = (colv != 0) & ~is_piv & has[None, :]  # (m, B)
        r = r ^ prow[None] * elim[:, None, :].astype(jnp.uint32)
        failed = failed | (~has & (col < nreal))
        return r, used, pivrow, failed

    r, _, pivrow, failed = jax.lax.fori_loop(
        0, emax, step, (r, used0, pivrow0, overflow)
    )
    r = jnp.transpose(r, (2, 0, 1))  # back to (B, m, C)

    # x = T[pivot rows] . rhs over GF(2). The virtual rows' rhs is zero, so
    # only the first m columns of T contribute.
    t_rows = jnp.take_along_axis(
        r[:, :, wa:], pivrow[:, :, None], axis=1
    )  # (B, emax, wt): row-op transform rows of each column's pivot
    t_bits = _words_to_bits(t_rows)[..., :m]  # (B, emax, m) int8
    w = values.shape[2]
    writable = real & ~overflow[:, None]
    rhs_top = _syndrome_known(arrays, values, 2)  # (B, m, W) uint32
    cw = min(w, 64)  # 2048-bit bit-plane chunks bound the unpacked temp
    xs = []
    for off in range(0, w, cw):
        wc = min(cw, w - off)
        rb = _words_to_bits(rhs_top[:, :, off : off + wc])  # (B,m,32wc)
        acc = jax.lax.dot_general(
            t_bits,
            rb,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32,
        )  # (B, emax, 32wc)
        xs.append(_bits_to_words(acc & 1))
    x = jnp.concatenate(xs, axis=2) if len(xs) > 1 else xs[0]

    x = x * writable[:, :, None].astype(x.dtype)
    safe_idx = jnp.where(writable, er_idx, n).astype(jnp.int32)
    bidx = jnp.arange(b)[:, None]
    values_p = _pad_n(values, 1)
    values_p = values_p.at[bidx, safe_idx].set(x)
    values = values_p[:, :n]
    solved = ~failed
    erased = erased & ~solved[:, None]
    return values, erased, failed


def _pack_bytes_words(x: jax.Array) -> jax.Array:
    """Pack uint8 (..., 4C) -> uint32 (..., C), LSB-first byte order (the
    wide-symbol packing convention)."""
    c = x.shape[-1] // 4
    xr = x.reshape(*x.shape[:-1], c, 4).astype(jnp.uint32)
    weights = jnp.uint32(1) << (8 * jnp.arange(4, dtype=jnp.uint32))
    return jnp.sum(xr * weights, axis=-1, dtype=jnp.uint32)


def _unpack_words_bytes(w: jax.Array) -> jax.Array:
    """Unpack uint32 (..., C) -> uint8 (..., 4C), LSB-first byte order."""
    shifts = 8 * jnp.arange(4, dtype=jnp.uint32)
    b = (w[..., None] >> shifts) & jnp.uint32(0xFF)
    return b.reshape(*w.shape[:-1], w.shape[-1] * 4).astype(jnp.uint8)


def _xtime8(v: jax.Array) -> jax.Array:
    """Multiply-by-x of uint8 GF(256) bytes (prim poly 0x171; the uint8 shift
    wraps mod 256, leaving only the polynomial reduction)."""
    return (v << 1) ^ ((v >> 7) * jnp.uint8(0x71))


def _bit_image_dev(mat: jax.Array) -> jax.Array:
    """Device-side GF(256) -> GF(2) binary image: (..., p, q) uint8 ->
    (..., 8p, 8q) int8, image[8i+b, 8j+c] = bit c of (mat[i,j] * x^b).

    Arithmetic construction (7 xtime chains + bit unpack) — no table
    gathers, so it runs at vector speed for per-frame matrices (the host
    :func:`gf.tables.bit_image` serves precomputed constants). Matches the
    host convention bit-exactly (tested), so ``bits(u) @ img mod 2 ==
    bits(u @ mat over GF(256))``."""
    prods = [mat]
    for _ in range(7):
        prods.append(_xtime8(prods[-1]))
    pv = jnp.stack(prods, axis=-2)  # (..., p, 8b, q)
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (pv[..., None] >> shifts) & 1  # (..., p, 8b, q, 8c)
    p, q = mat.shape[-2], mat.shape[-1]
    return bits.reshape(*mat.shape[:-2], 8 * p, 8 * q).astype(jnp.int8)


@functools.partial(jax.jit, static_argnames=("emax",))
def ge_solve_wide_nb(
    arrays: CodeArrays,
    values: jax.Array,
    erased: jax.Array,
    *,
    emax: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """GF(256) wide-symbol GE: narrow byte elimination + bit-image matmul apply.

    The GF(256) analog of :func:`ge_solve_packed`: the pivot loop eliminates
    the NARROW augmented system [A | T] (A = erased coefficient columns, T =
    identity tracking the accumulated row ops — (B, m, emax+m) bytes) and
    never touches the wide payloads; the wide values are handled
    by exactly two matmul passes at the end:

    * syndrome ``rhs = H_nb . y_known`` as a bit-plane int8 matmul against
      the binary image of H (built on device arithmetically — 7 xtime
      chains, no gathers);
    * solution ``x = T_top . rhs`` as a *batched* bit-image matmul (each
      frame's T gets its own on-device binary image).

    This is the batched form of the reference's table-gather row updates
    (Matlab/My_RS_Decode_Optimize_With_GFTables.m:55-91,
    My_LDPC_HybridML_NonBinary_Erasure_Decoder.m:98-126): same solution,
    failure flags from the same pivot order, wide work in matmuls instead of
    per-pivot wide row streams.

    Args/returns: as :func:`ge_solve` with gf_order=256 and (B, n, W) uint8
    values.
    """
    b, n = erased.shape
    emax = min(emax, n)
    m = arrays.h.shape[0]
    if values.ndim != 3 or values.dtype != jnp.uint8:
        raise ValueError("ge_solve_wide_nb needs wide (B, n, W) uint8 values")
    er_idx, real, nreal = erased_indices(erased, emax)
    overflow = nreal > emax

    # No virtual unit rows for pad slots (see ge_solve_packed): pad columns
    # are all-zero, find no pivot, and are masked out of the scatter — so
    # the elimination carries only the m real check rows and T = I(m).
    #
    # SWAR-packed, batch-minor elimination: the [A | T] rows are stored
    # as uint32 words holding FOUR GF(256) bytes each, in a (m, C, B)
    # layout with the BATCH on the minor axis.
    #
    # * gf_mul_arith costs ~30 uint16 vector ops per byte; packing quarters
    #   both the element count and the per-product op count (the pivot
    #   row's eight xtime images are formed once per step and every row's
    #   update is 8 mask-multiply-XOR passes — double-and-add over the
    #   factor bits).
    # * C = ceil((emax+m)/4) is only ~32 words at the RS shapes, so the
    #   batch, not C, is the long contiguous axis of every pass, and the
    #   pivot-row gather becomes a one-hot masked reduction over m.
    #
    # A is padded to a word boundary so T stays word-aligned. Pivot
    # choices, failure flags, and the recovered transform are
    # byte-identical to the unpacked formulation (tested vs ge_solve).
    wa = -(-emax // 4)
    wt = -(-m // 4)
    a_top = jnp.take(arrays.h_nb, er_idx, axis=1)  # (m, B, emax)
    a_mb = jnp.transpose(a_top, (0, 2, 1)) * jnp.transpose(real)[None].astype(
        jnp.uint8
    )  # (m, emax, B)
    a_pad = jnp.pad(a_mb, ((0, 0), (0, wa * 4 - emax), (0, 0)))
    weights = (jnp.uint32(1) << (8 * jnp.arange(4, dtype=jnp.uint32)))
    a_pk = jnp.sum(
        a_pad.reshape(m, wa, 4, b).astype(jnp.uint32)
        * weights[None, None, :, None],
        axis=2,
        dtype=jnp.uint32,
    )  # (m, wa, B)
    t_pk = _pack_bytes_words(
        jnp.pad(jnp.eye(m, dtype=jnp.uint8), ((0, 0), (0, wt * 4 - m)))
    )  # (m, wt)
    r = jnp.concatenate(
        [a_pk, jnp.broadcast_to(t_pk[:, :, None], (m, wt, b))], axis=1
    )  # (m, wa + wt, B) uint32

    row_iota = jnp.arange(m, dtype=jnp.int32)[:, None]  # (m, 1)

    # Swap-free elimination (see ge_solve_packed): a `used` mask + recorded
    # pivot-row indices replace the physical row swap's two full-matrix
    # select passes per pivot. Unlike the binary path the normalized pivot
    # row must be written back (one masked pass), since the end-state pivot
    # rows ARE the transform.
    used0 = jnp.zeros((m, b), dtype=bool)
    pivrow0 = jnp.zeros((b, emax), dtype=jnp.int32)

    def step(col, carry):
        r, used, pivrow, failed = carry
        colw = jax.lax.dynamic_index_in_dim(
            r, col >> 2, axis=1, keepdims=False
        )  # (m, B) uint32
        sh = ((col & 3) * 8).astype(jnp.uint32)
        colv = (colw >> sh) & jnp.uint32(0xFF)
        cand = (colv != 0) & ~used
        has = jnp.any(cand, axis=0)  # (B,)
        piv = jnp.argmax(cand, axis=0).astype(jnp.int32)  # first row
        is_piv = row_iota == piv[None, :]  # (m, B)
        used = used | (is_piv & has[None, :])
        pivrow = pivrow.at[:, col].set(jnp.where(has, piv, 0))
        sel = is_piv[:, None, :].astype(jnp.uint32)
        prow = jnp.sum(r * sel, axis=0)  # (C, B): exactly one row selected
        pivot_el = jnp.sum(colv * is_piv.astype(jnp.uint32), axis=0)  # (B,)
        prow = gf.gf_mul_packed(
            prow, gf.gf_inv(pivot_el.astype(jnp.uint8))[None, :]
        )
        r = jnp.where((is_piv & has[None, :])[:, None, :], prow[None], r)
        # Eight xtime images of the normalized pivot row, then the row
        # update as double-and-add over the factor bytes' bits.
        pw = prow
        factor = jnp.where(~is_piv & has[None, :], colv, jnp.uint32(0))
        acc = pw[None] * (factor & 1)[:, None, :]
        for bit in range(1, 8):
            pw = _xtime_packed_u32(pw)
            acc = acc ^ pw[None] * ((factor >> bit) & 1)[:, None, :]
        r = r ^ acc
        failed = failed | (~has & (col < nreal))
        return r, used, pivrow, failed

    r, _, pivrow, failed = jax.lax.fori_loop(
        0, emax, step, (r, used0, pivrow0, overflow)
    )
    r = jnp.transpose(r, (2, 0, 1))  # back to (B, m, C)

    # rhs = H_nb . y_known: erased slots hold zero, so the full-H product is
    # the known-only sum. Then x = T[pivot rows] . rhs per frame.
    h_img = _bit_image_dev(jnp.transpose(arrays.h_nb))  # (8n, 8m)
    t_top = _unpack_words_bytes(
        jnp.take_along_axis(r[:, :, wa:], pivrow[:, :, None], axis=1)
    )[:, :, :m]  # (B, emax, m)
    # Bit-plane products accumulate in int32 and keep the parity bit.
    ub = gf.bytes_to_bits(jnp.transpose(values, (0, 2, 1)))  # (B,W,8n)
    acc = jax.lax.dot_general(
        ub, h_img,
        dimension_numbers=(((2,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    rhs = gf.bits_to_bytes(acc & 1)  # (B, W, m) bytes
    tt_img = _bit_image_dev(
        jnp.transpose(t_top, (0, 2, 1))
    )  # (B, 8m, 8emax)
    rb = gf.bytes_to_bits(rhs)  # (B, W, 8m)
    xb = jax.lax.dot_general(
        rb, tt_img,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    )
    x = jnp.transpose(gf.bits_to_bytes(xb & 1), (0, 2, 1))  # (B,emax,W)
    values_p = _pad_n(values, 1)
    writable = real & ~overflow[:, None]
    x = x * writable[:, :, None].astype(x.dtype)
    bidx = jnp.arange(b)[:, None]
    safe_idx = jnp.where(writable, er_idx, n)
    values_p = values_p.at[bidx, safe_idx].set(x)
    values = values_p[:, :n]

    solved = ~failed
    erased = erased & ~solved[:, None]
    return values, erased, failed


@functools.partial(jax.jit, static_argnames=("emax", "gf_order"))
def ge_solve(
    arrays: CodeArrays,
    values: jax.Array,
    erased: jax.Array,
    *,
    emax: int,
    gf_order: int = 2,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Solve all residual erasures by batched Gauss-Jordan elimination.

    Args:
      values: (B, n) uint8 or (B, n, W) wide symbols, erased slots zero.
      erased: (B, n) bool residual erasure mask (e.g. after peeling).
      emax: static column bucket; codewords with more than emax residual
        erasures are flagged failed (choose emax >= expected residuals, at
        most m).
      gf_order: 2 or 256.

    Returns:
      (values, erased, failed) — ``failed`` (B,) bool marks rank-deficient or
      bucket-overflow codewords; their values are garbage in the previously
      erased slots (reference writes garbage too) and their ``erased`` mask is
      left set.
    """
    b, n = erased.shape
    # Clamp as in ge_rank_check: emax > n adds only pad columns, and the
    # unclamped shapes break (er_idx caps at n while the bucket iotas don't).
    emax = min(emax, n)
    m = arrays.h.shape[0]
    wide = values.ndim == 3
    er_idx, real, nreal = erased_indices(erased, emax)
    overflow = nreal > emax

    # A: (B, m+emax, emax). Top block = erased columns of H (zeroed for pad
    # slots); bottom block = identity rows for pad slots only.
    h_src = arrays.h_nb if gf_order == 256 else arrays.h.astype(jnp.uint8)
    a_top = jnp.take(h_src, er_idx, axis=1)  # (m, B, emax)
    a_top = jnp.transpose(a_top, (1, 0, 2)) * real[:, None, :].astype(jnp.uint8)
    eye = jnp.eye(emax, dtype=jnp.uint8)[None] * (~real)[:, None, :].astype(jnp.uint8)
    a = jnp.concatenate([a_top, eye], axis=1)  # (B, M, emax)
    mm = m + emax

    rhs_top = _syndrome_known(arrays, values, gf_order)  # (B, m[, W])
    pad_shape = (b, emax, values.shape[2]) if wide else (b, emax)
    rhs = jnp.concatenate([rhs_top, jnp.zeros(pad_shape, rhs_top.dtype)], axis=1)

    row_iota = jnp.arange(mm, dtype=jnp.int32)[None, :]  # (1, M)

    def step(col, carry):
        a, rhs, failed = carry
        colv = jax.lax.dynamic_index_in_dim(a, col, axis=2, keepdims=False)  # (B, M)
        cand = (colv != 0) & (row_iota >= col)
        has = jnp.any(cand, axis=1)  # (B,)
        piv = jnp.argmax(cand, axis=1).astype(jnp.int32)  # first True
        piv = jnp.where(has, piv, col)  # degenerate: self-swap no-op

        # Masked row swap col <-> piv (per codeword).
        is_piv = row_iota == piv[:, None]
        is_col = row_iota == col
        row_piv_a = jnp.take_along_axis(a, piv[:, None, None], axis=1)  # (B,1,E)
        row_col_a = jax.lax.dynamic_slice_in_dim(a, col, 1, axis=1)
        a = jnp.where(is_piv[:, :, None], row_col_a, a)
        a = jnp.where(is_col[:, :, None], row_piv_a, a)
        if wide:
            row_piv_r = jnp.take_along_axis(rhs, piv[:, None, None], axis=1)
            row_col_r = jax.lax.dynamic_slice_in_dim(rhs, col, 1, axis=1)
            rhs = jnp.where(is_piv[:, :, None], row_col_r, rhs)
            rhs = jnp.where(is_col[:, :, None], row_piv_r, rhs)
        else:
            row_piv_r = jnp.take_along_axis(rhs, piv[:, None], axis=1)
            row_col_r = jax.lax.dynamic_slice_in_dim(rhs, col, 1, axis=1)
            rhs = jnp.where(is_piv, row_col_r, rhs)
            rhs = jnp.where(is_col, row_piv_r, rhs)

        prow_a = jax.lax.dynamic_slice_in_dim(a, col, 1, axis=1)  # (B, 1, E)
        prow_r = jax.lax.dynamic_slice_in_dim(rhs, col, 1, axis=1)

        if gf_order == 256:
            # Normalize the pivot row to a unit pivot.
            pivot_el = jax.lax.dynamic_index_in_dim(
                prow_a[:, 0, :], col, axis=1, keepdims=False
            )  # (B,)
            inv_el = gf.gf_inv(pivot_el)
            prow_a = gf.gf_mul(inv_el[:, None, None], prow_a)
            prow_r = gf.gf_mul(
                inv_el[:, None, None] if wide else inv_el[:, None], prow_r
            )
            a = jnp.where(is_col[:, :, None], prow_a, a)
            rhs = jnp.where(is_col[:, :, None] if wide else is_col, prow_r, rhs)
            colv2 = jax.lax.dynamic_index_in_dim(a, col, axis=2, keepdims=False)
            factor = jnp.where((row_iota != col) & has[:, None], colv2, 0)  # (B, M)
            a = a ^ gf.gf_mul(factor[:, :, None], prow_a)
            fr = factor[:, :, None] if wide else factor
            rhs = rhs ^ gf.gf_mul(fr, prow_r)
        else:
            colv2 = jax.lax.dynamic_index_in_dim(a, col, axis=2, keepdims=False)
            elim = ((colv2 != 0) & (row_iota != col) & has[:, None]).astype(jnp.uint8)
            a = a ^ elim[:, :, None] * prow_a
            er8 = (elim[:, :, None] if wide else elim) * prow_r
            rhs = rhs ^ er8

        failed = failed | (~has & (col < nreal))
        return a, rhs, failed

    failed0 = overflow
    a, rhs, failed = jax.lax.fori_loop(0, emax, step, (a, rhs, failed0))

    # Identity now occupies rows 0..emax-1; the solution is rhs[:emax].
    x = rhs[:, :emax]  # (B, emax[, W])
    writable = real & ~overflow[:, None]
    if wide:
        x = x * writable[:, :, None].astype(x.dtype)
    else:
        x = x * writable.astype(x.dtype)
    bidx = jnp.arange(b)[:, None]
    safe_idx = jnp.where(writable, er_idx, n)  # scatter pads to a dropped slot
    values_p = _pad_n(values, 1)
    values_p = values_p.at[bidx, safe_idx].set(x)
    values = values_p[:, :n]
    solved = ~failed
    erased = erased & ~solved[:, None]
    return values, erased, failed
