"""Wide-symbol peeling decoder in XLA (symbol-major layout), and the choice
between it and the GPU replay kernel.

:func:`peel_decode_wide` is the plain version: the CPU path and the
reference the replay kernel (ops/peel_replay.py) is tested against.
:func:`peel_decode_packed` is what callers use; it picks the implementation
from the platform (utils/device.py).

Honest-throughput redesign of the wide value decode. The measurement story
(docs/DESIGN.md): early decode benchmarks consumed only the erasure mask and
iteration counts, and since mask evolution is value-independent, XLA
dead-code-eliminated the entire wide-symbol value computation — reporting
the pattern-decode rate as if it were value decode. Every number behind this
module consumes the decoded values.

Design vs the frame-major `peel_decode` gather step (measured ~2x faster):

* **Symbol-major layout**: values are held as (n+1, b, W) during decode, so
  each neighbor-gather index moves one contiguous (b, W) block — the batch
  dimension amortizes gather addressing, where the frame-major layout pays
  per-(frame, edge).
* **Direct degree-1 scatter**: the write target of each degree-1 check is
  computed on the mask side (sum of erased neighbor indices), replacing the
  column-adjacency (Clist) gather pass of the frame-major step — one fewer
  wide pass per sweep.
* The mask side (erasure counts, degree-1 detection) stays frame-major; it
  is W-free and cheap.

A static-phase frame-compaction variant (split the still-active frames into
halving buckets between sweeps) was implemented and benchmarked: the extra
compile shapes and frame shuffles cost more than the saved sweeps at
production operating points, so this module keeps the single-shape loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ldpc_erasure_codes_tpu import gf
from ldpc_erasure_codes_tpu.ops.arrays import CodeArrays
from ldpc_erasure_codes_tpu.ops.peel_replay import peel_decode_replay
from ldpc_erasure_codes_tpu.utils import device


def _sweep(
    arrays: CodeArrays,
    n: int,
    vt,
    ep,
    rows: slice = slice(None),
    gf_order: int = 2,
):
    """One symbol-major peeling sweep over check rows ``rows``.

    vt: (n+1, b, W) symbol-major padded values; ep: (b, n+1) padded mask.
    GF(256): the check value is the coefficient-weighted syndrome of the
    known neighbors times the erased slot's inverse coefficient
    (My_LDPC_HybridML_NonBinary_Erasure_Decoder.m:37-48), computed with the
    carryless multiply (gf.gf_mul) — no table gathers in the sweep.
    """
    idx = arrays.vlist_idx[rows]  # (m', dmax) constants, pad = n
    yv = jnp.take(vt, idx, axis=0)  # (m, dmax, b, W)
    ev = jnp.take(ep, idx, axis=1)  # (b, m, dmax)
    cnt = jnp.sum(ev, axis=2, dtype=jnp.int32)
    deg1 = cnt == 1  # (b, m)
    if gf_order == 2:
        val_c = jax.lax.reduce(
            yv, yv.dtype.type(0), jax.lax.bitwise_xor, (1,)
        )
    else:
        # uint32 lanes = four packed byte symbols (SWAR multiply, ~10x the
        # uint8-lane carryless mul); uint8 lanes = one symbol each.
        mul = gf.gf_mul_packed if vt.dtype == jnp.uint32 else gf.gf_mul
        coef = arrays.vlist_val[rows][:, :, None, None]  # (m, dmax, 1, 1)
        syn = jax.lax.reduce(
            mul(yv, coef), yv.dtype.type(0), jax.lax.bitwise_xor, (1,)
        )  # (m, b, W)
        inv_sel = jnp.where(
            ev, arrays.vlist_inv_val[rows][None], jnp.uint8(0)
        )
        coef_inv = jax.lax.reduce(
            inv_sel, jnp.uint8(0), jax.lax.bitwise_xor, (2,)
        )  # (b, m) — the erased slot's inverse coefficient (degree-1 rows)
        val_c = mul(syn, coef_inv.T[:, :, None])
    target = jnp.sum(jnp.where(ev, idx[None], 0), axis=2, dtype=jnp.int32)
    safe = jnp.where(deg1, target, n)  # (b, m)
    vals = jnp.where(deg1.T[:, :, None], val_c, jnp.zeros((), val_c.dtype))
    brange = jnp.arange(ep.shape[0])
    vt = vt.at[safe.T, brange[None, :]].set(vals)
    ep = ep.at[brange[:, None], safe].set(False)
    return vt, ep


@functools.partial(
    jax.jit, static_argnames=("max_iters", "early_stop_k", "split", "gf_order")
)
def peel_decode_wide(
    arrays: CodeArrays,
    values: jax.Array,
    erased: jax.Array,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
    split: int = 1,
    gf_order: int = 2,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Wide peeling decode (binary or GF(256)); same fixed point as
    ``peel_decode(impl="gather")``.

    ``split`` > 1 processes the checks in that many sequential sub-sweeps per
    iteration (the FPGA's 2-way check split taken Gauss-Seidel,
    decoder_perf_tests.cl:95-203): per-iteration edge volume is unchanged but
    in-iteration propagation cuts the iteration count ~25-35%, which is pure
    throughput at memory-bound shapes. Iteration counts are schedule-variant;
    the fixed point is identical (split=1 matches ``peel_decode`` exactly,
    iteration counts included).

    Args:
      values: (B, n, W) packed words (uint32 for binary; uint8 byte symbols
        for gf_order=256), erased slots zero.
      erased: (B, n) bool.
      gf_order: 2 or 256 (symbol-major GF(256) sweeps use the carryless
        multiply; ~same memory traffic as binary plus multiply-accumulate work).

    Returns (values, erased, iters).
    """
    b, n, w = values.shape
    m = arrays.vlist_idx.shape[0]
    bounds = [round(i * m / split) for i in range(split + 1)]
    row_slices = [slice(bounds[i], bounds[i + 1]) for i in range(split)]

    # GF(256) byte lanes: pack 4 symbols per uint32 for the SWAR multiply
    # (pure bitcast — byte lanes are independent, so packing is layout-only).
    packed_nb = gf_order == 256 and values.dtype == jnp.uint8 and w % 4 == 0
    if packed_nb:
        values = jax.lax.bitcast_convert_type(
            values.reshape(b, n, w // 4, 4), jnp.uint32
        )
        w = w // 4

    def done_cols(ep):
        er = ep[:, :n] if early_stop_k is None else ep[:, :early_stop_k]
        return ~jnp.any(er, axis=1)

    vt0 = jnp.pad(jnp.moveaxis(values, 1, 0), ((0, 1), (0, 0), (0, 0)))
    ep0 = jnp.pad(erased, ((0, 0), (0, 1)))

    def cond(s):
        vt, ep, iters, it, prev = s
        unresolved = jnp.sum(ep, dtype=jnp.int32)
        return (it < max_iters) & jnp.any(~done_cols(ep)) & (unresolved < prev)

    def body(s):
        vt, ep, iters, it, _ = s
        prev = jnp.sum(ep, dtype=jnp.int32)
        for rs in row_slices:
            vt, ep = _sweep(arrays, n, vt, ep, rs, gf_order)
        it = it + 1
        newly = done_cols(ep) & (iters == 0)
        iters = jnp.where(newly, it, iters)
        return vt, ep, iters, it, prev

    vt, ep, iters, it, _ = jax.lax.while_loop(
        cond,
        body,
        (
            vt0,
            ep0,
            jnp.zeros((b,), jnp.int32),
            jnp.zeros((), jnp.int32),
            jnp.iinfo(jnp.int32).max * jnp.ones((), jnp.int32),
        ),
    )
    iters = jnp.where(iters == 0, jnp.int32(max_iters), iters)
    iters = jnp.where(done_cols(ep0), jnp.int32(1), iters)
    out_vals = jnp.moveaxis(vt[:n], 0, 1)
    if packed_nb:
        out_vals = jax.lax.bitcast_convert_type(
            out_vals, jnp.uint8
        ).reshape(b, n, 4 * w)
    return out_vals, ep[:, :n], iters


def peel_decode_packed(
    arrays: CodeArrays,
    values: jax.Array,
    erased: jax.Array,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
    gf_order: int = 2,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """The wide peel for this platform: the replay kernel on a GPU
    (``utils.device.on_gpu``), :func:`peel_decode_wide` elsewhere. Same
    arguments and results as :func:`peel_decode_wide`."""
    fn = peel_decode_replay if device.on_gpu() else peel_decode_wide
    return fn(
        arrays, values, erased, max_iters=max_iters,
        early_stop_k=early_stop_k, gf_order=gf_order,
    )
