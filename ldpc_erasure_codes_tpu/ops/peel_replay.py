"""Wide peeling decode on the GPU: mask resolution, then a value replay kernel.

Mask evolution does not depend on the symbol values (docs/DESIGN.md), so the
wide decode splits in two:

1. :func:`peel_schedule` runs the peel on the (B, n) erasure mask in XLA —
   the same sweeps, fixed point and iteration accounting as
   :func:`ops.peel_wide.peel_decode_wide` — and records, for every symbol it
   resolves, the check that solved it and the sweep in which it did. Sorted
   by sweep, those are each frame's *events*.
2. :func:`replay_events` is a Pallas kernel (Triton route). One program per
   (frame, W-chunk) walks its frame's events in order and writes each
   resolved slot in place: the XOR of the check's other neighbours, or over
   GF(256) their coefficient-weighted sum times the slot's inverse
   coefficient (My_LDPC_HybridML_NonBinary_Erasure_Decoder.m:37-48).

A check that resolves a symbol in sweep s had every other neighbour known
when sweep s began, so replaying the events in sweep order reads only
symbols that are already final. The replay reads about events x dmax rows
per frame (~290 x 12 at the headline PER) and writes each resolved row once;
``peel_decode_wide`` re-gathers every check's neighbours on every sweep.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ldpc_erasure_codes_tpu import gf
from ldpc_erasure_codes_tpu.ops.arrays import CodeArrays

# Words of one symbol handled by one program (a power of two; Triton block
# shapes must be): 256 uint32 words = one 1 KB row load. On an H100, 256
# and 128 tied for binary symbols and 256 won for GF(256) (PERF.md).
_W_CHUNK = 256


@functools.partial(jax.jit, static_argnames=("max_iters", "early_stop_k"))
def peel_schedule(
    arrays: CodeArrays,
    erased: jax.Array,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
) -> tuple[jax.Array, ...]:
    """Resolve the peel on the erasure mask alone and list its events.

    Runs the Jacobi sweeps of ``peel_decode_wide`` (every degree-1 check
    resolves its erased neighbour; the loop stops at ``max_iters``, when no
    sweep makes progress, or when every frame's first ``early_stop_k``
    symbols are known). Where two checks resolve one symbol in the same
    sweep, the lower-numbered check is recorded; both give the same value
    for a codeword.

    Returns (erased_out (B, n) bool, iters (B,) int32, tgt (B, n) int32,
    chk (B, n) int32, count (B,) int32): ``tgt[f, :count[f]]`` are frame
    f's resolved symbols in sweep order and ``chk`` the solving checks.
    Entries past ``count`` are unspecified.
    """
    b, n = erased.shape
    m = arrays.vlist_idx.shape[0]
    idx = arrays.vlist_idx  # (m, dmax), pad = n
    brange = jnp.arange(b)[:, None]
    checks = jnp.arange(m, dtype=jnp.int32)[None, :]

    def done_cols(ep):
        er = ep[:, :n] if early_stop_k is None else ep[:, :early_stop_k]
        return ~jnp.any(er, axis=1)

    ep0 = jnp.pad(erased, ((0, 0), (0, 1)))

    def cond(s):
        ep, _, _, _, it, prev = s
        unresolved = jnp.sum(ep, dtype=jnp.int32)
        return (it < max_iters) & jnp.any(~done_cols(ep)) & (unresolved < prev)

    def body(s):
        ep, by, sweep, iters, it, _ = s
        prev = jnp.sum(ep, dtype=jnp.int32)
        ev = jnp.take(ep, idx, axis=1)  # (b, m, dmax)
        deg1 = jnp.sum(ev, axis=2, dtype=jnp.int32) == 1
        target = jnp.sum(jnp.where(ev, idx[None], 0), axis=2, dtype=jnp.int32)
        safe = jnp.where(deg1, target, n)  # (b, m); n is the dump column
        by = by.at[brange, safe].min(jnp.where(deg1, checks, m))
        ep_new = ep.at[brange, safe].set(False)
        sweep = jnp.where(ep & ~ep_new, it, sweep)
        it = it + 1
        newly = done_cols(ep_new) & (iters == 0)
        iters = jnp.where(newly, it, iters)
        return ep_new, by, sweep, iters, it, prev

    ep, by, sweep, iters, _, _ = jax.lax.while_loop(
        cond,
        body,
        (
            ep0,
            jnp.full((b, n + 1), m, jnp.int32),
            jnp.zeros((b, n + 1), jnp.int32),
            jnp.zeros((b,), jnp.int32),
            jnp.zeros((), jnp.int32),
            jnp.iinfo(jnp.int32).max * jnp.ones((), jnp.int32),
        ),
    )
    iters = jnp.where(iters == 0, jnp.int32(max_iters), iters)
    iters = jnp.where(done_cols(ep0), jnp.int32(1), iters)
    erased_out = ep[:, :n]
    resolved = erased & ~erased_out
    sym = jnp.arange(n, dtype=jnp.int32)[None, :]
    key = jnp.where(
        resolved, sweep[:, :n] * n + sym, jnp.iinfo(jnp.int32).max
    )
    tgt = jnp.sort(key, axis=1) % n
    chk = jnp.take_along_axis(by[:, :n], tgt, axis=1)
    count = jnp.sum(resolved, axis=1, dtype=jnp.int32)
    return erased_out, iters, tgt, chk, count


def _replay_kernel(*refs, n, dmax, wc, gf_order, interpret):
    if gf_order == 2:
        tgt_ref, chk_ref, cnt_ref, idx_ref, _, out_ref = refs
    else:
        tgt_ref, chk_ref, cnt_ref, idx_ref, val_ref, inv_ref, _, out_ref = refs
    f = pl.program_id(0)
    cols = pl.ds(pl.program_id(1) * wc, wc)

    def event(i, carry):
        t = tgt_ref[f, i]
        c = chk_ref[f, i]
        acc = jnp.zeros((wc,), jnp.uint32)
        inv = jnp.uint32(0)
        for j in range(dmax):
            s = idx_ref[c, j]
            row = plt.load(
                out_ref.at[f, jnp.minimum(s, n - 1), cols],
                mask=jnp.full((wc,), s < n),
                other=0,
            )
            if gf_order == 2:
                acc = acc ^ row
            else:
                acc = acc ^ gf.gf_mul_packed(row, val_ref[c, j])
                inv = inv | jnp.where(s == t, inv_ref[c, j], 0).astype(
                    jnp.uint32
                )
        if gf_order == 256:
            acc = gf.gf_mul_packed(acc, inv)
        plt.store(out_ref.at[f, t, cols], acc)
        # The next event may load the row just stored, and Triton spreads a
        # row over the block's threads with no promise that a store and a
        # later load of one element fall on the same thread: the barrier
        # makes every store of this event visible to the whole block. The
        # interpreter runs one event at a time and has no such hazard.
        if not interpret:
            plt.debug_barrier()
        return carry

    jax.lax.fori_loop(0, cnt_ref[f], event, 0)


def replay_events(
    arrays: CodeArrays,
    values: jax.Array,
    tgt: jax.Array,
    chk: jax.Array,
    count: jax.Array,
    *,
    gf_order: int = 2,
    w_chunk: int = _W_CHUNK,
    interpret: bool = False,
) -> jax.Array:
    """Write every event's resolved symbol into ``values`` (B, n, W) uint32.

    ``values`` holds zero in erased slots (the repo's invariant); the kernel
    updates it in place (input/output alias) and returns it. For
    ``gf_order=256`` each uint32 word carries four GF(256) byte symbols.
    The W axis is split into power-of-two chunks of at most ``w_chunk``
    words, one program each, and padded when it does not divide evenly.
    """
    b, n, w = values.shape
    dmax = arrays.vlist_idx.shape[1]
    wc = min(pl.next_power_of_2(w), w_chunk)
    w_pad = pl.cdiv(w, wc) * wc
    if w_pad != w:
        values = jnp.pad(values, ((0, 0), (0, 0), (0, w_pad - w)))
    tables = [arrays.vlist_idx]
    if gf_order == 256:
        tables += [arrays.vlist_val, arrays.vlist_inv_val]
    out = pl.pallas_call(
        functools.partial(
            _replay_kernel, n=n, dmax=dmax, wc=wc, gf_order=gf_order,
            interpret=interpret,
        ),
        out_shape=jax.ShapeDtypeStruct(values.shape, values.dtype),
        grid=(b, w_pad // wc),
        input_output_aliases={3 + len(tables): 0},
        interpret=interpret,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        name="peel_replay",
    )(tgt, chk, count, *tables, values)
    return out[:, :, :w] if w_pad != w else out


@functools.partial(
    jax.jit,
    static_argnames=("max_iters", "early_stop_k", "gf_order", "interpret"),
)
def peel_decode_replay(
    arrays: CodeArrays,
    values: jax.Array,
    erased: jax.Array,
    *,
    max_iters: int = 50,
    early_stop_k: int | None = None,
    gf_order: int = 2,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Drop-in for :func:`ops.peel_wide.peel_decode_wide`: same arguments,
    same (values, erased, iters), bit for bit on codewords."""
    b, n, w = values.shape
    packed_nb = gf_order == 256 and values.dtype == jnp.uint8
    if packed_nb:
        if w % 4:
            raise ValueError("GF(256) byte symbols need a width divisible by 4")
        values = jax.lax.bitcast_convert_type(
            values.reshape(b, n, w // 4, 4), jnp.uint32
        )
    erased_out, iters, tgt, chk, count = peel_schedule(
        arrays, erased, max_iters=max_iters, early_stop_k=early_stop_k
    )
    out = replay_events(
        arrays, values, tgt, chk, count, gf_order=gf_order,
        interpret=interpret,
    )
    if packed_nb:
        out = jax.lax.bitcast_convert_type(out, jnp.uint8).reshape(b, n, w)
    return out, erased_out, iters
