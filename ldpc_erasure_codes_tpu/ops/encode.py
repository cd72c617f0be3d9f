"""Systematic encoders.

The reference encodes by sequential triangular back-substitution — an
inherently serial loop over parity rows
(Matlab/LDPCErasureCodes_MessagePassingAlgSim.m:164-174 binary;
Matlab/ErasureCodes_NonBinaryLDPCSim.m:172-182 GF(256); the FPGA keeps the
same row-sequential schedule, OpenCL/device/ldpc_erasure_encoder.cl:72-84).

Design: the triangular solve is precomputed **once per code** on the
host (codes/registry.py parity_gen), turning encode into a single dense
mod-2 / GF(256)-bit-image matmul with bit-identical output. The
sequential `lax.scan` formulation is retained as a cross-check oracle
(the reference's dual-implementation test pattern,
Matlab/LDPCErasureCodes.m:117-129).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ldpc_erasure_codes_tpu import gf
from ldpc_erasure_codes_tpu.ops.arrays import CodeArrays


def encode(arrays: CodeArrays, source: jax.Array) -> jax.Array:
    """Binary systematic encode: (..., k) uint8 bits -> (..., n) uint8.

    One int8 matmul: parity = (source @ P) mod 2.
    """
    p = gf.mod2_matmul(source.astype(jnp.int8), arrays.parity_gen)
    return jnp.concatenate([source.astype(jnp.uint8), p.astype(jnp.uint8)], axis=-1)


def encode_nb(arrays: CodeArrays, source: jax.Array) -> jax.Array:
    """GF(256) systematic encode: (..., k) uint8 -> (..., n) uint8.

    The GF(256) parity generator is applied through its binary image
    (arrays.parity_gen is (8k, 8m) for non-binary codes), i.e. an int8
    matmul over bit lanes.
    """
    p = gf.gf_matmul_bitimage(source, arrays.parity_gen)
    return jnp.concatenate([source.astype(jnp.uint8), p], axis=-1)


def encode_wide(arrays: CodeArrays, source_bits: jax.Array) -> jax.Array:
    """Wide-symbol binary encode: (..., S, k) bitplanes -> (..., S, n).

    The symbol-width axis S rides along as extra matmul batch — S independent
    binary codewords sharing one erasure pattern, the reference's bit-plane
    parallelism axis (paper tex:51-59; symbol_type's 8192-bit packets,
    OpenCL/host/src/main.cpp:44-47).
    """
    return encode(arrays, source_bits)


def encode_packed(
    arrays: CodeArrays, source: jax.Array, *, gf_order: int = 2
) -> jax.Array:
    """Wide-symbol systematic encode on packed words: (B, k, W) -> (B, n, W).

    The reference's production packet is 8192 bits handled as 128 unrolled
    64-bit XOR lanes (OpenCL/device/ldpc_erasure_encoder.cl:72-84,
    symbol_type at OpenCL/host/src/main.cpp:44-47). Here W packed words (any
    unsigned dtype for binary; uint8 GF symbols for GF(256)) ride as a trailing
    vector axis.

    Binary path — two stages split the triangular solve:

    1. source stage (parallel over all m rows): ``t = A . s`` as a gather-XOR
       over each row's source-region neighbors;
    2. parity stage: ``p = L^{-1} t`` via ``lax.scan`` over parity rows — each
       step XORs the row's few strictly-lower parity neighbors (typically <= 3)
       and divides by the diagonal coefficient. The sequential axis is m steps
       of tiny vector work; batch and word axes keep it wide.

    GF(256) path: the scan's per-step table gathers are slow, so packed GF
    encode runs the precomputed parity generator's binary image as a matmul with the lane
    axis folded into the batch — identical output, one big int8 matmul.
    """
    b, k, w = source.shape
    m = arrays.enc_par_idx.shape[0]
    nb = gf_order == 256
    if nb:
        lanes_first = jnp.moveaxis(source, 2, 1)  # (B, W, k)
        # The bit-image matmul folds (B, W) into one giant batch; chunk the
        # lane axis so the folded operand stays bounded (B*W = 256k lanes of
        # a k=1530 code is a ~3 GB int8 operand otherwise — out of device memory).
        limit = max(1, 32768 // max(1, b))
        if w <= limit:
            cw = encode_nb(arrays, lanes_first)  # (B, W, n)
        else:
            # Ceil-division chunking with a zero-padded tail: a W with no
            # divisor near the limit (e.g. prime W) must not collapse to
            # chunk=1 and run W sequential single-lane matmuls.
            chunk = limit
            nc = -(-w // chunk)
            wp = nc * chunk
            if wp != w:
                lanes_first = jnp.pad(
                    lanes_first, ((0, 0), (0, wp - w), (0, 0))
                )
            xs = lanes_first.reshape(b, nc, chunk, k).swapaxes(0, 1)
            cw = jax.lax.map(
                lambda x: encode_nb(arrays, x), xs
            )  # (nc, B, chunk, n)
            cw = cw.swapaxes(0, 1).reshape(b, wp, -1)[:, :w]
        return jnp.moveaxis(cw, 1, 2)

    src_p = jnp.pad(source, ((0, 0), (0, 1), (0, 0)))  # pad col k reads zero
    sv = jnp.take(src_p, arrays.enc_src_idx, axis=1)  # (B, m, dmax, W)
    t = jax.lax.reduce(
        sv, sv.dtype.type(0), jax.lax.bitwise_xor, (2,)
    )  # (B, m, W)

    # Scan in parity-major layout (m leading) so each step is a cheap slice.
    t_m = jnp.moveaxis(t, 1, 0)  # (m, B, W)
    par0 = jnp.zeros((m + 1, b, w), dtype=source.dtype)

    def step(par, row):
        i, t_i, pidx = row
        nbrs = jnp.take(par, pidx, axis=0)  # (pmax, B, W)
        acc = t_i ^ jax.lax.reduce(
            nbrs, nbrs.dtype.type(0), jax.lax.bitwise_xor, (0,)
        )
        par = jax.lax.dynamic_update_index_in_dim(par, acc, i, axis=0)
        return par, None

    rows = (
        jnp.arange(m, dtype=jnp.int32),
        t_m,
        arrays.enc_par_idx,
    )
    par, _ = jax.lax.scan(step, par0, rows)
    parity = jnp.moveaxis(par[:m], 0, 1)  # (B, m, W)
    return jnp.concatenate([source, parity], axis=1)


def make_packed_encoder(code) -> "jax.stages.Wrapped":
    """Level-scheduled packed binary encoder for one code (the fast path).

    The parity back-substitution's dependency DAG is shallow (depth 27 for
    the (2040,1530) code vs its 510 rows), so parity rows are grouped into
    dependency *levels* and each level is computed in one parallel
    gather-XOR step — the sequential axis shrinks from m scan steps to
    depth unrolled steps. The level schedule is host-side NumPy baked into
    the jitted closure as compile-time constants, so every gather/scatter
    keeps the constant-topology lowering XLA optimizes well
    (docs/DESIGN.md — data-dependent indices measured far slower).

    Bit-identical to :func:`encode_packed` (XOR reassociation only).
    Returns a jitted ``fn(source (B, k, W) uint) -> (B, n, W)``.
    """
    import numpy as np

    from ldpc_erasure_codes_tpu.ops.arrays import _host_arrays

    host = _host_arrays(code)
    m, k = code.m, code.k
    src_idx = host["enc_src_idx"]  # (m, dmax) pad k
    par_idx = host["enc_par_idx"]  # (m, pmax) pad m
    # Dependency levels over the strictly-lower parity graph.
    level = np.zeros(m, dtype=np.int64)
    pmax = par_idx.shape[1]
    for i in range(m):
        js = par_idx[i][par_idx[i] < m]
        level[i] = 1 + (level[js].max() if js.size else 0)
    depth = int(level.max())
    levels = [np.nonzero(level == d + 1)[0].astype(np.int32) for d in range(depth)]

    @jax.jit
    def encode_fn(source: jax.Array) -> jax.Array:
        b, _, w = source.shape
        src_p = jnp.pad(source, ((0, 0), (0, 1), (0, 0)))
        sv = jnp.take(src_p, jnp.asarray(src_idx), axis=1)  # (B, m, dmax, W)
        t = jax.lax.reduce(sv, sv.dtype.type(0), jax.lax.bitwise_xor, (2,))
        par = jnp.zeros((b, m + 1, w), dtype=source.dtype)
        for rows in levels:  # unrolled: all indices are XLA constants
            pidx = jnp.asarray(par_idx[rows])  # (L, pmax) pad m
            nbrs = jnp.take(par, pidx, axis=1)  # (B, L, pmax, W)
            acc = t[:, jnp.asarray(rows)] ^ jax.lax.reduce(
                nbrs, nbrs.dtype.type(0), jax.lax.bitwise_xor, (2,)
            )
            par = par.at[:, jnp.asarray(rows)].set(acc)
        return jnp.concatenate([source, par[:, :m]], axis=1)

    return encode_fn


def encode_scan(arrays: CodeArrays, source: jax.Array, n: int, k: int) -> jax.Array:
    """Sequential-schedule binary encoder (cross-check path).

    ``lax.scan`` over parity rows, each step XOR-reducing the row's neighbors
    (minus the triangle diagonal) from the partially built codeword — the
    direct transcription of the reference's loop. O(m) sequential steps;
    used in tests to certify the matmul encoder, never on the hot path.
    """
    m, dmax = arrays.vlist_idx.shape
    batch = source.shape[:-1]
    cw0 = jnp.zeros((*batch, n + 1), dtype=jnp.uint8)
    cw0 = cw0.at[..., :k].set(source.astype(jnp.uint8))

    def step(cw, row):
        idx, deg = row
        nbrs = jnp.where(jnp.arange(dmax) < deg - 1, idx, n)  # drop diagonal+pad
        vals = jnp.take(cw, nbrs, axis=-1)
        p = jnp.sum(vals.astype(jnp.int32), axis=-1) & 1
        pos = idx[deg - 1]  # the diagonal column k+i
        cw = jax.lax.dynamic_update_index_in_dim(
            cw, p.astype(jnp.uint8), pos, axis=-1
        )
        return cw, None

    # Triangle rows list the diagonal last only when indices are sorted —
    # vlist rows are stored in ascending column order, and the diagonal k+i
    # is each row's largest index in triangle form.
    cw, _ = jax.lax.scan(step, cw0, (arrays.vlist_idx, arrays.vlist_len))
    return cw[..., :n]
