"""Device-side GF(2^8) primitives for JAX.

Three formulations, all traced under ``jit``:

1. **Carryless arithmetic (the default ``gf_mul``)** — schoolbook
   polynomial multiply + modular reduction, ~30 pure vector ops per element.
2. **Table gathers** (``gf_mul_table``/``gf_mul_log``) — the reference's
   formulation (Matlab/My_RS_Decode_Optimize_With_GFTables.m:61-67), kept
   for reference/benchmarking.
3. **Binary image (matmul path)** — GF(256) matmuls lifted to GF(2) matmuls
   8x larger per axis, executed as int8 matmuls with int32 accumulation,
   then reduced mod 2.

Erasures are represented *out of band* (a separate boolean mask), unlike the
reference's in-band ``-1`` sentinel (Matlab/My_LDPC_Erasure_Decoder.m:5) —
a sentinel value would poison table gathers and force dynamic control flow.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_erasure_codes_tpu.gf import tables as gf_tables


@functools.lru_cache(maxsize=4)
def _host_tables(prim_poly: int = gf_tables.DEFAULT_PRIM_POLY):
    # Cache NumPy arrays only. Converting with jnp.asarray at each use site
    # embeds them as compile-time constants; caching jnp arrays instead would
    # leak tracers when the first call happens under a jit trace.
    t = gf_tables.build_tables(prim_poly)
    return {
        "mul_flat": t.mul_flat,
        "exp": t.exp,
        "log": t.log.astype(np.int32),
        "inv": t.inv,
    }


def _device_tables(prim_poly: int = gf_tables.DEFAULT_PRIM_POLY):
    return {k: jnp.asarray(v) for k, v in _host_tables(prim_poly).items()}


def gf_mul_table(a: jax.Array, b: jax.Array) -> jax.Array:
    """Elementwise GF(256) product via one flat-table gather.

    Kept for reference/benchmarking; :func:`gf_mul` is the arithmetic path.
    """
    d = _device_tables()
    idx = a.astype(jnp.int32) * 256 + b.astype(jnp.int32)
    return d["mul_flat"][idx]


def gf_mul_log(a: jax.Array, b: jax.Array) -> jax.Array:
    """Elementwise GF(256) product via log/antilog (3 small-table gathers).

    Alternative formulation to benchmark against :func:`gf_mul`; the doubled
    antilog table removes the mod-255.
    """
    d = _device_tables()
    la = d["log"][a.astype(jnp.int32)]
    lb = d["log"][b.astype(jnp.int32)]
    prod = d["exp"][la + lb]
    zero = (a == 0) | (b == 0)
    return jnp.where(zero, jnp.uint8(0), prod)


def gf_mul_arith(
    a: jax.Array,
    b: jax.Array,
    prim_poly: int = gf_tables.DEFAULT_PRIM_POLY,
) -> jax.Array:
    """Elementwise GF(256) product by carryless multiply + reduction — no
    table gathers, ~30 pure vector ops on uint16 lanes.

    Schoolbook polynomial multiply (8 shift-select-XOR steps) followed by
    modular reduction by the field's primitive polynomial (7 steps). This
    trades the flat-table gather (one random access per element) for vector
    ALU work, for operand tensors that are large and gather-bound (e.g. the
    GF(256) Gauss-Jordan row updates). ``prim_poly`` selects the field, matching the
    parameterization of the table paths.
    """
    poly = jnp.uint16(prim_poly)
    a16 = a.astype(jnp.uint16)
    b16 = b.astype(jnp.uint16)
    prod = jnp.zeros_like(a16)
    for i in range(8):
        bit = (b16 >> i) & 1
        prod = prod ^ ((a16 << i) * bit)
    for i in range(14, 7, -1):
        bit = (prod >> i) & 1
        prod = prod ^ ((poly << (i - 8)) * bit)
    return prod.astype(jnp.uint8)


def gf_mul(
    a: jax.Array,
    b: jax.Array,
    prim_poly: int = gf_tables.DEFAULT_PRIM_POLY,
) -> jax.Array:
    """Elementwise GF(256) product (arithmetic formulation — see
    :func:`gf_mul_arith`; exhaustively equal to the table path)."""
    return gf_mul_arith(a, b, prim_poly)


def _xtime_packed(v: jax.Array, prim_poly: int) -> jax.Array:
    """SWAR multiply-by-x of four packed GF(256) bytes per uint32 lane.

    A byte overflowing its top bit wraps modulo the primitive polynomial's
    low byte (x^8 ≡ poly & 0xFF); the ``hi * low_byte`` product rebroadcasts
    the reduction into exactly the overflowing byte lanes.
    """
    hi = (v >> 7) & jnp.uint32(0x01010101)
    return ((v << 1) & jnp.uint32(0xFEFEFEFE)) ^ (
        hi * jnp.uint32(prim_poly & 0xFF)
    )


def gf_mul_packed(
    words: jax.Array,
    coef: jax.Array,
    prim_poly: int = gf_tables.DEFAULT_PRIM_POLY,
) -> jax.Array:
    """GF(256) product of packed byte symbols against a byte coefficient.

    ``words`` is uint32 with FOUR independent GF(256) symbols per word (the
    wide-symbol packing); ``coef`` is uint8/uint32 broadcastable against
    ``words`` — each of the four byte lanes of every word is multiplied by
    the (single) coefficient byte. SWAR double-and-add: 8 conditional XORs
    on the coefficient's bits interleaved with 7 packed xtime steps — ~40
    vector ops per FOUR multiplies, vs ~30 uint16 ops per ONE multiply for
    :func:`gf_mul_arith`. This is what makes the symbol-major GF(256) value
    sweep (ops/peel_wide.py) multiply-bound-free; exhaustively validated
    against the table path (tests/test_gf.py).
    """
    c = coef.astype(jnp.uint32)
    acc = jnp.zeros_like(words)
    cur = words
    for i in range(8):
        bit = (c >> i) & jnp.uint32(1)
        acc = acc ^ (cur * bit)
        if i < 7:
            cur = _xtime_packed(cur, prim_poly)
    return acc


def gf_inv(a: jax.Array) -> jax.Array:
    """Elementwise multiplicative inverse; gf_inv(0) == 0."""
    d = _device_tables()
    return d["inv"][a.astype(jnp.int32)]


def gf_add(a: jax.Array, b: jax.Array) -> jax.Array:
    """GF(2^8) addition is XOR (reference add table is bitxor,
    Matlab/Build_GF256_Lookup_Tables.m:57-67)."""
    return jnp.bitwise_xor(a, b)


# ---------------------------------------------------------------------------
# Binary-image (matmul) formulation
# ---------------------------------------------------------------------------


def bytes_to_bits(x: jax.Array) -> jax.Array:
    """Unpack uint8 (..., n) -> int8 bits (..., 8n), LSB-first per byte."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (x[..., :, None] >> shifts) & 1
    return bits.reshape(*x.shape[:-1], x.shape[-1] * 8).astype(jnp.int8)


def bits_to_bytes(bits: jax.Array) -> jax.Array:
    """Pack int bits (..., 8n) -> uint8 (..., n), LSB-first per byte."""
    n8 = bits.shape[-1]
    b = bits.reshape(*bits.shape[:-1], n8 // 8, 8).astype(jnp.uint8)
    weights = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))
    return jnp.sum(b * weights, axis=-1, dtype=jnp.uint8)


def gf_matmul_bitimage(u: jax.Array, g_bits: jax.Array) -> jax.Array:
    """y = u @ G over GF(256) using a precomputed binary image of G.

    Args:
      u: (..., k) uint8 operand.
      g_bits: (8k, 8n) int8 binary image from
        :func:`ldpc_erasure_codes_tpu.gf.tables.bit_image`.

    Returns:
      (..., n) uint8 product. The contraction runs as an int8
      matmul with int32 accumulation, then reduces mod 2.
    """
    ub = bytes_to_bits(u)  # (..., 8k) int8
    acc = jax.lax.dot_general(
        ub,
        g_bits,
        dimension_numbers=(((ub.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return bits_to_bytes(acc & 1)


def mod2_matmul(x: jax.Array, m: jax.Array) -> jax.Array:
    """(x @ m) mod 2 with int32 accumulation; inputs are 0/1 int8."""
    acc = jax.lax.dot_general(
        x,
        m,
        dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (acc & 1).astype(jnp.int8)


def int_matmul(x: jax.Array, m: jax.Array) -> jax.Array:
    """Plain integer matmul with int32 accumulation (for erasure counts)."""
    return jax.lax.dot_general(
        x,
        m,
        dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
