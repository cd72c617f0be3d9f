"""The XLA Gauss-Jordan solvers the GPU runs in the GE branch.

``ge_solve_packed`` (binary, packed-bit elimination + int8 bit-plane matmul
apply) and ``ge_solve_wide_nb`` (GF(256), SWAR-packed elimination +
bit-image matmul apply) against the NumPy oracle and the byte GE, across
code sizes, bucket widths (``emax`` on and off word boundaries, below and
above the residual) and symbol widths. Every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_erasure_codes_tpu.codes import gen_row_wise, get_code, toy_code
from ldpc_erasure_codes_tpu.ops import device_arrays, encode_packed
from ldpc_erasure_codes_tpu.ops.ge import ge_solve, ge_solve_packed, ge_solve_wide_nb
from ldpc_erasure_codes_tpu.rs import rs_code
from ldpc_erasure_codes_tpu.utils import oracle


def _code(name):
    if name == "small":
        return gen_row_wise(
            [(16, 6)], [(48, 2)], seed=3, max_tries=40, strict_tries=4
        )
    if name == "toy_gf256":
        return toy_code(n=96, k=64, seed=3, gf_order=256)
    if name == "rs":
        return rs_code(255, 192)
    return get_code(name)


def _batch(code, b, w, per, seed, gf_order):
    arrays = device_arrays(code)
    key = jax.random.key(seed)
    dtype = jnp.uint32 if gf_order == 2 else jnp.uint8
    src = jax.random.bits(key, (b, code.k, w), dtype=dtype)
    cw = encode_packed(arrays, src, gf_order=gf_order)
    mask = jax.random.uniform(jax.random.fold_in(key, 1), (b, code.n)) < per
    recv = jnp.where(mask[:, :, None], jnp.zeros((), cw.dtype), cw)
    return arrays, cw, mask, recv


def _oracle_solvable(code, mask, gf_order):
    """Per frame: does Gauss-Jordan on the erased columns succeed?"""
    h = code.h_dense_nb if gf_order == 256 else code.h_dense
    t = oracle.gf.build_tables() if gf_order == 256 else None
    out = []
    for f in range(mask.shape[0]):
        cols = np.nonzero(mask[f])[0]
        a = h[:, cols].astype(np.int64).copy()
        rhs = np.zeros(h.shape[0], np.int64)
        if gf_order == 2:
            singular = oracle._ge_binary_inplace(a, rhs, len(cols))
        else:
            singular = oracle._ge_gf256_inplace(a, rhs, len(cols), t)
        out.append(not singular)
    return np.asarray(out)


# (code, B, W, PER, emax): emax on and off the 32-bit word boundary, and
# below the largest residual so some frames overflow the bucket.
PACKED = [
    ("small", 8, 2, 0.25, 16),
    ("small", 8, 3, 0.30, 13),
    ("n2000_k1000", 4, 2, 0.08, 160),
    ("n2000_k1000", 6, 5, 0.10, 100),
    ("n2040_k1530", 4, 4, 0.05, 128),
    ("n2040_k1530", 4, 65, 0.04, 96),
]


@pytest.mark.parametrize("name,b,w,per,emax", PACKED)
def test_packed_matches_byte_ge_and_oracle(name, b, w, per, emax):
    code = _code(name)
    arrays, cw, mask, recv = _batch(code, b, w, per, seed=b + w, gf_order=2)
    v, e, failed = ge_solve_packed(arrays, recv, mask, emax=emax)
    vb, eb, fb = ge_solve(arrays, recv, mask, emax=emax)
    failed = np.asarray(failed)
    np.testing.assert_array_equal(failed, np.asarray(fb))
    np.testing.assert_array_equal(np.asarray(e), np.asarray(eb))
    ok = ~failed
    np.testing.assert_array_equal(np.asarray(v)[ok], np.asarray(cw)[ok])
    mask = np.asarray(mask)
    fits = mask.sum(1) <= emax
    np.testing.assert_array_equal(
        ok[fits], _oracle_solvable(code, mask, 2)[fits]
    )
    assert not np.asarray(e)[ok].any()


# (code, B, W bytes, PER or erasures per frame, emax)
WIDE_NB = [
    ("toy_gf256", 6, 8, 0.15, 32),
    ("toy_gf256", 6, 12, 0.30, 30),
    ("n2040_k1530_gf256", 3, 4, 0.05, 128),
    ("n2040_k1530_gf256", 3, 16, 0.02, 64),
    ("rs", 8, 8, 0.20, 63),
    ("rs", 8, 20, 0.25, 63),
]


@pytest.mark.parametrize("name,b,w,per,emax", WIDE_NB)
def test_wide_nb_matches_byte_ge_and_oracle(name, b, w, per, emax):
    code = _code(name)
    arrays, cw, mask, recv = _batch(code, b, w, per, seed=b + w, gf_order=256)
    v, e, failed = ge_solve_wide_nb(arrays, recv, mask, emax=emax)
    vb, eb, fb = ge_solve(arrays, recv, mask, emax=emax, gf_order=256)
    failed = np.asarray(failed)
    np.testing.assert_array_equal(failed, np.asarray(fb))
    np.testing.assert_array_equal(np.asarray(e), np.asarray(eb))
    ok = ~failed
    np.testing.assert_array_equal(np.asarray(v)[ok], np.asarray(cw)[ok])
    mask = np.asarray(mask)
    fits = mask.sum(1) <= emax
    np.testing.assert_array_equal(
        ok[fits], _oracle_solvable(code, mask, 256)[fits]
    )


def test_packed_rejects_byte_symbols():
    code = _code("small")
    arrays, _, mask, recv = _batch(code, 2, 4, 0.2, seed=0, gf_order=2)
    with pytest.raises(ValueError):
        ge_solve_packed(arrays, recv.astype(jnp.uint8), mask, emax=16)


def test_wide_nb_rejects_word_symbols():
    code = _code("toy_gf256")
    arrays, _, mask, recv = _batch(code, 2, 2, 0.2, seed=0, gf_order=2)
    with pytest.raises(ValueError):
        ge_solve_wide_nb(arrays, recv, mask, emax=16)
