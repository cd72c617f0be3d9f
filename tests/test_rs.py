"""Reed-Solomon module tests.

Mirrors the reference's RS test patterns: randomized exactness on a toy (7,5)
code (Matlab/Test_My_RS_Decode.m:42-58), the (255,192)/(250,125) production
shapes (ReedSolomonErasureCodes.m:20, LDPC_Vlist_data.h:10-14), dual-
implementation cross-check against the NumPy MATLAB-semantics oracle, and the
analytic MDS FER formula (scratch.m:30-38).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ldpc_erasure_codes_tpu import gf
from ldpc_erasure_codes_tpu.ops import device_arrays
from ldpc_erasure_codes_tpu.rs import (
    analytic_rs_fer,
    rs_code,
    rs_decode,
    rs_encode,
    rs_generator,
    rs_systematic_generator,
)
from ldpc_erasure_codes_tpu.utils import oracle


def test_generator_is_vandermonde():
    t = gf.build_tables()
    g = rs_generator(7, 5)
    for r in range(5):
        for c in range(7):
            assert g[r, c] == t.exp[(r * c) % 255]


def test_systematic_prefix_identity():
    gs = rs_systematic_generator(255, 192)
    assert np.array_equal(gs[:, :192], np.eye(192, dtype=np.uint8))


def test_rs_code_h_annihilates_g():
    code = rs_code(20, 12)
    gs = rs_systematic_generator(20, 12)
    # H . G^T = 0 over GF(256)
    prod = gf.gf_matmul_np(code.h_dense_nb, gs.T)
    assert not prod.any()


@pytest.mark.parametrize("n,k", [(7, 5), (15, 9)])
def test_random_exactness_toy(n, k):
    """100-trial version of the reference's 100k-trial (7,5) exactness test."""
    code = rs_code(n, k)
    arrays = device_arrays(code)
    rng = np.random.default_rng(0)
    b = 100
    src = rng.integers(0, 256, size=(b, k), dtype=np.uint8)
    cw = np.asarray(jax.device_get(rs_encode(arrays, jnp.asarray(src))))
    # Random erasure patterns with exactly <= n-k erasures (always decodable).
    erased = np.zeros((b, n), dtype=bool)
    for i in range(b):
        ne = rng.integers(0, n - k + 1)
        erased[i, rng.choice(n, size=ne, replace=False)] = True
    recv = np.where(erased, 0, cw)
    v, e, failed = jax.device_get(
        rs_decode(arrays, jnp.asarray(recv), jnp.asarray(erased))
    )
    assert not failed.any()
    assert not e.any()
    np.testing.assert_array_equal(v, cw)


def test_overflow_flags_failed():
    code = rs_code(10, 6)
    arrays = device_arrays(code)
    cw = jnp.zeros((2, 10), jnp.uint8)
    erased = jnp.zeros((2, 10), bool).at[1, :5].set(True)  # 5 > n-k = 4
    _, e, failed = rs_decode(arrays, cw, erased)
    assert bool(failed[1]) and not bool(failed[0])
    assert bool(jnp.any(e[1]))


def test_matches_numpy_oracle():
    """Dual-implementation oracle: device decode == MATLAB-semantics decode."""
    n, k = 21, 13
    code = rs_code(n, k)
    arrays = device_arrays(code)
    gs = rs_systematic_generator(n, k)
    rng = np.random.default_rng(7)
    b = 32
    src = rng.integers(0, 256, size=(b, k), dtype=np.uint8)
    cw = gf.gf_matmul_np(src, gs)
    erased = rng.random((b, n)) < 0.25
    recv = np.where(erased, 0, cw)
    v, e, failed = jax.device_get(
        rs_decode(arrays, jnp.asarray(recv), jnp.asarray(erased))
    )
    for i in range(b):
        recv_ind = np.nonzero(~erased[i])[0]
        decodable = recv_ind.size >= k
        assert decodable == (not failed[i])
        if decodable:
            # Oracle decodes from the first k received symbols (the reference
            # sim keeps the first k arrivals, ReedSolomonErasureCodes.m:64-81).
            ind = recv_ind[:k]
            ref = oracle.rs_decode(ind, cw[i, ind], gs, k)
            np.testing.assert_array_equal(v[i, :k], ref, err_msg=f"cw {i}")
            np.testing.assert_array_equal(v[i], cw[i])


def test_packed_rs_encode_decode():
    n, k = 18, 10
    code = rs_code(n, k)
    arrays = device_arrays(code)
    key = jax.random.key(0)
    b, w = 8, 3
    src = jax.random.bits(key, (b, k, w), dtype=jnp.uint8)
    cw = rs_encode(arrays, src)
    # Lane 0 must equal the scalar encoder.
    cw0 = rs_encode(arrays, src[:, :, 0])
    np.testing.assert_array_equal(jax.device_get(cw[:, :, 0]), jax.device_get(cw0))
    erased = jax.random.uniform(jax.random.key(1), (b, n)) < 0.3
    recv = jnp.where(erased[:, :, None], jnp.uint8(0), cw)
    v, e, failed = rs_decode(arrays, recv, erased)
    ne = jax.device_get(jnp.sum(erased, axis=1))
    for i in range(b):
        if ne[i] <= n - k:
            assert not failed[i]
            np.testing.assert_array_equal(
                jax.device_get(v[i]), jax.device_get(cw[i]), err_msg=f"cw {i}"
            )
        else:
            assert failed[i]


def test_bit_image_dev_matches_host():
    """The device-side arithmetic binary image == the host table image."""
    from ldpc_erasure_codes_tpu.ops.ge import _bit_image_dev

    rng = np.random.default_rng(40)
    mat = rng.integers(0, 256, (5, 7), dtype=np.uint8)
    host = gf.bit_image(mat)
    dev = np.asarray(_bit_image_dev(jnp.asarray(mat)))
    np.testing.assert_array_equal(dev, host)
    # Batched (leading dims) form.
    mats = rng.integers(0, 256, (3, 4, 6), dtype=np.uint8)
    dev_b = np.asarray(_bit_image_dev(jnp.asarray(mats)))
    for i in range(3):
        np.testing.assert_array_equal(dev_b[i], gf.bit_image(mats[i]))


def test_rs_decode_wide_matches_byte_ge():
    """ge_solve_wide_nb (narrow elimination + matmul apply) == the byte GE."""
    from ldpc_erasure_codes_tpu.rs import rs_decode_wide

    n, k = 18, 10
    code = rs_code(n, k)
    arrays = device_arrays(code)
    key = jax.random.key(3)
    b, w = 8, 5
    src = jax.random.bits(key, (b, k, w), dtype=jnp.uint8)
    cw = rs_encode(arrays, src)
    erased = jax.random.uniform(jax.random.key(4), (b, n)) < 0.3
    recv = jnp.where(erased[:, :, None], jnp.uint8(0), cw)
    v1, e1, f1 = rs_decode(arrays, recv, erased)
    v2, e2, f2 = rs_decode_wide(arrays, recv, erased)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(e1), np.asarray(e2))
    ok = ~np.asarray(f1)
    np.testing.assert_array_equal(np.asarray(v1)[ok], np.asarray(v2)[ok])
    ne = np.asarray(jnp.sum(erased, axis=1))
    for i in range(b):
        if ne[i] <= n - k:
            assert not np.asarray(f2)[i]
            np.testing.assert_array_equal(
                np.asarray(v2[i]), np.asarray(cw[i]), err_msg=f"cw {i}"
            )


def test_rs_decode_wide_production_shape():
    """(255,192) with real payload widths; every <= n-k pattern recovers."""
    from ldpc_erasure_codes_tpu.rs import rs_decode_wide

    n, k = 255, 192
    code = rs_code(n, k)
    arrays = device_arrays(code)
    key = jax.random.key(5)
    b, w = 2, 8
    src = jax.random.bits(key, (b, k, w), dtype=jnp.uint8)
    cw = rs_encode(arrays, src)
    erased = jax.random.uniform(jax.random.key(6), (b, n)) < 0.15
    recv = jnp.where(erased[:, :, None], jnp.uint8(0), cw)
    v, e, failed = rs_decode_wide(arrays, recv, erased)
    ne = np.asarray(jnp.sum(erased, axis=1))
    for i in range(b):
        assert ne[i] <= n - k and not np.asarray(failed)[i]
        np.testing.assert_array_equal(np.asarray(v[i]), np.asarray(cw[i]))


def test_analytic_fer():
    # Degenerate cases + monotonicity + a hand value.
    assert analytic_rs_fer(10, 10, 0.1) == pytest.approx(1 - 0.9**10)
    assert analytic_rs_fer(255, 192, 0.0) == 0.0
    a = analytic_rs_fer(250, 125, 0.3)
    b = analytic_rs_fer(250, 125, 0.4)
    assert 0 <= a < b <= 1
    # Binomial tail sanity via direct Monte Carlo.
    rng = np.random.default_rng(3)
    n, k, p = 30, 20, 0.3
    trials = 20000
    fails = (rng.random((trials, n)) < p).sum(axis=1) > (n - k)
    assert analytic_rs_fer(n, k, p) == pytest.approx(fails.mean(), abs=0.01)
