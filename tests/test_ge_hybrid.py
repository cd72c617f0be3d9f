"""Batched GE and hybrid decoder tests vs the NumPy oracle."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ldpc_erasure_codes_tpu import codes as codes_mod
from ldpc_erasure_codes_tpu.codes import gen_row_wise
from ldpc_erasure_codes_tpu.ops import device_arrays, encode_packed
from ldpc_erasure_codes_tpu import ops
from ldpc_erasure_codes_tpu.ops.ge import ge_solve
from ldpc_erasure_codes_tpu.ops.hybrid import hybrid_decode
from ldpc_erasure_codes_tpu.utils import oracle


@pytest.fixture(scope="module")
def c2000():
    return codes_mod.get_code("n2000_k1000")


@pytest.fixture(scope="module")
def a2000(c2000):
    return ops.device_arrays(c2000)


@pytest.fixture(scope="module")
def nb2040():
    return codes_mod.get_code("n2040_k1530_gf256")


@pytest.fixture(scope="module")
def anb2040(nb2040):
    return ops.device_arrays(nb2040)


def _mk_batch(rng, code, b, per, nb=False):
    hi = 256 if nb else 2
    src = rng.integers(0, hi, (b, code.k), dtype=np.uint8)
    enc = oracle.encode_triangular_nb if nb else oracle.encode_triangular
    cws = np.stack([enc(code, s) for s in src]).astype(np.uint8)
    mask = rng.random((b, code.n)) <= per
    vals = (cws * ~mask).astype(np.uint8)
    return cws, vals, mask


class TestGESolve:
    def test_pure_ge_binary(self, c2000, a2000):
        # Erase few symbols; GE alone (no peeling) must solve them all.
        rng = np.random.default_rng(20)
        cws, vals, mask = _mk_batch(rng, c2000, 8, 0.03)
        v, e, failed = ge_solve(a2000, jnp.asarray(vals), jnp.asarray(mask), emax=128)
        assert not np.asarray(failed).any()
        assert not np.asarray(e).any()
        assert np.array_equal(np.asarray(v), cws)

    def test_pure_ge_nb(self, nb2040, anb2040):
        rng = np.random.default_rng(21)
        cws, vals, mask = _mk_batch(rng, nb2040, 4, 0.02, nb=True)
        v, e, failed = ge_solve(
            anb2040, jnp.asarray(vals), jnp.asarray(mask), emax=96, gf_order=256
        )
        assert not np.asarray(failed).any()
        assert np.array_equal(np.asarray(v), cws)

    def test_emax_larger_than_n_clamps(self):
        """A bucket wider than the code must clamp to n (the defaults —
        emax=128 — previously crashed shape-broadcasting on short codes)."""
        import jax

        code = codes_mod.toy_code(n=60, k=36, seed=2)
        arrays = ops.device_arrays(code)
        rng = np.random.default_rng(29)
        src = (rng.integers(0, 2, (4, code.k))).astype(np.uint8)
        cws = np.asarray(ops.encode(arrays, jnp.asarray(src)))
        mask = rng.random((4, code.n)) <= 0.15
        vals = (cws * ~mask).astype(np.uint8)
        v, e, failed = ge_solve(
            arrays, jnp.asarray(vals), jnp.asarray(mask), emax=128
        )
        ok = ~np.asarray(failed)
        assert ok.any()
        assert np.array_equal(np.asarray(v)[ok], cws[ok])
        # hybrid default emax rides the same clamp
        v2, e2, _, f2 = hybrid_decode(
            arrays, jnp.asarray(vals), jnp.asarray(mask)
        )
        ok2 = ~np.asarray(f2)
        assert np.array_equal(np.asarray(v2)[ok2], cws[ok2])

    def test_bucket_overflow_flagged(self, c2000, a2000):
        rng = np.random.default_rng(22)
        cws, vals, mask = _mk_batch(rng, c2000, 2, 0.10)
        v, e, failed = ge_solve(a2000, jnp.asarray(vals), jnp.asarray(mask), emax=32)
        assert np.asarray(failed).all()  # ~200 erasures >> 32
        assert np.asarray(e).any(axis=1).all()  # masks left set

    def test_mixed_batch(self, c2000, a2000):
        # One clean codeword, one overflowing, several normal.
        rng = np.random.default_rng(23)
        cws, vals, mask = _mk_batch(rng, c2000, 6, 0.04)
        mask[0, :] = False
        vals[0] = cws[0]
        mask[1, :300] = True
        vals[1, :300] = 0
        v, e, failed = ge_solve(a2000, jnp.asarray(vals), jnp.asarray(mask), emax=128)
        failed = np.asarray(failed)
        assert not failed[0]
        assert failed[1]
        assert np.array_equal(np.asarray(v)[0], cws[0])
        for i in range(2, 6):
            assert not failed[i]
            assert np.array_equal(np.asarray(v)[i], cws[i])

    def test_wide_symbols(self, c2000, a2000):
        rng = np.random.default_rng(24)
        b, w = 2, 2
        src_bits = rng.integers(0, 2, (b, 64, c2000.k), dtype=np.uint8)
        planes = np.asarray(ops.encode(a2000, jnp.asarray(src_bits)))
        words = np.zeros((b, c2000.n, w), dtype=np.uint32)
        for s in range(64):
            words[:, :, s // 32] |= planes[:, s, :].astype(np.uint32) << (s % 32)
        mask = rng.random((b, c2000.n)) <= 0.03
        vals = words * ~mask[:, :, None]
        v, e, failed = ge_solve(
            a2000, jnp.asarray(vals), jnp.asarray(mask), emax=128
        )
        assert not np.asarray(failed).any()
        assert np.array_equal(np.asarray(v), words)


class TestGESolvePacked:
    """ge_solve_packed (packed-bit elimination + matmul apply) vs ge_solve."""

    def _wide_batch(self, code, arrays, rng, b, w, per):
        src = jnp.asarray(
            rng.integers(0, 2**32, (b, code.k, w), dtype=np.uint32)
        )
        cws = np.asarray(ops.encode_packed(arrays, src))
        mask = rng.random((b, code.n)) <= per
        vals = cws * ~mask[:, :, None]
        return cws, jnp.asarray(vals), jnp.asarray(mask)

    def test_matches_byte_ge_mixed_batch(self):
        from ldpc_erasure_codes_tpu.ops.ge import ge_solve_packed

        code = codes_mod.toy_code(n=96, k=64, seed=3)
        arrays = ops.device_arrays(code)
        rng = np.random.default_rng(30)
        cws, vals, mask = self._wide_batch(code, arrays, rng, 16, 3, 0.12)
        # Force failure modes into the batch: frame 0 overflows the emax
        # bucket, frame 1 erases more symbols than there are checks
        # (rank-deficient by counting).
        mask = np.asarray(mask).copy()
        vals = np.asarray(vals).copy()
        mask[0, :40] = True
        vals[0, :40] = 0
        mask[1, : code.n - code.k + 1] = True
        vals[1, : code.n - code.k + 1] = 0
        mask, vals = jnp.asarray(mask), jnp.asarray(vals)
        v1, e1, f1 = ge_solve(arrays, vals, mask, emax=33)
        v2, e2, f2 = ge_solve_packed(arrays, vals, mask, emax=33)
        assert np.array_equal(np.asarray(f1), np.asarray(f2))
        assert np.array_equal(np.asarray(e1), np.asarray(e2))
        ok = ~np.asarray(f1)
        assert ok.any() and (~ok).any(), "want a mixed batch"
        assert np.array_equal(np.asarray(v1)[ok], np.asarray(v2)[ok])
        assert np.array_equal(np.asarray(v2)[ok], cws[ok])

    def test_odd_width_and_emax(self):
        """Non-multiple-of-32 emax and odd W exercise the packing pads."""
        from ldpc_erasure_codes_tpu.ops.ge import ge_solve_packed

        code = codes_mod.toy_code(n=60, k=36, seed=2)
        arrays = ops.device_arrays(code)
        rng = np.random.default_rng(31)
        cws, vals, mask = self._wide_batch(code, arrays, rng, 6, 5, 0.10)
        v1, e1, f1 = ge_solve(arrays, vals, mask, emax=23)
        v2, e2, f2 = ge_solve_packed(arrays, vals, mask, emax=23)
        assert np.array_equal(np.asarray(f1), np.asarray(f2))
        ok = ~np.asarray(f1)
        assert np.array_equal(np.asarray(v1)[ok], np.asarray(v2)[ok])

    def test_production_code_wide(self, c2000, a2000):
        from ldpc_erasure_codes_tpu.ops.ge import ge_solve_packed

        rng = np.random.default_rng(32)
        cws, vals, mask = self._wide_batch(c2000, a2000, rng, 2, 2, 0.03)
        v, e, failed = ge_solve_packed(a2000, vals, mask, emax=128)
        assert not np.asarray(failed).any()
        assert not np.asarray(e).any()
        assert np.array_equal(np.asarray(v), cws)

    def test_hybrid_auto_picks_packed(self, c2000, a2000):
        """hybrid_decode(ge_impl=auto) on wide uint32 == ge_impl=bytes."""
        rng = np.random.default_rng(33)
        cws, vals, mask = self._wide_batch(c2000, a2000, rng, 4, 2, 0.38)
        out_a = hybrid_decode(
            a2000, vals, mask, peel_iters=10, emax=512, ge_impl="auto"
        )
        out_b = hybrid_decode(
            a2000, vals, mask, peel_iters=10, emax=512, ge_impl="bytes"
        )
        fa, fb = np.asarray(out_a[3]), np.asarray(out_b[3])
        assert np.array_equal(fa, fb)
        ok = ~fa
        assert np.array_equal(np.asarray(out_a[1]), np.asarray(out_b[1]))
        assert np.array_equal(
            np.asarray(out_a[0])[ok], np.asarray(out_b[0])[ok]
        )


class TestHybridDecode:
    def test_matches_oracle(self, c2000, a2000):
        rng = np.random.default_rng(25)
        b = 8
        cws, vals, mask = _mk_batch(rng, c2000, b, 0.40)
        emax = 512
        v, e, iters, failed = hybrid_decode(
            a2000, jnp.asarray(vals), jnp.asarray(mask), peel_iters=30, emax=emax
        )
        v, failed = np.asarray(v), np.asarray(failed)
        for i in range(b):
            recv = cws[i].astype(np.int64)
            recv[mask[i]] = oracle.ERASED
            want, _, singular = oracle.hybrid_ml_decode(c2000, recv, peel_iters=30)
            assert failed[i] == singular, f"cw {i}: failure flags differ"
            if not singular:
                assert np.array_equal(v[i], cws[i]), f"cw {i}: wrong decode"
                assert np.array_equal(v[i], want)

    def test_matches_oracle_nb(self, nb2040, anb2040):
        rng = np.random.default_rng(26)
        b = 4
        cws, vals, mask = _mk_batch(rng, nb2040, b, 0.22, nb=True)
        v, e, iters, failed = hybrid_decode(
            anb2040,
            jnp.asarray(vals),
            jnp.asarray(mask),
            gf_order=256,
            peel_iters=30,
            emax=448,
        )
        v, failed = np.asarray(v), np.asarray(failed)
        for i in range(b):
            recv = cws[i].astype(np.int64)
            recv[mask[i]] = oracle.ERASED
            want, _, singular = oracle.hybrid_ml_decode_nb(nb2040, recv, peel_iters=30)
            assert failed[i] == singular
            if not singular:
                assert np.array_equal(v[i], cws[i])

    def test_clean_batch_skips_ge(self, c2000, a2000):
        rng = np.random.default_rng(27)
        cws, vals, mask = _mk_batch(rng, c2000, 4, 0.05)
        v, e, iters, failed = hybrid_decode(
            a2000, jnp.asarray(vals), jnp.asarray(mask), peel_iters=30, emax=64
        )
        assert not np.asarray(failed).any()
        assert np.array_equal(np.asarray(v), cws)


def test_escalation_decodes_overflow_frames():
    """A frame whose residual exceeds emax (or the
    ge_subbatch frame bucket) must still decode via the escalation path —
    bucket sizing is a performance knob, never a correctness knob."""
    from ldpc_erasure_codes_tpu.ops import hybrid_decode_escalated

    code = codes_mod.get_code("n2000_k1000")
    arrays = device_arrays(code)
    b, w, per = 4, 2, 0.42
    key = jax.random.key(5)
    src = jax.random.bits(key, (b, code.k, w), dtype=jnp.uint32)
    cw = np.asarray(encode_packed(arrays, src))
    mask = np.asarray(
        jax.random.uniform(jax.random.fold_in(key, 1), (b, code.n)) < per
    )
    recv = jnp.where(jnp.asarray(mask)[:, :, None], jnp.uint32(0),
                     jnp.asarray(cw))
    # Baseline: emax=64 is far below the post-peel residual at this PER, so
    # every frame is flagged failed purely by bucket configuration.
    _, _, _, failed0 = hybrid_decode(
        arrays, recv, jnp.asarray(mask), peel_iters=10, emax=64,
    )
    failed0 = np.asarray(failed0)
    assert failed0.all(), "test premise: emax=64 must overflow every frame"
    # Escalated: the second dispatch sizes its bucket from the actual
    # residuals and recovers every ML-solvable frame bit-exactly.
    v1, e1, _, failed1, nesc = hybrid_decode_escalated(
        arrays, recv, jnp.asarray(mask), peel_iters=10, emax=64,
    )
    v1, e1, failed1 = map(np.asarray, (v1, e1, failed1))
    assert nesc == b
    assert failed1.sum() < failed0.sum()
    ok = ~failed1
    assert ok.any()
    np.testing.assert_array_equal(v1[ok], cw[ok])
    assert not e1[ok].any()
    # Frame-bucket overflow: ge_subbatch=1 spills all but one residual
    # frame; escalation recovers the spilled frames too.
    _, _, _, failed2 = hybrid_decode(
        arrays, recv, jnp.asarray(mask), peel_iters=10, emax=512,
        ge_subbatch=1,
    )
    v3, e3, _, failed3, nesc3 = hybrid_decode_escalated(
        arrays, recv, jnp.asarray(mask), peel_iters=10, emax=512,
        ge_subbatch=1,
    )
    v3, e3, failed3 = map(np.asarray, (v3, e3, failed3))
    assert np.asarray(failed2).sum() > failed3.sum()
    np.testing.assert_array_equal(failed3, failed1)
    np.testing.assert_array_equal(v3[~failed3], cw[~failed3])
