"""Residual-frame compaction: must be equivalent to whole-batch GE."""

import numpy as np
import jax
import jax.numpy as jnp

from ldpc_erasure_codes_tpu import channel as ch
from ldpc_erasure_codes_tpu.codes import get_code, toy_code
from ldpc_erasure_codes_tpu.ops import (
    compact_ge_rank,
    compact_ge_solve,
    device_arrays,
    ge_rank_check,
    ge_solve,
    hybrid_decode,
    peel_decode_mask,
)
from ldpc_erasure_codes_tpu.ops.compact import residual_order
from ldpc_erasure_codes_tpu.sim import DecoderConfig, SimConfig, make_sim_step


def _residual_after_peel(code, per, b, seed):
    arrays = device_arrays(code)
    mask = ch.iid_erasures(jax.random.key(seed), (b, code.n), per)
    e, _ = peel_decode_mask(arrays, mask, max_iters=50)
    return arrays, e


def test_residual_order():
    erased = jnp.zeros((6, 4), bool).at[1, 0].set(True).at[4, 2].set(True)
    sel, is_resid, overflow = residual_order(erased, 3)
    assert list(np.asarray(sel))[:2] == [1, 4]
    np.testing.assert_array_equal(np.asarray(is_resid), [True, True, False])
    assert not np.asarray(overflow).any()
    # Bucket of 1: frame 4 overflows.
    sel1, isr1, ov1 = residual_order(erased, 1)
    assert int(sel1[0]) == 1
    np.testing.assert_array_equal(np.asarray(ov1), [False, False, False, False, True, False])


def test_compact_rank_matches_full():
    code = get_code("n2040_k1530")
    arrays, e = _residual_after_peel(code, 0.185, 256, seed=3)
    full = ge_rank_check(arrays, e, emax=256)
    comp = compact_ge_rank(arrays, e, emax=256, f_max=64)
    nres = int(jnp.sum(jnp.any(e, axis=1)))
    assert nres <= 64, "test assumes bucket fits; raise f_max"
    np.testing.assert_array_equal(np.asarray(comp), np.asarray(full))


def test_compact_rank_overflow_flags():
    code = get_code("n2040_k1530")
    arrays, e = _residual_after_peel(code, 0.21, 128, seed=4)
    nres = int(jnp.sum(jnp.any(e, axis=1)))
    assert nres > 4
    comp = compact_ge_rank(arrays, e, emax=256, f_max=4)
    # All residual frames beyond the first 4 must be flagged.
    resid = np.asarray(jnp.any(e, axis=1))
    flagged = np.asarray(comp)
    assert flagged[resid].sum() >= nres - 4


def test_compact_solve_matches_full():
    code = toy_code(n=64, k=40, seed=7)
    arrays = device_arrays(code)
    key = jax.random.key(0)
    src = jax.random.bits(key, (64, code.k), dtype=jnp.uint8) & 1
    from ldpc_erasure_codes_tpu.ops import encode

    cw = encode(arrays, src)
    mask = ch.iid_erasures(jax.random.key(1), (64, code.n), 0.25)
    recv = ch.apply_erasures(cw, mask)
    vf, ef, failf = ge_solve(arrays, recv, mask, emax=24)
    vc, ec, failc = compact_ge_solve(arrays, recv, mask, emax=24, f_max=64)
    np.testing.assert_array_equal(np.asarray(vc), np.asarray(vf))
    np.testing.assert_array_equal(np.asarray(ec), np.asarray(ef))
    np.testing.assert_array_equal(np.asarray(failc), np.asarray(failf))


def test_hybrid_with_subbatch_decodes():
    code = get_code("n2040_k1530")
    arrays = device_arrays(code)
    key = jax.random.key(0)
    src = jax.random.bits(key, (32, code.k), dtype=jnp.uint8) & 1
    from ldpc_erasure_codes_tpu.ops import encode

    cw = encode(arrays, src)
    mask = ch.iid_erasures(jax.random.key(2), (32, code.n), 0.18)
    recv = ch.apply_erasures(cw, mask)
    v, e, iters, failed = hybrid_decode(
        arrays, recv, mask, peel_iters=50, emax=256, ge_subbatch=16
    )
    ok = np.asarray(~failed)
    np.testing.assert_array_equal(np.asarray(v)[ok], np.asarray(cw)[ok])


def test_sim_subbatch_matches():
    code = get_code("n2040_k1530")
    base = dict(code=code.name, batch=128, seed=5, track_values=False)
    d0 = DecoderConfig(kind="hybrid", emax=256, peel_iters=50)
    d1 = DecoderConfig(kind="hybrid", emax=256, peel_iters=50, ge_subbatch=32)
    s0 = make_sim_step(code, SimConfig(**base, decoder=d0))
    s1 = make_sim_step(code, SimConfig(**base, decoder=d1))
    key, per = jax.random.key(9), jnp.float32(0.185)
    a, b = jax.device_get(s0(key, per)), jax.device_get(s1(key, per))
    assert int(a.block_errors) == int(b.block_errors)
    assert int(a.ml_failed) == int(b.ml_failed)
