"""The GPU wide peel (ops/peel_replay.py): mask-side event resolver and the
Triton replay kernel, run here in Pallas interpret mode.

Everything is bit-exact (GF(2)/GF(256) integer arithmetic): the kernel path
must reproduce ``peel_decode_wide`` — values, residual mask and iteration
counts — and the NumPy oracle's fixed point. A ``gpu``-marked test runs the
compiled kernel on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldpc_erasure_codes_tpu import channel as ch
from ldpc_erasure_codes_tpu.codes import get_code, toy_code
from ldpc_erasure_codes_tpu.ops import device_arrays, encode_packed
from ldpc_erasure_codes_tpu.ops import peel_wide
from ldpc_erasure_codes_tpu.ops.peel_replay import (
    peel_decode_replay,
    peel_schedule,
    replay_events,
)
from ldpc_erasure_codes_tpu.ops.peel_wide import peel_decode_wide
from ldpc_erasure_codes_tpu.utils import oracle


def _code(name):
    if name == "toy":
        return toy_code(n=48, k=32, seed=3)
    if name == "toy_gf256":
        return toy_code(n=96, k=64, seed=3, gf_order=256)
    return get_code(name)


def _case(name, b, w, per, seed=0):
    code = _code(name)
    arrays = device_arrays(code)
    gf_order = code.gf_order
    key = jax.random.key(seed)
    dtype = jnp.uint32 if gf_order == 2 else jnp.uint8
    src = jax.random.bits(key, (b, code.k, w), dtype=dtype)
    cw = encode_packed(arrays, src, gf_order=gf_order)
    mask = ch.iid_erasures(jax.random.fold_in(key, 1), (b, code.n), per)
    return code, arrays, cw, mask, ch.apply_erasures(cw, mask)


# (code, W, PER, early stop at k): four codes, binary and GF(256), early
# stop on and off, narrow, odd and multi-chunk widths, and PERs on both
# sides of each code's waterfall.
CASES = [
    ("n2040_k1530", 1, 0.14, False),
    ("n2040_k1530", 3, 0.14, True),
    ("n2040_k1530", 8, 0.17, False),
    ("n2040_k1530", 4, 0.19, True),
    ("n2040_k1530", 2, 0.21, False),
    ("n2000_k1000", 2, 0.30, True),
    ("n2000_k1000", 5, 0.36, False),
    ("n2000_k1000", 4, 0.40, False),
    ("n4000_k2000", 2, 0.38, True),
    ("n4080_k3060", 2, 0.18, False),
    ("toy", 1, 0.10, False),
    ("toy", 7, 0.25, True),
    ("n2040_k1530_gf256", 4, 0.14, False),
    ("n2040_k1530_gf256", 8, 0.17, True),
    ("n2040_k1530_gf256", 12, 0.20, False),
    ("toy_gf256", 4, 0.10, False),
    ("toy_gf256", 8, 0.15, True),
    ("toy_gf256", 16, 0.25, False),
]


@pytest.mark.parametrize("name,w,per,early", CASES)
def test_replay_matches_peel_decode_wide(name, w, per, early):
    code, arrays, cw, mask, recv = _case(name, 4, w, per)
    kw = dict(
        max_iters=50, early_stop_k=code.k if early else None,
        gf_order=code.gf_order,
    )
    want = peel_decode_wide(arrays, recv, mask, **kw)
    got = peel_decode_replay(arrays, recv, mask, interpret=True, **kw)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    # Known slots hold the codeword, still-erased slots hold zero.
    v, e = np.asarray(got[0]), np.asarray(got[1])
    np.testing.assert_array_equal(
        np.where(e[..., None], 0, np.asarray(cw)), v
    )


@pytest.mark.parametrize(
    "name,per",
    [
        ("n2040_k1530", 0.16),
        ("n2040_k1530", 0.19),
        ("n2000_k1000", 0.38),
        ("toy", 0.2),
        ("n2040_k1530_gf256", 0.17),
        ("toy_gf256", 0.2),
    ],
)
def test_replay_reaches_oracle_fixed_point(name, per):
    """Without early stop the replay reaches the sequential-sweep oracle's
    fixed point: same residual mask, and every resolved symbol equal to the
    oracle's (symbol byte/bit plane 0)."""
    code, arrays, cw, mask, recv = _case(name, 3, 4, per, seed=5)
    v, e, _ = peel_decode_replay(
        arrays, recv, mask, max_iters=60, gf_order=code.gf_order,
        interpret=True,
    )
    v, e, cw, mask = map(np.asarray, (v, e, cw, mask))
    v = v.astype(np.int64)
    for f in range(3):
        sym = cw[f, :, 0].astype(np.int64)
        if code.gf_order == 2:
            o, _ = oracle.peel_decode(
                code, np.where(mask[f], oracle.ERASED, sym & 1), 60
            )
            got = np.where(e[f], oracle.ERASED, v[f, :, 0] & 1)
        else:
            o, _ = oracle.peel_decode_nb(
                code, np.where(mask[f], oracle.ERASED, sym), 60
            )
            got = np.where(e[f], oracle.ERASED, v[f, :, 0])
        np.testing.assert_array_equal(got, o)


@pytest.mark.parametrize("name,per", [
    ("n2040_k1530", 0.15), ("n2000_k1000", 0.35), ("toy", 0.3),
])
def test_schedule_events_respect_sweep_order(name, per):
    """Each event's solving check has the event's symbol as its only
    neighbour still erased when the event is replayed, and the events list
    exactly the resolved symbols."""
    code, arrays, _, mask, _ = _case(name, 3, 1, per, seed=2)
    e_out, _, tgt, chk, count = map(
        np.asarray, peel_schedule(arrays, mask, max_iters=50)
    )
    vl = np.asarray(arrays.vlist_idx)
    mask = np.asarray(mask)
    for f in range(3):
        er = mask[f].copy()
        seen = []
        for t, c in zip(tgt[f, : count[f]], chk[f, : count[f]]):
            nbrs = vl[c][vl[c] < code.n]
            assert t in nbrs
            assert er[nbrs].sum() == 1 and er[t]
            er[t] = False
            seen.append(t)
        np.testing.assert_array_equal(er, e_out[f])
        assert sorted(seen) == sorted(np.nonzero(mask[f] & ~e_out[f])[0])


@pytest.mark.parametrize("name,per,early", [
    ("n2040_k1530", 0.17, False),
    ("n2040_k1530", 0.14, True),
    ("n2000_k1000", 0.42, False),
    ("toy", 0.3, True),
])
def test_schedule_mask_and_iters_match_wide(name, per, early):
    code, arrays, _, mask, recv = _case(name, 4, 1, per, seed=4)
    es = code.k if early else None
    e_s, it_s, *_ = peel_schedule(arrays, mask, max_iters=50, early_stop_k=es)
    _, e_w, it_w = peel_decode_wide(
        arrays, recv, mask, max_iters=50, early_stop_k=es
    )
    np.testing.assert_array_equal(np.asarray(e_s), np.asarray(e_w))
    np.testing.assert_array_equal(np.asarray(it_s), np.asarray(it_w))


def test_schedule_erasure_free_frames_have_no_events():
    code, arrays, _, _, _ = _case("toy", 2, 1, 0.0)
    mask = jnp.zeros((2, code.n), bool)
    e, iters, _, _, count = peel_schedule(arrays, mask, max_iters=50)
    assert not np.asarray(e).any()
    np.testing.assert_array_equal(np.asarray(count), [0, 0])
    np.testing.assert_array_equal(np.asarray(iters), [1, 1])


@pytest.mark.parametrize("w_chunk", [1, 2, 4])
def test_replay_w_chunks_match_one_chunk(w_chunk):
    """Several programs per frame (W split into chunks, the last padded)
    give the same result as one program over the whole width."""
    code, arrays, cw, mask, recv = _case("n2040_k1530", 2, 5, 0.15, seed=7)
    _, _, tgt, chk, count = peel_schedule(arrays, mask, max_iters=50)
    one = replay_events(arrays, recv, tgt, chk, count, interpret=True)
    many = replay_events(
        arrays, recv, tgt, chk, count, w_chunk=w_chunk, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(many), np.asarray(one))


def test_replay_reads_symbols_it_wrote():
    """A chain in which every event reads the symbol the previous event
    stored, inside one program: the store-then-load case the kernel's
    barrier orders on the card."""
    # Checks {0,1}, {1,2}, {2,3}: erasing 1, 2, 3 peels them one per sweep.
    from ldpc_erasure_codes_tpu.ops.arrays import CodeArrays

    n = 4
    idx = jnp.array([[0, 1], [1, 2], [2, 3]], jnp.int32)
    zeros = jnp.zeros((3, 2), jnp.uint8)
    arrays = CodeArrays(*([None] * len(CodeArrays._fields)))._replace(
        vlist_idx=idx, vlist_val=zeros, vlist_inv_val=zeros
    )
    vals = jnp.zeros((1, n, 4), jnp.uint32).at[0, 0].set(
        jnp.array([1, 2, 3, 4], jnp.uint32)
    )
    tgt = jnp.array([[1, 2, 3, 0]], jnp.int32)
    chk = jnp.array([[0, 1, 2, 0]], jnp.int32)
    out = replay_events(
        arrays, vals, tgt, chk, jnp.array([3], jnp.int32), interpret=True
    )
    np.testing.assert_array_equal(
        np.asarray(out[0]), np.tile(np.arange(1, 5, dtype=np.uint32), (n, 1))
    )


def test_replay_zero_count_leaves_values():
    code, arrays, _, mask, recv = _case("toy", 2, 3, 0.2)
    _, _, tgt, chk, _ = peel_schedule(arrays, mask, max_iters=50)
    out = replay_events(
        arrays, recv, tgt, chk, jnp.zeros((2,), jnp.int32), interpret=True
    )
    np.testing.assert_array_equal(np.asarray(out), np.asarray(recv))


def test_replay_nb_rejects_width_not_multiple_of_4():
    code, arrays, _, mask, recv = _case("toy_gf256", 2, 6, 0.1)
    with pytest.raises(ValueError):
        peel_decode_replay(arrays, recv, mask, gf_order=256, interpret=True)


def test_packed_dispatch_uses_xla_on_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(
        peel_wide, "peel_decode_replay",
        lambda *a, **k: calls.append("kernel"),
    )
    code, arrays, _, mask, recv = _case("toy", 2, 2, 0.2)
    out = peel_wide.peel_decode_packed(arrays, recv, mask)
    assert calls == []
    want = peel_decode_wide(arrays, recv, mask)
    for g, r in zip(out, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


@pytest.fixture
def kernel_path(monkeypatch):
    """Route the platform dispatch to the replay kernel, in interpret mode:
    the GPU code path of every caller, run on the CPU."""
    from ldpc_erasure_codes_tpu.utils import device

    monkeypatch.setattr(device, "on_gpu", lambda: True)
    monkeypatch.setattr(
        peel_wide, "peel_decode_replay",
        functools.partial(peel_decode_replay, interpret=True),
    )
    jax.clear_caches()  # traces made under the CPU choice must not be reused
    yield
    jax.clear_caches()


@pytest.mark.parametrize("name,per", [
    ("n2040_k1530", 0.19), ("n2040_k1530_gf256", 0.19),
])
def test_hybrid_kernel_path_matches_xla_path(kernel_path, name, per):
    from ldpc_erasure_codes_tpu.ops import hybrid_decode

    code, arrays, cw, mask, recv = _case(name, 8, 4, per, seed=9)
    kw = dict(gf_order=code.gf_order, peel_iters=10, emax=256, ge_subbatch=8)
    got = hybrid_decode(arrays, recv, mask, **kw)
    want_v, want_e, want_it = peel_decode_wide(
        arrays, recv, mask, max_iters=10, gf_order=code.gf_order
    )
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want_it))
    ok = ~np.asarray(got[3])
    assert ok.any()
    np.testing.assert_array_equal(
        np.asarray(got[0])[ok], np.asarray(cw)[ok]
    )


def test_throughput_step_kernel_path_matches(kernel_path):
    from ldpc_erasure_codes_tpu.utils import cli

    code, arrays, cw, _, _ = _case("n2000_k1000", 4, 2, 0.0)
    step = cli.make_throughput_step(code, arrays, batch=4, per=0.3, max_iters=50)
    got = step(jax.random.key(3), cw)
    mask = ch.iid_erasures(jax.random.key(3), (4, code.n), 0.3)
    v, e, _ = peel_decode_wide(
        arrays, ch.apply_erasures(cw, mask), mask, max_iters=50,
        early_stop_k=code.k,
    )
    assert int(got[0]) == int(jnp.sum(e[:, : code.k]))
    want = jnp.bitwise_xor.reduce(jnp.bitwise_xor.reduce(v, axis=1), axis=0)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want))


def test_value_sim_kernel_path_matches_pattern_only(kernel_path):
    """The value-tracking sim on the kernel path counts the same errors as
    the pattern-only sim (statistics are mask-derived)."""
    from ldpc_erasure_codes_tpu.sim import DecoderConfig, SimConfig
    from ldpc_erasure_codes_tpu.sim.driver import make_sim_step

    outs = []
    for track in (True, False):
        cfg = SimConfig(
            code="n2000_k1000", batch=8, symbol_words=2, track_values=track,
            decoder=DecoderConfig(kind="peel", max_iters=30, early_stop_k=True),
        )
        step = make_sim_step("n2000_k1000", cfg)
        outs.append(step(jax.random.key(5), jnp.float32(0.36)))
    a, b = outs
    for f in ("frames", "block_errors", "erased_symbols", "residual_erasures"):
        assert int(getattr(a, f)) == int(getattr(b, f)), f


@pytest.mark.gpu
@pytest.mark.parametrize("name,w", [("n2040_k1530", 256), ("n2040_k1530_gf256", 1024)])
def test_compiled_kernel_matches_reference_on_gpu(gpu, name, w):
    """The kernel as compiled for the card, at production width, against
    ``peel_decode_wide`` on the same card."""
    code, arrays, cw, mask, recv = _case(name, 64, w, 0.1406)
    kw = dict(max_iters=50, gf_order=code.gf_order)
    got = peel_decode_replay(arrays, recv, mask, **kw)
    want = peel_decode_wide(arrays, recv, mask, **kw)
    for g, r in zip(got, want):
        assert bool(jnp.array_equal(g, r))
