"""Simulation driver, packed encoders, parallel mesh, and graft-entry tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ldpc_erasure_codes_tpu.codes import get_code
from ldpc_erasure_codes_tpu.codes.toy import toy_code
from ldpc_erasure_codes_tpu.ops import (
    device_arrays,
    encode,
    encode_nb,
    encode_packed,
)
from ldpc_erasure_codes_tpu.parallel import default_mesh, make_mesh, shard_sim_step
from ldpc_erasure_codes_tpu.sim import (
    ChannelConfig,
    DecoderConfig,
    SimConfig,
    format_report,
    make_sim_step,
    run_fer_point,
    run_fer_sweep,
)


@pytest.fixture(scope="module")
def code2040():
    return get_code("n2040_k1530")


class TestPackedEncode:
    def test_binary_matches_bitplane(self, code2040):
        arrays = device_arrays(code2040)
        key = jax.random.key(0)
        b, w = 3, 2
        src = jax.random.bits(key, (b, code2040.k, w), dtype=jnp.uint32)
        cw = encode_packed(arrays, src)
        assert cw.shape == (b, code2040.n, w)
        for bit in (0, 13, 31):
            plane = ((src[:, :, 1] >> bit) & 1).astype(jnp.uint8)
            want = encode(arrays, plane)
            got = ((cw[:, :, 1] >> bit) & 1).astype(jnp.uint8)
            np.testing.assert_array_equal(jax.device_get(got), jax.device_get(want))

    def test_nb_matches_scalar(self):
        code = toy_code(n=40, k=24, seed=5, gf_order=256)
        arrays = device_arrays(code)
        key = jax.random.key(1)
        b, w = 4, 3
        src = jax.random.bits(key, (b, code.k, w), dtype=jnp.uint8)
        cw = encode_packed(arrays, src, gf_order=256)
        for lane in range(w):
            want = encode_nb(arrays, src[:, :, lane])
            np.testing.assert_array_equal(
                jax.device_get(cw[:, :, lane]), jax.device_get(want)
            )

    def test_packed_codeword_satisfies_checks(self, code2040):
        arrays = device_arrays(code2040)
        src = jax.random.bits(jax.random.key(2), (2, code2040.k, 1), dtype=jnp.uint32)
        cw = jax.device_get(encode_packed(arrays, src))[:, :, 0]
        h = code2040.h_dense.astype(np.uint64)
        for b in range(2):
            # XOR-syndrome of packed words must vanish on every check.
            syn = np.zeros(code2040.m, dtype=np.uint64)
            for r in range(code2040.m):
                cols = np.nonzero(h[r])[0]
                syn[r] = np.bitwise_xor.reduce(cw[b, cols].astype(np.uint64))
            assert not syn.any()


class TestSimStep:
    def test_stats_consistency(self, code2040):
        cfg = SimConfig(
            code=code2040.name, batch=128, decoder=DecoderConfig(kind="hybrid", emax=64)
        )
        step = make_sim_step(code2040, cfg)
        s = jax.device_get(step(jax.random.key(0), jnp.float32(0.14)))
        assert int(s.frames) == 128
        assert 0 <= int(s.block_errors) <= 128
        assert sum(int(x) for x in s.iters_hist) == 128
        # measured PER ~ 0.14
        meas = int(s.erased_symbols) / (128 * code2040.n)
        assert abs(meas - 0.14) < 0.02

    def test_peel_vs_hybrid_fer_ordering(self, code2040):
        # Hybrid can only fix more than peel-only at the same operating point.
        base = dict(code=code2040.name, batch=256, seed=42)
        sp = make_sim_step(code2040, SimConfig(**base, decoder=DecoderConfig(kind="peel")))
        sh = make_sim_step(
            code2040, SimConfig(**base, decoder=DecoderConfig(kind="hybrid", emax=128))
        )
        key = jax.random.key(9)
        per = jnp.float32(0.17)
        ep = int(sp(key, per).block_errors)
        eh = int(sh(key, per).block_errors)
        assert eh <= ep

    def test_per64_channel(self, code2040):
        cfg = SimConfig(
            code=code2040.name,
            batch=64,
            channel=ChannelConfig(kind="per64"),
            decoder=DecoderConfig(kind="peel"),
        )
        step = make_sim_step(code2040, cfg)
        s = jax.device_get(step(jax.random.key(0), jnp.uint32(9)))
        meas = int(s.erased_symbols) / (64 * code2040.n)
        assert abs(meas - 9 / 64) < 0.02

    def test_gilbert_elliott_channel(self):
        code = toy_code(n=64, k=40, seed=1)
        cfg = SimConfig(
            code=code.name,
            batch=256,
            channel=ChannelConfig(
                kind="gilbert_elliott", ge_alpha=0.01, ge_beta=0.5
            ),
            decoder=DecoderConfig(kind="peel"),
        )
        step = make_sim_step(code, cfg)
        s = jax.device_get(step(jax.random.key(3), jnp.float32(0.0)))
        from ldpc_erasure_codes_tpu.channel import (
            GilbertElliottParams,
            gilbert_elliott_steady_state,
        )
        expect = gilbert_elliott_steady_state(GilbertElliottParams(0.01, 0.5))
        meas = int(s.erased_symbols) / (256 * code.n)
        assert abs(meas - expect) < 0.02

    def test_nb_sim_step(self):
        code = toy_code(n=60, k=36, seed=2)
        cfg = SimConfig(
            code=code.name,
            gf_order=256,
            batch=32,
            decoder=DecoderConfig(kind="hybrid", emax=24),
        )
        s = jax.device_get(make_sim_step(code, cfg)(jax.random.key(0), jnp.float32(0.1)))
        assert int(s.frames) == 32

    def test_ml_decoder_kind(self):
        code = toy_code(n=64, k=40, seed=4)
        cfg = SimConfig(
            code=code.name, batch=32, decoder=DecoderConfig(kind="ml", emax=24)
        )
        s = jax.device_get(make_sim_step(code, cfg)(jax.random.key(0), jnp.float32(0.1)))
        assert int(s.frames) == 32
        # ML-from-scratch leaves block errors only where GE failed.
        assert int(s.block_errors) <= int(s.ml_failed)


class TestDriver:
    def test_run_fer_point_and_report(self, code2040):
        cfg = SimConfig(
            code=code2040.name, batch=64, decoder=DecoderConfig(kind="hybrid", emax=64)
        )
        pt = run_fer_point(code2040, cfg, 0.16, target_errors=3, max_frames=256)
        assert pt.frames >= 64
        assert 0.14 < pt.measured_per < 0.18
        rep = format_report(code2040.name, cfg, [pt])
        assert "FER" in rep and code2040.name in rep

    def test_sweep_reuses_compile(self):
        code = toy_code(n=64, k=40, seed=6)
        cfg = SimConfig(code=code.name, batch=64, decoder=DecoderConfig(kind="peel"))
        pts = run_fer_sweep(
            code, cfg, [0.05, 0.15], target_errors=10, max_frames=256
        )
        assert len(pts) == 2
        assert pts[0].fer <= pts[1].fer + 0.1


class TestParallel:
    def test_shard_sim_step_psum(self, code2040):
        mesh = default_mesh()
        ndev = mesh.devices.size
        cfg = SimConfig(
            code=code2040.name, batch=32, decoder=DecoderConfig(kind="peel")
        )
        step = shard_sim_step(make_sim_step(code2040, cfg), mesh)
        s = jax.device_get(step(jax.random.key(0), jnp.float32(0.14)))
        assert int(s.frames) == 32 * ndev
        assert sum(int(x) for x in s.iters_hist) == 32 * ndev

    def test_make_mesh_shapes(self):
        with pytest.raises(ValueError):
            make_mesh((1000,), ("data",))
        m = make_mesh((2, 2), ("data", "lane"))
        assert m.axis_names == ("data", "lane")


class TestGraftEntry:
    def test_entry_compiles(self):
        import __graft_entry__ as g

        fn, args = g.entry()
        out = jax.block_until_ready(fn(*args))
        assert int(out.frames) == 32

    def test_dryrun_multichip(self):
        import __graft_entry__ as g

        g.dryrun_multichip(len(jax.devices()))


def test_count_all_symbols_scope():
    """MATLAB-mode block errors (any residual symbol) >= FPGA-mode (first k)."""
    code = toy_code(n=64, k=40, seed=8)
    base = dict(code=code.name, batch=256, seed=3, track_values=False)
    d_k = DecoderConfig(kind="peel", max_iters=3)
    d_all = DecoderConfig(kind="peel", max_iters=3, count_all_symbols=True)
    sk = make_sim_step(code, SimConfig(**base, decoder=d_k))
    sa = make_sim_step(code, SimConfig(**base, decoder=d_all))
    key = jax.random.key(1)
    per = jnp.float32(0.25)
    ek = int(sk(key, per).block_errors)
    ea = int(sa(key, per).block_errors)
    assert ea >= ek


def test_level_encoder_matches_scan():
    """Level-scheduled packed encoder is bit-identical to the scan encoder."""
    from ldpc_erasure_codes_tpu.ops.encode import make_packed_encoder

    code = get_code("n2040_k1530")
    arrays = device_arrays(code)
    enc = make_packed_encoder(code)
    src = jax.random.bits(jax.random.key(4), (3, code.k, 2), dtype=jnp.uint32)
    np.testing.assert_array_equal(
        np.asarray(enc(src)), np.asarray(encode_packed(arrays, src))
    )


def test_measure_scaling_virtual_mesh():
    """Scaling measurement runs on the 8-device virtual mesh and reports
    monotone frame counts with an efficiency baseline of 1.0."""
    from ldpc_erasure_codes_tpu.parallel import measure_scaling

    code = toy_code(n=64, k=40, seed=6)
    cfg = SimConfig(
        code=code.name, batch=64, track_values=False,
        decoder=DecoderConfig(kind="peel"),
    )
    pts = measure_scaling(code, cfg, 0.1, device_counts=[1, 2, 4], reps=2)
    assert [p.devices for p in pts] == [1, 2, 4]
    assert pts[0].efficiency == 1.0
    assert pts[1].frames == 2 * pts[0].frames
    assert all(p.frames_per_sec > 0 for p in pts)
