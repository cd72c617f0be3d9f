"""Smoke run of the codec's main paths on one GPU, at production sizes.

Drives, in one process and through the entry points a user calls:

1. a card report (name and power limit, devices, JAX version, compile cache);
2. the headline decode, bench.py's path: (2040,1530), 8192-bit symbols,
   B=2048, PER 0.1406, first-k early stop; every decoded word is compared
   with the encoded input, and the steady-state rate is printed;
3. ``hybrid_decode`` with the Gauss-Jordan fallback firing, at PER 0.1875
   and 0.2031, B=1024; every non-failed frame must equal its codeword, and
   at 0.1875, with buckets that hold every residual, the ML fallback must
   decode every frame (at most one failure);
4. the GF(256) hybrid on the lifted (2040,1530) code, B=512, 1 KB symbols;
5. ``rs_decode_wide`` for RS(255,192), B=1024, 1 KB payloads, e = 1..63
   erasures that must all decode and one e=64 frame that must fail;
6. a few steps of the pattern-only FER campaign (``sim.run_fer_sweep``)
   with VALIDATION.md's configuration (256-column residual bucket), whose
   FER must lie in a Monte-Carlo band around VALIDATION.md's 4.72e-3 and
   whose erasure masks must equal the CPU's for the same key.

Every phase compares bit-exactly (the value arithmetic is GF(2)/GF(256) on
integers). Any failure exits non-zero and prints no result line. The last
line is ``{"ok": true, "device": {...}}``.

``--four`` runs only the four-card path instead: the sharded pattern-only
FER step on a 4-GPU ``data`` mesh compared with its four shard folds run
one after another on one card, then ``__graft_entry__.dryrun_multichip(4)``.

Run: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

# VALIDATION.md, (2040,1530) hybrid, PER 0.1875: FER 4.72e-3 with a
# 256-column residual bucket. Every one of those failures is a stopping set
# wider than the bucket; with a bucket that holds every residual the ML
# fallback decodes them all (PERF.md, PR 1), hence the 0.0 for phase 3.
HYBRID_FER_1875 = 4.72e-3
HYBRID_EMAX_1875 = 256


def _log(msg: str) -> None:
    print(msg, flush=True)


def fer_band(p: float, frames: int, sigmas: float = 5.0) -> tuple[float, float]:
    """Counts a binomial(frames, p) lands in with ~``sigmas`` sigma
    confidence (with a floor of one count each side for tiny means)."""
    mean = p * frames
    half = sigmas * math.sqrt(mean * (1 - p)) + 1
    return max(0.0, mean - half), mean + half


def card_report() -> str:
    """Print the card, JAX's devices, version and compile cache; return the
    card's name and power limit as nvidia-smi gives them."""
    from ldpc_erasure_codes_tpu.utils.cache import enable_persistent_cache

    try:
        card = subprocess.run(
            [
                "nvidia-smi",
                "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        card = f"nvidia-smi unavailable ({type(exc).__name__})"
    _log(f"card: {card}")
    _log(f"devices: {jax.devices()}")
    _log(f"jax {jax.__version__}; compile cache: {enable_persistent_cache()}")
    return card


def _wide_case(code, b: int, w: int, seed: int, gf_order: int = 2):
    """(arrays, codewords (B, n, W)) from a random source, encoded by the
    production encoder for the symbol type."""
    from ldpc_erasure_codes_tpu.ops import (
        device_arrays,
        encode_packed,
        make_packed_encoder,
    )

    arrays = device_arrays(code)
    key = jax.random.key(seed)
    if gf_order == 2:
        src = jax.random.bits(key, (b, code.k, w), dtype=jnp.uint32)
        return arrays, make_packed_encoder(code)(src)
    src = jax.random.bits(key, (b, code.k, w), dtype=jnp.uint8)
    return arrays, jax.jit(
        lambda s: encode_packed(arrays, s, gf_order=256)
    )(src)


def phase_headline(
    b: int = 2048, w: int = 256, per: float = 0.1406, reps: int = 10
) -> dict:
    """bench.py's step: channel, masking, the platform's wide peel with
    first-k early stop. Every known slot must equal the codeword and every
    still-erased slot must be zero."""
    from ldpc_erasure_codes_tpu import channel as ch
    from ldpc_erasure_codes_tpu.codes import get_code
    from ldpc_erasure_codes_tpu.ops.peel_wide import peel_decode_packed

    code = get_code("n2040_k1530")
    arrays, cw = _wide_case(code, b, w, seed=0)

    def decode(key, cw):
        mask = ch.iid_erasures(key, (b, code.n), per)
        recv = ch.apply_erasures(cw, mask)
        return peel_decode_packed(
            arrays, recv, mask, max_iters=50, early_stop_k=code.k
        )

    @jax.jit
    def step(key, cw):
        values, erased, iters = decode(key, cw)
        digest = jnp.bitwise_xor.reduce(
            jnp.bitwise_xor.reduce(values, axis=1), axis=0
        )
        return jnp.sum(erased[:, : code.k], dtype=jnp.int32), digest

    @jax.jit
    def check(key, cw):
        values, erased, _ = decode(key, cw)
        bad = jnp.where(erased[:, :, None], values != 0, values != cw)
        return (
            jnp.sum(bad, dtype=jnp.int32),
            jnp.sum(jnp.any(erased[:, : code.k], axis=1), dtype=jnp.int32),
        )

    key = jax.random.key(7)
    t0 = time.perf_counter()
    compiled = step.lower(key, cw).compile()
    compile_s = time.perf_counter() - t0
    _log(f"headline memory: {compiled.memory_analysis()}")
    jax.block_until_ready(compiled(jax.random.fold_in(key, 999), cw))
    t0 = time.perf_counter()
    out = None
    for i in range(reps):
        out = compiled(jax.random.fold_in(key, i), cw)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    mismatches = residual = 0
    for i in range(reps):
        bad, res = check(jax.random.fold_in(key, i), cw)
        mismatches += int(bad)
        residual += int(res)
    gbps = b * reps * code.k * 32 * w / dt / 1e9
    return {
        "ok": mismatches == 0,
        "frames": b * reps,
        "word_mismatches": mismatches,
        "frames_with_residual_in_k": residual,
        "compile_s": compile_s,
        "step_ms": dt / reps * 1e3,
        "gbps_info": gbps,
    }


def phase_hybrid(
    per: float,
    emax: int,
    ge_subbatch: int,
    *,
    b: int = 1024,
    w: int = 256,
    code_name: str = "n2040_k1530",
    gf_order: int = 2,
    fer_ref: float | None = None,
    seed: int = 3,
) -> dict:
    """``hybrid_decode`` at a GE-firing PER: frames reaching the GE, every
    non-failed frame equal to its codeword, failures by bucket overflow
    apart from genuine rank deficiency, and (with ``fer_ref``) the genuine
    failure count inside a Monte-Carlo band."""
    from ldpc_erasure_codes_tpu import channel as ch
    from ldpc_erasure_codes_tpu.codes import get_code
    from ldpc_erasure_codes_tpu.ops import hybrid_decode, peel_decode_mask

    code = get_code(code_name)
    arrays, cw = _wide_case(code, b, w, seed=seed, gf_order=gf_order)
    peel_iters = 10

    @jax.jit
    def run(key, cw):
        mask = ch.iid_erasures(key, (b, code.n), per)
        recv = ch.apply_erasures(cw, mask)
        values, erased, _, failed, overflow = hybrid_decode(
            arrays, recv, mask, gf_order=gf_order, peel_iters=peel_iters,
            emax=emax, ge_subbatch=ge_subbatch, return_overflow=True,
        )
        resid, _ = peel_decode_mask(arrays, mask, max_iters=peel_iters)
        ok = ~failed
        return (
            jnp.sum(jnp.any(resid, axis=1), dtype=jnp.int32),
            jnp.sum(failed, dtype=jnp.int32),
            jnp.sum(overflow, dtype=jnp.int32),
            jnp.sum(jnp.where(ok[:, None, None], values != cw, False),
                    dtype=jnp.int32),
            jnp.sum(erased & ok[:, None], dtype=jnp.int32),
        )

    key = jax.random.key(seed + 100)
    t0 = time.perf_counter()
    ge_frames, failed, overflow, bad, resid_ok = map(
        int, jax.block_until_ready(run(key, cw))
    )
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(run(key, cw))
    rec = {
        "per": per,
        "frames": b,
        "ge_frames": ge_frames,
        "failed": failed,
        "failed_by_bucket_overflow": overflow,
        "value_mismatches_on_solved": bad,
        "residual_on_solved": resid_ok,
        "compile_and_first_run_s": first_s,
        "step_ms": (time.perf_counter() - t0) * 1e3,
    }
    ok = bad == 0 and resid_ok == 0 and ge_frames > 0 and failed < b
    if fer_ref is not None:
        lo, hi = fer_band(fer_ref, b)
        rec["genuine_failure_band"] = [lo, hi]
        ok = ok and overflow == 0 and lo <= failed <= hi
    rec["ok"] = ok
    return rec


def phase_rs(b: int = 1024, wb: int = 1024) -> dict:
    """``rs_decode_wide`` RS(255,192): the verification battery's rs_wide
    tier at production batch and payload width."""
    from ldpc_erasure_codes_tpu.utils.verify import _tier, verify_rs

    rec = _tier("rs_wide", lambda: verify_rs(b=b, wb=wb))
    rec["ok"] = rec["status"] == "PASSED"
    return rec


def phase_sim(
    batch: int = 4096,
    steps_per_call: int = 8,
    calls: int = 2,
    per: float = 0.1875,
    fer_ref: float | None = HYBRID_FER_1875,
    emax: int = HYBRID_EMAX_1875,
    code_name: str = "n2040_k1530",
) -> dict:
    """A few calls of the user-facing pattern-only FER campaign; the masks
    it drew must equal the CPU's for the same keys."""
    from ldpc_erasure_codes_tpu import channel as ch
    from ldpc_erasure_codes_tpu.codes import get_code
    from ldpc_erasure_codes_tpu.sim import (
        ChannelConfig,
        DecoderConfig,
        SimConfig,
        run_fer_sweep,
    )

    code = get_code(code_name)
    cfg = SimConfig(
        code=code_name,
        batch=batch,
        channel=ChannelConfig(kind="iid", per=per),
        decoder=DecoderConfig(
            kind="hybrid", max_iters=50, emax=emax, ge_subbatch=batch // 8
        ),
        track_values=False,
        steps_per_call=steps_per_call,
    )
    # run_fer_sweep shards the batch over every visible device.
    ndev = len(jax.devices())
    frames = batch * steps_per_call * calls * ndev
    t0 = time.perf_counter()
    [pt] = run_fer_sweep(
        code, cfg, [per], target_errors=frames + 1, max_frames=frames
    )
    wall = time.perf_counter() - t0
    erased_dev = round(pt.measured_per * pt.frames * code.n)

    # The driver's keys: call i folds i into key(seed); on a mesh, device d
    # folds d into that; step j of a call folds j; the channel takes the
    # second half of that key's split.
    def masks(call: int) -> jax.Array:
        kc = jax.random.fold_in(jax.random.key(cfg.seed), call)
        dev_keys = (
            [jax.random.fold_in(kc, d) for d in range(ndev)]
            if ndev > 1 else [kc]
        )
        return jnp.stack([
            ch.iid_erasures(
                jax.random.split(jax.random.fold_in(kd, j))[1],
                (batch, code.n), jnp.float32(per),
            )
            for kd in dev_keys
            for j in range(steps_per_call)
        ])

    first = jax.jit(masks, static_argnums=0)(0)
    with jax.default_device(jax.devices("cpu")[0]):
        first_cpu = jax.jit(masks, static_argnums=0)(0)
        erased_cpu = sum(
            int(jnp.sum(masks(i), dtype=jnp.int32)) for i in range(calls)
        )
    same_bits = bool(np.array_equal(np.asarray(first), np.asarray(first_cpu)))
    rec = {
        "frames": pt.frames,
        "block_errors": pt.block_errors,
        "ml_failed": pt.ml_failed,
        "fer": pt.fer,
        "erased_symbols_device": erased_dev,
        "erased_symbols_cpu": erased_cpu,
        "first_call_masks_bit_equal_cpu": same_bits,
        "frames_per_sec": pt.frames_per_sec,
        "wall_s": wall,
    }
    ok = same_bits and erased_dev == erased_cpu and pt.frames == frames
    if fer_ref is not None:
        lo, hi = fer_band(fer_ref, pt.frames)
        rec["block_error_band"] = [lo, hi]
        ok = ok and lo <= pt.block_errors <= hi
    rec["ok"] = ok
    return rec


def phase_four(batch: int = 4096, per: float = 0.1875,
               code_name: str = "n2040_k1530") -> dict:
    """Sharded pattern-only hybrid step on a 4-device ``data`` mesh with
    psum'd SimStats, compared field by field with the four shard folds run
    one after another on one device and summed; then the multichip dry
    run."""
    import __graft_entry__
    from ldpc_erasure_codes_tpu.parallel import make_mesh, shard_sim_step
    from ldpc_erasure_codes_tpu.sim import DecoderConfig, SimConfig, make_sim_step

    devices = jax.devices()[:4]
    if len(devices) < 4:
        raise RuntimeError(f"--four needs 4 devices, found {len(devices)}")
    cfg = SimConfig(
        code=code_name,
        batch=batch,
        decoder=DecoderConfig(
            kind="hybrid", max_iters=50, emax=384, ge_subbatch=batch // 8
        ),
        track_values=False,
    )
    step = make_sim_step(code_name, cfg)
    mesh = make_mesh((4,), ("data",), devices)
    key, per_arr = jax.random.key(11), jnp.float32(per)
    t0 = time.perf_counter()
    sharded = jax.block_until_ready(shard_sim_step(step, mesh)(key, per_arr))
    sharded_s = time.perf_counter() - t0
    with jax.default_device(devices[0]):
        parts = [step(jax.random.fold_in(key, i), per_arr) for i in range(4)]
    summed = jax.tree.map(lambda *xs: sum(np.asarray(x) for x in xs), *parts)
    equal = all(
        np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(sharded, summed)
    )
    __graft_entry__.dryrun_multichip(4)
    return {
        "ok": equal and int(sharded.frames) == 4 * batch,
        "frames": int(sharded.frames),
        "block_errors": int(sharded.block_errors),
        "sharded_equals_summed_folds": equal,
        "sharded_first_call_s": sharded_s,
        "dryrun_multichip_4": "ok",
    }


def _phases(four: bool):
    if four:
        return [("four_card_sim", phase_four)]
    return [
        ("headline", phase_headline),
        ("hybrid_0.1875", lambda: phase_hybrid(0.1875, 384, 1024, fer_ref=0.0)),
        ("hybrid_0.2031", lambda: phase_hybrid(0.2031, 512, 448)),
        ("nb_hybrid", lambda: phase_hybrid(
            0.1875, 384, 512, b=512, w=1024,
            code_name="n2040_k1530_gf256", gf_order=256)),
        ("rs_wide", phase_rs),
        ("sim", phase_sim),
    ]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four", action="store_true",
        help="run only the four-card sharded FER path and its comparison",
    )
    args = ap.parse_args(argv)
    if jax.default_backend() != "gpu":
        print(
            f"chip_smoke.py needs a GPU; JAX found {jax.default_backend()}",
            file=sys.stderr,
        )
        return 2
    card = card_report()
    for name, fn in _phases(args.four):
        t0 = time.perf_counter()
        rec = fn()
        rec["phase"] = name
        rec["wall_s"] = time.perf_counter() - t0
        _log(json.dumps(rec))
        if not rec["ok"]:
            print(f"phase {name} FAILED", file=sys.stderr)
            return 1
    dev = jax.devices()[0]
    _log(card)
    _log(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
