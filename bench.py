"""Headline benchmark: LDPC erasure-decoder information throughput.

Reproduces the reference's headline measurement — the (2040, 1530) code at raw
PER 14.06% with 8192-bit packet symbols, decoder throughput in information
bits/s (S·frames·k/T) — on one GPU. Baseline: 36.3 Gbps on a Stratix 10
FPGA (Latex/Milcom_2022_ErasureCodes.tex:185; formula main.cpp:652-658).

Timed region matches the FPGA run(): erasure-pattern generation on device
(counter RNG, as decoder_top.cl:89-116), channel masking, and the peeling
decode with first-k early stop (decoder_perf_tests.cl:86-88,205-210).
Codewords are pre-encoded outside the loop (the FPGA decoder also receives
already-encoded frames). The decode is the platform's wide peel
(``ops.peel_wide.peel_decode_packed``).

The run needs a GPU and fails without one. ``BENCH_PLATFORM=cpu`` runs it
on the CPU instead (the test suite's contract check); the output always
names the device it ran on.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

BASELINE_GBPS = 36.3


def main() -> int:
    plat = os.environ.get("BENCH_PLATFORM")
    if plat:
        jax.config.update("jax_platforms", plat)
    elif jax.default_backend() != "gpu":
        print(
            f"bench.py needs a GPU; JAX found {jax.default_backend()}",
            file=sys.stderr,
        )
        return 1

    from ldpc_erasure_codes_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    from ldpc_erasure_codes_tpu import channel as ch
    from ldpc_erasure_codes_tpu.codes import get_code
    from ldpc_erasure_codes_tpu.ops import device_arrays, make_packed_encoder
    from ldpc_erasure_codes_tpu.ops.peel_wide import peel_decode_packed

    quick = "--quick" in sys.argv
    code = get_code("n2040_k1530")
    arrays = device_arrays(code)
    b = int(os.environ.get("BENCH_BATCH", "16" if quick else "2048"))
    w = int(os.environ.get("BENCH_WORDS", "256"))  # 256 x uint32 = 8192 bits = S
    per = float(os.environ.get("BENCH_PER", "0.1406"))
    reps = int(os.environ.get("BENCH_REPS", "5" if quick else "10"))
    symbol_bits = 32 * w

    key = jax.random.key(0)
    src = jax.random.bits(key, (b, code.k, w), dtype=jnp.uint32)
    cw = jax.block_until_ready(make_packed_encoder(code)(src))

    @jax.jit
    def step(key, cw):
        mask = ch.iid_erasures(key, (b, code.n), per)
        recv = ch.apply_erasures(cw, mask)
        values, erased, iters = peel_decode_packed(
            arrays, recv, mask, max_iters=50, early_stop_k=code.k
        )
        # Consume the decoded VALUES (not just the mask): mask evolution is
        # value-independent, so returning only residual counts lets XLA
        # dead-code-eliminate the whole wide-symbol decode.
        digest = jnp.bitwise_xor.reduce(
            jnp.bitwise_xor.reduce(values, axis=1), axis=0
        )
        return (
            jnp.sum(erased[:, : code.k], dtype=jnp.int32),
            jnp.max(iters),
            digest,
        )

    t_c = time.perf_counter()
    out = jax.block_until_ready(step(jax.random.fold_in(key, 999), cw))
    print(
        f"warmup: residual={int(out[0])} max_iters={int(out[1])} "
        f"compile+run={time.perf_counter() - t_c:.1f}s",
        file=sys.stderr,
    )

    t0 = time.perf_counter()
    for i in range(reps):
        out = step(jax.random.fold_in(key, i), cw)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0

    frames = b * reps
    fps = frames / dt
    gbps = fps * code.k * symbol_bits / 1e9
    print(
        f"frames={frames} time={dt:.3f}s fps={fps:.1f} "
        f"info={gbps:.2f} Gbps (S={symbol_bits} bits)",
        file=sys.stderr,
    )
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "ldpc_decode_throughput_n2040_k1530_per0.1406",
                "value": gbps,
                "unit": "Gbps_info",
                "vs_baseline": gbps / BASELINE_GBPS,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
