"""The wide peel on the card: the Triton replay kernel against XLA's sweeps.

Times bench.py's step (channel, masking, wide peel with first-k early stop,
value digest) with the decode done by ``peel_decode_replay`` and by
``peel_decode_wide``, in turns (xla, kernel, kernel, xla, ...) within one
process, at the headline shape and at the GF(256) shape; then the
kernel path's parts (the mask-side schedule alone, the masking pass alone).
Checks that both decodes give identical values, masks and iteration counts.
One JSON line per measurement, each naming the card and its power limit.

Run: python scripts/bench_peel_kernel.py   (needs a GPU)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def _median_ms(fn, args, reps: int) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[len(ts) // 2]


def run_shape(code_name: str, b: int, w: int, per: float, card: str,
              rounds: int = 3, reps: int = 5) -> None:
    from ldpc_erasure_codes_tpu import channel as ch
    from ldpc_erasure_codes_tpu.codes import get_code
    from ldpc_erasure_codes_tpu.ops import device_arrays, encode_packed
    from ldpc_erasure_codes_tpu.ops.peel_replay import (
        peel_decode_replay,
        peel_schedule,
    )
    from ldpc_erasure_codes_tpu.ops.peel_wide import peel_decode_wide

    code = get_code(code_name)
    arrays = device_arrays(code)
    gf_order = code.gf_order
    dtype = jnp.uint32 if gf_order == 2 else jnp.uint8
    src = jax.random.bits(jax.random.key(0), (b, code.k, w), dtype=dtype)
    cw = jax.jit(lambda s: encode_packed(arrays, s, gf_order=gf_order))(src)
    kw = dict(max_iters=50, early_stop_k=code.k, gf_order=gf_order)

    def make(decode):
        @jax.jit
        def step(key, cw):
            mask = ch.iid_erasures(key, (b, code.n), per)
            v, e, it = decode(arrays, ch.apply_erasures(cw, mask), mask, **kw)
            d = jnp.bitwise_xor.reduce(jnp.bitwise_xor.reduce(v, axis=1), axis=0)
            return d, jnp.sum(e[:, : code.k]), jnp.max(it)
        return step

    steps = {"xla": make(peel_decode_wide), "kernel": make(peel_decode_replay)}

    @jax.jit
    def same(key, cw):
        mask = ch.iid_erasures(key, (b, code.n), per)
        recv = ch.apply_erasures(cw, mask)
        a = peel_decode_wide(arrays, recv, mask, **kw)
        k = peel_decode_replay(arrays, recv, mask, **kw)
        return sum(jnp.sum(x != y) for x, y in zip(a, k))

    @jax.jit
    def schedule_only(key):
        mask = ch.iid_erasures(key, (b, code.n), per)
        out = peel_schedule(arrays, mask, max_iters=50, early_stop_k=code.k)
        return [jnp.sum(x) for x in out]

    @jax.jit
    def mask_only(key, cw):
        mask = ch.iid_erasures(key, (b, code.n), per)
        v = ch.apply_erasures(cw, mask)
        return jnp.bitwise_xor.reduce(jnp.bitwise_xor.reduce(v, axis=1), axis=0)

    key = jax.random.key(5)
    compile_s = {}
    for name, st in steps.items():
        t0 = time.perf_counter()
        jax.block_until_ready(st(key, cw))
        compile_s[name] = time.perf_counter() - t0
    times = {"xla": [], "kernel": []}
    for r in range(rounds):
        order = ["xla", "kernel"] if r % 2 == 0 else ["kernel", "xla"]
        for name in order + order[::-1]:
            times[name].append(_median_ms(steps[name], (key, cw), reps))
    mismatches = int(same(key, cw))
    jax.block_until_ready(schedule_only(key))
    jax.block_until_ready(mask_only(key, cw))
    info_bits = b * code.k * (32 if gf_order == 2 else 8) * w
    for name, ts in times.items():
        med = sorted(ts)[len(ts) // 2]
        print(json.dumps({
            "shape": f"{code_name} B={b} W={w} per={per}",
            "decode": name,
            "step_ms_median": med,
            "step_ms_all": ts,
            "gbps_info": info_bits / med / 1e6,
            "compile_and_first_run_s": compile_s[name],
            "mismatches_kernel_vs_xla": mismatches,
            "card": card,
        }), flush=True)
    print(json.dumps({
        "shape": f"{code_name} B={b} W={w} per={per}",
        "kernel_parts_ms": {
            "schedule": _median_ms(schedule_only, (key,), reps),
            "channel_and_masking": _median_ms(mask_only, (key, cw), reps),
        },
        "card": card,
    }), flush=True)


def main() -> int:
    if jax.default_backend() != "gpu":
        print("needs a GPU", file=sys.stderr)
        return 1
    card = _card()
    run_shape("n2040_k1530", 2048, 256, 0.1406, card)
    run_shape("n2040_k1530_gf256", 512, 1024, 0.1406, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
