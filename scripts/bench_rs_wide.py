"""Wide-symbol RS tier: Gbps + the reference's decode-cost-vs-N_sys profile.

The reference profiles RS decode time against the number of systematic
symbols received (Matlab/ReedSolomonErasureCodes.m:83-91, stem plot
:115-119): its per-payload-byte Gauss-Jordan costs O(k (k - N_sys)^2). The
batched formulation (rs_decode_wide: one narrow pattern solve + bit-image
matmul apply) should be ~flat in N_sys and flat per payload byte — this
script measures both claims on the device.

Run: python scripts/bench_rs_wide.py
"""

from __future__ import annotations

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    from ldpc_erasure_codes_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    from ldpc_erasure_codes_tpu.ops import device_arrays
    from ldpc_erasure_codes_tpu.rs import rs_code, rs_decode_wide, rs_encode

    n, k = 255, 192
    code = rs_code(n, k)
    arrays = device_arrays(code)
    # 1 KB payloads (S = 8192 bits, the LDPC rows' S) by default.
    b = int(os.environ.get("RS_BATCH", "256"))
    wb = int(os.environ.get("RS_WB", "1024"))
    reps = 10
    key = jax.random.key(0)
    src = jax.random.bits(key, (b, k, wb), dtype=jnp.uint8)
    cw = jax.block_until_ready(rs_encode(arrays, src))

    @jax.jit
    def dec(mask, cw):
        recv = jnp.where(mask[:, :, None], jnp.uint8(0), cw)
        v, e, failed = rs_decode_wide(arrays, recv, mask)
        digest = jnp.bitwise_xor.reduce(
            jnp.bitwise_xor.reduce(v.astype(jnp.uint32), axis=1), axis=0
        )
        return digest, jnp.sum(failed), jnp.sum(e)

    # decode-cost-vs-N_sys profile: erase exactly e SYSTEMATIC symbols
    # (N_sys = k - e received systematic), repairs all present.
    print(f"RS({n},{k}) wide decode, B={b}, {wb}-byte payloads:", flush=True)
    for e in (4, 16, 32, 48, 63):
        mask_np = np.zeros((b, n), dtype=bool)
        rng = np.random.default_rng(e)
        for i in range(b):
            mask_np[i, rng.choice(k, size=e, replace=False)] = True
        mask = jnp.asarray(mask_np)
        out = jax.block_until_ready(dec(mask, cw))
        assert int(out[1]) == 0 and int(out[2]) == 0
        t0 = time.perf_counter()
        for _ in range(reps):
            out = dec(mask, cw)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        gbps = b * k * 8 * wb / dt / 1e9
        print(
            f"  N_sys={k - e:3d} (e={e:2d}): {dt * 1e3:7.2f} ms/batch "
            f"{gbps:7.1f} Gbps info  {b / dt:9.0f} cw/s",
            flush=True,
        )

    # i.i.d. channel at PER .15 (the round-1 scalar benchmark's setting).
    @jax.jit
    def dec_iid(kk, cw):
        from ldpc_erasure_codes_tpu import channel as ch

        mask = ch.iid_erasures(kk, (b, n), 0.15)
        recv = jnp.where(mask[:, :, None], jnp.uint8(0), cw)
        v, e, failed = rs_decode_wide(arrays, recv, mask)
        digest = jnp.bitwise_xor.reduce(
            jnp.bitwise_xor.reduce(v.astype(jnp.uint32), axis=1), axis=0
        )
        return digest, jnp.sum(failed)

    out = jax.block_until_ready(dec_iid(jax.random.fold_in(key, 9), cw))
    t0 = time.perf_counter()
    for i in range(reps):
        out = dec_iid(jax.random.fold_in(key, i), cw)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    gbps = b * k * 8 * wb / dt / 1e9
    print(
        f"  iid PER .15: {dt * 1e3:7.2f} ms/batch  {gbps:7.1f} Gbps info  "
        f"{b / dt:9.0f} cw/s  (failed {int(out[1])}/{b})",
        flush=True,
    )


if __name__ == "__main__":
    main()
