"""Stage anatomy of the wide-RS solver at the B=1024 / 1 KB point.

Times ge_solve_wide_nb's stages (narrow elimination, syndrome, apply and
scatter) separately, so a change to one stage is attributable. Each leg
consumes its outputs via digest.

Run: python scripts/bench_rs_stages.py  [env RS_BATCH / RS_WB / RS_E]
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

    from ldpc_erasure_codes_tpu import gf
    from ldpc_erasure_codes_tpu.ops import device_arrays
    from ldpc_erasure_codes_tpu.ops import ge as ge_mod
    from ldpc_erasure_codes_tpu.rs import rs_code, rs_decode_wide, rs_encode

    n, k = 255, 192
    code = rs_code(n, k)
    arrays = device_arrays(code)
    b = int(os.environ.get("RS_BATCH", "1024"))
    wb = int(os.environ.get("RS_WB", "1024"))
    e = int(os.environ.get("RS_E", "48"))
    m = n - k
    reps = 10
    key = jax.random.key(0)
    src = jax.random.bits(key, (b, k, wb), dtype=jnp.uint8)
    cw = jax.block_until_ready(rs_encode(arrays, src))
    del src

    mask_np = np.zeros((b, n), dtype=bool)
    rng = np.random.default_rng(e)
    for i in range(b):
        mask_np[i, rng.choice(k, size=e, replace=False)] = True
    mask = jnp.asarray(mask_np)
    recv = jax.block_until_ready(
        jax.jit(lambda m, c: jnp.where(m[:, :, None], jnp.uint8(0), c))(mask, cw)
    )

    def timed(name, fn, *args):
        out = jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        gbps = b * k * 8 * wb / dt / 1e9
        print(f"{name:28s} {dt * 1e3:8.2f} ms  ({gbps:6.1f} Gbps-equiv)",
              flush=True)
        return out, dt

    # Stage 1: narrow elimination (approximated by a 4-byte-payload
    # decode: the syndrome/apply shrink with W, the pattern solve does not —
    # and the script stays in sync with the production solver).
    @jax.jit
    def elim_only(values4, erased):
        v, e2, failed = rs_decode_wide(arrays, values4, erased)
        return jnp.sum(v.astype(jnp.uint32)), jnp.sum(failed)

    recv4 = jax.block_until_ready(jnp.array(recv[:, :, :4]))

    # Stage 2: syndrome only.
    @jax.jit
    def syndrome_only(values):
        h_img = ge_mod._bit_image_dev(jnp.transpose(arrays.h_nb))
        ub = gf.bytes_to_bits(jnp.transpose(values, (0, 2, 1)))
        acc = jax.lax.dot_general(
            ub, h_img,
            dimension_numbers=(((2,), (0,)), ((), ())),
            preferred_element_type=jnp.int8,
        )
        rhs = gf.bits_to_bytes(acc & 1)
        return jnp.sum(rhs.astype(jnp.uint32))

    # Full decode.
    @jax.jit
    def full(values, erased):
        v, e2, failed = rs_decode_wide(arrays, values, erased)
        digest = jnp.bitwise_xor.reduce(
            jnp.bitwise_xor.reduce(v.astype(jnp.uint32), axis=1), axis=0
        )
        return digest, jnp.sum(failed), jnp.sum(e2)

    print(f"RS({n},{k}) B={b} {wb}-byte payloads, e={e} erasures:", flush=True)
    _, t_el = timed("narrow GE (packed, W=4)", elim_only, recv4, mask)
    _, t_sy = timed("syndrome (int8 acc)", syndrome_only, recv)
    out, t_full = timed("full rs_decode_wide", full, recv, mask)
    assert int(out[1]) == 0 and int(out[2]) == 0
    print(
        f"apply+scatter (residual)     {max(t_full - t_el - t_sy, 0) * 1e3:8.2f} ms",
        flush=True,
    )


if __name__ == "__main__":
    main()
