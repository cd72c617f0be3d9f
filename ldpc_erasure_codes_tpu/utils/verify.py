"""PASSED/FAILED verification battery for the production decode tiers.

The reference never reports a throughput without bit-exact hardware
verification in the same run: its host harness decodes on the device,
compares every output word against the golden vectors, and prints
PASSED/FAILED (OpenCL/host/src/main.cpp:298-305,413-425). This module is
that contract: every production decode tier runs end to end on the default
device — encode -> channel -> decode — through the same entry points users
call, and its decoded values and masks are checked bit-exactly against the
encoded input, the plain XLA reference and the NumPy oracle.

Tiers:
  binary_peel  the platform's wide peel (ops/peel_wide.peel_decode_packed)
  nb_peel      the same over GF(256) byte symbols
  hybrid_ge    peel + GE at a GE-firing PER (every non-failed frame must
               reproduce its codeword exactly)
  rs_wide      RS(255,192) wide decode across e = 1..63 erasures in one
               batch, plus an e=64 frame that must flag failed (MDS bound)

Each tier yields one JSON-able record with status PASSED/FAILED.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np


def _tier(name: str, fn: Callable[[], dict]) -> dict:
    t0 = time.perf_counter()
    try:
        detail = fn()
        status = "PASSED" if detail.pop("_ok") else "FAILED"
    except Exception as exc:  # noqa: BLE001 — a crash is a FAILED tier
        detail = {"error": f"{type(exc).__name__}: {exc}"}
        status = "FAILED"
    return {
        "tier": name,
        "status": status,
        "elapsed_s": round(time.perf_counter() - t0, 2),
        **detail,
    }


def _small_code():
    # --quick shapes: a small generated code exercises the same paths.
    from ldpc_erasure_codes_tpu.codes import gen_row_wise

    return gen_row_wise(
        [(16, 6)], [(48, 2)], seed=3, max_tries=40, strict_tries=4
    )


def _case(code, b: int, w: int, per: float, seed: int, gf_order: int = 2):
    """Random source -> codewords (B, n, W) and an i.i.d. erasure mask."""
    import jax
    import jax.numpy as jnp

    from ldpc_erasure_codes_tpu.ops import device_arrays, encode_packed

    arrays = device_arrays(code)
    key = jax.random.key(seed)
    dtype = jnp.uint32 if gf_order == 2 else jnp.uint8
    src = jax.random.bits(key, (b, code.k, w), dtype=dtype)
    cw = encode_packed(arrays, src, gf_order=gf_order)
    mask = jax.random.uniform(jax.random.fold_in(key, 1), (b, code.n)) < per
    return arrays, cw, mask


def verify_peel(
    code=None,
    *,
    gf_order: int = 2,
    b: int = 64,
    w: int = 256,
    per: float = 0.1406,
    n_oracle: int = 8,
) -> dict:
    """Full (no early stop) wide peel through ``peel_decode_packed``:
    resolved slots equal the codeword, erased slots hold zero, values, mask
    and iterations equal ``peel_decode_wide``, and the mask equals the
    oracle's fixed point on the first ``n_oracle`` frames."""
    import jax.numpy as jnp

    from ldpc_erasure_codes_tpu.codes import get_code
    from ldpc_erasure_codes_tpu.ops.peel_wide import (
        peel_decode_packed,
        peel_decode_wide,
    )
    from ldpc_erasure_codes_tpu.utils import oracle

    if code is None:
        code = get_code("n2040_k1530" if gf_order == 2 else "n2040_k1530_gf256")
    arrays, cw, mask = _case(code, b, w, per, seed=11, gf_order=gf_order)
    recv = jnp.where(mask[:, :, None], jnp.zeros((), cw.dtype), cw)
    kw = dict(max_iters=50, gf_order=gf_order)
    out = peel_decode_packed(arrays, recv, mask, **kw)
    ref = peel_decode_wide(arrays, recv, mask, **kw)
    ref_bad = sum(int(jnp.sum(a != r)) for a, r in zip(out, ref))
    v, e, _ = map(np.asarray, out)
    cw, mask = np.asarray(cw), np.asarray(mask)
    val_bad = int((np.where(e[:, :, None], 0, v) != np.where(
        e[:, :, None], 0, cw
    )).sum())
    zero_bad = int((v[e] != 0).sum())
    mask_bad = 0
    for f in range(min(b, n_oracle)):
        sym = cw[f, :, 0].astype(np.int64)
        if gf_order == 2:
            recv_f = np.where(mask[f], oracle.ERASED, sym & 1)
            o_out, _ = oracle.peel_decode(code, recv_f)
        else:
            recv_f = np.where(mask[f], oracle.ERASED, sym)
            o_out, _ = oracle.peel_decode_nb(code, recv_f)
        mask_bad += int(((o_out == oracle.ERASED) != e[f]).sum())
    return {
        "_ok": val_bad == 0 and zero_bad == 0 and mask_bad == 0
        and ref_bad == 0,
        "frames": b,
        "value_mismatches": val_bad,
        "erased_nonzero": zero_bad,
        "oracle_mask_mismatches": mask_bad,
        "reference_mismatches": ref_bad,
    }


def verify_hybrid(
    code=None,
    *,
    gf_order: int = 2,
    b: int = 64,
    w: int = 256,
    per: float = 0.1875,
    emax: int = 192,
    ge_subbatch: int = 64,
    peel_iters: int = 10,
) -> dict:
    """Hybrid peel + GE at a GE-firing PER through ``hybrid_decode``: every
    non-failed frame must reproduce its codeword bit-exactly, and some
    frames must have reached the GE."""
    import jax.numpy as jnp

    from ldpc_erasure_codes_tpu.codes import get_code
    from ldpc_erasure_codes_tpu.ops import hybrid_decode, peel_decode_mask

    if code is None:
        code = get_code("n2040_k1530" if gf_order == 2 else "n2040_k1530_gf256")
    arrays, cw, mask = _case(code, b, w, per, seed=31, gf_order=gf_order)
    # Mask evolution is value-independent: the mask-only peel tells exactly
    # which frames the peeler leaves stuck, i.e. how many frames the GE
    # tier decodes in this run.
    resid, _ = peel_decode_mask(arrays, mask, max_iters=peel_iters)
    ge_frames = int(jnp.sum(jnp.any(resid, axis=1)))
    recv = jnp.where(mask[:, :, None], jnp.zeros((), cw.dtype), cw)
    v, e, _, failed = hybrid_decode(
        arrays, recv, mask, gf_order=gf_order, peel_iters=peel_iters,
        emax=emax, ge_subbatch=ge_subbatch,
    )
    ok_f = ~failed
    val_bad = int(jnp.sum(jnp.where(ok_f[:, None, None], v != cw, False)))
    mask_bad = int(jnp.sum(e & ok_f[:, None]))
    return {
        "_ok": val_bad == 0 and mask_bad == 0 and bool(jnp.any(ok_f))
        and ge_frames > 0,
        "frames": b,
        "ge_frames": ge_frames,
        "failed_frames": int(jnp.sum(failed)),
        "value_mismatches": val_bad,
        "residual_on_solved": mask_bad,
    }


def verify_rs(*, b: int = 64, wb: int = 1024) -> dict:
    """RS(255,192) wide decode, e spread over 1..63 across the batch + one
    frame at e = 64 that must flag failed (the MDS bound)."""
    import jax
    import jax.numpy as jnp

    from ldpc_erasure_codes_tpu.ops import device_arrays
    from ldpc_erasure_codes_tpu.rs import rs_code, rs_decode_wide, rs_encode

    code = rs_code(255, 192)
    arrays = device_arrays(code)
    key = jax.random.key(41)
    src = jax.random.bits(key, (b, code.k, wb), dtype=jnp.uint8)
    cw = rs_encode(arrays, src)
    rng = np.random.default_rng(5)
    mask = np.zeros((b, code.n), bool)
    want_fail = np.zeros(b, bool)
    for f in range(b):
        # e spreads over 1..63 (full coverage at b >= 64); the last frame
        # carries 64, beyond the MDS bound, and must flag failed.
        e = 1 + (f * 62) // max(b - 2, 1) if f < b - 1 else 64
        mask[f, rng.choice(code.n, e, replace=False)] = True
        want_fail[f] = e > code.n - code.k
    mask = jnp.asarray(mask)
    recv = jnp.where(mask[:, :, None], jnp.uint8(0), cw)
    v, _, failed = rs_decode_wide(arrays, recv, mask)
    flag_bad = int(np.sum(np.asarray(failed) != want_fail))
    val_bad = int(jnp.sum(jnp.where(~failed[:, None, None], v != cw, False)))
    return {
        "_ok": val_bad == 0 and flag_bad == 0,
        "frames": b,
        "erasures": f"spread 1..63 over {b - 1} frames + one 64 (must fail)",
        "value_mismatches": val_bad,
        "failure_flag_mismatches": flag_bad,
    }


def run_battery(*, quick: bool = False) -> list[dict]:
    """Run every tier; returns the list of records."""
    if quick:
        from ldpc_erasure_codes_tpu.codes import toy_code

        small = _small_code()
        nb = toy_code(n=96, k=64, seed=3, gf_order=256)
        bin_kw = dict(code=small, b=16, w=2, per=0.25)
        nb_kw = dict(code=nb, gf_order=256, b=8, w=8, per=0.12, n_oracle=4)
        hy_kw = dict(code=small, b=16, w=2, per=0.25, emax=16, ge_subbatch=16)
        rs_kw = dict(b=16, wb=8)
    else:
        bin_kw, nb_kw, hy_kw, rs_kw = {}, dict(gf_order=256, w=1024), {}, {}
    tiers = [
        ("binary_peel", lambda: verify_peel(**bin_kw)),
        ("nb_peel", lambda: verify_peel(**nb_kw)),
        ("hybrid_ge", lambda: verify_hybrid(**hy_kw)),
        ("rs_wide", lambda: verify_rs(**rs_kw)),
    ]
    return [_tier(name, fn) for name, fn in tiers]
