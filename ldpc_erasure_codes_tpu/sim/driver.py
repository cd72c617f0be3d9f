"""End-to-end Monte-Carlo FER simulation driver.

Batched re-design of the reference's simulation loops
(Matlab/LDPCErasureCodes_MessagePassingAlgSim.m:134-243 binary,
Matlab/ErasureCodes_NonBinaryLDPCSim.m:154-243 GF(256),
OpenCL host run() + on-device data_in/data_out,
OpenCL/host/src/main.cpp:555-659): encode → channel → decode → counters, one
jitted step per batch, batch sharded over the device mesh, error-count-
targeted stopping on the host (reference stops at >=1000 errors or 1e6
trials, MessagePassingAlgSim.m:141).

The channel operating point (PER) is a *traced* argument so one compilation
serves a whole FER sweep.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import jax
import jax.numpy as jnp

from ldpc_erasure_codes_tpu import channel as ch
from ldpc_erasure_codes_tpu.codes import get_code, LDPCCode
from ldpc_erasure_codes_tpu.ops import (
    CodeArrays,
    device_arrays,
    encode,
    encode_nb,
    encode_packed,
)
from ldpc_erasure_codes_tpu.ops.compact import compact_ge_rank
from ldpc_erasure_codes_tpu.ops.ge import ge_rank_check, ge_solve
from ldpc_erasure_codes_tpu.ops.hybrid import hybrid_decode
from ldpc_erasure_codes_tpu.ops.peel import peel_decode, peel_decode_mask
from ldpc_erasure_codes_tpu.ops.peel_wide import peel_decode_packed
from ldpc_erasure_codes_tpu.parallel import default_mesh, shard_sim_step
from ldpc_erasure_codes_tpu.sim.config import SimConfig
from ldpc_erasure_codes_tpu.sim.stats import Accumulator, SimStats, batch_stats


def _draw_source(key: jax.Array, cfg: SimConfig, k: int) -> jax.Array:
    w = cfg.symbol_words
    if cfg.gf_order == 2:
        if w == 0:
            return jax.random.bits(key, (cfg.batch, k), dtype=jnp.uint8) & 1
        return jax.random.bits(key, (cfg.batch, k, w), dtype=jnp.uint32)
    if w == 0:
        return jax.random.bits(key, (cfg.batch, k), dtype=jnp.uint8)
    return jax.random.bits(key, (cfg.batch, k, w), dtype=jnp.uint8)


def _encode(arrays: CodeArrays, cfg: SimConfig, source: jax.Array) -> jax.Array:
    if cfg.symbol_words > 0:
        return encode_packed(arrays, source, gf_order=cfg.gf_order)
    if cfg.gf_order == 2:
        return encode(arrays, source)
    return encode_nb(arrays, source)


def _erasure_mask(key: jax.Array, cfg: SimConfig, n: int, per: jax.Array) -> jax.Array:
    c = cfg.channel
    if c.kind == "iid":
        return ch.iid_erasures(key, (cfg.batch, n), per)
    if c.kind == "per64":
        return ch.iid_erasures_per64(key, (cfg.batch, n), per.astype(jnp.uint32))
    params = ch.GilbertElliottParams(c.ge_alpha, c.ge_beta, c.ge_transition, c.ge_bias)
    if c.carry_state:
        # Statistically equivalent to the reference's carrying the Markov
        # state across codewords (ErasureCodes_NonBinaryLDPCSim.m:191-198):
        # start each codeword's chain in the steady-state distribution.
        ks, kc = jax.random.split(key)
        p_bad = (1.0 / c.ge_bias) / (1.0 + 1.0 / c.ge_bias)
        init = (jax.random.uniform(ks, (cfg.batch,)) < p_bad).astype(jnp.int32)
    else:
        kc = key
        init = None
    mask, _ = ch.gilbert_elliott_erasures(kc, cfg.batch, n, params, init)
    return mask


def _decode(
    arrays: CodeArrays, cfg: SimConfig, values: jax.Array, erased: jax.Array,
    k: int,
):
    d = cfg.decoder
    early = k if d.early_stop_k else None
    if d.kind == "peel":
        if values.ndim == 3 and d.impl == "gather":
            v, e, iters = peel_decode_packed(
                arrays, values, erased, max_iters=d.max_iters,
                early_stop_k=early, gf_order=cfg.gf_order,
            )
        else:
            v, e, iters = peel_decode(
                arrays, values, erased, gf_order=cfg.gf_order,
                max_iters=d.max_iters, early_stop_k=early, impl=d.impl,
            )
        return v, e, iters, None, None
    if d.kind == "hybrid":
        v, e, iters, failed, overflow = hybrid_decode(
            arrays,
            values,
            erased,
            gf_order=cfg.gf_order,
            peel_iters=d.peel_iters,
            emax=d.emax,
            impl=d.impl,
            ge_subbatch=d.ge_subbatch,
            return_overflow=True,
        )
        return v, e, iters, failed, overflow
    v, e, failed = ge_solve(
        arrays, values, erased, emax=d.emax, gf_order=cfg.gf_order
    )
    ov = jnp.sum(erased, axis=1) > min(d.emax, erased.shape[1])
    return v, e, jnp.zeros(erased.shape[0], jnp.int32), failed, ov


def _decode_mask(arrays: CodeArrays, cfg: SimConfig, erased: jax.Array, k: int):
    """Pattern-only decode: residual mask + iterations + GE-failure flag."""
    d = cfg.decoder
    early = k if d.early_stop_k else None
    if d.kind == "peel":
        e, iters = peel_decode_mask(
            arrays, erased, max_iters=d.max_iters, early_stop_k=early
        )
        return e, iters, None, None
    if d.kind == "hybrid":
        # Peel to convergence before the rank check: ML solvability is
        # invariant to how much peeling precedes the elimination (peeling is
        # partial elimination of the same system), so this gives the same
        # FER as the reference's peel-10-then-GE at a far smaller residual.
        # Caveat: the invariance covers *solvability*, not the emax /
        # ge_subbatch bucket-overflow flags — the value path eliminates after
        # only d.peel_iters, so its residuals are larger and overflow can
        # bind earlier there. Pattern-only and value-mode FER are identical
        # only at operating points where no residual nears emax/ge_subbatch
        # (all VALIDATION.md campaigns check the overflow counters are zero).
        e, iters = peel_decode_mask(arrays, erased, max_iters=d.max_iters)

        def rank(er):
            if d.ge_subbatch > 0:
                return compact_ge_rank(
                    arrays, er, emax=d.emax, f_max=d.ge_subbatch,
                    gf_order=cfg.gf_order,
                )
            return ge_rank_check(arrays, er, emax=d.emax, gf_order=cfg.gf_order)

        failed = jax.lax.cond(
            jnp.any(e),
            rank,
            lambda er: jnp.zeros(er.shape[0], bool),
            e,
        )
        ov = jnp.sum(e, axis=1) > min(d.emax, e.shape[1])
        if d.ge_subbatch > 0:
            from ldpc_erasure_codes_tpu.ops.compact import residual_order

            _, _, frame_ov = residual_order(e, d.ge_subbatch)
            ov = ov | frame_ov
        return e & failed[:, None], iters, failed, ov
    failed = ge_rank_check(arrays, erased, emax=d.emax, gf_order=cfg.gf_order)
    ov = jnp.sum(erased, axis=1) > min(d.emax, erased.shape[1])
    return (
        erased & failed[:, None],
        jnp.zeros(erased.shape[0], jnp.int32),
        failed,
        ov,
    )


def make_sim_step(
    code: LDPCCode | str, cfg: SimConfig
) -> Callable[[jax.Array, jax.Array], SimStats]:
    """Build the jitted per-batch simulation step ``step(key, per) -> SimStats``.

    ``per`` is the erasure probability (iid) or the /64 numerator (per64);
    ignored for the Gilbert-Elliott channel (its point lives in the config).
    """
    if isinstance(code, str):
        code = get_code(code)
    if cfg.gf_order == 256 and code.gf_order != 256:
        code = code.lift_to_gf256(seed=cfg.seed)
    arrays = device_arrays(code)
    n, k = code.n, code.k
    rs_n, rs_k = code.rs_n, code.rs_k
    max_hist = cfg.decoder.max_iters if cfg.decoder.kind == "peel" else cfg.decoder.peel_iters

    def step_once(key: jax.Array, per: jax.Array) -> SimStats:
        k_src, k_ch = jax.random.split(key)
        mask = _erasure_mask(k_ch, cfg, n, per)
        if cfg.track_values:
            source = _draw_source(k_src, cfg, k)
            cw = _encode(arrays, cfg, source)
            recv = ch.apply_erasures(cw, mask)
            _, e_out, iters, failed, overflow = _decode(
                arrays, cfg, recv, mask, k
            )
        else:
            e_out, iters, failed, overflow = _decode_mask(arrays, cfg, mask, k)
        return batch_stats(
            mask, e_out, iters, failed, k, rs_n, rs_k, max_hist,
            count_all_symbols=cfg.decoder.count_all_symbols,
            overflow=overflow,
        )

    if cfg.steps_per_call <= 1:
        return jax.jit(step_once)

    @jax.jit
    def step(key: jax.Array, per: jax.Array) -> SimStats:
        def body(acc, i):
            s = step_once(jax.random.fold_in(key, i), per)
            return jax.tree.map(jnp.add, acc, s), None

        shapes = jax.eval_shape(step_once, key, per)
        zero = jax.tree.map(lambda sd: jnp.zeros(sd.shape, sd.dtype), shapes)
        acc, _ = jax.lax.scan(
            body, zero, jnp.arange(cfg.steps_per_call, dtype=jnp.uint32)
        )
        return acc

    return step


@dataclasses.dataclass
class FERPoint:
    """One operating point of a FER sweep (one row of the paper's Table I,
    Latex/Milcom_2022_ErasureCodes.tex:195-210)."""

    per: float
    frames: int
    block_errors: int
    rs_block_errors: int
    fer: float
    rs_fer: float
    measured_per: float
    mean_iters: float
    ml_failed: int
    seconds: float
    frames_per_sec: float
    info_gbps: float


def symbol_bits(cfg: SimConfig) -> int:
    if cfg.symbol_words == 0:
        return 1 if cfg.gf_order == 2 else 8
    return cfg.symbol_words * (32 if cfg.gf_order == 2 else 8)


def run_fer_point(
    code: LDPCCode | str,
    cfg: SimConfig,
    per: float,
    *,
    target_errors: int = 100,
    max_frames: int = 1_000_000,
    mesh=None,
    step=None,
    warmup: bool = True,
) -> FERPoint:
    """Simulate one operating point with error-count-targeted stopping.

    When ``mesh`` is given (or more than one device is visible) the batch is
    sharded over it via shard_map and counters psum-reduce across devices.
    """
    if isinstance(code, str):
        code = get_code(code)
    if step is None:
        step = make_sim_step(code, cfg)
        if mesh is None and len(jax.devices()) > 1:
            mesh = default_mesh()
        if mesh is not None:
            step = shard_sim_step(step, mesh)
    per_arr = (
        jnp.asarray(per, jnp.float32)
        if cfg.channel.kind != "per64"
        else jnp.asarray(int(round(per * 64)), jnp.uint32)
    )
    key = jax.random.key(cfg.seed)
    acc = Accumulator()
    ndev = mesh.devices.size if mesh is not None else 1
    if warmup:
        jax.block_until_ready(step(jax.random.fold_in(key, 0xFFFFFFF), per_arr))
    t0 = time.perf_counter()
    i = 0
    while acc.frames < max_frames and acc.block_errors < target_errors:
        stats = step(jax.random.fold_in(key, i), per_arr)
        acc.add(jax.tree.map(jax.device_get, stats))
        i += 1
    dt = time.perf_counter() - t0
    sb = symbol_bits(cfg)
    fps = acc.frames / dt if dt > 0 else 0.0
    return FERPoint(
        per=float(per),
        frames=acc.frames,
        block_errors=acc.block_errors,
        rs_block_errors=acc.rs_block_errors,
        fer=acc.fer,
        rs_fer=acc.rs_fer,
        measured_per=acc.erased_symbols / max(acc.frames * code.n, 1),
        mean_iters=acc.mean_iters,
        ml_failed=acc.ml_failed,
        seconds=dt,
        frames_per_sec=fps,
        info_gbps=fps * code.k * sb / 1e9,
    )


def run_fer_sweep(
    code: LDPCCode | str,
    cfg: SimConfig,
    pers: list[float],
    *,
    target_errors: int = 100,
    max_frames: int = 1_000_000,
    mesh=None,
) -> list[FERPoint]:
    """Sweep PER operating points reusing one compiled step."""
    if isinstance(code, str):
        code = get_code(code)
    step = make_sim_step(code, cfg)
    if mesh is None and len(jax.devices()) > 1:
        mesh = default_mesh()
    if mesh is not None:
        step = shard_sim_step(step, mesh)
    return [
        run_fer_point(
            code,
            cfg,
            p,
            target_errors=target_errors,
            max_frames=max_frames,
            mesh=mesh,
            step=step,
        )
        for p in pers
    ]


def format_report(code_name: str, cfg: SimConfig, points: list[FERPoint]) -> str:
    """Render a sweep as the paper's Table-I format
    (Latex/Milcom_2022_ErasureCodes.tex:195-210)."""
    lines = [
        f"# FER sweep — code={code_name} gf={cfg.gf_order} decoder={cfg.decoder.kind} "
        f"channel={cfg.channel.kind} batch={cfg.batch} symbol_bits={symbol_bits(cfg)}",
        f"{'PER':>8} {'frames':>12} {'errs':>7} {'FER':>10} {'RS FER':>10} "
        f"{'meas PER':>9} {'iters':>6} {'fps':>12} {'Gbps':>8}",
    ]
    for p in points:
        lines.append(
            f"{p.per:8.4f} {p.frames:12d} {p.block_errors:7d} {p.fer:10.3e} "
            f"{p.rs_fer:10.3e} {p.measured_per:9.4f} {p.mean_iters:6.2f} "
            f"{p.frames_per_sec:12.1f} {p.info_gbps:8.3f}"
        )
    return "\n".join(lines)
