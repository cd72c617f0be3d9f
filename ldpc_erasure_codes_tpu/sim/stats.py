"""Monte-Carlo statistics: the replacement for the FPGA's ERROR_STAT
channel (OpenCL/device/ldpc_erasure_decoder_top.cl:46-55,124-158) and the
MATLAB sims' FER bookkeeping (LDPCErasureCodes_MessagePassingAlgSim.m:214-236).

All fields are summable int32 device scalars/vectors; the host driver
accumulates them into Python ints across batches (no overflow at 1e8+ frames).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp


class SimStats(NamedTuple):
    """Per-batch counters (psum-reducible pytree)."""

    frames: jax.Array  # () int32
    block_errors: jax.Array  # () int32 — residual erasure among first k
    rs_block_errors: jax.Array  # () int32 — failing RS windows (per window!)
    rs_blocks: jax.Array  # () int32 — RS windows scored (frames * n/rs_n)
    ml_failed: jax.Array  # () int32 — singular/overflow GE frames
    escalations: jax.Array  # () int32 — frames needing bucket escalation
    #   (residual > emax or spilled past the ge_subbatch frame bucket —
    #   the frames hybrid_decode_escalated would re-dispatch.)
    erased_symbols: jax.Array  # () int32 — channel erasures (measured PER)
    residual_erasures: jax.Array  # () int32 — erasures left after decode
    iters_hist: jax.Array  # (max_iters + 1,) int32 — iterations to finish


def batch_stats(
    erased_in: jax.Array,
    erased_out: jax.Array,
    iters: jax.Array,
    failed: jax.Array | None,
    k: int,
    rs_n: int,
    rs_k: int,
    max_iters: int,
    count_all_symbols: bool = False,
    overflow: jax.Array | None = None,
) -> SimStats:
    """Fold one decoded batch into counters.

    Block error = any information symbol (first k) still erased — the FPGA
    counts residual erasures the same way
    (OpenCL/device/ldpc_erasure_decoder_perf_tests.cl:215-228).

    RS comparison needs no RS decoder: by the MDS property a rate-matched
    RS(rs_n, rs_k) block fails iff its window holds more than rs_n - rs_k
    erasures (paper Latex/Milcom_2022_ErasureCodes.tex:220; inline comparison
    at decoder_perf_tests.cl:64-81). Errors are counted and normalized *per
    RS window*, matching the reference's accounting
    (MessagePassingAlgSim.m:199-205, :240 — P_block_RS divides by
    ceil(n/n_RS)*trials).
    """
    b, n = erased_in.shape
    scope = erased_out if count_all_symbols else erased_out[:, :k]
    blk = jnp.any(scope, axis=1)
    if rs_n > 0 and n % rs_n == 0:
        nwin = n // rs_n
        wins = erased_in.reshape(b, nwin, rs_n)
        cnt = jnp.sum(wins, axis=2, dtype=jnp.int32)
        rs_errs = jnp.sum(cnt > (rs_n - rs_k), dtype=jnp.int32)
        rs_blocks = jnp.int32(b * nwin)
    else:
        rs_errs = jnp.int32(0)
        rs_blocks = jnp.int32(0)
    hist = jnp.zeros((max_iters + 1,), jnp.int32).at[
        jnp.clip(iters, 0, max_iters)
    ].add(1)
    nfail = (
        jnp.sum(failed, dtype=jnp.int32) if failed is not None else jnp.int32(0)
    )
    nesc = (
        jnp.sum(overflow, dtype=jnp.int32)
        if overflow is not None
        else jnp.int32(0)
    )
    return SimStats(
        frames=jnp.int32(b),
        block_errors=jnp.sum(blk, dtype=jnp.int32),
        rs_block_errors=rs_errs,
        rs_blocks=rs_blocks,
        ml_failed=nfail,
        escalations=nesc,
        erased_symbols=jnp.sum(erased_in, dtype=jnp.int32),
        residual_erasures=jnp.sum(erased_out, dtype=jnp.int32),
        iters_hist=hist,
    )


@dataclasses.dataclass
class Accumulator:
    """Host-side accumulation of SimStats across batches (Python ints)."""

    frames: int = 0
    block_errors: int = 0
    rs_block_errors: int = 0
    rs_blocks: int = 0
    ml_failed: int = 0
    escalations: int = 0
    erased_symbols: int = 0
    residual_erasures: int = 0
    iters_hist: list[int] = dataclasses.field(default_factory=list)

    def add(self, s: SimStats) -> None:
        self.frames += int(s.frames)
        self.block_errors += int(s.block_errors)
        self.rs_block_errors += int(s.rs_block_errors)
        self.rs_blocks += int(s.rs_blocks)
        self.ml_failed += int(s.ml_failed)
        self.escalations += int(s.escalations)
        self.erased_symbols += int(s.erased_symbols)
        self.residual_erasures += int(s.residual_erasures)
        h = [int(x) for x in s.iters_hist]
        if len(self.iters_hist) < len(h):
            self.iters_hist += [0] * (len(h) - len(self.iters_hist))
        for i, v in enumerate(h):
            self.iters_hist[i] += v

    @property
    def fer(self) -> float:
        return self.block_errors / max(self.frames, 1)

    @property
    def rs_fer(self) -> float:
        """Per-RS-window block error rate (the reference's normalization)."""
        return self.rs_block_errors / max(self.rs_blocks, 1)

    @property
    def mean_iters(self) -> float:
        tot = sum(self.iters_hist)
        if not tot:
            return 0.0
        return sum(i * v for i, v in enumerate(self.iters_hist)) / tot
