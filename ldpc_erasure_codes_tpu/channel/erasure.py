"""Erasure channel models on device.

The reference injects erasures three ways; all are reproduced here on the device:

* i.i.d. uniform with real-valued PER
  (Matlab/LDPCErasureCodes_MessagePassingAlgSim.m:183-188);
* i.i.d. with PER quantized to j/64, drawn by comparing the bottom 6 bits of
  a counter-RNG word — the FPGA's on-device generator
  (OpenCL/device/ldpc_erasure_decoder_top.cl:89-116). JAX's default PRNG is
  Threefry, the same Random123 family the FPGA vendors (threefry.h), so this
  maps natively onto ``jax.random``;
* the two-state Gilbert-Elliott bursty channel
  (Matlab/Bursty_Error_Channel_Model_Generator.m:12-47), expressed as a
  ``lax.scan`` over the symbol axis carrying the per-codeword Markov state,
  with the state optionally carried across codewords as the non-binary sim
  does (Matlab/ErasureCodes_NonBinaryLDPCSim.m:191-198).

Erasures are out-of-band: a boolean mask plus the invariant that erased value
slots are zeroed (so XOR/GF accumulation never needs to test for erasure —
the same trick as the FPGA's all-zeros erased symbols,
OpenCL/device/ldpc_erasure_decoder.cl:17-20).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class GilbertElliottParams(NamedTuple):
    """Gilbert-Elliott parameters. State 0 = Good (PER alpha), state 1 = Bad
    (PER beta); P(G->B) = transition/bias, P(B->G) = transition."""

    alpha: float
    beta: float
    transition: float = 0.1
    bias: float = 10.0


def iid_erasures(key: jax.Array, shape: tuple[int, ...], per: float | jax.Array) -> jax.Array:
    """i.i.d. erasure mask: P(erased) = per."""
    return jax.random.uniform(key, shape) <= per


def iid_erasures_per64(key: jax.Array, shape: tuple[int, ...], per_numerator: jax.Array) -> jax.Array:
    """i.i.d. erasures with PER = per_numerator/64.

    Matches the FPGA parameterization: draw a random word, compare its bottom
    6 bits against the numerator (decoder_top.cl:102-110, granularity 1/64 —
    paper tex:222).
    """
    bits = jax.random.bits(key, shape, dtype=jnp.uint32)
    return (bits & 63) < per_numerator


def gilbert_elliott_erasures(
    key: jax.Array,
    batch: int,
    n: int,
    params: GilbertElliottParams,
    init_state: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Sample (batch, n) erasure masks from the Gilbert-Elliott chain.

    The chain scans the symbol axis (the sequential dependence) while the
    batch axis stays vectorized. Two uniforms per symbol (erasure draw, state
    draw) as in the reference generator.

    Args:
      init_state: (batch,) int32 starting states; zeros (Good) when None,
        matching the sim's ``next_state = 0`` init. Pass the returned final
        state back in to carry bursts across codewords.

    Returns:
      (mask (batch, n) bool, final_state (batch,) int32).
    """
    if init_state is None:
        init_state = jnp.zeros((batch,), dtype=jnp.int32)
    u = jax.random.uniform(key, (n, batch, 2))
    p_gb = params.transition / params.bias
    p_bg = params.transition

    def step(state, u_sym):
        u_err, u_state = u_sym[:, 0], u_sym[:, 1]
        per = jnp.where(state == 0, params.alpha, params.beta)
        erased = u_err <= per
        go_bad = (state == 0) & (u_state <= p_gb)
        go_good = (state == 1) & (u_state <= p_bg)
        next_state = jnp.where(go_bad, 1, jnp.where(go_good, 0, state))
        return next_state, erased

    final_state, mask_t = jax.lax.scan(step, init_state, u)
    return mask_t.T, final_state


def gilbert_elliott_steady_state(params: GilbertElliottParams) -> float:
    """Analytic average erasure rate (Matlab/Bursty_Error_Channel_Model.m:20-24)."""
    p_bad = (1.0 / params.bias) / (1.0 + 1.0 / params.bias)
    return (1.0 - p_bad) * params.alpha + p_bad * params.beta


def apply_erasures(values: jax.Array, mask: jax.Array) -> jax.Array:
    """Zero the erased value slots (maintains the erased-is-zero invariant).

    ``values`` may be (batch, n) scalar symbols or (batch, n, W) packed wide
    symbols; ``mask`` is (batch, n).
    """
    if values.ndim == mask.ndim + 1:
        mask = mask[..., None]
    return jnp.where(mask, jnp.zeros((), dtype=values.dtype), values)
