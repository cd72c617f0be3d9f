"""Device-resident code arrays.

:class:`CodeArrays` is the pytree handed to every jitted kernel: all arrays an
(n, k) code needs on device, derived once from the host-side
:class:`~ldpc_erasure_codes_tpu.codes.registry.LDPCCode`. Passing it as a
pytree argument (rather than closing over globals) keeps kernels retrace-free
and mesh-shardable (the arrays are replicated; the codeword batch is sharded).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ldpc_erasure_codes_tpu import gf
from ldpc_erasure_codes_tpu.codes.registry import LDPCCode


class CodeArrays(NamedTuple):
    """Device arrays for one code. Static ints live in aux fields of the
    kernels (passed statically), not here.

    Attributes:
      h: (m, n) int8 binary support of H (mask form, matmul operand).
      h_t: (n, m) int8 transpose of ``h`` (contraction layout).
      h_nb: (m, n) uint8 GF(256) coefficient matrix (equals ``h`` for
        binary codes).
      vlist_idx: (m, dmax) int32 neighbor columns, pad = n.
      vlist_len: (m,) int32 check degrees.
      vlist_val: (m, dmax) uint8 GF coefficients, pad = 0.
      vlist_inv_val: (m, dmax) uint8 inverse coefficients, pad = 0.
      clist_idx: (n, cmax) int32 check rows per symbol, pad = m.
      clist_len: (n,) int32 symbol degrees.
      parity_gen: (k, m) int8 binary parity generator (binary codes), or the
        (8k, 8m) int8 bit image of the GF(256) parity generator (NB codes).
      enc_src_idx: (m, dmax) int32 — per parity row, the neighbor columns that
        fall in the source region (col < k), pad = k.
      enc_src_val: (m, dmax) uint8 GF coefficients on the same support, pad 0.
      enc_par_idx: (m, pmax) int32 — per parity row i, the (col - k) indices of
        strictly-lower parity-region neighbors (k <= col < k+i), pad = m.
      enc_par_val: (m, pmax) uint8 coefficients, pad 0.
      enc_diag_inv: (m,) uint8 — inverse of each row's diagonal (triangle)
        coefficient; all-ones for binary codes.
    """

    h: jnp.ndarray
    h_t: jnp.ndarray
    h_nb: jnp.ndarray
    vlist_idx: jnp.ndarray
    vlist_len: jnp.ndarray
    vlist_val: jnp.ndarray
    vlist_inv_val: jnp.ndarray
    clist_idx: jnp.ndarray
    clist_len: jnp.ndarray
    parity_gen: jnp.ndarray
    enc_src_idx: jnp.ndarray
    enc_src_val: jnp.ndarray
    enc_par_idx: jnp.ndarray
    enc_par_val: jnp.ndarray
    enc_diag_inv: jnp.ndarray


def _code_digest(code: LDPCCode) -> str:
    import hashlib

    h = hashlib.sha1()
    h.update(f"{code.name}|{code.n}|{code.k}|{code.gf_order}".encode())
    h.update(code.vlist_idx.tobytes())
    h.update(code.vlist_val.tobytes())
    return h.hexdigest()


_HOST_ARRAYS_CACHE: dict[str, dict] = {}


def _host_arrays(code: LDPCCode) -> dict:
    key = _code_digest(code)
    if key in _HOST_ARRAYS_CACHE:
        return _HOST_ARRAYS_CACHE[key]
    t = gf.build_tables()
    cl_idx, cl_len, _cl_val = code.clist
    hd = (code.h_dense != 0).astype(np.int8)
    if code.gf_order == 2:
        pgen = code.parity_gen.astype(np.int8)
    else:
        pgen = gf.bit_image(code.parity_gen_nb).astype(np.int8)

    # Encoder split of the Vlist: source-region neighbors (parallel gather-XOR
    # stage) vs strictly-lower parity-region neighbors (sequential
    # back-substitution stage). Triangle form guarantees row i's parity
    # neighbors all have column <= k+i with the diagonal at exactly k+i.
    m, dmax, k, n = code.m, code.dmax, code.k, code.n
    enc_src_idx = np.full((m, dmax), k, dtype=np.int32)
    enc_src_val = np.zeros((m, dmax), dtype=np.uint8)
    par_rows: list[list[tuple[int, int]]] = []
    diag = np.zeros(m, dtype=np.uint8)
    for r in range(m):
        d = int(code.vlist_len[r])
        s_fill = 0
        par_rows.append([])
        for j in range(d):
            c = int(code.vlist_idx[r, j])
            v = int(code.vlist_val[r, j])
            if c < k:
                enc_src_idx[r, s_fill] = c
                enc_src_val[r, s_fill] = v
                s_fill += 1
            elif c == k + r:
                diag[r] = v
            else:
                assert c < k + r, f"row {r}: parity neighbor above diagonal"
                par_rows[r].append((c - k, v))
    assert np.all(diag != 0), "triangle diagonal missing"
    pmax = max(1, max(len(p) for p in par_rows))
    enc_par_idx = np.full((m, pmax), m, dtype=np.int32)
    enc_par_val = np.zeros((m, pmax), dtype=np.uint8)
    for r, plist in enumerate(par_rows):
        for j, (c, v) in enumerate(plist):
            enc_par_idx[r, j] = c
            enc_par_val[r, j] = v

    out = dict(
        h=hd,
        h_t=hd.T.copy(),
        h_nb=code.h_dense_nb,
        vlist_idx=code.vlist_idx,
        vlist_len=code.vlist_len.astype(np.int32),
        vlist_val=code.vlist_val,
        vlist_inv_val=t.inv[code.vlist_val],
        clist_idx=cl_idx,
        clist_len=cl_len,
        parity_gen=pgen,
        enc_src_idx=enc_src_idx,
        enc_src_val=enc_src_val,
        enc_par_idx=enc_par_idx,
        enc_par_val=enc_par_val,
        enc_diag_inv=t.inv[diag],
    )
    _HOST_ARRAYS_CACHE[key] = out
    return out


def device_arrays(code: LDPCCode) -> CodeArrays:
    """Build (host-cached) CodeArrays for a code; jnp conversion per call so
    no tracers are ever cached."""
    host = _host_arrays(code)
    return CodeArrays(**{k: jnp.asarray(v) for k, v in host.items()})
