"""Reed-Solomon code construction over GF(2^8).

Reference semantics:

* Vandermonde generator ``G[r, c] = alpha^(r*c)`` — i.e. codeword =
  evaluations of the degree-(k-1) message polynomial at the distinct points
  ``alpha^c`` (Matlab/Test_My_RS_Decode.m:30-37); any n <= 255 (shortened
  codes like the paper's RS(250,125) take the first n evaluation points).
* Systematic form ``G_sys = inv(G[:, :k]) @ G`` so the first k symbols are the
  message (Matlab/ReedSolomonErasureCodes.m:31-32).

Design decision: instead of porting the G-side column-swap
Gauss-Jordan decoder (Matlab/My_RS_Decode_Optimize_With_GFTables.m:15-119),
RS codes are expressed in the framework's common parity-check form
``H = [P^T | I]`` (with ``G_sys = [I | P]``) and *reuse* the batched LDPC
machinery: the bit-image matmul encoder and the batched GF(256)
Gauss-Jordan erasure solver (ops/ge.py) — which performs the identical
computation (solve the erased-column system from the known-symbol syndrome).
The MDS property guarantees any <= n-k erasures are solvable, which the
analytic FER shortcut exploits (Matlab/scratch.m:30-38; paper tex:220).
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ldpc_erasure_codes_tpu import gf
from ldpc_erasure_codes_tpu.codes.registry import LDPCCode, from_h_dense


@functools.lru_cache(maxsize=16)
def rs_generator(n: int, k: int) -> np.ndarray:
    """(k, n) Vandermonde generator G[r, c] = alpha^(r*c) over GF(256)."""
    if not (0 < k <= n <= 255):
        raise ValueError(f"need 0 < k <= n <= 255, got ({n}, {k})")
    t = gf.build_tables()
    r = np.arange(k)[:, None]
    c = np.arange(n)[None, :]
    return t.exp[(r * c) % 255].astype(np.uint8)


@functools.lru_cache(maxsize=16)
def rs_systematic_generator(n: int, k: int) -> np.ndarray:
    """(k, n) systematic generator G_sys = inv(G[:, :k]) @ G; G_sys[:, :k] = I."""
    g = rs_generator(n, k)
    ginv = gf.gf_inv_matrix_np(g[:, :k])
    gs = gf.gf_matmul_np(ginv, g)
    assert np.array_equal(gs[:, :k], np.eye(k, dtype=np.uint8))
    return gs


def rs_code(n: int, k: int, name: str | None = None) -> LDPCCode:
    """RS(n, k) as an LDPCCode: dense H = [P^T | I] from G_sys = [I | P].

    The identity parity region is trivially triangle-form, so every LDPC
    kernel applies (encode_nb / encode_packed / ge_solve / peel for the
    degree-(k+1) checks).
    """
    gs = rs_systematic_generator(n, k)
    p = gs[:, k:]  # (k, m)
    m = n - k
    h = np.concatenate([p.T, np.eye(m, dtype=np.uint8)], axis=1)
    return from_h_dense(h, name or f"rs_n{n}_k{k}", rs_n=n, rs_k=k)


def analytic_rs_fer(n: int, k: int, per: float) -> float:
    """Exact MDS block-error rate under i.i.d. erasures:
    ``1 - sum_{i=0}^{n-k} C(n,i) p^i (1-p)^(n-i)`` (Matlab/scratch.m:30-38)."""
    q = 1.0 - per
    acc = 0.0
    for i in range(n - k + 1):
        acc += math.comb(n, i) * (per**i) * (q ** (n - i))
    return 1.0 - acc
