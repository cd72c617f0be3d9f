"""NumPy oracle: bit-faithful re-implementations of the reference's MATLAB
decode/encode semantics.

Every device kernel in ops/ is validated against this module on fixed seeds.
The oracle keeps the reference's conventions — in-band ``-1`` erasure
sentinels, sequential (Gauss-Seidel) check sweeps, ascending-index pivoting —
so that fixed points and failure cases can be compared exactly. The device
kernels use different schedules (Jacobi sweeps, batched masked GE) that reach
the same fixed points; tests assert agreement at convergence.

Reference sources (cited per function): Matlab/My_LDPC_Erasure_Decoder.m,
Matlab/My_LDPC_HybridML_Erasure_Decoder.m,
Matlab/My_LDPC_HybridML_NonBinary_Erasure_Decoder.m,
Matlab/My_ML_LDPC_Erasure_Decoder.m,
Matlab/My_RS_Decode_Optimize_With_GFTables.m,
Matlab/LDPCErasureCodes_MessagePassingAlgSim.m (encoder),
Matlab/ErasureCodes_NonBinaryLDPCSim.m (NB encoder).
"""

from __future__ import annotations

import numpy as np

from ldpc_erasure_codes_tpu import gf
from ldpc_erasure_codes_tpu.codes.registry import LDPCCode

ERASED = -1


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------


def encode_triangular(code: LDPCCode, source: np.ndarray) -> np.ndarray:
    """Binary systematic triangular encode, sequential back-substitution.

    p_i = H[i, :k+i] . v[:k+i] mod 2
    (reference: Matlab/LDPCErasureCodes_MessagePassingAlgSim.m:164-174).
    """
    h = code.h_dense
    cw = np.zeros(code.n, dtype=np.int64)
    cw[: code.k] = source
    for i in range(code.m):
        cw[code.k + i] = int(h[i, : code.k + i] @ cw[: code.k + i]) & 1
    return cw


def encode_triangular_nb(code: LDPCCode, source: np.ndarray) -> np.ndarray:
    """GF(256) systematic triangular encode.

    Accumulate the row's off-diagonal GF products, multiply by the inverse of
    the diagonal coefficient
    (reference: Matlab/ErasureCodes_NonBinaryLDPCSim.m:172-182).
    """
    t = gf.build_tables()
    h = code.h_dense_nb.astype(np.int64)
    cw = np.zeros(code.n, dtype=np.int64)
    cw[: code.k] = source
    for i in range(code.m):
        d = code.k + i
        acc = 0
        for j in np.nonzero(h[i, :d])[0]:
            acc ^= t.mul[h[i, j], cw[j]]
        cw[code.k + i] = t.mul[acc, t.inv[h[i, d]]]
    return cw


# ---------------------------------------------------------------------------
# Peeling (message-passing) decoders
# ---------------------------------------------------------------------------


def peel_decode(
    code: LDPCCode, recv: np.ndarray, max_iters: int = 50
) -> tuple[np.ndarray, int]:
    """Binary erasure peeling, sequential check sweep (Gauss-Seidel order).

    Per iteration, sweep all checks in row order; a check with exactly one
    erased neighbor solves it as the XOR of its other neighbors. In-place
    updates propagate within a sweep, exactly as in the reference
    (Matlab/My_LDPC_Erasure_Decoder.m:18-47; itenum=50 at :10).

    Returns (decoded vector with -1 for unresolved erasures, iterations used).
    """
    y = np.asarray(recv, dtype=np.int64).copy()
    iters = 0
    for _ in range(max_iters):
        iters += 1
        for r in range(code.m):
            d = int(code.vlist_len[r])
            nbrs = code.vlist_idx[r, :d]
            er = nbrs[y[nbrs] == ERASED]
            if er.size == 1:
                others = nbrs[nbrs != er[0]]
                y[er[0]] = int(y[others].sum()) & 1
        if not np.any(y == ERASED):
            break
    return y, iters


def peel_decode_nb(
    code: LDPCCode, recv: np.ndarray, max_iters: int = 50
) -> tuple[np.ndarray, int]:
    """GF(256) erasure peeling, sequential check sweep.

    Degree-1 check solve: y_e = inv(h_e) * XOR_j h_j y_j over the other
    neighbors (reference: Matlab/My_LDPC_HybridML_NonBinary_Erasure_Decoder.m:37-48).
    """
    t = gf.build_tables()
    h = code.h_dense_nb.astype(np.int64)
    y = np.asarray(recv, dtype=np.int64).copy()
    iters = 0
    for _ in range(max_iters):
        iters += 1
        for r in range(code.m):
            d = int(code.vlist_len[r])
            nbrs = code.vlist_idx[r, :d]
            er = nbrs[y[nbrs] == ERASED]
            if er.size == 1:
                acc = 0
                for j in nbrs[nbrs != er[0]]:
                    acc = acc ^ t.mul[y[j], h[r, j]]
                y[er[0]] = t.mul[acc, t.inv[h[r, er[0]]]]
        if not np.any(y == ERASED):
            break
    return y, iters


# ---------------------------------------------------------------------------
# Hybrid peeling + ML (Gaussian elimination on the residual)
# ---------------------------------------------------------------------------


def hybrid_ml_decode(
    code: LDPCCode, recv: np.ndarray, peel_iters: int = 10
) -> tuple[np.ndarray, int, bool]:
    """Binary hybrid decoder: peeling (10 iters) then GF(2) GE on the residual.

    Faithful to Matlab/My_LDPC_HybridML_Erasure_Decoder.m:3-91 including the
    singular-case behavior: when a column has no pivot the Jordan pass is
    skipped but the (garbage) rhs values are still written back (:59-62, :87).

    Returns (decoded, peel iterations, ge_singular flag).
    """
    y, iters = peel_decode(code, recv, max_iters=peel_iters)
    singular = False
    er = np.nonzero(y == ERASED)[0]
    e = er.size
    if e > code.m:
        # More residual unknowns than checks: the system is underdetermined.
        # The reference never reaches this (its sims guard num_erasures > n-k
        # before decoding, ErasureCodes_NonBinaryLDPCSim.m:216-221).
        return y, iters, True
    if e > 0:
        h = code.h_dense.astype(np.int64)
        a = h[:, er].copy()  # (m, e)
        known = np.setdiff1d(np.arange(code.n), er)
        rhs = (h[:, known] @ y[known]) & 1
        singular = _ge_binary_inplace(a, rhs, e)
        y[er] = rhs[:e]
    return y, iters, singular


def _ge_binary_inplace(a: np.ndarray, rhs: np.ndarray, e: int) -> bool:
    """GF(2) forward elimination + Jordan, MATLAB pivot order. Returns
    True when singular (reference 'dont_do_jordan')."""
    for col in range(e):
        nz = np.nonzero(a[col:, col])[0] + col
        if nz.size == 0:
            return True
        p = nz[0]
        if p != col:
            a[[col, p]] = a[[p, col]]
            rhs[[col, p]] = rhs[[p, col]]
        rest = nz[1:]
        if rest.size:
            a[rest] ^= a[col]
            rhs[rest] ^= rhs[col]
    for col in range(e - 1, 0, -1):
        nz = np.nonzero(a[:col, col])[0]
        if nz.size:
            a[nz] ^= a[col]
            rhs[nz] ^= rhs[col]
    return False


def hybrid_ml_decode_nb(
    code: LDPCCode, recv: np.ndarray, peel_iters: int = 10
) -> tuple[np.ndarray, int, bool]:
    """GF(256) hybrid decoder: NB peeling then GF(256) GE on the residual.

    Faithful to Matlab/My_LDPC_HybridML_NonBinary_Erasure_Decoder.m:61-128:
    pivot rows normalized via the inverse table, elimination via
    add/mult-table MACs, Jordan pass on rhs only, rhs written back even when
    singular.
    """
    t = gf.build_tables()
    y, iters = peel_decode_nb(code, recv, max_iters=peel_iters)
    singular = False
    er = np.nonzero(y == ERASED)[0]
    e = er.size
    if e > code.m:
        return y, iters, True  # underdetermined; see hybrid_ml_decode
    if e > 0:
        h = code.h_dense_nb.astype(np.int64)
        a = h[:, er].copy()
        known = np.setdiff1d(np.arange(code.n), er)
        prod = t.mul[h[:, known], y[known][None, :]]
        rhs = np.bitwise_xor.reduce(prod, axis=1).astype(np.int64)
        singular = _ge_gf256_inplace(a, rhs, e, t)
        y[er] = rhs[:e]
    return y, iters, singular


def _ge_gf256_inplace(a: np.ndarray, rhs: np.ndarray, e: int, t) -> bool:
    for col in range(e):
        nz = np.nonzero(a[col:, col])[0] + col
        if nz.size == 0:
            return True
        p = nz[0]
        if p != col:
            a[[col, p]] = a[[p, col]]
            rhs[[col, p]] = rhs[[p, col]]
        mult = t.inv[a[col, col]]
        a[col] = t.mul[a[col], mult]
        rhs[col] = t.mul[rhs[col], mult]
        for r in nz[1:]:
            m = a[r, col]
            a[r] ^= t.mul[m, a[col]]
            rhs[r] ^= t.mul[m, rhs[col]]
    for col in range(e - 1, 0, -1):
        nz = np.nonzero(a[:col, col])[0]
        for r in nz:
            rhs[r] ^= t.mul[a[r, col], rhs[col]]
            a[r, col] = 0
    return False


# ---------------------------------------------------------------------------
# ML decoding from the generator matrix (binary)
# ---------------------------------------------------------------------------


def ml_decode_from_g(
    g: np.ndarray, recv: np.ndarray, k: int
) -> tuple[np.ndarray, bool]:
    """Binary ML erasure decode from a systematic generator matrix G (k, n).

    Solves u . G_recv = y_recv by Gauss-Jordan over GF(2), exploiting the
    systematic prefix via column swaps with permutation tracking
    (reference: Matlab/My_ML_LDPC_Erasure_Decoder.m:3-122; the zero-row
    optimization at :74-80 does not change the output — the reference
    cross-checks the two variants for equality, Matlab/LDPCErasureCodes.m:127-129).

    Returns (message estimate (k,), success flag). On rank deficiency the
    reference returns the received vector unchanged (:95-99); here we return
    recv[:k] and ok=False.
    """
    recv = np.asarray(recv, dtype=np.int64)
    recv_ind = np.nonzero(recv >= 0)[0]
    gj = g[:, recv_ind].T.astype(np.int64).copy()  # (num_recv, k)
    vals = recv[recv_ind].copy()
    num_sys = int((recv_ind < k).sum())
    order = np.arange(k)
    # Column-swap the systematic prefix into the upper-left identity.
    for i in range(num_sys):
        col = int(np.nonzero(gj[i])[0][0])
        if col != i:
            gj[:, [i, col]] = gj[:, [col, i]]
            order[[i, col]] = order[[col, i]]
    acc = vals.copy()
    row = num_sys
    swap = row + 1
    nrecv = gj.shape[0]
    ok = True
    while row < k:
        for j in range(num_sys):
            if gj[row, j]:
                acc[row] ^= acc[j]
                gj[row, j] = 0
        for j in range(num_sys, row):
            if gj[row, j]:
                acc[row] ^= acc[j]
                gj[row, j:] ^= gj[j, j:]
        if gj[row, row]:
            row += 1
            swap = row + 1
        else:
            if swap >= nrecv:
                ok = False
                break
            gj[[row, swap]] = gj[[swap, row]]
            acc[[row, swap]] = acc[[swap, row]]
            swap += 1
    if not ok:
        return recv[:k].copy(), False
    for i in range(k - 2, num_sys - 1, -1):
        for j in range(i + 1, k):
            if gj[i, j]:
                acc[i] ^= acc[j]
                gj[i, j] = 0
    out = np.zeros(k, dtype=np.int64)
    out[order[:num_sys]] = vals[:num_sys]
    out[order[num_sys:k]] = acc[num_sys:k]
    return out, True


# ---------------------------------------------------------------------------
# Reed-Solomon erasure decode (table formulation)
# ---------------------------------------------------------------------------


def rs_decode(
    recv_ind: np.ndarray, recv_val: np.ndarray, g: np.ndarray, k: int
) -> np.ndarray:
    """RS erasure decode from k received symbols of a systematic codeword.

    Faithful to Matlab/My_RS_Decode_Optimize_With_GFTables.m:15-119: build the
    k x k system from the received columns of G, swap the systematic prefix
    into the identity, forward-eliminate with a running multiply-accumulator
    for the rhs, normalize pivots with the inverse table, then a Jordan pass.

    Args:
      recv_ind: (k,) 0-based indices of the received symbols, ascending.
      recv_val: (k,) received symbol values.
      g: (k, n) systematic generator matrix over GF(256).
      k: message length.

    Returns the (k,) decoded message.
    """
    t = gf.build_tables()
    gj = g[:, recv_ind].T.astype(np.int64).copy()  # (k, k)
    num_sys = int((recv_ind < k).sum())
    order = np.arange(k)
    for i in range(num_sys):
        col = int(np.nonzero(gj[i])[0][0])
        if col != i:
            gj[:, [i, col]] = gj[:, [col, i]]
            order[[i, col]] = order[[col, i]]
    acc = np.asarray(recv_val, dtype=np.int64).copy()
    row = num_sys
    swap = row + 1
    while row < k:
        for j in range(num_sys):
            acc[row] ^= t.mul[gj[row, j], acc[j]]
            gj[row, j] = 0
        for j in range(num_sys, row):
            acc[row] ^= t.mul[gj[row, j], acc[j]]
            mult = gj[row, j]
            gj[row, j:] ^= t.mul[mult, gj[j, j:]]
        if gj[row, row]:
            inv = t.inv[gj[row, row]]
            gj[row, row:] = t.mul[inv, gj[row, row:]]
            acc[row] = t.mul[inv, acc[row]]
            row += 1
            swap = row + 1
        else:
            if swap >= k:
                break  # rank deficient; reference leaves the rest unsolved
            gj[[row, swap]] = gj[[swap, row]]
            acc[[row, swap]] = acc[[swap, row]]
            swap += 1
    for i in range(k - 2, num_sys - 1, -1):
        for j in range(i + 1, k):
            acc[i] ^= t.mul[acc[j], gj[i, j]]
            gj[i, j] = 0
    out = np.zeros(k, dtype=np.int64)
    out[order[:num_sys]] = recv_val[:num_sys]
    out[order[num_sys:]] = acc[num_sys:]
    return out


# ---------------------------------------------------------------------------
# Channels
# ---------------------------------------------------------------------------


def gilbert_elliott_steady_state(
    alpha: float, beta: float, transition: float = 0.1, bias: float = 10.0
) -> float:
    """Analytic average erasure rate of the two-state Gilbert-Elliott channel.

    P(G->B) = transition/bias, P(B->G) = transition, so
    P(bad) = (1/bias) / (1 + 1/bias) and
    P_err = P(good) alpha + P(bad) beta
    (reference: Matlab/Bursty_Error_Channel_Model.m:20-24, :63-71).
    """
    p_bad = (1.0 / bias) / (1.0 + 1.0 / bias)
    return (1.0 - p_bad) * alpha + p_bad * beta


def gilbert_elliott_sample(
    rng: np.random.Generator,
    num_symbols: int,
    alpha: float,
    beta: float,
    transition: float = 0.1,
    bias: float = 10.0,
    state: int = 0,
) -> tuple[np.ndarray, int]:
    """Sample a per-symbol erasure sequence from the Gilbert-Elliott chain.

    Two uniform draws per symbol (erasure draw, state draw), matching
    Matlab/Bursty_Error_Channel_Model_Generator.m:24-47; the state carries
    across calls/codewords as in ErasureCodes_NonBinaryLDPCSim.m:191-198.
    """
    p_gb = transition / bias
    p_bg = transition
    err = np.zeros(num_symbols, dtype=bool)
    for i in range(num_symbols):
        u_err = rng.random()
        u_state = rng.random()
        per = alpha if state == 0 else beta
        err[i] = u_err <= per
        if state == 0:
            state = 1 if u_state <= p_gb else 0
        else:
            state = 0 if u_state <= p_bg else 1
    return err, state
