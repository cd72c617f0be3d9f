"""GF(2^8) arithmetic tables.

Re-design of the reference's MATLAB table builder
(reference: Matlab/Build_GF256_Lookup_Tables.m:7-77). The reference builds three
lookup tables from MATLAB ``gf`` objects: a 256x256 add table (= bitwise XOR),
a 256x256 multiply table built via log/antilog composition, and a 255-entry
inverse table. We build the same tables from first principles (log/antilog over
the primitive polynomial) in NumPy, once, at import/build time; the JAX compute
path consumes them as device-resident ``uint8`` arrays (the mult table is
64 KiB).

Primitive polynomial: the reference declares ``prim_poly_m8 = [1 0 1 1 1 0 0 0 1]``
(highest-degree coefficient first, Matlab/ErasureCodes_NonBinaryLDPCSim.m:70,
Matlab/GF_play.m:28), i.e. x^8 + x^6 + x^5 + x^4 + 1 = 0x171. We verified our
tables built with 0x171 are byte-exact against the shipped fixture
``GF_256_add_mult_inv_tables.mat``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

# x^8 + x^6 + x^5 + x^4 + 1 (reference's polynomial; byte-exact vs .mat fixture)
DEFAULT_PRIM_POLY = 0x171
GF_SIZE = 256


def _build_exp_log(prim_poly: int = DEFAULT_PRIM_POLY) -> tuple[np.ndarray, np.ndarray]:
    """Antilog (exp) and log tables for GF(256) with generator alpha = x.

    ``exp`` is doubled to 512 entries so that ``exp[log a + log b]`` never needs
    an explicit mod-255 (log a + log b <= 508).
    """
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= prim_poly
    exp[255:510] = exp[0:255]
    return exp, log


@dataclasses.dataclass(frozen=True)
class GFTables:
    """All GF(2^8) lookup tables as NumPy uint8 arrays.

    Attributes:
      exp: (512,) antilog table, doubled for mod-free index arithmetic.
      log: (256,) log table (log[0] is 0 and must be masked by callers).
      mul: (256, 256) full multiplication table; mul[a, b] = a*b in GF(256).
      inv: (256,) multiplicative inverse; inv[0] = 0 by convention.
      mul_flat: (65536,) flattened mul table for single-gather lookups.
    """

    exp: np.ndarray
    log: np.ndarray
    mul: np.ndarray
    inv: np.ndarray

    @property
    def mul_flat(self) -> np.ndarray:
        return self.mul.reshape(-1)

    @property
    def prim_poly(self) -> int:
        return self._prim_poly  # type: ignore[attr-defined]


@functools.lru_cache(maxsize=4)
def build_tables(prim_poly: int = DEFAULT_PRIM_POLY) -> GFTables:
    exp, log = _build_exp_log(prim_poly)
    a = np.arange(256)
    la = log[a]
    # mul[a, b] = exp[(log a + log b) % 255], zero if either operand is zero.
    mul = exp[(la[:, None] + la[None, :]) % 255].astype(np.uint8)
    mul[0, :] = 0
    mul[:, 0] = 0
    inv = np.zeros(256, dtype=np.uint8)
    inv[1:] = exp[(255 - log[1:]) % 255]
    t = GFTables(exp=exp, log=log, mul=mul, inv=inv)
    object.__setattr__(t, "_prim_poly", prim_poly)
    return t


def gf_mul_np(a: np.ndarray, b: np.ndarray, tables: GFTables | None = None) -> np.ndarray:
    """Elementwise GF(256) multiply on NumPy arrays (host-side oracle path)."""
    t = tables or build_tables()
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    return t.mul[a, b]


def gf_inv_np(a: np.ndarray, tables: GFTables | None = None) -> np.ndarray:
    t = tables or build_tables()
    return t.inv[np.asarray(a, dtype=np.int64)]


def gf_matvec_np(mat: np.ndarray, vec: np.ndarray, tables: GFTables | None = None) -> np.ndarray:
    """y[i] = XOR_j mat[i, j] * vec[j] over GF(256) (host-side oracle path)."""
    t = tables or build_tables()
    prod = t.mul[np.asarray(mat, dtype=np.int64), np.asarray(vec, dtype=np.int64)[None, :]]
    return np.bitwise_xor.reduce(prod, axis=1)


def gf_matmul_np(a: np.ndarray, b: np.ndarray, tables: GFTables | None = None) -> np.ndarray:
    """C = A @ B over GF(256) for 2-D NumPy arrays (host-side, small sizes)."""
    t = tables or build_tables()
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    prod = t.mul[a[:, :, None], b[None, :, :]]  # (m, k, n)
    return np.bitwise_xor.reduce(prod, axis=1)


def gf_inv_matrix_np(a: np.ndarray, tables: GFTables | None = None) -> np.ndarray:
    """Invert a square matrix over GF(256) by Gauss-Jordan (host-side).

    Raises ValueError when the matrix is singular. Used once per code to build
    systematic generator matrices; never on the device hot path.
    """
    t = tables or build_tables()
    a = np.asarray(a, dtype=np.uint8).copy()
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"expected square matrix, got {a.shape}")
    aug = np.concatenate([a, np.eye(n, dtype=np.uint8)], axis=1).astype(np.int64)
    for col in range(n):
        piv_rows = np.nonzero(aug[col:, col])[0]
        if piv_rows.size == 0:
            raise ValueError("matrix is singular over GF(256)")
        piv = piv_rows[0] + col
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        scale = t.inv[aug[col, col]]
        aug[col] = t.mul[aug[col], scale]
        other = np.nonzero(aug[:, col])[0]
        other = other[other != col]
        if other.size:
            aug[other] ^= t.mul[aug[other, col][:, None], aug[col][None, :]]
    return aug[:, n:].astype(np.uint8)


@functools.lru_cache(maxsize=4)
def _bit_image_basis(prim_poly: int = DEFAULT_PRIM_POLY) -> np.ndarray:
    """(256, 8, 8) binary image of multiplication by each field element.

    ``basis[h, b, c]`` = bit ``c`` of ``h * x^b``. Multiplication by a constant
    ``h`` is GF(2)-linear on the 8-bit vector representation, so a GF(256)
    matrix lifts to a GF(2) matrix 8x larger in each dimension; GF(256) matmuls
    then become binary matmuls (see gf/ops.py).
    """
    t = build_tables(prim_poly)
    basis = np.zeros((256, 8, 8), dtype=np.uint8)
    for b in range(8):
        prod = t.mul[:, 1 << b]  # h * x^b for all h
        for c in range(8):
            basis[:, b, c] = (prod >> c) & 1
    return basis


def bit_image(mat: np.ndarray, prim_poly: int = DEFAULT_PRIM_POLY) -> np.ndarray:
    """Lift a GF(256) matrix (m, n) to its GF(2) binary image (8m, 8n).

    With bytes unpacked LSB-first into bit vectors, ``bits(u) @ bit_image(G)
    mod 2 == bits(u @ G over GF(256))``. This is the matmul formulation of
    GF(256) linear algebra (the reference explores the same binary-image idea
    host-side in Matlab/GF_play.m:104-118).
    """
    mat = np.asarray(mat, dtype=np.int64)
    m, n = mat.shape
    basis = _bit_image_basis(prim_poly)
    img = basis[mat]  # (m, n, 8, 8) -> [i, j, b, c]
    return img.transpose(0, 2, 1, 3).reshape(m * 8, n * 8)
