"""LDPC code objects and the code registry.

The reference keeps each code in three redundant forms: a MATLAB sparse H
(``.mat``), a generated OpenCL Vlist ROM (``OpenCL/device/LDPC_Vlist_data.h``),
and a host-side params table (``OpenCL/host/inc/Main_LDPC_header.h:10-14``).
Here a code is a single :class:`LDPCCode` value object holding the padded
check-neighbor lists (the Vlist form — it is both the sparse storage and the
natural gather-index layout for device kernels), with every derived array the
kernels need computed lazily and cached:

* dense int8 H for mask matmuls,
* the dense parity generator ``P`` such that ``parity = source @ P`` (the
  one-matmul systematic encoder; bit-exact equal to the reference's sequential
  triangular back-substitution, Matlab/LDPCErasureCodes_MessagePassingAlgSim.m:164-174),
* binary images of the GF(256) variants for GF matmuls.

Codes are (de)serialized as ``.npz`` (see io.py); the two production codes are
shipped in ``ldpc_erasure_codes_tpu/data/codes/``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ldpc_erasure_codes_tpu import gf


@dataclasses.dataclass(frozen=True)
class LDPCCode:
    """An (n, k) LDPC erasure code over GF(2) or GF(256).

    Attributes:
      name: registry key, e.g. ``"n2040_k1530"``.
      n: codeword length in symbols.
      k: source symbols per codeword.
      vlist_idx: (m, dmax) int32, 0-based column indices of each check row's
        neighbors, padded with ``n`` (gathers read a zero pad slot).
      vlist_len: (m,) int32 check degrees.
      vlist_val: (m, dmax) uint8 GF coefficients on the same support; all-ones
        in the padded region-free positions for binary codes. Pad positions
        hold 0.
      rs_n / rs_k: the rate-matched Reed-Solomon comparison code
        (reference: OpenCL/device/LDPC_Vlist_data.h:10-14 columns 4-5).
      gf_order: 2 for binary codes, 256 for non-binary.
    """

    name: str
    n: int
    k: int
    vlist_idx: np.ndarray
    vlist_len: np.ndarray
    vlist_val: np.ndarray
    rs_n: int = 0
    rs_k: int = 0
    gf_order: int = 2

    def __post_init__(self):
        m = self.n - self.k
        if self.vlist_idx.shape[0] != m:
            raise ValueError(
                f"vlist has {self.vlist_idx.shape[0]} rows, expected m={m}"
            )
        if self.vlist_idx.shape != self.vlist_val.shape:
            raise ValueError("vlist_idx and vlist_val shapes differ")

    @property
    def m(self) -> int:
        return self.n - self.k

    @property
    def dmax(self) -> int:
        return self.vlist_idx.shape[1]

    @functools.cached_property
    def h_dense(self) -> np.ndarray:
        """(m, n) uint8 binary parity-check matrix."""
        h = np.zeros((self.m, self.n), dtype=np.uint8)
        rows = np.repeat(np.arange(self.m), self.dmax)
        cols = self.vlist_idx.reshape(-1)
        valid = cols < self.n
        h[rows[valid], cols[valid]] = 1
        return h

    @functools.cached_property
    def h_dense_nb(self) -> np.ndarray:
        """(m, n) uint8 GF(256) parity-check matrix (coefficients)."""
        h = np.zeros((self.m, self.n), dtype=np.uint8)
        rows = np.repeat(np.arange(self.m), self.dmax)
        cols = self.vlist_idx.reshape(-1)
        vals = self.vlist_val.reshape(-1)
        valid = cols < self.n
        h[rows[valid], cols[valid]] = vals[valid]
        return h

    @functools.cached_property
    def clist(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Column-major adjacency: (clist_idx (n, cmax) int32 padded with m,
        clist_len (n,) int32, clist_val (n, cmax) uint8).

        Mirror of the reference's Clist structure
        (Matlab/LDPCErasureCodes_MessagePassingAlgSim.m:74-97).
        """
        col_deg = np.zeros(self.n, dtype=np.int64)
        for r in range(self.m):
            cols = self.vlist_idx[r, : self.vlist_len[r]]
            col_deg[cols] += 1
        cmax = int(col_deg.max(initial=1))
        cl_idx = np.full((self.n, cmax), self.m, dtype=np.int32)
        cl_val = np.zeros((self.n, cmax), dtype=np.uint8)
        fill = np.zeros(self.n, dtype=np.int64)
        for r in range(self.m):
            d = self.vlist_len[r]
            for j in range(d):
                c = self.vlist_idx[r, j]
                cl_idx[c, fill[c]] = r
                cl_val[c, fill[c]] = self.vlist_val[r, j]
                fill[c] += 1
        return cl_idx, col_deg.astype(np.int32), cl_val

    @functools.cached_property
    def is_triangular(self) -> bool:
        """True when H[:, k:] is lower triangular with a nonzero diagonal —
        the systematic "triangle form" every production code in the reference
        uses (reference: Matlab/Hgen_no6cycles_systematic_encoding.m:264-273)."""
        hp = self.h_dense_nb[:, self.k :]
        if np.any(np.diagonal(hp) == 0):
            return False
        return not np.any(np.triu(hp, 1))

    @functools.cached_property
    def parity_gen(self) -> np.ndarray:
        """(k, m) uint8 binary P with ``parity = (source @ P) mod 2``.

        Derived once per code by GF(2) forward substitution on the triangular
        parity block: H = [A | L], L lower-triangular unit-ish diagonal, so
        p = L^{-1} A s. Turns the reference's inherently sequential encoder
        loop into a single matmul with bit-identical output.
        """
        if self.gf_order != 2:
            raise ValueError("parity_gen is for binary codes; use parity_gen_nb")
        if not self.is_triangular:
            raise ValueError(f"code {self.name} is not in triangle form")
        a = self.h_dense[:, : self.k].astype(np.uint8)
        l_strict = np.tril(self.h_dense[:, self.k :], -1)
        # x_i = a_i XOR sum_{j<i} L_ij x_j  (diagonal is 1 for binary codes)
        x = a.copy()
        for i in range(1, self.m):
            js = np.nonzero(l_strict[i, :i])[0]
            if js.size:
                x[i] ^= np.bitwise_xor.reduce(x[js], axis=0)
        return x.T.copy()  # (k, m)

    @functools.cached_property
    def parity_gen_nb(self) -> np.ndarray:
        """(k, m) uint8 GF(256) P with ``parity = source @ P`` over GF(256).

        GF(256) forward substitution matching the reference's non-binary
        triangular encoder: accumulate the row's off-diagonal products, then
        multiply by the inverse of the diagonal coefficient
        (reference: Matlab/ErasureCodes_NonBinaryLDPCSim.m:172-182).
        """
        t = gf.build_tables()
        hd = self.h_dense_nb
        a = hd[:, : self.k].astype(np.int64)
        lp = hd[:, self.k :].astype(np.int64)
        diag_inv = t.inv[np.diagonal(lp)].astype(np.int64)
        x = np.zeros((self.m, self.k), dtype=np.int64)
        for i in range(self.m):
            acc = a[i].copy()
            js = np.nonzero(lp[i, :i])[0]
            for j in js:
                acc ^= t.mul[lp[i, j], x[j]]
            x[i] = t.mul[diag_inv[i], acc]
        return x.T.astype(np.uint8)

    @functools.cached_property
    def h_bits_nb(self) -> np.ndarray:
        """(8m, 8n) int8 binary image of the GF(256) H for matmul syndromes."""
        return gf.bit_image(self.h_dense_nb).astype(np.int8)

    def lift_to_gf256(self, seed: int = 0, name: str | None = None) -> "LDPCCode":
        """Non-binary lift: replace each 1 in H with uniform random 1..255.

        Reference semantics: ErasureCodes_NonBinaryLDPCSim.m:52-58 (commented
        generator showing how H_sparse_nb is derived from H_sparse).
        """
        rng = np.random.default_rng(seed)
        vals = self.vlist_val.copy()
        support = self.vlist_idx < self.n
        vals[support] = rng.integers(1, 256, size=int(support.sum()), dtype=np.uint8)
        return dataclasses.replace(
            self,
            name=name or f"{self.name}_gf256",
            vlist_val=vals,
            gf_order=256,
        )

    def validate(self) -> None:
        """Structural sanity checks (degrees, index bounds, padding)."""
        m, dmax = self.vlist_idx.shape
        for r in range(m):
            d = int(self.vlist_len[r])
            assert 1 <= d <= dmax, f"row {r}: bad degree {d}"
            idx = self.vlist_idx[r, :d]
            assert np.all((idx >= 0) & (idx < self.n)), f"row {r}: index out of range"
            assert len(np.unique(idx)) == d, f"row {r}: duplicate neighbor"
            assert np.all(self.vlist_idx[r, d:] == self.n), f"row {r}: bad padding"
            assert np.all(self.vlist_val[r, :d] >= 1), f"row {r}: zero coefficient"
            assert np.all(self.vlist_val[r, d:] == 0), f"row {r}: bad value padding"


def from_h_dense(
    h: np.ndarray,
    name: str,
    rs_n: int = 0,
    rs_k: int = 0,
    dmax: int | None = None,
) -> LDPCCode:
    """Build an LDPCCode from a dense (or scipy-sparse) parity-check matrix.

    ``h`` may carry GF(256) coefficients; gf_order is inferred from the values.
    """
    if hasattr(h, "toarray"):
        h = h.toarray()
    h = np.asarray(h)
    if h.dtype == np.float64 or h.dtype == np.float32:
        assert np.all(h == np.round(h))
    h = h.astype(np.int64)
    m, n = h.shape
    k = n - m
    degs = (h != 0).sum(axis=1)
    dm = dmax or int(degs.max())
    vlist_idx = np.full((m, dm), n, dtype=np.int32)
    vlist_val = np.zeros((m, dm), dtype=np.uint8)
    for r in range(m):
        cols = np.nonzero(h[r])[0]
        vlist_idx[r, : cols.size] = cols
        vlist_val[r, : cols.size] = h[r, cols]
    gf_order = 256 if np.any(h > 1) else 2
    return LDPCCode(
        name=name,
        n=n,
        k=k,
        vlist_idx=vlist_idx,
        vlist_len=degs.astype(np.int32),
        vlist_val=vlist_val,
        rs_n=rs_n,
        rs_k=rs_k,
        gf_order=gf_order,
    )
