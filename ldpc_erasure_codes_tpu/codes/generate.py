"""Girth-8 LDPC code construction (host-side, NumPy).

From-scratch re-implementation of the reference's probabilistic
"bit-filling"-style generators (paper Latex/Milcom_2022_ErasureCodes.tex:109)
covering all four variants:

* column-wise, systematic triangle form
  (Matlab/Hgen_no6cycles_systematic_encoding.m:17-278);
* column-wise, non-systematic (Matlab/Hgen_no6cycles.m — same core without
  the triangle restriction/insertion);
* row-wise with regular variable degree
  (Matlab/Hgen_regularDegree_no6cycles_systematic_encoding.m:17-226);
* row-wise with irregular variable degree profile
  (Matlab/Hgen_irregularDegree_no6cycles_systematic_encoding.m — dv taken
  per-column from the profile).

Plus the cycle machinery: the local girth test that gates each candidate edge
(Matlab/Cycle_Finder_length4_fromroot.m:3-19, Matlab/Cycle_Finder_length6.m:2-76)
and the whole-matrix 4/6/8-cycle census (Matlab/Hcyclefinder.m:19-147), the toy
grid product code (Matlab/Grid_Erasure_Code_Parity_gen.m:1-34), and the
row/column weight histograms (Matlab/scratch.m:1-11).

Code construction runs once per code on the host — it is deliberately not a
device kernel (SURVEY.md §7 stage 2). Degree profiles are lists of
``(count, degree)`` pairs, highest degree first, matching the reference's
``deg_*_prof`` convention.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ldpc_erasure_codes_tpu.codes.registry import LDPCCode, from_h_dense

Profile = list[tuple[int, int]]


def expand_profile(prof: Profile) -> np.ndarray:
    """[(count, degree), ...] -> per-node degree vector (descending blocks)."""
    out: list[int] = []
    last = None
    for cnt, deg in prof:
        if last is not None and deg > last:
            raise ValueError("profile degrees must be non-increasing")
        last = deg
        out.extend([deg] * cnt)
    return np.asarray(out, dtype=np.int64)


def check_profiles(deg_c_prof: Profile, deg_v_prof: Profile) -> tuple[int, int]:
    """Validate edge-count balance; returns (n, m)."""
    dc = expand_profile(deg_c_prof)
    dv = expand_profile(deg_v_prof)
    if dc.sum() != dv.sum():
        raise ValueError(
            f"edge mismatch: checks want {int(dc.sum())}, vars want {int(dv.sum())}"
        )
    return len(dv), len(dc)


class _Graph:
    """Mutable bipartite adjacency during construction (0-based indices)."""

    def __init__(self, n: int, m: int):
        self.n = n
        self.m = m
        self.var_checks: list[list[int]] = [[] for _ in range(n)]  # per column
        self.check_vars: list[list[int]] = [[] for _ in range(m)]  # per row

    def add_edge(self, v: int, c: int) -> None:
        self.var_checks[v].append(c)
        self.check_vars[c].append(v)

    def remove_edge(self, v: int, c: int) -> None:
        self.var_checks[v].remove(c)
        self.check_vars[c].remove(v)

    def creates_short_cycle(self, v: int, c: int) -> bool:
        """Would edge (v, c) close a cycle of length < 8?

        Equivalent to the reference's add-then-test with the 4- and 6-cycle
        finders rooted at v (Hgen_regularDegree...m:160-161): after adding
        (v, c), the tree rooted at v must have unique tier-1 variable nodes
        (else a 4-cycle) and unique tier-2 check nodes (else a 6-cycle).
        Tested incrementally — only paths through the new edge can create a
        new short cycle.
        """
        vset = set(self.check_vars[c])
        if v in vset:
            return True  # parallel edge
        # 4-cycle: a variable sharing two checks with v.
        tier1_v: set[int] = set()
        for cc in self.var_checks[v]:
            for vv in self.check_vars[cc]:
                if vv != v:
                    if vv in tier1_v:
                        return True  # pre-existing; defensive
                    tier1_v.add(vv)
        for vv in vset:
            if vv in tier1_v:
                return True
        # 6-cycle: a check reachable at distance 2 from v along two paths.
        # Existing tier-2 checks (via existing tier-1):
        tier2_c: set[int] = set(self.var_checks[v])
        dup = False
        for cc in self.var_checks[v]:
            for vv in self.check_vars[cc]:
                if vv == v:
                    continue
                for c2 in self.var_checks[vv]:
                    if c2 == cc:
                        continue
                    if c2 == c:
                        return True  # new edge would duplicate check c
                    if c2 in tier2_c:
                        dup = True  # pre-existing short cycle elsewhere
                    tier2_c.add(c2)
        if c in tier2_c:
            return True
        tier2_c.add(c)
        # New tier-2 checks through the candidate edge:
        for vv in vset:
            for c2 in self.var_checks[vv]:
                if c2 == c:
                    continue
                if c2 in tier2_c:
                    return True
                tier2_c.add(c2)
        return dup

    def to_dense(self) -> np.ndarray:
        h = np.zeros((self.m, self.n), dtype=np.uint8)
        for c, vs in enumerate(self.check_vars):
            h[c, vs] = 1
        return h


def _weighted_pick(rng: np.random.Generator, cands: np.ndarray, w: np.ndarray) -> int:
    """Sample one candidate with probability proportional to ``w``."""
    tot = int(w.sum())
    if tot <= 0:
        return int(cands[0])
    u = rng.random()
    target = int(np.ceil(tot * u))
    cum = np.cumsum(w)
    idx = int(np.searchsorted(cum, max(target, 1)))
    return int(cands[min(idx, len(cands) - 1)])


def _staircase_cleanup(g: _Graph, k: int) -> None:
    """Give weight-1 parity columns a second, below-diagonal edge.

    Reference behavior: unconditionally add the subdiagonal 1
    (Hgen_no6cycles_systematic_encoding.m:267-271 and
    Hgen_regularDegree...m:213-220). Improvement here: the subdiagonal slot is
    cycle-tested first and the edge walks further down the column until a
    girth-preserving row is found (any row below the diagonal keeps the
    triangle property); a column is left at weight 1 only if every slot would
    close a 4/6-cycle (harmless for erasure decoding — the diagonal check
    still recovers it)."""
    n, m = g.n, g.m
    for col in range(k, n - 1):
        if len(g.var_checks[col]) != 1:
            continue
        for row in range(col - k + 1, m):
            if not g.creates_short_cycle(col, row):
                g.add_edge(col, row)
                break


def gen_column_wise(
    deg_c_prof: Profile,
    deg_v_prof: Profile,
    *,
    systematic: bool = True,
    seed: int = 0,
    max_tries: int = 200,
    strict_tries: int = 10,
    name: str | None = None,
) -> LDPCCode:
    """Column-major girth-8 construction.

    Walks variable nodes in profile order; each edge picks a check node with
    probability proportional to its residual degree need, restricted (in
    systematic mode) to checks at/below the column's triangle diagonal with
    unmet above-diagonal need redistributed round-robin below
    (Hgen_no6cycles_systematic_encoding.m:146-158); an edge is kept only if
    it closes no 4- or 6-cycle. A column that cannot place all its edges
    aborts the attempt and the build restarts with fresh randomness.

    Deviation (improvement) from the reference: the triangle diagonal edges
    are pre-seeded into the graph before construction so every candidate edge
    is cycle-tested against them. The reference inserts the triangle *after*
    construction without re-checking (Hgen_no6cycles_systematic_encoding.m:264-273),
    which can silently close 4/6-cycles through the inserted diagonals; here
    the girth-8 guarantee holds for the finished matrix (staircase-cleanup
    edges under weight-1 columns excepted, as in the reference).
    """
    n, m = check_profiles(deg_c_prof, deg_v_prof)
    k = n - m
    dv = expand_profile(deg_v_prof)
    dc0 = expand_profile(deg_c_prof)
    rng = np.random.default_rng(seed)

    for _try in range(max_tries):
        # Endgame escape hatch: after the strict attempts, allow check degrees
        # to overshoot by one (the reference carries the same knob, commented:
        # Hgen_regularDegree_no6cycles_systematic_encoding.m:79) — without it
        # tight profiles restart indefinitely on the last few columns.
        dc = dc0 + 1 if _try >= strict_tries else dc0
        g = _Graph(n, m)
        dc_cur = np.zeros(m, dtype=np.int64)
        ok = True
        for col in range(n):
            if systematic and col >= k:
                # Seed this column's triangle diagonal before its random
                # edges so every subsequent cycle test sees it (the girth-8
                # improvement over the reference's post-hoc insertion).
                g.add_edge(col, col - k)
            if systematic and col >= n - 2:
                continue  # last two columns take triangle edges only
            if not systematic or col < k:
                temp_dc = dc
                avail = np.nonzero(temp_dc - dc_cur)[0]
            else:
                r0 = col - k  # 0-based diagonal row of this parity column
                missed = int((dc[:r0] - dc_cur[:r0]).sum())
                temp_dc = dc.copy()
                span = n - col - 2  # rows r0 .. r0+span-1 absorb the slack
                if span > 0:
                    for j in range(1, missed + 1):
                        temp_dc[r0 + (j % span)] += 1
                avail = r0 + np.nonzero(temp_dc[r0:] - dc_cur[r0:])[0]
            placed = 0
            tried: set[int] = set()
            while placed < dv[col]:
                cands = np.asarray([c for c in avail if c not in tried])
                if cands.size == 0:
                    break
                w = temp_dc[cands] - dc_cur[cands]
                c = _weighted_pick(rng, cands, w)
                tried.add(c)
                if systematic and col >= k and c == col - k:
                    # Merges with the seeded diagonal (the reference allows a
                    # random edge on the diagonal slot; insertion is idempotent).
                    dc_cur[c] += 1
                    placed += 1
                elif not g.creates_short_cycle(col, c):
                    g.add_edge(col, c)
                    dc_cur[c] += 1
                    placed += 1
            if placed < dv[col]:
                ok = False
                break
        if ok:
            if systematic:
                _staircase_cleanup(g, k)
            h = g.to_dense()
            nm = name or (
                f"gen_col_n{n}_k{k}" + ("" if systematic else "_nonsys")
            )
            code = from_h_dense(h, nm)
            code.validate()
            return code
    raise RuntimeError(
        f"column-wise construction failed after {max_tries} tries "
        f"(profile too tight for girth 8?)"
    )


def gen_row_wise(
    deg_c_prof: Profile,
    deg_v_prof: Profile,
    *,
    seed: int = 0,
    max_tries: int = 200,
    strict_tries: int = 10,
    relax_tail: float = 0.997,
    backtrack_depth: int = 4,
    backtrack_budget: int = 400,
    name: str | None = None,
) -> LDPCCode:
    """Row-major girth-8 systematic construction.

    For each check row, place ``row_weight - 1`` edges on columns left of the
    triangle diagonal, sampling with a cube-law preference for columns with
    the most unmet degree (Hgen_regularDegree...m:131-142); each edge must
    close no 4/6-cycle; the diagonal edge is appended afterwards. Column
    degree targets relax by +1 for the last ``1 - relax_tail`` fraction of
    rows (:108-110). A regular code is the single-entry ``deg_v_prof`` case;
    a per-column profile gives the irregular variant.
    """
    n, m = check_profiles(deg_c_prof, deg_v_prof)
    k = n - m
    dv0 = expand_profile(deg_v_prof)
    dc = expand_profile(deg_c_prof)
    rng = np.random.default_rng(seed)

    for _try in range(max_tries):
        # Same endgame escape hatch as gen_column_wise: the reference's
        # commented "allow to go over by 1" knob (Hgen_regularDegree...m:79).
        dv = dv0 + 1 if _try >= strict_tries else dv0
        # Strict attempts fail fast like the reference (their profile may be
        # infeasible for girth 8); backtracking only arms on slack attempts.
        budget = backtrack_budget if _try >= strict_tries else 0
        g = _Graph(n, m)
        dv_cur = np.zeros(n, dtype=np.int64)
        journal: list[list[int]] = []  # per completed row: its random columns
        backtracks = 0
        row = 0
        ok = True

        def fill_row(row: int) -> list[int] | None:
            temp_dv = dv + 1 if (row + 1) / m > relax_tail else dv
            limit = k + row  # columns >= k+row are at/right of the diagonal
            placed: list[int] = []
            tried: set[int] = set()
            want = dc[row] - 1
            while len(placed) < want:
                need = temp_dv[:limit] - dv_cur[:limit]
                cands = np.asarray(
                    [v for v in np.nonzero(need > 0)[0] if v not in tried]
                )
                if cands.size == 0:
                    for v in placed:  # undo the partial row
                        g.remove_edge(v, row)
                        dv_cur[v] -= 1
                    return None
                w = (temp_dv[cands] - dv_cur[cands]) ** 3  # cube law
                v = _weighted_pick(rng, cands, w)
                tried.add(v)
                if not g.creates_short_cycle(v, row):
                    g.add_edge(v, row)
                    dv_cur[v] += 1
                    placed.append(v)
            g.add_edge(k + row, row)  # triangle diagonal
            dv_cur[k + row] += 1
            return placed

        best_row = 0  # deepest frontier reached since the last escalation reset
        stuck = 0  # consecutive failures without pushing past best_row
        while row < m - 1:
            placed = fill_row(row)
            if placed is not None:
                journal.append(placed)
                row += 1
                if row > best_row:
                    best_row = row
                    stuck = 0
                continue
            # Endgame rescue: instead of the reference's whole-matrix restart,
            # unwind recent rows and redraw them. The rollback depth escalates
            # exponentially while the frontier fails to advance, so local
            # traps are escaped instead of cycled in.
            stuck += 1
            depth = min(row, backtrack_depth << min(stuck // 3, 8))
            if depth == 0 or backtracks >= budget:
                ok = False
                break
            backtracks += 1
            for _ in range(depth):
                row -= 1
                for v in journal.pop():
                    g.remove_edge(v, row)
                    dv_cur[v] -= 1
                g.remove_edge(k + row, row)
                dv_cur[k + row] -= 1
        if ok:
            g.add_edge(n - 1, m - 1)  # closing corner (last column's diagonal)
            _staircase_cleanup(g, k)
            code = from_h_dense(g.to_dense(), name or f"gen_row_n{n}_k{k}")
            code.validate()
            return code
    raise RuntimeError(f"row-wise construction failed after {max_tries} tries")


# ---------------------------------------------------------------------------
# Cycle census and diagnostics
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CycleCensus:
    """Per-root cycle counts (root = variable node), as Hcyclefinder reports
    them: for each root, the number of duplicate-pair hits at variable tier 1
    (4-cycles), check tier 2 (6-cycles) and variable tier 2 (8-cycles).
    Aggregate totals count each cycle once per participating root."""

    num_4: np.ndarray
    num_6: np.ndarray
    num_8: np.ndarray

    @property
    def girth_at_least_8(self) -> bool:
        return not (self.num_4.any() or self.num_6.any())

    def totals(self) -> tuple[int, int, int]:
        return int(self.num_4.sum()), int(self.num_6.sum()), int(self.num_8.sum())


def _dup_count(arr: list[int]) -> int:
    """Number of adjacent-equal pairs after sorting = sum(multiplicity - 1)."""
    if not arr:
        return 0
    vals, cnts = np.unique(np.asarray(arr), return_counts=True)
    return int((cnts - 1).sum())


def cycle_census(h: np.ndarray | LDPCCode) -> CycleCensus:
    """Count 4-, 6- and 8-cycles rooted at every variable node.

    Re-implementation of Matlab/Hcyclefinder.m:61-144 (without its stale-
    buffer artifact: MATLAB reuses ``c_tier_2``/``v_tier_2`` across roots
    without clearing, so shorter tiers read leftovers; here every root's
    tiers are built fresh)."""
    if isinstance(h, LDPCCode):
        h = h.h_dense
    h = np.asarray(h) != 0
    m, n = h.shape
    check_vars = [np.nonzero(h[c])[0] for c in range(m)]
    var_checks = [np.nonzero(h[:, v])[0] for v in range(n)]
    n4 = np.zeros(n, dtype=np.int64)
    n6 = np.zeros(n, dtype=np.int64)
    n8 = np.zeros(n, dtype=np.int64)
    for root in range(n):
        tier1: list[tuple[int, int]] = []  # (vnode, parent check)
        for c in var_checks[root]:
            for v in check_vars[c]:
                if v != root:
                    tier1.append((int(v), int(c)))
        n4[root] = _dup_count([v for v, _ in tier1])
        tier2c: list[tuple[int, int]] = []  # (check, parent vnode)
        for v, pc in tier1:
            for c in var_checks[v]:
                if c != pc:
                    tier2c.append((int(c), v))
        n6[root] = _dup_count([c for c, _ in tier2c])
        tier2v: list[int] = []
        for c, pv in tier2c:
            for v in check_vars[c]:
                if v != pv:
                    tier2v.append(int(v))
        n8[root] = _dup_count(tier2v)
    return CycleCensus(n4, n6, n8)


def grid_code(rows: int, cols: int, name: str | None = None) -> LDPCCode:
    """Product (grid) code: one parity per row and per column of a rows x cols
    source array (Matlab/Grid_Erasure_Code_Parity_gen.m:1-34). Toy baseline;
    not triangle-form (its parity region is the identity)."""
    k = rows * cols
    m = rows + cols
    n = k + m
    h = np.zeros((m, n), dtype=np.uint8)
    for r in range(rows):
        h[r, r * cols : (r + 1) * cols] = 1
        h[r, k + r] = 1
    for c in range(cols):
        h[rows + c, c::cols][:rows] = 1
        h[rows + c, k + rows + c] = 1
    return from_h_dense(h, name or f"grid_{rows}x{cols}")


def weight_histograms(h: np.ndarray | LDPCCode) -> tuple[np.ndarray, np.ndarray]:
    """(row-weight histogram, column-weight histogram), index = weight
    (Matlab/scratch.m:1-11)."""
    if isinstance(h, LDPCCode):
        h = h.h_dense
    h = np.asarray(h) != 0
    rw = h.sum(axis=1)
    cw = h.sum(axis=0)
    return (
        np.bincount(rw.astype(np.int64)),
        np.bincount(cw.astype(np.int64)),
    )
