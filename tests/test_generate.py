"""Code-construction tests: generators, cycle predicate/census, grid code.

Model: the reference validates constructions by cycle census
(Matlab/Hcyclefinder.m) and by using them in the sims; here the generated
codes are additionally run end-to-end through the device decode path.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ldpc_erasure_codes_tpu.codes import get_code
from ldpc_erasure_codes_tpu.codes.generate import (
    _Graph,
    cycle_census,
    expand_profile,
    gen_column_wise,
    gen_row_wise,
    grid_code,
    weight_histograms,
)


def test_expand_profile():
    np.testing.assert_array_equal(
        expand_profile([(2, 5), (3, 2)]), [5, 5, 2, 2, 2]
    )
    with pytest.raises(ValueError):
        expand_profile([(2, 3), (1, 5)])  # ascending degrees


def test_profile_edge_balance():
    with pytest.raises(ValueError):
        gen_row_wise([(10, 4)], [(20, 3)])  # 40 != 60


def test_cycle_predicate_matches_census():
    """Randomized dual-oracle test: the incremental predicate must agree with
    the whole-matrix census about whether an edge closes a 4/6-cycle."""
    rng = np.random.default_rng(1)
    g = _Graph(40, 20)
    for _ in range(250):
        v, c = int(rng.integers(40)), int(rng.integers(20))
        if c in g.var_checks[v]:
            continue
        pred = g.creates_short_cycle(v, c)
        g.add_edge(v, c)
        truth = not cycle_census(g.to_dense()).girth_at_least_8
        assert pred == truth, (v, c)
        if pred:
            g.var_checks[v].remove(c)
            g.check_vars[c].remove(v)
    assert cycle_census(g.to_dense()).girth_at_least_8


def test_census_counts_known_graph():
    # A single 4-cycle: two vars sharing two checks.
    h = np.zeros((2, 2), dtype=np.uint8)
    h[:, 0] = 1
    h[:, 1] = 1
    cen = cycle_census(h)
    assert cen.num_4.sum() > 0
    # A pure 6-cycle: 3 vars, 3 checks in a ring.
    h6 = np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1]], dtype=np.uint8)
    cen6 = cycle_census(h6)
    assert not cen6.num_4.any()
    assert cen6.num_6.sum() > 0


@pytest.fixture(scope="module")
def row_code():
    return gen_row_wise([(102, 6)], [(204, 3)], seed=7, max_tries=60, strict_tries=5)


def test_row_wise_girth8_triangular(row_code):
    c = row_code
    assert (c.n, c.k) == (204, 102)
    assert c.is_triangular
    assert cycle_census(c).girth_at_least_8
    rw, cw = weight_histograms(c)
    # Row weights concentrate at the profile value (6); slack +1 allowed.
    assert rw[:5].sum() == 0 or rw.argmax() >= 5


def test_column_wise_girth8_triangular():
    c = gen_column_wise(
        [(51, 4)], [(102, 2)], seed=9, max_tries=120, strict_tries=10
    )
    assert (c.n, c.k) == (102, 51)
    assert c.is_triangular
    # Improvement over the reference: girth 8 holds for the *finished* matrix
    # (triangle diagonals are pre-seeded into the cycle tests).
    assert cycle_census(c).girth_at_least_8


def test_column_wise_nonsystematic():
    c = gen_column_wise(
        [(51, 4)], [(102, 2)], systematic=False, seed=11, max_tries=120
    )
    assert cycle_census(c).girth_at_least_8
    assert not c.is_triangular or True  # no triangle requirement


def test_generated_code_decodes(row_code):
    """Generated code runs through encode -> channel -> hybrid decode."""
    from ldpc_erasure_codes_tpu import channel as ch
    from ldpc_erasure_codes_tpu.ops import device_arrays, encode, hybrid_decode

    arrays = device_arrays(row_code)
    key = jax.random.key(0)
    src = jax.random.bits(key, (32, row_code.k), dtype=jnp.uint8) & 1
    cw = encode(arrays, src)
    mask = ch.iid_erasures(jax.random.key(1), (32, row_code.n), 0.2)
    recv = ch.apply_erasures(cw, mask)
    v, e, iters, failed = hybrid_decode(arrays, recv, mask, emax=64)
    okmask = np.asarray(~failed)
    assert okmask.sum() >= 28  # rate-1/2 code at PER .2 nearly always decodes
    np.testing.assert_array_equal(
        np.asarray(v)[okmask], np.asarray(cw)[okmask]
    )


def test_grid_code_structure():
    c = grid_code(10, 5)
    assert (c.n, c.k, c.m) == (65, 50, 15)
    cen = cycle_census(c)
    assert cen.girth_at_least_8  # grid codes have 8-cycles but none shorter
    assert cen.num_8.sum() > 0
    h = c.h_dense
    # every source symbol covered by exactly one row parity + one col parity
    assert (h[:, :50].sum(axis=0) == 2).all()


def test_shipped_codes_census():
    """Census of the reference's production codes.

    Finding: (2000,1000) is clean girth-8, but the shipped (2040,1530) and
    (4000,2000) matrices contain a few 6-cycles (51 and 6 root-hits), the
    latter rooted at tail parity columns — the footprint of the reference's
    unchecked post-construction triangle/staircase insertion
    (Hgen_no6cycles_systematic_encoding.m:264-273). None contain 4-cycles.
    """
    expected_6 = {"n2000_k1000": 0, "n2040_k1530": 51, "n4000_k2000": 6}
    for name, want6 in expected_6.items():
        cen = cycle_census(get_code(name))
        n4, n6, _ = cen.totals()
        assert n4 == 0, name
        assert n6 == want6, (name, n6)
