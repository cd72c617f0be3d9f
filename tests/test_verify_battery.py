"""Smoke of the verification battery (utils/verify.py) at small shapes.

Runs the same tier functions ``cli verify`` runs on the device, so a broken
tier fails here instead of silently reporting PASSED on the card.
"""

from ldpc_erasure_codes_tpu.utils.verify import run_battery


def test_battery_quick_all_passed():
    results = run_battery(quick=True)
    assert [r["tier"] for r in results] == [
        "binary_peel",
        "nb_peel",
        "hybrid_ge",
        "rs_wide",
    ]
    for r in results:
        assert r["status"] == "PASSED", r
    # The hybrid tier must actually have exercised the GE fallback.
    hy = next(r for r in results if r["tier"] == "hybrid_ge")
    assert hy["ge_frames"] > 0
