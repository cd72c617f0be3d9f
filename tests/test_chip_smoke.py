"""chip_smoke.py's phases at tiny sizes on the CPU.

On the card the script runs them at production sizes; here each phase runs
the same code path on small inputs, so a broken phase fails in the suite
first. The script itself refuses to run without a GPU.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_headline_phase_small():
    rec = chip_smoke.phase_headline(b=4, w=2, reps=2)
    assert rec["ok"], rec
    assert rec["word_mismatches"] == 0 and rec["frames"] == 8


def test_hybrid_phase_small_fires_ge():
    rec = chip_smoke.phase_hybrid(
        0.42, 512, 16, b=16, w=2, code_name="n2000_k1000"
    )
    assert rec["ok"], rec
    assert rec["ge_frames"] > 0
    assert rec["value_mismatches_on_solved"] == 0


def test_hybrid_phase_band_rejects_wrong_rate():
    """A reference FER far from the run's own makes the phase fail."""
    rec = chip_smoke.phase_hybrid(
        0.42, 512, 16, b=16, w=2, code_name="n2000_k1000", fer_ref=0.9
    )
    assert not rec["ok"]


def test_nb_hybrid_phase_small():
    rec = chip_smoke.phase_hybrid(
        0.21, 256, 8, b=8, w=8, code_name="n2040_k1530_gf256", gf_order=256
    )
    assert rec["ok"], rec


def test_rs_phase_small():
    rec = chip_smoke.phase_rs(b=16, wb=8)
    assert rec["ok"], rec


def test_sim_phase_small_masks_match_cpu():
    rec = chip_smoke.phase_sim(
        batch=32, steps_per_call=2, calls=2, per=0.1875, fer_ref=None
    )
    assert rec["ok"], rec
    assert rec["erased_symbols_device"] == rec["erased_symbols_cpu"] > 0


def test_four_phase_on_virtual_devices():
    rec = chip_smoke.phase_four(batch=16)
    assert rec["ok"], rec
    assert rec["frames"] == 64


@pytest.mark.parametrize(
    "p,frames", [(4.72e-3, 1024), (4.72e-3, 65536), (0.5, 10), (0.0, 1024)]
)
def test_fer_band_contains_mean(p, frames):
    lo, hi = chip_smoke.fer_band(p, frames)
    assert lo <= p * frames <= hi
    assert hi - lo >= 1


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    cap = capsys.readouterr()
    assert cap.out == ""
    assert "needs a GPU" in cap.err


def test_script_alone_fails_without_repo(tmp_path):
    """Copied into an empty directory, the script exits non-zero and prints
    no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        timeout=120, cwd=tmp_path, env=env,
    )
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises((json.JSONDecodeError, TypeError, KeyError)):
            assert not json.loads(line)["ok"]
