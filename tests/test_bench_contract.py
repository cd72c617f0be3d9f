"""Bench contract: ``python bench.py`` must emit one parseable JSON line,
naming the device it ran on, within its wall-clock budget.

Reference analog: the PASSED/FAILED discipline of the OpenCL host harness
(/root/reference/OpenCL/host/src/main.cpp:298-305).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_quick_emits_one_json_line_within_budget(tmp_path):
    """End-to-end: bench.py --quick on CPU finishes fast and prints exactly
    one stdout line that parses as the driver's expected JSON schema."""
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(
        BENCH_PLATFORM="cpu",
        BENCH_BATCH="4",
        BENCH_REPS="2",
        JAX_PLATFORMS="",  # let BENCH_PLATFORM decide
    )
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--quick"],
        capture_output=True,
        text=True,
        timeout=180,
        env=env,
        cwd=tmp_path,
    )
    elapsed = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, f"stdout must be ONE JSON line, got: {proc.stdout!r}"
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert rec["device"]["platform"] == "cpu"
    assert rec["value"] > 0
    assert elapsed < 180
    # The CPU backend keeps no persistent compile cache (utils/cache.py).
    assert not os.path.exists(os.path.join(tmp_path, ".jax_cache"))


def test_bench_without_gpu_fails_and_prints_nothing(tmp_path):
    """With no GPU and no explicit CPU opt-in, bench.py exits non-zero and
    prints no result: a measurement never falls back to the CPU."""
    env = dict(os.environ)
    env.pop("BENCH_PLATFORM", None)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--quick"],
        capture_output=True,
        text=True,
        timeout=120,
        env=env,
        cwd=tmp_path,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs a GPU" in proc.stderr
