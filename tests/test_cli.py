"""CLI tests: the throughput step's measurement integrity + smoke runs.

The reference's user surface is the OpenCL host CLI (main.cpp:157-170);
here we additionally pin the measurement-integrity property (VALIDATION.md):
a throughput step must consume decoded VALUES, or XLA dead-code-eliminates
the wide value decode and the CLI prints phantom Gbps (the round-1 bug at
utils/cli.py:94-111, fixed in round 2).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_erasure_codes_tpu.codes import get_code
from ldpc_erasure_codes_tpu.ops import device_arrays, encode_packed
from ldpc_erasure_codes_tpu.utils import cli


def test_throughput_step_consumes_values():
    """The jitted step's outputs must depend on the codeword values, not
    just the erasure mask — two different codeword batches under the SAME
    channel key must yield different digests."""
    code = get_code("n2000_k1000")
    arrays = device_arrays(code)
    b, w = 4, 2
    key = jax.random.key(0)
    step = cli.make_throughput_step(
        code, arrays, batch=b, per=0.2, max_iters=50
    )
    src1 = jax.random.bits(jax.random.key(1), (b, code.k, w), dtype=jnp.uint32)
    src2 = jax.random.bits(jax.random.key(2), (b, code.k, w), dtype=jnp.uint32)
    cw1 = encode_packed(arrays, src1)
    cw2 = encode_packed(arrays, src2)
    chan = jax.random.fold_in(key, 7)
    _, d1 = step(chan, cw1)
    _, d2 = step(chan, cw2)
    assert not np.array_equal(np.asarray(d1), np.asarray(d2))


def test_throughput_cli_smoke(capsys):
    rc = cli.main(
        [
            "throughput",
            "--code", "n2000_k1000",
            "--batch", "4",
            "--symbol-words", "2",
            "--per", "0.2",
            "--reps", "2",
        ]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["info_gbps"] > 0
    assert out["symbol_bits"] == 64


def test_codes_cli_smoke(capsys):
    assert cli.main(["codes"]) == 0
    out = capsys.readouterr().out
    assert "n2040_k1530" in out


def test_scaling_cli_smoke(capsys):
    """Scaling sweep runs on the 8-device virtual mesh and reports
    efficiency 1.0 at the base point."""
    rc = cli.main(
        [
            "scaling",
            "--code", "n2000_k1000",
            "--batch", "8",
            "--devices", "1,2,8",
            "--reps", "2",
            "--steps-per-call", "1",
        ]
    )
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert [p["devices"] for p in lines] == [1, 2, 8]
    assert lines[0]["efficiency"] == 1.0
    assert lines[2]["frames"] == 8 * 8 * 2 * 1  # devices*batch*reps*steps


def test_throughput_cli_narrow_symbol_fallback(capsys):
    """A symbol width that is no power of two runs through the same wide
    peel (the replay kernel pads the W axis to its chunk) and the record
    names the device it ran on."""
    rc = cli.main(
        [
            "throughput",
            "--code", "n2000_k1000",
            "--batch", "4",
            "--symbol-words", "3",
            "--per", "0.2",
            "--reps", "1",
        ]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["info_gbps"] > 0
    assert out["symbol_bits"] == 96
    assert out["device"] == {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }
