"""Native C++ IO library and golden-vector protocol tests.

The golden protocol is the reference's MATLAB<->OpenCL cross-validation
(SURVEY §4.1); the native lib is the analog of the C++ host
harness's file readers (OpenCL/host/src/main.cpp:329-401)."""

import numpy as np
import pytest

from ldpc_erasure_codes_tpu.codes import get_code, toy_code
from ldpc_erasure_codes_tpu.utils import native
from ldpc_erasure_codes_tpu.utils.golden import generate_golden, verify_golden


def test_native_lib_builds():
    # g++ is baked into the image; the native path should be live.
    assert native.have_native()


def test_vector_file_roundtrip(tmp_path):
    vals = np.array([1, 2, 65535, 42, 0, 7], dtype=np.uint16)
    p = tmp_path / "v.txt"
    native.write_vector_file(p, vals)
    got = native.read_vector_file(p)
    np.testing.assert_array_equal(got, vals)
    # Reference files may carry comma-separated extras; first token wins.
    p2 = tmp_path / "v2.txt"
    p2.write_text("5, 99\n6, 98\n")
    np.testing.assert_array_equal(native.read_vector_file(p2), [5, 6])


def test_expand_collapse_symbols():
    vals = np.array([1, 0, 0xBEEF], dtype=np.uint16)
    sym, er = native.expand_symbols(vals, words=4)
    assert sym.shape == (3, 4)
    np.testing.assert_array_equal(er, [False, True, False])
    assert sym[0, 0] == 0x00010001
    assert sym[2, 3] == 0xBEEFBEEF
    assert (sym[1] == 0).all()  # erased slots zero
    back = native.collapse_symbols(sym)
    np.testing.assert_array_equal(back, [1, 0, 0xBEEF])
    with pytest.raises(ValueError):
        bad = sym.copy()
        bad[2, 1] ^= 1
        native.collapse_symbols(bad)


def test_pack_unpack_bitplanes_roundtrip():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(2, 64, 9), dtype=np.uint8)
    packed = native.pack_bitplanes(bits)
    assert packed.shape == (2, 9, 2)
    back = native.unpack_bitplanes(packed)
    np.testing.assert_array_equal(back, bits)
    # Bit placement: plane s -> bit s%32 of word s//32.
    one = np.zeros((1, 64, 3), dtype=np.uint8)
    one[0, 37, 2] = 1
    p = native.pack_bitplanes(one)
    assert p[0, 2, 1] == 1 << 5


def test_pack_bitplanes_native_matches_numpy():
    if not native.have_native():
        pytest.skip("no toolchain")
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, size=(3, 96, 17), dtype=np.uint8)
    lib = native.load_native
    # Force the NumPy fallback by calling the internals directly.
    got_native = native.pack_bitplanes(bits)
    w = 96 // 32
    planes = bits.reshape(3, w, 32, 17).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))[None, None, :, None]
    want = (planes * weights).sum(axis=2, dtype=np.uint32).transpose(0, 2, 1)
    np.testing.assert_array_equal(got_native, want)


def test_vlist_header_roundtrip(tmp_path):
    code = toy_code(n=24, k=16, seed=2)
    p = tmp_path / "vlist.h"
    native.write_vlist_header(p, code.vlist_idx, code.vlist_len, cols=code.dmax + 2)
    ints = native.parse_header_ints(p)
    # Re-assemble: rows of [deg, 1-based cols..., 0 pad].
    cols = code.dmax + 2
    rows = ints.reshape(code.m, cols)
    for r in range(code.m):
        d = int(rows[r, 0])
        assert d == int(code.vlist_len[r])
        np.testing.assert_array_equal(
            rows[r, 1 : 1 + d] - 1, code.vlist_idx[r, :d]
        )
        assert (rows[r, 1 + d :] == 0).all()


def test_parse_reference_master_rom():
    """Parse the reference's actual generated Vlist ROM natively and check it
    against the registry (which was imported through the Python parser)."""
    import os

    path = "/root/reference/OpenCL/device/LDPC_Vlist_data.h"
    if not os.path.exists(path):
        pytest.skip("reference not present")
    text_ints = native.parse_header_ints(path, max_vals=64)
    # First top-level array is ldpc_params[2][6]:
    # {2000,1000,0,999,250,125},{2040,1530,1000,1509,255,192}
    np.testing.assert_array_equal(
        text_ints[:12], [2000, 1000, 0, 999, 250, 125, 2040, 1530, 1000, 1509, 255, 192]
    )


def test_golden_roundtrip(tmp_path):
    code = get_code("n2000_k1000")
    gs = generate_golden(code, tmp_path, frames=2, per=0.25, seed=1)
    assert gs.frames >= 1
    passed, report = verify_golden(code, tmp_path, words=4, emax=128)
    assert passed, report
    assert "PASSED" in report


def test_golden_detects_corruption(tmp_path):
    code = get_code("n2000_k1000")
    generate_golden(code, tmp_path, frames=1, per=0.2, seed=2)
    # Corrupt one encoder-output value -> encode comparison must fail.
    from ldpc_erasure_codes_tpu.utils.golden import ENC_OUT

    vals = native.read_vector_file(tmp_path / ENC_OUT)
    vals[5] ^= 1
    native.write_vector_file(tmp_path / ENC_OUT, vals)
    passed, report = verify_golden(code, tmp_path, words=4)
    assert not passed
    assert "encode=FAILED" in report


def test_golden_nb_roundtrip(tmp_path):
    """GF(256) golden protocol: NB oracle files -> device packed NB encode +
    wide NB hybrid decode, bit-exact (explicit mask file, since 0x00 is a
    legal GF(256) symbol value)."""
    from ldpc_erasure_codes_tpu.codes import toy_code
    from ldpc_erasure_codes_tpu.utils.golden import (
        generate_golden_nb,
        verify_golden_nb,
    )

    code = toy_code(n=60, k=36, seed=2, gf_order=256)
    gs = generate_golden_nb(code, tmp_path, frames=3, per=0.08, seed=1)
    assert gs.frames == 3
    passed, report = verify_golden_nb(code, tmp_path, words=4, emax=32)
    assert passed, report


def test_golden_rs_roundtrip(tmp_path):
    """RS golden protocol: MATLAB-faithful oracle decode
    (My_RS_Decode_Optimize_With_GFTables.m) vs the device GE solve."""
    from ldpc_erasure_codes_tpu.utils.golden import (
        generate_golden_rs,
        verify_golden_rs,
    )

    gs = generate_golden_rs(15, 11, tmp_path, frames=4, per=0.2, seed=3)
    assert gs.frames == 4
    passed, report = verify_golden_rs(15, 11, tmp_path, words=4)
    assert passed, report


def test_golden_nb_detects_corruption(tmp_path):
    from ldpc_erasure_codes_tpu.codes import toy_code
    from ldpc_erasure_codes_tpu.utils.golden import (
        DEC_OUT,
        generate_golden_nb,
        verify_golden_nb,
    )

    code = toy_code(n=60, k=36, seed=2, gf_order=256)
    generate_golden_nb(code, tmp_path, frames=1, per=0.08, seed=4)
    vals = native.read_vector_file(tmp_path / DEC_OUT)
    vals[7] ^= 0x5A
    native.write_vector_file(tmp_path / DEC_OUT, vals)
    passed, report = verify_golden_nb(code, tmp_path, words=4, emax=32)
    assert not passed
    assert "decode=FAILED" in report
