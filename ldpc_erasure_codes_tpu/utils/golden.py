"""Golden-vector protocol: the MATLAB <-> accelerator integration test.

Reproduces the reference's de-facto integration test (SURVEY §4.1): the
oracle ("MATLAB side") writes encoder-input / encoder-output /
decoder-noisy-input / decoder-output text vector files, the accelerator side
reads them, runs the device kernels, and compares bit-exactly, printing
PASSED/FAILED (Matlab/data_gen_for_OpenCL_erasure_codec.m:53-91,
OpenCL/host/src/main.cpp:274-305,413-425).

File format: one decimal uint16 per line; a 0 in the decoder input marks an
erasure (in-band, main.cpp:380-387 — so golden sources are drawn nonzero);
each value expands to a wide symbol by replication across all 16-bit lanes.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

import numpy as np

from ldpc_erasure_codes_tpu.codes.registry import LDPCCode
from ldpc_erasure_codes_tpu.utils import native, oracle

ENC_IN = "encoder_input.txt"
ENC_OUT = "encoder_output.txt"
DEC_IN = "decoder_noisy_input.txt"
DEC_OUT = "decoder_output.txt"
# NB/RS extension: GF(256) symbols are bytes and zero is a LEGAL symbol
# value, so in-band zero-as-erasure (main.cpp:380-387) cannot mark erasures;
# the non-binary protocol adds an explicit 0/1 mask file instead.
DEC_MASK = "decoder_erasure_mask.txt"


@dataclasses.dataclass
class GoldenSet:
    """One golden frame set on disk (frames concatenated per file)."""

    directory: pathlib.Path
    code_name: str
    n: int
    k: int
    frames: int


def generate_golden(
    code: LDPCCode,
    directory: str | os.PathLike,
    *,
    frames: int = 4,
    per: float = 0.2,
    seed: int = 0,
) -> GoldenSet:
    """Oracle side: draw nonzero 16-bit sources, encode with the NumPy
    MATLAB-semantics encoder, erase i.i.d., decode with the oracle hybrid
    decoder, and write all four vector files."""
    if code.gf_order != 2:
        raise ValueError("golden protocol covers binary codes")
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    enc_in = []
    enc_out = []
    dec_in = []
    dec_out = []
    attempts = 0
    max_attempts = 50 * frames
    while len(enc_in) < frames:
        if attempts >= max_attempts:
            raise RuntimeError(
                f"generate_golden: only {len(enc_in)}/{frames} decodable "
                f"frames after {attempts} draws at per={per} — lower the "
                "erasure rate"
            )
        attempts += 1
        src = rng.integers(1, 1 << 16, size=code.k, dtype=np.uint16)
        # Bit-plane encode through the oracle: replication means every bit
        # plane of a symbol is either the value's bit or zero, so encoding
        # the 16 planes independently equals encoding the replicated symbol.
        src_bits = ((src[None, :] >> np.arange(16)[:, None]) & 1).astype(np.uint8)
        cw_bits = np.stack(
            [oracle.encode_triangular(code, p) for p in src_bits]
        )  # (16, n)
        cw = np.zeros(code.n, dtype=np.uint16)
        for b in range(16):
            cw |= (cw_bits[b].astype(np.uint16) << b)
        erased = rng.random(code.n) < per
        noisy = np.where(erased, 0, cw).astype(np.uint16)
        # Oracle decode of the erasure pattern on every bit plane.
        dec_bits = np.zeros_like(cw_bits)
        ok_all = True
        for b in range(16):
            recv = np.where(erased, -1, cw_bits[b].astype(np.int64))
            out, _, singular = oracle.hybrid_ml_decode(code, recv, peel_iters=10)
            if singular or np.any(out < 0):
                ok_all = False
            dec_bits[b] = np.maximum(out, 0).astype(np.uint8)
        dec = np.zeros(code.n, dtype=np.uint16)
        for b in range(16):
            dec |= (dec_bits[b].astype(np.uint16) << b)
        if not ok_all:
            # Keep golden sets decodable: re-draw this frame (the while
            # loop keeps drawing until the requested count is reached).
            continue
        enc_in.append(src)
        enc_out.append(cw)
        dec_in.append(noisy)
        dec_out.append(dec)
    frames = len(enc_in)
    native.write_vector_file(d / ENC_IN, np.concatenate(enc_in))
    native.write_vector_file(d / ENC_OUT, np.concatenate(enc_out))
    native.write_vector_file(d / DEC_IN, np.concatenate(dec_in))
    native.write_vector_file(d / DEC_OUT, np.concatenate(dec_out))
    return GoldenSet(d, code.name, code.n, code.k, frames)


def generate_golden_nb(
    code: LDPCCode,
    directory: str | os.PathLike,
    *,
    frames: int = 4,
    per: float = 0.15,
    seed: int = 0,
) -> GoldenSet:
    """Oracle side, GF(256) tier: byte symbols through the NumPy NB
    triangular encoder and NB hybrid decoder
    (Matlab/ErasureCodes_NonBinaryLDPCSim.m:172-182,
    My_LDPC_HybridML_NonBinary_Erasure_Decoder.m). Writes the four vector
    files plus the explicit erasure-mask file (see DEC_MASK note)."""
    if code.gf_order != 256:
        raise ValueError("generate_golden_nb needs a GF(256) code")
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    enc_in, enc_out, dec_in, dec_mask, dec_out = [], [], [], [], []
    attempts, max_attempts = 0, 50 * frames
    while len(enc_in) < frames:
        if attempts >= max_attempts:
            raise RuntimeError(
                f"generate_golden_nb: only {len(enc_in)}/{frames} decodable "
                f"frames after {attempts} draws at per={per}"
            )
        attempts += 1
        src = rng.integers(1, 256, size=code.k, dtype=np.uint16)
        cw = oracle.encode_triangular_nb(code, src.astype(np.int64))
        erased = rng.random(code.n) < per
        noisy = np.where(erased, 0, cw).astype(np.uint16)
        recv = np.where(erased, -1, cw)
        out, _iters, singular = oracle.hybrid_ml_decode_nb(
            code, recv, peel_iters=10
        )
        if singular or np.any(out < 0):
            continue
        enc_in.append(src)
        enc_out.append(cw.astype(np.uint16))
        dec_in.append(noisy)
        dec_mask.append(erased.astype(np.uint16))
        dec_out.append(out.astype(np.uint16))
    native.write_vector_file(d / ENC_IN, np.concatenate(enc_in))
    native.write_vector_file(d / ENC_OUT, np.concatenate(enc_out))
    native.write_vector_file(d / DEC_IN, np.concatenate(dec_in))
    native.write_vector_file(d / DEC_MASK, np.concatenate(dec_mask))
    native.write_vector_file(d / DEC_OUT, np.concatenate(dec_out))
    return GoldenSet(d, code.name, code.n, code.k, frames)


def verify_golden_nb(
    code: LDPCCode,
    directory: str | os.PathLike,
    *,
    words: int = 8,
    peel_iters: int = 10,
    emax: int = 128,
) -> tuple[bool, str]:
    """Accelerator side, GF(256) tier: device packed NB encoder + wide NB
    hybrid decoder (symbol-major sweeps), byte symbols replicated across
    ``words`` lanes, compared bit-exactly."""
    import jax.numpy as jnp

    from ldpc_erasure_codes_tpu.ops import (
        device_arrays,
        encode_packed,
        hybrid_decode,
    )

    d = pathlib.Path(directory)
    n, k = code.n, code.k
    enc_in = native.read_vector_file(d / ENC_IN).reshape(-1, k)
    enc_out = native.read_vector_file(d / ENC_OUT).reshape(-1, n)
    dec_in = native.read_vector_file(d / DEC_IN).reshape(-1, n)
    dec_mask = native.read_vector_file(d / DEC_MASK).reshape(-1, n) != 0
    dec_out = native.read_vector_file(d / DEC_OUT).reshape(-1, n)
    frames = enc_in.shape[0]
    arrays = device_arrays(code)

    def expand(vals):  # bytes replicated across W uint8 lanes
        return np.repeat(
            vals.astype(np.uint8)[:, :, None], words, axis=2
        )

    cw = np.asarray(
        encode_packed(arrays, jnp.asarray(expand(enc_in)), gf_order=256)
    )
    enc_ok = np.array_equal(cw[:, :, 0], enc_out.astype(np.uint8)) and bool(
        (cw == cw[:, :, :1]).all()
    )

    sym = expand(dec_in) * ~dec_mask[:, :, None]  # erased slots zero
    v, e, _iters, failed = hybrid_decode(
        arrays,
        jnp.asarray(sym),
        jnp.asarray(dec_mask),
        gf_order=256,
        peel_iters=peel_iters,
        emax=emax,
    )
    v = np.asarray(v)
    dec_ok = (
        not bool(np.asarray(failed).any())
        and np.array_equal(v[:, :, 0], dec_out.astype(np.uint8))
        and bool((v == v[:, :, :1]).all())
    )
    passed = bool(enc_ok and dec_ok)
    report = (
        f"golden-nb {code.name}: frames={frames} encode="
        f"{'PASSED' if enc_ok else 'FAILED'} decode="
        f"{'PASSED' if dec_ok else 'FAILED'}"
    )
    return passed, report


def generate_golden_rs(
    n: int,
    k: int,
    directory: str | os.PathLike,
    *,
    frames: int = 4,
    per: float = 0.2,
    seed: int = 0,
) -> GoldenSet:
    """Oracle side, RS tier: systematic Vandermonde encode + the faithful
    table-optimized MATLAB decoder (oracle.rs_decode,
    My_RS_Decode_Optimize_With_GFTables.m:15-119)."""
    from ldpc_erasure_codes_tpu import gf
    from ldpc_erasure_codes_tpu.rs.code import rs_systematic_generator

    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    g = rs_systematic_generator(n, k)
    enc_in, enc_out, dec_in, dec_mask, dec_out = [], [], [], [], []
    attempts, max_attempts = 0, 50 * frames
    while len(enc_in) < frames:
        if attempts >= max_attempts:
            raise RuntimeError(
                f"generate_golden_rs: only {len(enc_in)}/{frames} decodable "
                f"frames after {attempts} draws at per={per}"
            )
        attempts += 1
        src = rng.integers(1, 256, size=k, dtype=np.uint8)
        cw = gf.gf_matmul_np(src[None, :], g)[0]
        erased = rng.random(n) < per
        if int(erased.sum()) > n - k:
            continue  # beyond the MDS bound — undecodable by any decoder
        recv_ind = np.nonzero(~erased)[0][:k]
        msg = oracle.rs_decode(recv_ind, cw[recv_ind].astype(np.int64), g, k)
        full = gf.gf_matmul_np(
            np.asarray(msg, dtype=np.uint8)[None, :], g
        )[0]
        noisy = np.where(erased, 0, cw).astype(np.uint16)
        enc_in.append(src.astype(np.uint16))
        enc_out.append(cw.astype(np.uint16))
        dec_in.append(noisy)
        dec_mask.append(erased.astype(np.uint16))
        dec_out.append(full.astype(np.uint16))
    native.write_vector_file(d / ENC_IN, np.concatenate(enc_in))
    native.write_vector_file(d / ENC_OUT, np.concatenate(enc_out))
    native.write_vector_file(d / DEC_IN, np.concatenate(dec_in))
    native.write_vector_file(d / DEC_MASK, np.concatenate(dec_mask))
    native.write_vector_file(d / DEC_OUT, np.concatenate(dec_out))
    return GoldenSet(d, f"rs_{n}_{k}", n, k, frames)


def verify_golden_rs(
    n: int,
    k: int,
    directory: str | os.PathLike,
    *,
    words: int = 8,
) -> tuple[bool, str]:
    """Accelerator side, RS tier: device rs_encode (bit-image) +
    batched GF(256) GE solve, byte symbols replicated across ``words``
    lanes, compared bit-exactly against the MATLAB-faithful oracle files."""
    import jax.numpy as jnp

    from ldpc_erasure_codes_tpu.ops import device_arrays
    from ldpc_erasure_codes_tpu.rs.code import rs_code
    from ldpc_erasure_codes_tpu.rs.decode import rs_decode as dev_rs_decode
    from ldpc_erasure_codes_tpu.rs.decode import rs_encode as dev_rs_encode

    d = pathlib.Path(directory)
    enc_in = native.read_vector_file(d / ENC_IN).reshape(-1, k)
    enc_out = native.read_vector_file(d / ENC_OUT).reshape(-1, n)
    dec_in = native.read_vector_file(d / DEC_IN).reshape(-1, n)
    dec_mask = native.read_vector_file(d / DEC_MASK).reshape(-1, n) != 0
    dec_out = native.read_vector_file(d / DEC_OUT).reshape(-1, n)
    frames = enc_in.shape[0]
    code = rs_code(n, k)
    arrays = device_arrays(code)

    def expand(vals):
        return np.repeat(vals.astype(np.uint8)[:, :, None], words, axis=2)

    cw = np.asarray(dev_rs_encode(arrays, jnp.asarray(expand(enc_in))))
    enc_ok = np.array_equal(cw[:, :, 0], enc_out.astype(np.uint8)) and bool(
        (cw == cw[:, :, :1]).all()
    )

    sym = expand(dec_in) * ~dec_mask[:, :, None]
    v, e, failed = dev_rs_decode(arrays, jnp.asarray(sym), jnp.asarray(dec_mask))
    v = np.asarray(v)
    dec_ok = (
        not bool(np.asarray(failed).any())
        and np.array_equal(v[:, :, 0], dec_out.astype(np.uint8))
        and bool((v == v[:, :, :1]).all())
    )
    passed = bool(enc_ok and dec_ok)
    report = (
        f"golden-rs ({n},{k}): frames={frames} encode="
        f"{'PASSED' if enc_ok else 'FAILED'} decode="
        f"{'PASSED' if dec_ok else 'FAILED'}"
    )
    return passed, report


def verify_golden(
    code: LDPCCode,
    directory: str | os.PathLike,
    *,
    words: int = 8,
    peel_iters: int = 10,
    emax: int = 128,
) -> tuple[bool, str]:
    """Accelerator side: read the vector files, run the device packed
    encoder and hybrid decoder, compare bit-exactly.

    Returns (passed, report). Mirrors the host harness verify_output()
    (main.cpp:298-305,413-425) for both the encode and decode directions.
    """
    import jax.numpy as jnp

    from ldpc_erasure_codes_tpu.ops import device_arrays, encode_packed, hybrid_decode

    d = pathlib.Path(directory)
    n, k = code.n, code.k
    enc_in = native.read_vector_file(d / ENC_IN).reshape(-1, k)
    enc_out = native.read_vector_file(d / ENC_OUT).reshape(-1, n)
    dec_in = native.read_vector_file(d / DEC_IN).reshape(-1, n)
    dec_out = native.read_vector_file(d / DEC_OUT).reshape(-1, n)
    frames = enc_in.shape[0]
    arrays = device_arrays(code)

    # Encode direction.
    src = np.stack([native.expand_symbols(f, words)[0] for f in enc_in])
    cw = np.asarray(encode_packed(arrays, jnp.asarray(src)))
    cw_vals = np.stack([native.collapse_symbols(f) for f in cw])
    enc_ok = np.array_equal(cw_vals, enc_out)

    # Decode direction.
    sym = np.stack([native.expand_symbols(f, words)[0] for f in dec_in])
    er = np.stack([native.expand_symbols(f, words)[1] for f in dec_in])
    v, e, iters, failed = hybrid_decode(
        arrays,
        jnp.asarray(sym),
        jnp.asarray(er),
        peel_iters=peel_iters,
        emax=emax,
    )
    v = np.asarray(v)
    dec_vals = np.stack([native.collapse_symbols(f) for f in v])
    dec_ok = (not bool(np.asarray(failed).any())) and np.array_equal(
        dec_vals, dec_out
    )

    passed = bool(enc_ok and dec_ok)
    report = (
        f"golden {code.name}: frames={frames} encode="
        f"{'PASSED' if enc_ok else 'FAILED'} decode="
        f"{'PASSED' if dec_ok else 'FAILED'}"
    )
    return passed, report
