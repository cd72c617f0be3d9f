"""Configuration dataclasses for the simulation driver.

The reference configures by editing commented-out MATLAB lines and a small CLI
on the OpenCL host (`-p` PER/64, `-n` frames, `-i` iters, `-c` code,
`-e|-h` platform — OpenCL/host/src/main.cpp:157-170). Here the whole space is
typed config: code registry key, channel, decoder, batch/symbol geometry.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Erasure-channel operating point.

    kind:
      * ``iid``  — i.i.d. with real-valued ``per``
        (Matlab/LDPCErasureCodes_MessagePassingAlgSim.m:183-188);
      * ``per64`` — i.i.d. with PER = per_numerator/64, the FPGA's on-device
        parameterization (OpenCL/device/ldpc_erasure_decoder_top.cl:102-110);
      * ``gilbert_elliott`` — 2-state bursty channel
        (Matlab/Bursty_Error_Channel_Model_Generator.m:12-47).
    """

    kind: str = "iid"
    per: float = 0.1
    per_numerator: int = 9
    ge_alpha: float = 0.01
    ge_beta: float = 0.5
    ge_transition: float = 0.1
    ge_bias: float = 10.0
    carry_state: bool = True  # carry GE state across codewords (NB sim does)

    def __post_init__(self):
        if self.kind not in ("iid", "per64", "gilbert_elliott"):
            raise ValueError(f"unknown channel kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Decoder selection and iteration budget.

    kind: ``peel`` (MPA only), ``hybrid`` (MPA then Gauss-Jordan on the
    residual), or ``ml`` (Gauss-Jordan from scratch, no peeling).
    """

    kind: str = "hybrid"
    max_iters: int = 50  # peel-only cap (My_LDPC_Erasure_Decoder.m:10)
    peel_iters: int = 10  # hybrid peel budget (My_LDPC_HybridML_Erasure_Decoder.m:9)
    emax: int = 128  # residual-GE column bucket
    # Peeling step: "gather" (wide symbols take the platform's wide peel,
    # ops/peel_wide.peel_decode_packed) or "matmul" (binary scalar only).
    impl: str = "gather"
    early_stop_k: bool = False  # FPGA first-k-known early exit
    ge_subbatch: int = 0  # >0: compact residual frames into this bucket for GE
    # Block-error scope: False (default) counts residual erasures among the
    # first k info symbols (the FPGA's accounting,
    # decoder_perf_tests.cl:215-228); True counts any residual symbol, the
    # MATLAB sims' whole-codeword comparison
    # (LDPCErasureCodes_MessagePassingAlgSim.m:229-236).
    count_all_symbols: bool = False

    def __post_init__(self):
        if self.kind not in ("peel", "hybrid", "ml"):
            raise ValueError(f"unknown decoder kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """One simulation campaign.

    symbol_words: 0 → scalar symbols (one uint8 per code symbol — the MATLAB
    sims' geometry); W > 0 → packed wide symbols, W words per symbol riding a
    trailing vector axis (uint32 words for binary = 32W bits/symbol; uint8 GF
    symbols for GF(256)). The FPGA's 8192-bit packet is symbol_words=256
    binary.
    """

    code: str = "n2000_k1000"
    gf_order: int = 2
    batch: int = 256
    symbol_words: int = 0
    channel: ChannelConfig = dataclasses.field(default_factory=ChannelConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    seed: int = 0
    # Pattern-only fast path: FER statistics depend only on erasure patterns
    # (peeling progress and GE rank are value-independent), so the encoder
    # and all symbol values can be skipped — the same structural fact behind
    # the reference's decoder-free RS scoring (paper tex:220). Set False for
    # FER sweeps; keep True to exercise the full value-decoding path.
    track_values: bool = True
    # Batches simulated per device dispatch (lax.scan on device, stats summed
    # there). Amortizes host->device launch latency; the host loop then
    # checks the error-count stopping rule every `steps_per_call` batches.
    steps_per_call: int = 1

    def __post_init__(self):
        if self.gf_order not in (2, 256):
            raise ValueError("gf_order must be 2 or 256")
