"""ldpc_erasure_codes_tpu: a JAX packet-level FEC erasure-coding framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
LDPC_Erasure_Codes stack (MATLAB research tier + OpenCL/FPGA streaming tier):
LDPC erasure codes over GF(2) and GF(256), Reed-Solomon erasure codes,
peeling / hybrid-ML / ML decoders, i.i.d. and Gilbert-Elliott channels, code
construction, and a sharded Monte-Carlo FER simulation driver.

Decoding is embarrassingly parallel per codeword, so the codeword batch is the
scaling axis: `vmap` on-chip, `shard_map` over a device mesh across chips.
"""

__version__ = "0.1.0"
