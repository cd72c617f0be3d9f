"""Packet-stream block assembly: out-of-order FEC packets → decode batches.

The reference sketches (but never finishes — the file does not compile
upstream) a datapath that reassembles UDP packets carrying an 8-byte FEC
header into codeword blocks and triggers decode while later blocks are still
arriving (OpenCL/device/ldpc_erasure_decoder_with_reordering_logic.cl:17-26,
:81-91; header layout {FECClassCode, blockNum, symbolNum} packed by the
encoder at ldpc_erasure_encoder_VITA_in_UDP_out.cl:112-114). This module is
the working host-side equivalent:

* the FEC header codec (same three fields, fixed 8-byte layout);
* a bounded reorder buffer of in-flight blocks;
* decode triggering on "decodable" (>= k symbols arrived — by the MDS-style
  rank argument more symbols only help) or on block eviction (buffer
  pressure / explicit flush), mirroring the sketch's decode-while-assembling
  intent;
* batch draining: ready blocks come out as (values, erasure-mask) arrays
  shaped for the batched device decoders.

Assembly is a host-side streaming concern (per-packet bookkeeping), so it
lives in Python over NumPy buffers; the decode itself stays on the device.
"""

from __future__ import annotations

import dataclasses
import struct
from collections import OrderedDict

import numpy as np

# {class_code: u16, block_num: u32, symbol_num: u16} — the sketch's three
# fields in a fixed 8-byte little-endian layout.
_HEADER = struct.Struct("<HIH")
HEADER_BYTES = _HEADER.size


def pack_header(class_code: int, block_num: int, symbol_num: int) -> bytes:
    return _HEADER.pack(class_code, block_num, symbol_num)


def unpack_header(data: bytes) -> tuple[int, int, int]:
    """Returns (class_code, block_num, symbol_num); payload follows."""
    return _HEADER.unpack_from(data)


def make_packet(
    class_code: int, block_num: int, symbol_num: int, payload: bytes
) -> bytes:
    return pack_header(class_code, block_num, symbol_num) + payload


@dataclasses.dataclass
class _Block:
    values: np.ndarray  # (n, symbol_bytes) uint8
    received: np.ndarray  # (n,) bool
    count: int = 0


class BlockAssembler:
    """Reorder buffer turning packets into decode-ready codeword blocks.

    Args:
      n, k: code geometry (symbols per block, source symbols).
      symbol_bytes: payload bytes per symbol.
      max_blocks: bound on in-flight blocks; when exceeded the *oldest*
        block is force-drained (its missing symbols become erasures) — the
        sketch's buffer-pressure decode trigger.
      decode_at_k: drain a block as soon as any k symbols arrived (decodable
        already; waiting only adds latency). Set False to wait for all n or
        eviction.
    """

    def __init__(
        self,
        n: int,
        k: int,
        symbol_bytes: int,
        *,
        max_blocks: int = 8,
        decode_at_k: bool = True,
    ):
        self.n = n
        self.k = k
        self.symbol_bytes = symbol_bytes
        self.max_blocks = max_blocks
        self.decode_at_k = decode_at_k
        self._blocks: OrderedDict[int, _Block] = OrderedDict()
        self._ready: list[tuple[int, np.ndarray, np.ndarray]] = []
        # Recently-completed block numbers (bounded LRU): a straggler packet
        # for an already-drained block must count as late, not recreate a
        # phantom block that would later be emitted as a duplicate frame.
        self._completed: OrderedDict[int, None] = OrderedDict()
        self._completed_cap = max(64, 4 * max_blocks)
        self.stats = {
            "packets": 0,
            "duplicates": 0,
            "late": 0,
            "bad": 0,
            "blocks_out": 0,
            "evictions": 0,
        }

    def push(self, packet: bytes) -> None:
        """Ingest one packet (header + symbol payload)."""
        self.stats["packets"] += 1
        if len(packet) != HEADER_BYTES + self.symbol_bytes:
            self.stats["bad"] += 1
            return
        _cls, block_num, sym = unpack_header(packet)
        if sym >= self.n:
            self.stats["bad"] += 1
            return
        if block_num in self._completed:
            self.stats["late"] += 1
            return
        blk = self._blocks.get(block_num)
        if blk is None:
            blk = _Block(
                values=np.zeros((self.n, self.symbol_bytes), dtype=np.uint8),
                received=np.zeros(self.n, dtype=bool),
            )
            self._blocks[block_num] = blk
            while len(self._blocks) > self.max_blocks:
                old_num, old_blk = self._blocks.popitem(last=False)
                self._finish(old_num, old_blk)
                self.stats["evictions"] += 1
            if block_num not in self._blocks:
                # The just-inserted block was itself the eviction victim
                # (max_blocks < 1): it is already finished, so this packet
                # counts as late — matching the native assembler, which
                # re-finds the block after eviction (ldpc_io.cpp).
                self.stats["late"] += 1
                return
        if blk.received[sym]:
            self.stats["duplicates"] += 1
            return
        blk.received[sym] = True
        blk.values[sym] = np.frombuffer(
            packet, dtype=np.uint8, offset=HEADER_BYTES
        )
        blk.count += 1
        if blk.count == self.n or (self.decode_at_k and blk.count >= self.k):
            self._blocks.pop(block_num)
            self._finish(block_num, blk)

    def _finish(self, block_num: int, blk: _Block) -> None:
        # Erased slots stay zero — the framework's erased-is-zero invariant.
        self._ready.append((block_num, blk.values, ~blk.received))
        self.stats["blocks_out"] += 1
        self._completed[block_num] = None
        while len(self._completed) > self._completed_cap:
            self._completed.popitem(last=False)

    def flush(self) -> None:
        """Force-drain every in-flight block (end of stream)."""
        while self._blocks:
            num, blk = self._blocks.popitem(last=False)
            self._finish(num, blk)

    @property
    def ready_count(self) -> int:
        return len(self._ready)

    def drain(
        self, max_batch: int | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pop up to ``max_batch`` ready blocks as decoder-shaped arrays.

        Returns (block_nums (B,), values (B, n, symbol_bytes) uint8,
        erased (B, n) bool) — feed values/erased straight to
        ``ops.peel_decode`` / ``ops.hybrid_decode`` (after any packing).
        """
        take = len(self._ready) if max_batch is None else min(max_batch, len(self._ready))
        items, self._ready = self._ready[:take], self._ready[take:]
        if not items:
            z = np.zeros
            return (
                z(0, dtype=np.int64),
                z((0, self.n, self.symbol_bytes), dtype=np.uint8),
                z((0, self.n), dtype=bool),
            )
        nums = np.asarray([i[0] for i in items], dtype=np.int64)
        vals = np.stack([i[1] for i in items])
        erased = np.stack([i[2] for i in items])
        return nums, vals, erased


class NativeBlockAssembler:
    """Native C++ implementation of :class:`BlockAssembler` (same semantics,
    property-tested equal in tests/test_streaming.py). The Python assembler
    is per-packet interpreter-bound; this one ingests datagram bursts at
    memcpy speed — the production data-loader path of the streaming runtime
    (native/ldpc_io.cpp, the reference's host-harness analog)."""

    def __init__(
        self,
        n: int,
        k: int,
        symbol_bytes: int,
        *,
        max_blocks: int = 8,
        decode_at_k: bool = True,
    ):
        from ldpc_erasure_codes_tpu.utils import native as _native
        import ctypes

        self._native = _native
        self._ctypes = ctypes
        lib = _native.load_native()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.n = n
        self.k = k
        self.symbol_bytes = symbol_bytes
        self._h = lib.ldpc_asm_create(
            n, k, symbol_bytes, max_blocks, int(decode_at_k)
        )

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ldpc_asm_destroy(h)
            self._h = None

    def push(self, packet: bytes) -> None:
        buf = np.frombuffer(packet, dtype=np.uint8)
        size = np.asarray([len(packet)], dtype=np.int32)
        want = HEADER_BYTES + self.symbol_bytes
        if len(packet) != want:
            # Wrong-length packets can't be laid out at the expected stride;
            # feed a zero-padded/clipped copy with the TRUE size so the native
            # side counts it bad (oversized datagrams — stray traffic on the
            # port — must not raise, or they'd kill the UdpReceiver thread).
            buf = np.zeros(want, dtype=np.uint8)
            m = min(len(packet), want)
            buf[:m] = np.frombuffer(packet, dtype=np.uint8)[:m]
        self._lib.ldpc_asm_push(
            self._h,
            self._native._ptr(np.ascontiguousarray(buf), self._ctypes.c_uint8),
            self._native._ptr(size, self._ctypes.c_int32),
            1,
            want,
        )

    def push_burst(self, packets: np.ndarray) -> None:
        """Ingest (count, HEADER_BYTES + symbol_bytes) uint8 packet rows."""
        packets = np.ascontiguousarray(packets, dtype=np.uint8)
        count, stride = packets.shape
        self._lib.ldpc_asm_push(
            self._h,
            self._native._ptr(packets, self._ctypes.c_uint8),
            None,
            count,
            stride,
        )

    @property
    def ready_count(self) -> int:
        return int(self._lib.ldpc_asm_ready(self._h))

    def flush(self) -> None:
        self._lib.ldpc_asm_flush(self._h)

    @property
    def stats(self) -> dict:
        out = np.zeros(6, dtype=np.int64)
        self._lib.ldpc_asm_stats(
            self._h, self._native._ptr(out, self._ctypes.c_longlong)
        )
        keys = ["packets", "duplicates", "late", "bad", "blocks_out",
                "evictions"]
        return dict(zip(keys, (int(x) for x in out)))

    def drain(
        self, max_batch: int | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        avail = self.ready_count
        take = avail if max_batch is None else min(max_batch, avail)
        nums = np.zeros(take, dtype=np.int64)
        vals = np.zeros((take, self.n, self.symbol_bytes), dtype=np.uint8)
        er = np.zeros((take, self.n), dtype=np.uint8)
        if take:
            got = self._lib.ldpc_asm_drain(
                self._h,
                self._native._ptr(nums, self._ctypes.c_longlong),
                self._native._ptr(vals, self._ctypes.c_uint8),
                self._native._ptr(er, self._ctypes.c_uint8),
                take,
            )
            assert got == take
        return nums, vals, er.astype(bool)


def make_assembler(
    n: int,
    k: int,
    symbol_bytes: int,
    *,
    max_blocks: int = 8,
    decode_at_k: bool = True,
    prefer_native: bool = True,
):
    """BlockAssembler factory: the native C++ assembler when the toolchain
    is available, else the Python reference implementation."""
    if prefer_native:
        from ldpc_erasure_codes_tpu.utils import native as _native

        if _native.have_native():
            return NativeBlockAssembler(
                n, k, symbol_bytes, max_blocks=max_blocks,
                decode_at_k=decode_at_k,
            )
    return BlockAssembler(
        n, k, symbol_bytes, max_blocks=max_blocks, decode_at_k=decode_at_k
    )
