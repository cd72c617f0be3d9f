"""VITA-49 (VRT) framing for the streaming encoder ingest.

The reference's production encoder kernel takes a VITA-49 radio-transport
stream in and emits FEC-protected UDP datagrams out
(OpenCL/device/ldpc_erasure_encoder_VITA_in_UDP_out.cl): it reads the VRT
word-0 header, takes the packet length from the low 16 bits (:141), strips
the header word, forwards the payload words into one FEC symbol per VRT
packet (:180-212), and interleaves context packets on a ``dataPerContext``
cadence with distinct class codes (:142-160; data 0x000A / context 0x000B,
test mode 0x0006 / 0x0008).

This module is the host-side framework equivalent: a VRT header codec
(the standard word-0 bit layout, big-endian network order), an emitter that
frames payload symbols as a VRT data stream with mod-16 packet counts and
periodic context packets, and an ingest stage that validates/strips VRT
framing and yields FEC-ready symbols for the encode -> UDP datapath
(``utils.streaming`` / the ``stream`` CLI subcommand). Framing is a
per-packet host concern, so it lives in Python; the encode/decode stays on
the device.

Class codes follow the reference; the VRT word-0 layout follows VITA-49.0
(packet type / C / T / TSI / TSF / packet count / packet size).
"""

from __future__ import annotations

import dataclasses
import struct

# VRT packet types (VITA-49.0 table 6.1.1-1).
PKT_IF_DATA = 0x0  # IF data, no stream id
PKT_IF_DATA_SID = 0x1  # IF data with stream id
PKT_EXT_DATA = 0x2
PKT_EXT_DATA_SID = 0x3
PKT_IF_CONTEXT = 0x4
PKT_EXT_CONTEXT = 0x5

# Reference class codes (ldpc_erasure_encoder_VITA_in_UDP_out.cl:42,142-160).
CLASS_DATA = 0x000A
CLASS_CONTEXT = 0x000B
CLASS_DATA_TEST = 0x0006
CLASS_CONTEXT_TEST = 0x0008

_WORD = struct.Struct(">I")


@dataclasses.dataclass(frozen=True)
class VitaHeader:
    """VRT word-0 fields (+ the optional stream-id word).

    packet_size counts 32-bit words INCLUDING the header word and any
    stream-id word — the field the reference derives its FEC payload length
    from (:141).
    """

    packet_type: int
    packet_count: int  # mod-16 continuity counter
    packet_size: int  # total 32-bit words incl. header (+ stream id)
    has_class_id: bool = False
    has_trailer: bool = False
    tsi: int = 0
    tsf: int = 0
    stream_id: int | None = None

    @property
    def has_stream_id(self) -> bool:
        return self.packet_type in (
            PKT_IF_DATA_SID,
            PKT_EXT_DATA_SID,
            PKT_IF_CONTEXT,
            PKT_EXT_CONTEXT,
        )

    @property
    def header_words(self) -> int:
        return 1 + (1 if self.has_stream_id else 0)

    def pack(self) -> bytes:
        if not 0 <= self.packet_count < 16:
            raise ValueError("packet_count must be mod-16")
        if not 0 <= self.packet_size < (1 << 16):
            raise ValueError("packet_size must fit 16 bits")
        w0 = (
            (self.packet_type & 0xF) << 28
            | (1 << 27 if self.has_class_id else 0)
            | (1 << 26 if self.has_trailer else 0)
            | (self.tsi & 0x3) << 22
            | (self.tsf & 0x3) << 20
            | (self.packet_count & 0xF) << 16
            | (self.packet_size & 0xFFFF)
        )
        out = _WORD.pack(w0)
        if self.has_stream_id:
            out += _WORD.pack((self.stream_id or 0) & 0xFFFFFFFF)
        return out


def parse_header(data: bytes) -> VitaHeader:
    """Parse word-0 (+ stream id when the type carries one)."""
    if len(data) < 4:
        raise ValueError("short VRT packet (no header word)")
    (w0,) = _WORD.unpack_from(data)
    ptype = (w0 >> 28) & 0xF
    hdr = VitaHeader(
        packet_type=ptype,
        has_class_id=bool((w0 >> 27) & 1),
        has_trailer=bool((w0 >> 26) & 1),
        tsi=(w0 >> 22) & 0x3,
        tsf=(w0 >> 20) & 0x3,
        packet_count=(w0 >> 16) & 0xF,
        packet_size=w0 & 0xFFFF,
    )
    if hdr.has_stream_id:
        if len(data) < 8:
            raise ValueError("short VRT packet (no stream-id word)")
        (sid,) = _WORD.unpack_from(data, 4)
        hdr = dataclasses.replace(hdr, stream_id=sid)
    return hdr


class VitaEmitter:
    """Frame payload symbols as a VRT data stream.

    Mirrors the reference encoder's upstream: one VRT data packet per FEC
    symbol payload, a context packet every ``data_per_context`` data packets
    (0 disables, the kernel's ``disableContextPackets``), and mod-16 packet
    counters kept INDEPENDENTLY for the data and context packet streams —
    VITA-49.0 specifies one continuity counter per packet stream (stream id
    + packet type), not one per link. ``test_mode`` selects the test-class
    codes (:145-160); the class code rides with the emitted packet for
    transport layers that carry it (the VRT class-id word itself is not
    emitted — has_class_id=False — matching the kernel, which never parses
    one).
    """

    def __init__(
        self,
        stream_id: int,
        *,
        data_per_context: int = 0,
        test_mode: bool = False,
    ):
        self.stream_id = stream_id
        self.data_per_context = data_per_context
        self.test_mode = test_mode
        self._data_count = 0
        self._ctx_count = 0
        self._since_context = 0

    def _next_count(self, ctx: bool = False) -> int:
        if ctx:
            c = self._ctx_count
            self._ctx_count = (c + 1) & 0xF
        else:
            c = self._data_count
            self._data_count = (c + 1) & 0xF
        return c

    def emit(self, payload: bytes) -> list[tuple[int, bytes]]:
        """Frame one payload; returns [(class_code, vrt_packet), ...]
        (a context packet may precede the data packet)."""
        if len(payload) % 4:
            raise ValueError("VRT payload must be whole 32-bit words")
        out: list[tuple[int, bytes]] = []
        if self.data_per_context > 0:
            if self._since_context >= self.data_per_context:
                self._since_context = 0
                ctx = VitaHeader(
                    packet_type=PKT_IF_CONTEXT,
                    packet_count=self._next_count(ctx=True),
                    packet_size=2,
                    stream_id=self.stream_id,
                )
                cls = (
                    CLASS_CONTEXT_TEST if self.test_mode else CLASS_CONTEXT
                )
                out.append((cls, ctx.pack()))
            self._since_context += 1
        hdr = VitaHeader(
            packet_type=PKT_IF_DATA_SID,
            packet_count=self._next_count(),
            packet_size=2 + len(payload) // 4,
            stream_id=self.stream_id,
        )
        cls = CLASS_DATA_TEST if self.test_mode else CLASS_DATA
        out.append((cls, hdr.pack() + payload))
        return out

    def emit_burst(self, payloads) -> tuple["object", list]:
        """Vectorized framing of N equal-size payloads (round 3, the TX
        batching half — the per-packet ``struct`` path
        measured as part of the end-to-end TX bottleneck).

        ``payloads``: (N, sb) uint8 NumPy array, sb % 4 == 0. Returns
        ``(data_pkts, contexts)`` where ``data_pkts`` is the (N, 8 + sb)
        uint8 matrix of framed VRT data packets (one NumPy pass — ready for
        ``native.udp_send_burst``) and ``contexts`` is
        ``[(data_index, class_code, packet_bytes), ...]`` — each context
        packet belongs immediately BEFORE data packet ``data_index`` in the
        stream. Counters advance exactly as N sequential :meth:`emit` calls
        (asserted byte-exact in tests/test_vita.py).
        """
        import numpy as np

        payloads = np.ascontiguousarray(payloads, dtype=np.uint8)
        n, sb = payloads.shape
        if sb % 4:
            raise ValueError("VRT payload must be whole 32-bit words")
        words = 2 + sb // 4
        counts = (self._data_count + np.arange(n, dtype=np.uint32)) & 0xF
        w0 = (
            np.uint32(PKT_IF_DATA_SID << 28)
            | (counts << np.uint32(16))
            | np.uint32(words & 0xFFFF)
        )
        out = np.empty((n, 8 + sb), dtype=np.uint8)
        out[:, 0:4] = w0.astype(">u4").view(np.uint8).reshape(n, 4)
        out[:, 4:8] = np.broadcast_to(
            np.frombuffer(
                _WORD.pack(self.stream_id & 0xFFFFFFFF), dtype=np.uint8
            ),
            (n, 4),
        )
        out[:, 8:] = payloads
        self._data_count = (self._data_count + n) & 0xF
        contexts: list[tuple[int, int, bytes]] = []
        if self.data_per_context > 0:
            cls = CLASS_CONTEXT_TEST if self.test_mode else CLASS_CONTEXT
            since = self._since_context
            for i in range(n):
                if since >= self.data_per_context:
                    since = 0
                    ctx = VitaHeader(
                        packet_type=PKT_IF_CONTEXT,
                        packet_count=self._next_count(ctx=True),
                        packet_size=2,
                        stream_id=self.stream_id,
                    )
                    contexts.append((i, cls, ctx.pack()))
                since += 1
            self._since_context = since
        return out, contexts


class VitaIngest:
    """Validate/strip VRT framing; yield FEC-ready payload symbols.

    The host-side analog of the kernel's ingest loop (:140-212): per packet,
    parse word-0, check the declared packet_size against the datagram,
    detect mod-16 packet-count discontinuities (lost upstream VRT packets —
    the erasures the FEC exists for), drop context packets, and hand back
    the stripped payload. Continuity is tracked PER PACKET STREAM (stream
    id + packet type), as VITA-49.0 specifies — a conformant source that
    interleaves context packets (their own mod-16 counter) with data
    packets must not trigger false loss reports.
    """

    def __init__(self, expected_stream_id: int | None = None):
        self.expected_stream_id = expected_stream_id
        self._last_count: dict[tuple[int, int | None], int] = {}
        self.stats = {
            "packets": 0,
            "data": 0,
            "context": 0,
            "bad": 0,
            "wrong_stream": 0,
            "count_gaps": 0,
            "lost_upstream": 0,
        }

    def push(self, datagram: bytes) -> bytes | None:
        """Returns the stripped payload for data packets, None otherwise."""
        self.stats["packets"] += 1
        try:
            hdr = parse_header(datagram)
        except ValueError:
            self.stats["bad"] += 1
            return None
        if len(datagram) != 4 * hdr.packet_size or len(datagram) % 4:
            self.stats["bad"] += 1
            return None
        if (
            self.expected_stream_id is not None
            and hdr.has_stream_id
            and hdr.stream_id != self.expected_stream_id
        ):
            self.stats["wrong_stream"] += 1
            return None
        stream = (hdr.packet_type, hdr.stream_id)
        last = self._last_count.get(stream)
        if last is not None:
            gap = (hdr.packet_count - last - 1) & 0xF
            if gap:
                self.stats["count_gaps"] += 1
                self.stats["lost_upstream"] += gap
        self._last_count[stream] = hdr.packet_count
        if hdr.packet_type in (PKT_IF_CONTEXT, PKT_EXT_CONTEXT):
            self.stats["context"] += 1
            return None
        self.stats["data"] += 1
        return datagram[4 * hdr.header_words :]
