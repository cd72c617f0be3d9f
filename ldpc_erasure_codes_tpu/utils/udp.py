"""UDP streaming datapath: encoder → datagrams → reorder buffer → decode.

The reference's production encoder emits real UDP datagrams carrying an
8-byte FEC header ahead of each symbol payload
(OpenCL/device/ldpc_erasure_encoder_VITA_in_UDP_out.cl:84-136; header pack
:112-114), and its decode side sketches reassembly with reordering logic
(ldpc_erasure_decoder_with_reordering_logic.cl:17-26). This module is the
working framework datapath over real sockets:

* :func:`send_blocks` — packetize encoded codeword blocks
  (``streaming.make_packet``) and transmit them over a UDP socket, with
  optional deterministic loss injection and reordering (for demos/tests;
  a real lossy network provides its own).
* :class:`UdpReceiver` — background thread draining a bound UDP socket into
  a :class:`streaming.BlockAssembler`.
* :func:`loopback_demo` — end-to-end: encode on device → UDP loopback →
  reassemble → batched device decode → bit-exact payload verification;
  returns counters (packets, blocks, recovered, packets/s). Exposed as the
  ``stream`` CLI subcommand.

With ``vita=True`` the demo runs the reference's full chain: the source
symbols first ride a VITA-49 (VRT) stream over a UDP loopback and are
recovered by :class:`utils.vita.VitaIngest` (header strip, packet-count
continuity, context-packet drop) before encoding — the host-side analog of
the kernel's ingest loop (ldpc_erasure_encoder_VITA_in_UDP_out.cl:140-212).
"""

from __future__ import annotations

import dataclasses
import socket
import threading
import time

import numpy as np

from ldpc_erasure_codes_tpu.utils import native
from ldpc_erasure_codes_tpu.utils.streaming import (
    BlockAssembler,
    HEADER_BYTES,
    make_assembler,
)


def set_rcvbuf(sock: socket.socket, nbytes: int) -> int:
    """Size a socket receive buffer, exceeding ``net.core.rmem_max`` when
    privileged (SO_RCVBUFFORCE needs CAP_NET_ADMIN; plain SO_RCVBUF is
    silently capped at rmem_max — 4 MB here, ~100 ms of queue at the native
    sender's rate). Returns the size actually granted."""
    so_rcvbufforce = getattr(socket, "SO_RCVBUFFORCE", 33)
    try:
        sock.setsockopt(socket.SOL_SOCKET, so_rcvbufforce, nbytes)
    except OSError:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, nbytes)
    return sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)


def send_blocks(
    sock: socket.socket,
    addr: tuple[str, int],
    blocks: np.ndarray,
    *,
    class_code: int = 0,
    first_block_num: int = 0,
    loss: float = 0.0,
    shuffle: bool = False,
    seed: int = 0,
    window: int = 0,
    feedback=None,
) -> int:
    """Packetize and transmit encoded blocks (B, n, symbol_bytes) uint8.

    Returns the number of datagrams actually sent. ``loss`` drops packets
    deterministically (seeded), ``shuffle`` reorders the whole stream —
    both model the network for loopback demos.

    Production path (round 3): packetization is one native C pass over the
    block matrix (``native.tx_packetize``) and transmission is ``sendmmsg``
    bursts — one syscall per 512 datagrams (``native.udp_send_burst``) —
    mirroring the RX-side native assembler. The round-2 per-datagram Python
    ``sendto`` loop measured 67.3k pkts/s and was the end-to-end bottleneck
    (VALIDATION.md); the reference's TX side is line-rate hardware
    (ldpc_erasure_encoder_VITA_in_UDP_out.cl:84-136).

    ``window`` + ``feedback`` add application-level flow control for
    loopback runs: at most ``window`` datagrams are in flight beyond what
    ``feedback()`` (the receiver's drained-datagram count) has confirmed —
    without it the sendmmsg burst outruns the RX drain and the kernel
    drops at the socket queue once the stream exceeds the receive buffer
    (loss injection happens *before* transmission, so every transmitted
    datagram is expected to arrive on a loopback).
    """
    rng = np.random.default_rng(seed)
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    b, n, _sb = blocks.shape
    order = np.arange(b * n, dtype=np.int64)
    if loss > 0.0:
        order = order[rng.random(b * n) >= loss]
    if shuffle:
        rng.shuffle(order)

    def send_slice(order_slice: np.ndarray) -> int:
        cnt = native.udp_send_blocks_gso(
            sock.fileno(), blocks, order_slice, addr[0], addr[1],
            class_code=class_code, first_block_num=first_block_num,
        )
        if cnt is not None:
            return cnt
        # No native toolchain / no kernel GSO: materialized packet matrix.
        pkts = native.tx_packetize(
            blocks, order_slice, class_code=class_code,
            first_block_num=first_block_num,
        )
        cnt = native.udp_send_burst(sock.fileno(), pkts, addr[0], addr[1])
        if cnt is None:  # plain per-datagram Python loop
            for p in pkts:
                sock.sendto(p.tobytes(), addr)
            cnt = len(pkts)
        return cnt

    if not window or feedback is None:
        return send_slice(order)
    base = feedback()
    sent = 0
    for lo in range(0, len(order), window):
        sent += send_slice(order[lo : lo + window])
        deadline = time.monotonic() + 5.0
        while (
            sent - (feedback() - base) > window
            and time.monotonic() < deadline
        ):
            time.sleep(0.0002)
    return sent


class UdpReceiver:
    """Background receive thread feeding a BlockAssembler.

    Bind with port 0 to get an ephemeral port (``.addr``). Stop with
    ``.close()``; the assembler is available as ``.assembler``.
    """

    def __init__(
        self,
        assembler: BlockAssembler,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        rcvbuf: int = 1 << 26,
        burst: int = 256,
    ):
        self.assembler = assembler
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.rcvbuf = set_rcvbuf(self._sock, rcvbuf)
        # UDP_GRO: the kernel hands the drain whole GSO super-chunks (up to
        # 61 datagrams per recv on loopback) instead of re-segmenting —
        # the RX mirror of the sender's UDP_SEGMENT path.
        self._gro = False
        if native.have_native():
            try:
                self._sock.setsockopt(
                    socket.IPPROTO_UDP, getattr(socket, "UDP_GRO", 104), 1
                )
                self._gro = True
            except OSError:  # pragma: no cover - kernel-dependent
                pass
        self._sock.bind((host, port))
        self._sock.settimeout(0.05)
        self.addr = self._sock.getsockname()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.datagrams = 0
        # Burst buffer: exact-size datagrams accumulate here and flush to the
        # assembler in one call, so the native burst assembler pays its
        # ctypes/FFI entry once per `burst` packets, not once per packet
        # (per-packet FFI measured slower than the pure-Python assembler).
        self._burst_cap = burst if hasattr(assembler, "push_burst") else 0
        if self._burst_cap:
            size = HEADER_BYTES + assembler.symbol_bytes
            self._burst_buf = np.empty((self._burst_cap, size), dtype=np.uint8)
            self._burst_n = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _flush_burst_locked(self) -> None:
        if self._burst_cap and self._burst_n:
            self.assembler.push_burst(self._burst_buf[: self._burst_n])
            self._burst_n = 0

    def _run(self) -> None:
        size = HEADER_BYTES + self.assembler.symbol_bytes
        if self._gro:
            self._run_gro(size)
            return
        if native.have_native():
            self._run_native(size)
            return
        while not self._stop.is_set():
            try:
                data, _ = self._sock.recvfrom(size + 64)
            except socket.timeout:
                with self._lock:
                    self._flush_burst_locked()
                continue
            except OSError:
                break
            with self._lock:
                self.datagrams += 1
                if self._burst_cap and len(data) == size:
                    self._burst_buf[self._burst_n] = np.frombuffer(
                        data, dtype=np.uint8
                    )
                    self._burst_n += 1
                    if self._burst_n == self._burst_cap:
                        self._flush_burst_locked()
                else:
                    self._flush_burst_locked()  # preserve arrival order
                    self.assembler.push(data)

    def _run_gro(self, size: int) -> None:
        """GRO-chunk drain: one recvmmsg row may carry a kernel-coalesced
        run of up to 61 equal-size datagrams, which IS the assembler burst
        API's packet-matrix layout — a whole GSO send flows kernel -> buf
        row -> native assembler with one FFI call and no per-datagram
        Python work."""
        import select

        cap = 64
        buf = np.empty((cap, 65536 + 128), dtype=np.uint8)
        sizes = np.empty(cap, dtype=np.int32)
        segs = np.empty(cap, dtype=np.int32)
        fd = self._sock.fileno()
        burstable = hasattr(self.assembler, "push_burst")
        while not self._stop.is_set():
            try:
                ready, _, _ = select.select([self._sock], [], [], 0.05)
            except (OSError, ValueError):
                break
            if not ready:
                continue
            try:
                n = native.udp_recv_gro(fd, buf, sizes, segs)
            except OSError:
                break
            if not n:
                continue
            with self._lock:
                for i in range(n):
                    ln = int(sizes[i])
                    seg = int(segs[i]) or ln
                    if seg == size and ln % size == 0:
                        cnt = ln // size
                        rows = buf[i, :ln].reshape(cnt, size)
                        if burstable:
                            self.assembler.push_burst(rows)
                        else:
                            for r in range(cnt):
                                self.assembler.push(bytes(rows[r]))
                        self.datagrams += cnt
                    else:  # odd-size datagram(s): split at the cmsg size
                        pos = 0
                        while pos < ln:
                            end = min(pos + seg, ln)
                            self.assembler.push(bytes(buf[i, pos:end]))
                            self.datagrams += 1
                            pos = end

    def _run_native(self, size: int) -> None:
        """recvmmsg burst drain (round 3): one syscall per 512 datagrams
        straight into a matrix the assembler's burst API consumes — the
        Python per-datagram recvfrom loop capped the RX path at ~0.3M
        pkts/s, an order below both the native assembler (21M) and the
        native sendmmsg TX (0.6M+)."""
        import select

        cap = max(self._burst_cap, 1024)
        buf = np.empty((cap, size + 64), dtype=np.uint8)
        sizes = np.empty(cap, dtype=np.int32)
        fd = self._sock.fileno()
        while not self._stop.is_set():
            try:
                ready, _, _ = select.select([self._sock], [], [], 0.05)
            except (OSError, ValueError):
                break
            if not ready:
                continue
            try:
                n = native.udp_recv_burst(fd, buf, sizes)
            except OSError:
                break
            if not n:
                continue
            with self._lock:
                self.datagrams += n
                # Push contiguous exact-size runs as bursts (arrival order
                # preserved); odd-size datagrams go through push().
                i = 0
                while i < n:
                    if sizes[i] == size:
                        j = i
                        while j < n and sizes[j] == size:
                            j += 1
                        if hasattr(self.assembler, "push_burst"):
                            self.assembler.push_burst(buf[i:j, :size])
                        else:
                            for r in range(i, j):
                                self.assembler.push(bytes(buf[r, :size]))
                        i = j
                    else:
                        self.assembler.push(bytes(buf[i, : sizes[i]]))
                        i += 1

    def drain(self, max_batch: int | None = None):
        with self._lock:
            self._flush_burst_locked()
            return self.assembler.drain(max_batch)

    def wait_for(self, datagrams: int, timeout: float = 10.0) -> bool:
        """Block until at least ``datagrams`` arrived (or timeout)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self.datagrams >= datagrams:
                    return True
            time.sleep(0.005)
        return False

    def flush(self) -> None:
        with self._lock:
            self._flush_burst_locked()
            self.assembler.flush()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._sock.close()


@dataclasses.dataclass
class StreamResult:
    blocks: int
    packets_sent: int
    packets_received: int
    blocks_recovered: int
    blocks_failed: int
    send_seconds: float
    packets_per_sec: float
    stats: dict
    vita_stats: dict | None = None
    payload_gbps: float = 0.0  # received payload bits / transfer wall time
    transfer_complete: bool = True  # every transmitted datagram arrived


def _vita_leg(
    src_bytes: np.ndarray, *, stream_id: int, data_per_context: int
) -> tuple[np.ndarray, dict]:
    """Send source symbols as a VRT stream over UDP loopback; ingest back.

    ``src_bytes`` is (blocks, k, symbol_bytes) uint8. Returns the recovered
    array (bit-exact, asserted by the caller) and the ingest stats. Loopback
    UDP is lossless and ordered; upstream-loss detection (packet-count gaps)
    is unit-tested separately (tests/test_vita.py).
    """
    from ldpc_erasure_codes_tpu.utils.vita import VitaEmitter, VitaIngest

    blocks, k, sb = src_bytes.shape
    emitter = VitaEmitter(stream_id, data_per_context=data_per_context)
    ingest = VitaIngest(expected_stream_id=stream_id)
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    set_rcvbuf(rx, 1 << 26)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(0.05)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    addr = rx.getsockname()

    # Drain concurrently with the send: the whole stream must never be
    # required to fit the socket receive queue (SO_RCVBUF requests are
    # silently capped by net.core.rmem_max — ~208 KB on stock Linux — so a
    # send-all-then-read loop drops packets on a lossless loopback).
    payloads: list[bytes] = []
    stop = threading.Event()

    def _drain() -> None:
        while True:
            try:
                data, _ = rx.recvfrom(65536)
            except socket.timeout:
                if stop.is_set():
                    return
                continue
            except OSError:
                return
            p = ingest.push(data)
            if p is not None:
                payloads.append(p)

    drainer = threading.Thread(target=_drain, daemon=True)
    drainer.start()
    nsent = 0
    try:
        # Batched VRT framing (one NumPy pass) + sendmmsg bursts, with the
        # context-packet cadence preserved by splitting the data stream at
        # each context's position (round 3; was a per-packet struct+sendto
        # loop — the measured end-to-end TX bottleneck).
        flat = src_bytes.reshape(blocks * k, sb)
        pkts, contexts = emitter.emit_burst(flat)

        def send_range(lo: int, hi: int) -> int:
            if hi <= lo:
                return 0
            sent = native.udp_send_gso(
                tx.fileno(), pkts[lo:hi], addr[0], addr[1]
            )
            if sent is None:  # no native toolchain
                for row in pkts[lo:hi]:
                    tx.sendto(row.tobytes(), addr)
                sent = hi - lo
            return sent

        pos = 0
        for i, _cls, cpkt in contexts:
            nsent += send_range(pos, i)
            tx.sendto(cpkt, addr)
            nsent += 1
            pos = i
        nsent += send_range(pos, len(pkts))
        deadline = time.monotonic() + 10.0
        while ingest.stats["packets"] < nsent and time.monotonic() < deadline:
            time.sleep(0.002)
    finally:
        stop.set()
        drainer.join(timeout=2.0)
        tx.close()
        rx.close()
    if ingest.stats["packets"] < nsent:  # pragma: no cover - loopback
        raise RuntimeError(
            f"VITA leg: {ingest.stats['packets']}/{nsent} datagrams arrived"
        )
    out = np.frombuffer(b"".join(payloads), dtype=np.uint8).reshape(
        blocks, k, sb
    )
    return out, dict(ingest.stats)


def loopback_demo(
    code_name: str = "n2000_k1000",
    *,
    blocks: int = 8,
    symbol_words: int = 2,
    loss: float = 0.1,
    shuffle: bool = True,
    seed: int = 0,
    peel_iters: int = 50,
    emax: int = 128,
    assembler: str = "auto",
    vita: bool = False,
    data_per_context: int = 16,
) -> StreamResult:
    """Encode → UDP loopback (lossy, reordered) → reassemble → device decode.

    Every block whose decode did not fail is verified bit-exact against the
    transmitted codeword. Reference datapath:
    ldpc_erasure_encoder_VITA_in_UDP_out.cl:84-136 (send side),
    ldpc_erasure_decoder_with_reordering_logic.cl:17-26 (reassembly).
    ``vita=True`` prepends the reference's ingest leg: the source symbols
    arrive as a VITA-49 stream over UDP and are recovered bit-exactly by
    VitaIngest before encoding (:140-212).
    """
    import jax
    import jax.numpy as jnp

    from ldpc_erasure_codes_tpu.codes import get_code
    from ldpc_erasure_codes_tpu.ops import (
        device_arrays,
        encode_packed,
        hybrid_decode,
    )

    code = get_code(code_name)
    arrays = device_arrays(code)
    w = symbol_words
    sb = 4 * w
    src = jax.random.bits(
        jax.random.key(seed), (blocks, code.k, w), dtype=jnp.uint32
    )
    vita_stats = None
    if vita:
        # Reference ingest leg: source symbols ride a VRT stream first.
        src_np = np.asarray(jax.device_get(src)).astype(
            "<u4", order="C"
        ).view(np.uint8).reshape(blocks, code.k, sb)
        got, vita_stats = _vita_leg(
            src_np, stream_id=0xCC01 + seed, data_per_context=data_per_context
        )
        np.testing.assert_array_equal(got, src_np, err_msg="VITA leg corrupt")
        src = jnp.asarray(
            np.ascontiguousarray(got).view("<u4").reshape(blocks, code.k, w)
        )
    cw = np.asarray(jax.device_get(encode_packed(arrays, src)))  # (B, n, W)
    # device_get may hand back a transposed-stride view; force C order
    # before the byte view.
    wire = cw.astype("<u4", order="C").view(np.uint8).reshape(
        blocks, code.n, sb
    )

    if assembler == "python":
        asm = BlockAssembler(
            code.n, code.k, sb, max_blocks=blocks, decode_at_k=False
        )
    else:
        asm = make_assembler(
            code.n, code.k, sb, max_blocks=blocks, decode_at_k=False,
            prefer_native=True,
        )
    rx = UdpReceiver(asm)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    # Flow control: cap in-flight datagrams at half the granted receive
    # queue so the native sendmmsg burst (which outruns the RX drain) never
    # overflows it — loopback transport is lossless, so any kernel drop is
    # a self-inflicted measurement artifact, not channel loss.
    window = max(512, rx.rcvbuf // (2 * (HEADER_BYTES + sb)))
    t0 = time.perf_counter()
    sent = send_blocks(
        tx, rx.addr, wire, loss=loss, shuffle=shuffle, seed=seed + 1,
        window=window, feedback=lambda: rx.datagrams,
    )
    complete = rx.wait_for(sent, timeout=30.0)
    # Transfer time = send start -> last datagram observed (not the timeout
    # wait): poll granularity is wait_for's 5 ms sleep.
    transfer_dt = time.perf_counter() - t0
    tx.close()
    rx.flush()
    nums, vals, erased = rx.drain()
    received = rx.datagrams
    rx.close()

    values = jnp.asarray(
        np.ascontiguousarray(vals).view("<u4").reshape(len(nums), code.n, w)
    )
    v, e, _iters, failed = hybrid_decode(
        arrays, values, jnp.asarray(erased), peel_iters=peel_iters, emax=emax
    )
    v = np.asarray(jax.device_get(v))
    failed = np.asarray(jax.device_get(failed))
    recovered = 0
    for i, num in enumerate(nums):
        if failed[i]:
            continue
        np.testing.assert_array_equal(
            v[i], cw[int(num)], err_msg=f"block {num} payload mismatch"
        )
        recovered += 1
    return StreamResult(
        blocks=blocks,
        packets_sent=sent,
        packets_received=received,
        blocks_recovered=recovered,
        blocks_failed=int(failed.sum()),
        send_seconds=transfer_dt,
        packets_per_sec=received / transfer_dt if transfer_dt > 0 else 0.0,
        stats=dict(asm.stats),
        vita_stats=vita_stats,
        payload_gbps=(
            received * sb * 8 / transfer_dt / 1e9 if transfer_dt > 0 else 0.0
        ),
        transfer_complete=complete,
    )
