"""TX-side throughput: native burst send vs the round-2 Python sendto loop.

Pure host benchmark (no accelerator): packetize + transmit a block batch over a UDP
loopback socket into a draining native-assembler receiver, at the
VALIDATION.md RX benchmark shape ((2040,1530), 32-byte symbols). Reports
packets/s and payload Gbps for (a) the round-2 per-datagram Python path and
(b) the round-3 native path (C packetizer + sendmmsg bursts).

Run: python scripts/bench_tx.py
"""

from __future__ import annotations

import os
import socket
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ldpc_erasure_codes_tpu.utils import native
from ldpc_erasure_codes_tpu.utils.streaming import make_assembler, make_packet
from ldpc_erasure_codes_tpu.utils.udp import UdpReceiver, send_blocks


def main() -> None:
    n, k, sb = 2040, 1530, 32
    blocks = 64
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (blocks, n, sb), dtype=np.uint8)
    npkts = blocks * n

    def run(name, send_fn):
        asm = make_assembler(n, k, sb, max_blocks=blocks, decode_at_k=False,
                             prefer_native=True)
        rx = UdpReceiver(asm, rcvbuf=1 << 26, burst=1024)
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        tx.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 26)
        t0 = time.perf_counter()
        sent = send_fn(tx, rx.addr)
        dt = time.perf_counter() - t0
        got = rx.wait_for(int(sent * 0.95), timeout=30.0)
        rx.flush()
        received = rx.datagrams
        rx.close()
        tx.close()
        pps = sent / dt
        gbps = sent * sb * 8 / dt / 1e9
        print(
            f"{name:28s} sent={sent} in {dt * 1e3:7.1f} ms  "
            f"{pps / 1e6:6.2f} M pkts/s  {gbps:6.2f} Gbps payload  "
            f"(received {received}{'' if got else ' TIMEOUT'})",
            flush=True,
        )

    def py_send(tx, addr):
        sent = 0
        for i in range(blocks):
            for s in range(n):
                tx.sendto(make_packet(0, i, s, data[i, s].tobytes()), addr)
                sent += 1
        return sent

    def native_send(tx, addr):
        pkts = native.tx_packetize(
            data, np.arange(npkts, dtype=np.int64)
        )
        return native.udp_send_burst(tx.fileno(), pkts, addr[0], addr[1])

    def gso_send(tx, addr):
        return send_blocks(tx, addr, data, loss=0.0, shuffle=False)

    run("python per-datagram sendto", py_send)
    run("native packetize+sendmmsg", native_send)
    run("native packetize+GSO", gso_send)
    # Packetization alone (no socket): the C pass cost.
    order = np.arange(npkts, dtype=np.int64)
    t0 = time.perf_counter()
    pkts = native.tx_packetize(data, order)
    dt = time.perf_counter() - t0
    print(
        f"{'packetize only (C pass)':28s} {npkts} pkts in {dt * 1e3:7.1f} ms "
        f" {npkts / dt / 1e6:6.2f} M pkts/s",
        flush=True,
    )


if __name__ == "__main__":
    main()
