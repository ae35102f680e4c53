"""The port's socket transport under a busy replica, on the CPU.

A replica runs its engine on one thread and its ``TransportServer`` on
another, so every server loop turn waits for the GIL.  This script gives
the server's process a busy pure-Python thread, a worst case for that
wait, and times KV-sized frames:

- ``inbound``: a ``SocketTransport`` pushes ``--mb`` of ``kv_block``
  commands into the server (the decode replica's side of a migration);
- ``relay``: a source server emits ``--requests`` exports of ``--blocks``
  blocks as events, and this process relays each to a destination server
  (the router between a prefill and a decode replica).

Run from the repo root: ``python scripts/torch_wire_rate.py inbound`` or
``... relay``.  It prints MB/s and the clients' ``send_backlog_max_s``.
"""

import argparse
import multiprocessing as mp
import os
import queue
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

BLOCK_BYTES = 1_179_648      # GPT-124M fp32: 12 layers x K,V x 16 x 768 x 4


def replica(conn, exports):
    """A ``TransportServer`` beside a busy thread; with ``exports`` the
    first command makes the busy thread queue that many block events."""
    from apex_tpu_torch.serving.transport import TransportServer

    cmd_q, evt_q = queue.Queue(), queue.Queue()
    server = TransportServer(cmd_q, evt_q, max_buffered_bytes=1 << 31)
    stop = threading.Event()

    def busy():
        x = 0
        while not stop.is_set():
            for i in range(2000):
                x += i * i
            if exports and not cmd_q.empty():
                cmd_q.get()
                block = np.zeros(BLOCK_BYTES // 4, np.float32)
                for r, n in enumerate(exports):
                    for i in range(n):
                        evt_q.put(("kv_block", r, i, [block]))
    threading.Thread(target=busy, daemon=True).start()
    conn.send(server.address)
    conn.recv()
    stop.set()
    server.close(bye=False)


def start(exports=None):
    ours, theirs = mp.Pipe()
    proc = mp.get_context("spawn").Process(target=replica,
                                           args=(theirs, exports))
    proc.start()
    return proc, ours, ours.recv()


def connected(*clients):
    while not all(c._hello_done for c in clients):
        for c in clients:
            c.poll()
        time.sleep(0.001)


def main():
    from apex_tpu_torch.serving.transport import SocketTransport

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("inbound", "relay"))
    ap.add_argument("--mb", type=float, default=53.0)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=24)
    a = ap.parse_args()
    block = np.zeros(BLOCK_BYTES // 4, np.float32)
    if a.mode == "inbound":
        replicas = [start()]
        dst = SocketTransport("decode", replicas[0][2], send_timeout_s=600)
        connected(dst)
        n = max(1, int(a.mb * 1e6 / block.nbytes))
        t0 = time.monotonic()
        for i in range(n):
            dst.kv_block(0, i, [block])
        while dst._outbox:
            dst.poll()
            time.sleep(0.0005)
        clients = [dst]
    else:
        replicas = [start([a.blocks] * a.requests), start()]
        src, dst = (SocketTransport(name, r[2], send_timeout_s=600)
                    for name, r in zip(("prefill", "decode"), replicas))
        connected(src, dst)
        n = a.blocks * a.requests
        t0 = time.monotonic()
        src.submit(0, [1], 1)            # the busy thread's cue to export
        got = 0
        while got < n or dst._outbox:
            for ev in src.poll():
                if ev[0] == "kv_block":
                    got += 1
                    dst.kv_block(ev[1], ev[2], ev[3])
            dst.poll()
            time.sleep(0.0005)
        clients = [src, dst]
    dt = time.monotonic() - t0
    mb = n * block.nbytes / 1e6
    print(f"{a.mode}: {n} frames, {mb:.1f} MB in {dt:.3f} s = "
          f"{mb / dt:.1f} MB/s; longest send backlog "
          f"{ {c.name: round(c.send_backlog_max_s, 3) for c in clients} } s")
    for proc, conn, _ in replicas:
        conn.send(1)
        proc.join(30)


if __name__ == "__main__":
    main()
