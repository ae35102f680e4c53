"""The port's router↔replica wire against the JAX package's.

The frame codec gives the same bytes on both sides for the same plain
payloads (numpy KV slabs included), and each side decodes the other's
frames.  Every scenario of ``tests/test_transport.py`` (the decoder on
incremental, torn, version, CRC and length-bound input; socket round
trip, reconnect churn, partition failover, a half-open link, slow-link
demotion, torn and corrupt frames, KV migration over the socket, the
router's reattach) runs over an in-process served fake through the
JAX package's ``SocketTransport``/``TransportServer``/``ChaosProxy``
and through the port's, with its own asserts on each side; each
request's final state and tokens are equal (``fleet_twins.py``).
"""

import numpy as np
import pytest

import fleet_twins as tw
from apex_tpu.serving import transport as ref_transport
from apex_tpu_torch.serving import transport
from torch_threads import one_torch_thread  # noqa: F401

PAYLOADS = [
    ("token", 3, 42),
    ("state", {"free_blocks": 7, "hb": 12.5, "draining": False}),
    ("submit_many", [(0, [1, 2, 3], 8, None, None, {"trace_id": "ab",
                                                     "attempt": 1})]),
    ("kv_block", 5, 0, (np.arange(24, dtype=np.uint16).reshape(2, 3, 4),
                        np.arange(24, dtype=np.uint16).reshape(2, 3, 4))),
    ("kv_block", 5, 1, (np.full((2, 4), -3, np.int8),
                        np.ones((2, 4), np.float32))),
    ("evt", 9, ("ready", {"pid": 1, "name": "r", "role": "decode"})),
]


def test_encode_frame_is_the_references_byte_for_byte():
    assert transport.FRAME_HEADER.format == ref_transport.FRAME_HEADER.format
    assert transport.FRAME_VERSION == ref_transport.FRAME_VERSION
    assert transport.MAX_FRAME_BYTES == ref_transport.MAX_FRAME_BYTES
    for p in PAYLOADS:
        assert transport.encode_frame(p) == ref_transport.encode_frame(p)


@pytest.mark.parametrize("enc,dec", [(ref_transport, transport),
                                     (transport, ref_transport)])
def test_each_side_decodes_the_others_frames(enc, dec):
    wire = b"".join(enc.encode_frame(p) for p in PAYLOADS)
    got = []
    d = dec.FrameDecoder()
    for i in range(0, len(wire), 7):
        got.extend(d.feed(wire[i:i + 7]))
    assert not d.partial and len(got) == len(PAYLOADS)
    for g, p in zip(got, PAYLOADS):
        assert repr(g) == repr(p)


@pytest.mark.parametrize("case", tw.cases("test_transport"))
def test_transport_scenario_matches_reference(case, tmp_path):
    tw.assert_same("test_transport", case, tmp_path, tw.SOCKET_PARTS)


def test_server_drains_the_socket_in_one_read_turn():
    """A busy worker thread makes every server loop turn wait for the
    GIL, so a turn reads all the kernel holds, not one 64 KiB chunk:
    a KV migration's blocks must not trickle in a chunk a turn."""
    import queue
    import socket

    cmd_q = queue.Queue()
    server = transport.TransportServer(cmd_q, queue.Queue())
    server.close(bye=False)            # stop the loop; drive _read here
    router, replica = socket.socketpair()
    try:
        replica.setblocking(False)
        server._conns[replica] = transport._ServerConn(
            transport.MAX_FRAME_BYTES)
        block = np.zeros(10_000, np.uint8)
        wire = transport.encode_frame(("hello", 0, 0, True, 1)) + b"".join(
            transport.encode_frame(("cmd", i + 1, ("kv_block", 0, i, [block])))
            for i in range(12))
        assert len(wire) > 65536
        router.sendall(wire)
        server._read(replica)
        got = [cmd_q.get_nowait()[2] for _ in range(cmd_q.qsize())]
        assert got == list(range(12))
    finally:
        router.close()
        replica.close()
