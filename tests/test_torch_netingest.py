"""The port's network ingest (runtime/netingest.py) against the JAX
package's: one wire format, so a sender of either package feeds a server of
the other, with the same drop counts.  Localhost sockets and NumPy only.

F9 as the reference has it: a producer that reconnects starts a new sender
whose ``seq`` restarts at 1, and its frames are dropped as stale until they
pass the stream's last accepted ``seq``.
"""

import socket
import time

import numpy as np
import pytest

from headtrackr_tpu.runtime import fanout as jf
from headtrackr_tpu.runtime import netingest as jn
from headtrackr_tpu_torch.runtime import fanout as tf
from headtrackr_tpu_torch.runtime import netingest as tn

SHAPE = (24, 32)
PAIRS = {"jax_to_port": (jn.FrameSender, tn.NetIngestServer, tf.IngestRing),
         "port_to_jax": (tn.FrameSender, jn.NetIngestServer, jf.IngestRing),
         "port_to_port": (tn.FrameSender, tn.NetIngestServer, tf.IngestRing)}


def _mk(v, shape=SHAPE):
    return np.full(shape + (3,), v, np.uint8)


def _wait(pred, timeout=5.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


@pytest.fixture(params=sorted(PAIRS))
def served(request):
    sender, server, ring_cls = PAIRS[request.param]
    ring = ring_cls(4, SHAPE)
    srv = server(ring, host="127.0.0.1").start()
    yield sender, ring, srv
    # the reference's close() waits 5 s for its accept thread: wake it
    srv._sock.shutdown(socket.SHUT_RDWR)
    srv.close()


def test_wire_format_is_the_reference():
    assert tn.MAGIC == jn.MAGIC == 0x48544631
    assert tn.HEADER.format == jn.HEADER.format and tn.HEADER.size == 20
    assert tn.MAX_DIM == jn.MAX_DIM


def test_frames_land_in_ring(served):
    sender, ring, srv = served
    s = sender(srv.address)
    assert [s.send(0, _mk(10)), s.send(2, _mk(20)), s.send(0, _mk(11))] \
        == [1, 1, 2]
    assert _wait(lambda: srv.stats()["received"] == 3)
    s.close()
    batch = ring.snapshot()
    assert (batch[0] == 11).all() and (batch[2] == 20).all()
    assert (batch[1] == 0).all()
    seq = ring.seq()
    assert seq[0] == 2 and seq[2] == 1 and seq[1] == 0


def test_bad_records_counted_not_fatal(served):
    sender, ring, srv = served
    s = sender(srv.address)
    s.send(0, _mk(1, (8, 8)))      # wrong dims -> dropped_shape
    s.send(99, _mk(2))             # unknown stream -> dropped_stream
    s.send(1, _mk(3))              # still accepted on the same connection
    assert _wait(lambda: srv.stats()["received"] == 1)
    assert srv.stats() == dict(received=1, dropped_shape=1, dropped_stream=1,
                               dropped_stale=0)
    assert (ring.snapshot()[1] == 3).all()
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        s.send(0, np.zeros(SHAPE, np.uint8))
    s.close()


def test_reconnect_restarts_seq_and_is_dropped_stale(served):
    """F9, inherited: the reconnected producer's seq 1 and 2 are not newer
    than the 2 already accepted; its third frame is."""
    sender, ring, srv = served
    a = sender(srv.address)
    a.send(3, _mk(50))
    a.send(3, _mk(51))
    assert _wait(lambda: srv.stats()["received"] == 2)
    a.close()
    b = sender(srv.address)        # the same producer, reconnected
    b.send(3, _mk(60))
    b.send(3, _mk(61))
    assert _wait(lambda: srv.stats()["dropped_stale"] == 2)
    assert (ring.snapshot()[3] == 51).all()
    b.send(3, _mk(62))             # seq 3 > 2: accepted
    assert _wait(lambda: srv.stats()["received"] == 3)
    assert (ring.snapshot()[3] == 62).all()
    b.close()


def test_close_returns_at_once():
    """The port's close() wakes its accept loop instead of waiting out the
    join's 5 s timeout, as the reference's does."""
    srv = tn.NetIngestServer(tf.IngestRing(2, SHAPE), host="127.0.0.1").start()
    s = tn.FrameSender(srv.address)
    s.send(0, _mk(4))
    assert _wait(lambda: srv.stats()["received"] == 1)
    t0 = time.perf_counter()
    srv.close()
    assert time.perf_counter() - t0 < 2.0
    assert not srv._accept_thread.is_alive()
    s.close()


def test_garbage_closes_connection_only(served):
    sender, ring, srv = served
    raw = socket.create_connection(srv.address)
    raw.sendall(b"not a frame header at all........")
    raw.close()
    s = sender(srv.address)
    s.send(0, _mk(7))
    assert _wait(lambda: srv.stats()["received"] == 1)
    assert (ring.snapshot()[0] == 7).all()
    s.close()
