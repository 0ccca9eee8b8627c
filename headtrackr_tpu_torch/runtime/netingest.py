"""Network frame ingest: remote producers -> IngestRing over TCP.

The port's copy of headtrackr_tpu/runtime/netingest.py: the same wire
format, so a sender of either package feeds a server of the other.  Its
behaviour is the reference's, including this: a producer that reconnects
starts a new FrameSender whose ``seq`` restarts at 1, so its frames are
dropped as stale until they pass the stream's last accepted ``seq``.

The reference ingests frames from a local ``<video>`` element
(src/main.js:144-171); the batched equivalent is ``IngestRing``
(latest-frame-wins, runtime/fanout.py).  This module is the multi-host
leg of that path: producers on other machines push frames over plain TCP
into the serving host's ring, which ``BatchedSession`` then batches onto
the GPU.  Streams never communicate, so this is the only cross-host
traffic the framework needs: one frame stream per camera, no collectives,
no cross-host device state.

Design notes:

* Wire format (little-endian), one record per frame:
      magic  u32  0x48544631 ("HTF1")
      stream u32  ring slot index
      seq    u64  producer's frame counter (monotonic per stream)
      h, w   u16  frame dims — MUST match the ring's (no silent resize:
                  capture normalization is the producer's job, same as
                  the reference's drawImage scaling at src/main.js:168-170)
      data   h*w*3 bytes of RGB u8
  The magic guards against desync/garbage; any malformed record closes
  the connection (a producer reconnects with clean state).

* Latest-frame-wins is inherited from IngestRing.put: a slow consumer
  never blocks producers, stale frames are overwritten, ``seq`` lets the
  server drop reordered frames from producer failover (two producers
  racing one stream id).

* Threads, not asyncio: one reader thread per connection matches
  IngestRing's per-stream locking and keeps the hot serving loop
  (BatchedSession) untouched.  Ingest is not the bottleneck — a 240x320
  frame is 230 KB; localhost TCP moves >1 GB/s while a 256-stream tick
  consumes ~59 MB — so clarity beats an event loop here.
"""

import socket
import struct
import threading

import numpy as np

__all__ = ["NetIngestServer", "FrameSender", "HEADER", "MAGIC"]

MAGIC = 0x48544631  # "HTF1"
HEADER = struct.Struct("<IIQHH")  # magic, stream, seq, h, w
MAX_DIM = 4096  # sanity bound on h/w before trusting a record's size


def _recv_exact(sock, n, buf=None):
    """Read exactly n bytes (into ``buf`` if given); None on EOF/short read."""
    view = memoryview(buf if buf is not None else bytearray(n))[:n]
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            return None
        got += r
    return view


class NetIngestServer:
    """TCP listener feeding an IngestRing from remote frame producers.

    ring: runtime.fanout.IngestRing (or anything with ``.put(i, frame)``
    and ``._buf`` shaped (2, N, H, W, 3)).  Frames whose stream id is out
    of range, whose dims mismatch the ring, or whose seq is not newer than
    the stream's last accepted seq are counted in ``stats()`` and dropped;
    the connection stays up (a camera glitch shouldn't sever its peers on
    a shared producer process).

    Usage::

        ring = IngestRing(n_streams, frame_shape)
        srv = NetIngestServer(ring).start()           # port 0 -> ephemeral
        ... producers connect to srv.address ...
        session = BatchedSession(n_streams, ring=ring, ...)
    """

    def __init__(self, ring, host="0.0.0.0", port=0):
        self.ring = ring
        _, self.n, self.h, self.w, _ = ring._buf.shape
        self._sock = socket.create_server((host, port))
        self.address = self._sock.getsockname()  # (host, real port)
        self._threads = []
        self._conns = []
        self._lock = threading.Lock()
        self._run = False
        self._accept_thread = None
        # telemetry (under _lock)
        self._received = 0
        self._dropped_shape = 0
        self._dropped_stream = 0
        self._dropped_stale = 0
        self._last_seq = {}

    def start(self):
        self._run = True
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self):
        while self._run:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.append(conn)
            t = threading.Thread(target=self._reader, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _reader(self, conn):
        hdr_buf = bytearray(HEADER.size)
        frame_buf = np.empty((self.h, self.w, 3), np.uint8)
        flat = frame_buf.reshape(-1)
        try:
            while self._run:
                if _recv_exact(conn, HEADER.size, hdr_buf) is None:
                    return
                magic, stream, seq, h, w = HEADER.unpack(bytes(hdr_buf))
                if magic != MAGIC or h > MAX_DIM or w > MAX_DIM:
                    return  # desynced/garbage: drop the connection
                nbytes = h * w * 3
                if (h, w) != (self.h, self.w):
                    # wrong size: drain the payload, count, keep the conn
                    if _recv_exact(conn, nbytes) is None:
                        return
                    with self._lock:
                        self._dropped_shape += 1
                    continue
                if _recv_exact(conn, nbytes, flat) is None:
                    return
                if stream >= self.n:
                    with self._lock:
                        self._dropped_stream += 1
                    continue
                with self._lock:
                    last = self._last_seq.get(stream)
                    if last is not None and seq <= last:
                        self._dropped_stale += 1
                        continue
                    self._last_seq[stream] = seq
                    self._received += 1
                self.ring.put(stream, frame_buf)
        finally:
            conn.close()

    def stats(self):
        with self._lock:
            return dict(received=self._received,
                        dropped_shape=self._dropped_shape,
                        dropped_stream=self._dropped_stream,
                        dropped_stale=self._dropped_stale)

    def close(self):
        self._run = False
        try:
            # wakes the accept() the loop is blocked in (closing alone does
            # not, and the join below would wait out its timeout)
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        for t in self._threads:
            t.join(timeout=5.0)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        return self


class FrameSender:
    """Producer-side client: pushes (stream, frame) records to a
    NetIngestServer.  One sender per producer process; a sender may carry
    any number of streams.  Not thread-safe (one socket, sequential
    writes) — use one FrameSender per producer thread."""

    def __init__(self, address):
        self._sock = socket.create_connection(address)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._seq = {}

    def send(self, stream, frame):
        frame = np.ascontiguousarray(frame, np.uint8)
        if frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"frame must be (H, W, 3) u8; got {frame.shape}")
        seq = self._seq.get(stream, 0) + 1
        self._seq[stream] = seq
        h, w = frame.shape[:2]
        self._sock.sendall(HEADER.pack(MAGIC, stream, seq, h, w))
        self._sock.sendall(frame.data)
        return seq

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
