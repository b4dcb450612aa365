"""Localhost TCP transport: the same overlay node objects that run on the
simulator run over real sockets (the paper's prototype used TCP/TLS; TLS
termination is out of scope for the offline container — the S-IDA layer
already encrypts payload content end-to-end).

Each node gets a listening socket + a dispatcher thread; ``send`` opens
(and caches) outbound connections.  The ``TcpNet`` object quacks like
SimNet for the subset of the interface the overlay nodes use (send /
call_after via a timer thread / alive), so UserNode/ModelNode work
unmodified.  Own copy of ``repro/net/tcp.py``, framing through the
port's ``messages``.
"""
from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass

from repro_torch.net import messages


@dataclass
class _Peer:
    host: str
    port: int


class TcpNet:
    def __init__(self):
        self.t0 = time.monotonic()
        self.nodes: dict = {}          # node_id -> handler
        self.addrs: dict = {}          # node_id -> _Peer
        self._servers: dict = {}
        self._conns: dict = {}
        self._lock = threading.Lock()
        self._timers: list = []
        self.delivered = 0
        self.dropped = 0
        self._closed = False

    # ---- SimNet-compatible surface ----
    @property
    def t(self) -> float:
        return time.monotonic() - self.t0

    def alive(self, node_id) -> bool:
        return node_id in self.nodes

    def call_after(self, dt: float, fn, *args):
        timer = threading.Timer(dt, fn, args)
        timer.daemon = True
        timer.start()
        self._timers.append(timer)

    def call_at(self, t: float, fn, *args):
        self.call_after(max(0.0, t - self.t), fn, *args)

    # ---- lifecycle ----
    def add_node(self, node_id, handler, host: str = "127.0.0.1"):
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, 0))
        srv.listen(32)
        port = srv.getsockname()[1]
        self.nodes[node_id] = handler
        self.addrs[node_id] = _Peer(host, port)
        self._servers[node_id] = srv
        th = threading.Thread(target=self._accept_loop,
                              args=(node_id, srv), daemon=True)
        th.start()

    def remove_node(self, node_id):
        self.nodes.pop(node_id, None)
        srv = self._servers.pop(node_id, None)
        if srv:
            try:
                srv.close()
            except OSError:
                pass

    def close(self):
        self._closed = True
        for t in self._timers:
            t.cancel()
        for nid in list(self._servers):
            self.remove_node(nid)
        with self._lock:
            for c in self._conns.values():
                try:
                    c.close()
                except OSError:
                    pass
            self._conns.clear()

    # ---- data path ----
    def send(self, src, dst, msg, size_bytes: int = 0):
        peer = self.addrs.get(dst)
        if peer is None or dst not in self.nodes:
            self.dropped += 1
            return
        wire = dict(msg)
        wire["_src"] = _encode_id(src)
        data = messages.encode(wire)
        try:
            conn = self._conn_to(src, dst, peer)
            conn.sendall(data)
        except OSError:
            self.dropped += 1

    def _conn_to(self, src, dst, peer: _Peer):
        key = (src, dst)
        with self._lock:
            c = self._conns.get(key)
            if c is None:
                c = socket.create_connection((peer.host, peer.port),
                                             timeout=5)
                self._conns[key] = c
            return c

    def _accept_loop(self, node_id, srv):
        while not self._closed:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            th = threading.Thread(target=self._recv_loop,
                                  args=(node_id, conn), daemon=True)
            th.start()

    def _recv_loop(self, node_id, conn):
        dec = messages.Decoder()
        while not self._closed:
            try:
                data = conn.recv(65536)
            except OSError:
                return
            if not data:
                return
            for msg in dec.feed(data):
                handler = self.nodes.get(node_id)
                if handler is None:
                    self.dropped += 1
                    continue
                src = _decode_id(msg.pop("_src", None))
                msg = _debytes(msg)
                self.delivered += 1
                try:
                    handler.on_message(self, src, msg)
                except Exception:
                    pass

    def run_until(self, t_end: float):
        """Wall-clock wait (keeps example/test code transport-agnostic)."""
        dt = t_end - self.t
        if dt > 0:
            time.sleep(dt)


def _encode_id(x):
    return ["b", x.hex()] if isinstance(x, bytes) else ["s", x]


def _decode_id(v):
    if v is None:
        return None
    tag, body = v
    return bytes.fromhex(body) if tag == "b" else body


def _debytes(msg):
    """msgpack round-trips py bytes fine; path_id hex strings unchanged."""
    return msg
