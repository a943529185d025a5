"""Dependency-free memcached backend, text protocol (the port's own copy of
``stif_tpu/data/memcache.py``; pure Python).

Parity target: the reference's ``data_type == 'mc'`` branch
(``codes/data/Vimeo7_dataset.py:70-109``) reads PNG-encoded frames from a
cluster memcached via the proprietary ``mc`` client, with GT frames stored
as three single-channel PNGs under ``<root>_B/_G/_R`` to stay below the
1 MB value limit (``_read_img_mc_BGR``). That branch is unreachable-buggy
in the reference (``Vimeo7_dataset.py:168`` calls ``_read_img_mc_BGR`` with
four args against a three-arg signature); this module implements the same
capability correctly and without the cluster-specific ``mc`` package:

* ``MemcachedClient`` — a minimal socket client for the standard memcached
  TEXT protocol (``get``/``set``), enough to serve read-mostly training
  traffic against any stock memcached.
* ``MiniMemcachedServer`` — an in-process threaded server speaking the same
  protocol subset, used by the tests and for local development without a
  memcached installation.

Values are opaque bytes; the dataset layer stores/loads PNG buffers.
"""

from __future__ import annotations

import socket
import socketserver
import threading
from typing import Dict, Optional


class MemcachedClient:
    """Tiny memcached text-protocol client (get/set).

    Lazily connects; one reconnect attempt per operation on socket errors
    (training workers are long-lived and memcached restarts happen).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 11211,
                 timeout: float = 10.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._sock: Optional[socket.socket] = None
        self._buf = b""

    # -- connection -------------------------------------------------------
    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection((self.host, self.port),
                                         timeout=self.timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
            self._buf = b""
        return self._sock

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._buf = b""

    def _readline(self, s: socket.socket) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = s.recv(65536)
            if not chunk:
                raise ConnectionError("memcached closed connection")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _readn(self, s: socket.socket, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = s.recv(65536)
            if not chunk:
                raise ConnectionError("memcached closed connection")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n:]
        return data

    @staticmethod
    def _check_key(key: str) -> bytes:
        kb = key.encode("utf-8")
        if len(kb) > 250 or any(c <= 0x20 or c == 0x7F for c in kb):
            raise ValueError(f"invalid memcached key: {key!r}")
        return kb

    # -- operations -------------------------------------------------------
    def get(self, key: str) -> Optional[bytes]:
        """Return the value bytes, or None if the key is absent."""
        kb = self._check_key(key)
        for attempt in (0, 1):
            try:
                s = self._connect()
                s.sendall(b"get " + kb + b"\r\n")
                line = self._readline(s)
                if line == b"END":
                    return None
                if not line.startswith(b"VALUE "):
                    raise ConnectionError(f"unexpected reply: {line!r}")
                nbytes = int(line.split()[3])
                data = self._readn(s, nbytes)
                self._readn(s, 2)              # trailing \r\n
                end = self._readline(s)
                if end != b"END":
                    raise ConnectionError(f"missing END: {end!r}")
                return data
            except (OSError, ConnectionError):
                self.close()
                if attempt:
                    raise
        return None  # unreachable

    def set(self, key: str, value: bytes, exptime: int = 0) -> None:
        kb = self._check_key(key)
        for attempt in (0, 1):
            try:
                s = self._connect()
                s.sendall(b"set %s 0 %d %d\r\n" % (kb, exptime, len(value))
                          + value + b"\r\n")
                line = self._readline(s)
                if line != b"STORED":
                    raise ConnectionError(f"set not stored: {line!r}")
                return
            except (OSError, ConnectionError):
                self.close()
                if attempt:
                    raise


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        buf = b""
        store: Dict[bytes, bytes] = self.server.store  # type: ignore

        def readline():
            nonlocal buf
            while b"\r\n" not in buf:
                chunk = self.request.recv(65536)
                if not chunk:
                    return None
                buf += chunk
            line, buf = buf.split(b"\r\n", 1)
            return line

        def readn(n):
            nonlocal buf
            while len(buf) < n:
                chunk = self.request.recv(65536)
                if not chunk:
                    return None
                buf += chunk
            data, buf = buf[:n], buf[n:]
            return data

        while True:
            line = readline()
            if line is None:
                return
            parts = line.split()
            if not parts:
                continue
            cmd = parts[0]
            if cmd == b"get":
                out = b""
                for key in parts[1:]:
                    val = store.get(key)
                    if val is not None:
                        out += b"VALUE %s 0 %d\r\n%s\r\n" % (key, len(val),
                                                             val)
                self.request.sendall(out + b"END\r\n")
            elif cmd == b"set":
                key, nbytes = parts[1], int(parts[4])
                data = readn(nbytes)
                if data is None or readn(2) is None:
                    return
                store[key] = data
                self.request.sendall(b"STORED\r\n")
            elif cmd == b"quit":
                return
            else:
                self.request.sendall(b"ERROR\r\n")


class MiniMemcachedServer:
    """In-process memcached (text-protocol get/set subset) for tests/dev.

    Usage::

        with MiniMemcachedServer() as srv:
            client = MemcachedClient(port=srv.port)
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socketserver.ThreadingTCPServer((host, port), _Handler,
                                                    bind_and_activate=True)
        self._srv.daemon_threads = True
        self._srv.store = {}  # type: ignore[attr-defined]
        self.host = host
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def store(self) -> Dict[bytes, bytes]:
        return self._srv.store  # type: ignore[attr-defined]

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
