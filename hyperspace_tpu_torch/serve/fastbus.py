"""Fast data plane transport: per-host push over Unix domain sockets.

Counterpart of ``hyperspace_tpu/serve/fastbus.py``; the frames and the
Arrow payloads are the reference's, byte for byte. The durable fleet planes
(``serve/bus.py``, the claim/spool single-flight in ``serve/fleet.py``)
coordinate through files and polling; this module is the microsecond path
under the same contracts, allowed to drop anything:

* **Framing.** One message a connection: an 8-byte prefix of two lengths
  (JSON header bytes, binary body bytes), then the frames. Results travel
  as Arrow IPC streams in the body, the spool's encoding.
* **Push** (:func:`push`) is fire-and-forget: a failed connect or send
  returns False, and the durable plane delivers the same information a
  poll interval later.
* **Request** (:func:`request`) is one round trip with a deadline; any
  failure raises ``OSError`` and the caller falls back to the claim/spool
  election. Both carry the ``fastbus_send`` fault point
  (``testing/faults.py``).
* **Serve** (:class:`FastBusServer`) binds a short socket path under the
  system temp dir (Unix socket paths are limited to 108 bytes on Linux, so
  never under a deep lake path; the member lease file of
  ``serve/router.py`` carries the path to peers) and hands each message to
  a small handler pool.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import tempfile
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple

import pyarrow as pa

from hyperspace_tpu_torch.testing import faults
from hyperspace_tpu_torch.utils import files as file_utils

_log = logging.getLogger("hyperspace_tpu_torch.fleet.fastbus")

#: (header length, body length) prefix — big-endian, fixed width
_FRAME = struct.Struct(">II")

#: defensive bound on either frame length: a torn/hostile peer must cost
#: one dropped connection, not an attempted multi-GiB allocation
_MAX_FRAME = 1 << 30


def socket_path() -> str:
    """A fresh, SHORT socket path under the system temp dir (never under
    the lake — pytest tmp dirs routinely exceed the ~100-byte UDS
    limit). The router's member file records it for peers."""
    return os.path.join(
        tempfile.gettempdir(),
        f"hsfb-{os.getpid()}-{uuid.uuid4().hex[:8]}.sock",
    )


# -- Arrow payload codec (identical to the spool encoding) -------------------


def table_to_bytes(table: pa.Table) -> bytes:
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as writer:
        writer.write_table(table)
    return sink.getvalue().to_pybytes()


def table_from_bytes(data: bytes) -> pa.Table:
    return pa.ipc.open_stream(pa.py_buffer(data)).read_all()


# -- framing -----------------------------------------------------------------


def _send_frame(sock: socket.socket, header: Dict, body: bytes = b"") -> None:
    hdr = json.dumps(header).encode("utf-8")
    sock.sendall(_FRAME.pack(len(hdr), len(body)) + hdr + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n > 0:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("fastbus peer closed mid-frame")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv_frame(sock: socket.socket) -> Tuple[Dict, bytes]:
    hdr_len, body_len = _FRAME.unpack(_recv_exact(sock, _FRAME.size))
    if hdr_len > _MAX_FRAME or body_len > _MAX_FRAME:
        raise ConnectionError(
            f"fastbus frame too large ({hdr_len}/{body_len} bytes)"
        )
    header = json.loads(_recv_exact(sock, hdr_len).decode("utf-8"))
    body = _recv_exact(sock, body_len) if body_len else b""
    return header, body


# -- client side -------------------------------------------------------------


def push(
    sock_path: str, header: Dict, body: bytes = b"", timeout_s: float = 0.5
) -> bool:
    """Fire-and-forget delivery of one message. Returns True when the
    frames were handed to the kernel, False on any socket failure — the
    durable plane is the retransmit. The armed ``fastbus_send`` fault
    raises out of here (an ``OSError`` the caller's degrade contract
    handles exactly like a dead peer)."""
    faults.check("fastbus_send", sock_path)
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(timeout_s)
            s.connect(sock_path)
            _send_frame(s, header, body)
        return True
    except OSError:
        return False


def request(
    sock_path: str,
    header: Dict,
    body: bytes = b"",
    timeout_s: float = 2.0,
) -> Tuple[Dict, bytes]:
    """One round trip: send a message, wait for the reply frame. Raises
    ``OSError`` on connect/send/receive failure or deadline — callers
    fall back to the durable plane (``serve/fleet.py`` counts it). The
    armed ``fastbus_send`` fault fires here too."""
    faults.check("fastbus_send", sock_path)
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout_s)
        s.connect(sock_path)
        _send_frame(s, header, body)
        return _recv_frame(s)


# -- server side -------------------------------------------------------------


class FastBusServer:
    """Accept loop + handler pool over one Unix socket.

    ``handler(header, body)`` returns ``(reply_header, reply_body)`` for
    request messages or ``None`` for one-way pushes. Handler exceptions
    are contained per connection — the fast plane is an optimization; a
    poisoned message costs one dropped connection, never the listener.
    """

    def __init__(
        self,
        handler: Callable[[Dict, bytes], Optional[Tuple[Dict, bytes]]],
        workers: int = 4,
    ):
        self._handler = handler
        self.path = socket_path()
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.path)
        self._sock.listen(128)
        # the accept timeout is a SHUTDOWN poll, not a data-plane poll:
        # messages are dispatched the instant accept() returns
        self._sock.settimeout(0.2)
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, workers), thread_name_prefix="hs-fastbus"
        )
        self._thread = threading.Thread(
            target=self._accept_loop, name="hs-fastbus-accept", daemon=True
        )
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # closed under us during stop()
            try:
                self._pool.submit(self._serve_conn, conn)
            except RuntimeError:
                conn.close()  # pool already shut down

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(5.0)
            header, body = _recv_frame(conn)
            reply = self._handler(header, body)
            if reply is not None:
                _send_frame(conn, reply[0], reply[1])
        except Exception as exc:  # hslint: disable=HS402
            # contain by contract (see class doc): requester timeouts
            # already cover a lost reply with the durable fallback
            _log.debug("fastbus connection failed: %s", exc)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def stop(self) -> None:
        """Stop accepting, drain the handler pool, unlink the socket
        file (a clean member leaves nothing on disk)."""
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)
        self._pool.shutdown(wait=False)
        file_utils.delete(self.path)
