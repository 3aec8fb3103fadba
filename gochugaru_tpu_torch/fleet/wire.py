"""Framed-JSON wire protocol for the fleet: router ⇄ replica ⇄ client.

Stdlib-only (socket/struct/json/threading) by constraint — the container
bakes no RPC framework, and a length-prefixed JSON frame is all the
fleet needs: requests are small (a check batch, a health probe), the
bulk paths (bootstrap export, log stream) are streamed as frame
sequences, and every error crosses the wire as a *classified* frame
that re-raises as the same ``AuthzError`` subclass on the caller's side
— so the retry envelope (utils/retry.py) treats a remote shed exactly
like a local one.

Frame format: 4-byte big-endian length + UTF-8 JSON.  A connection that
dies mid-frame raises ``WireClosed`` (a ``ConnectionError`` subclass,
so ``classify_dispatch_exception`` maps it to a retriable
``UnavailableError`` — the router's failover trigger).
"""

from __future__ import annotations

import datetime as _dt
import json
import socket
import struct
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

from ..consistency import Requirement, Strategy
from ..rel.relationship import Relationship, expiration_micros
from ..rel.update import Update, UpdateType
from ..utils import errors as _errors

#: Frame size ceiling — a corrupted length prefix must not allocate GBs.
FRAME_MAX = 64 << 20


class WireClosed(ConnectionError):
    """The peer closed the connection (mid-frame or mid-request)."""


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------


def send_frame(sock: socket.socket, obj: Any) -> None:
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int, *, eof_ok: bool) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if eof_ok and not buf:
                return None
            raise WireClosed("connection closed mid-frame")
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Optional[Any]:
    """One frame, or None on clean EOF at a frame boundary."""
    head = _recv_exact(sock, 4, eof_ok=True)
    if head is None:
        return None
    (n,) = struct.unpack(">I", head)
    if n > FRAME_MAX:
        raise ValueError(f"frame of {n} bytes exceeds FRAME_MAX")
    body = _recv_exact(sock, n, eof_ok=False)
    return json.loads(body.decode("utf-8"))


# ---------------------------------------------------------------------------
# Classified errors over the wire
# ---------------------------------------------------------------------------

#: AuthzError classes that survive a wire crossing by name.  Anything not
#: listed deserializes as PermanentError — unknown remote failures must
#: not retry blindly.
_ERROR_TYPES: Dict[str, type] = {
    cls.__name__: cls
    for cls in (
        _errors.UnavailableError,
        _errors.ShedError,
        _errors.DeadlineExceededError,
        _errors.CancelledError,
        _errors.PermanentError,
        _errors.PreconditionFailedError,
        _errors.AlreadyExistsError,
        _errors.RevisionUnavailableError,
        _errors.SchemaError,
        _errors.PartialDeletionError,
    )
}


def register_error(cls: type) -> type:
    """Let modules above this one (fleet/zookie.py) add their own
    classified error to the wire vocabulary."""
    _ERROR_TYPES[cls.__name__] = cls
    return cls


def error_frame(err: BaseException) -> Dict[str, Any]:
    return {"ok": False, "error": type(err).__name__, "msg": str(err)}


def raise_error_frame(frame: Dict[str, Any]) -> None:
    cls = _ERROR_TYPES.get(frame.get("error", ""), _errors.PermanentError)
    raise cls(frame.get("msg", frame.get("error", "remote error")))


# ---------------------------------------------------------------------------
# Relationship / update / strategy codecs
# ---------------------------------------------------------------------------


def rel_to_wire(r: Relationship) -> Dict[str, Any]:
    d: Dict[str, Any] = {
        "rt": r.resource_type, "ri": r.resource_id, "rr": r.resource_relation,
        "st": r.subject_type, "si": r.subject_id,
    }
    if r.subject_relation:
        d["sr"] = r.subject_relation
    if r.caveat_name:
        d["cv"] = r.caveat_name
        if r.caveat_context:
            d["cc"] = dict(r.caveat_context)
    exp = expiration_micros(r.expiration)
    if exp:
        d["ex"] = exp
    return d


def rel_from_wire(d: Dict[str, Any]) -> Relationship:
    exp = None
    if d.get("ex"):
        exp = _dt.datetime.fromtimestamp(d["ex"] / 1e6, tz=_dt.timezone.utc)
    return Relationship(
        resource_type=d["rt"], resource_id=d["ri"],
        resource_relation=d["rr"],
        subject_type=d["st"], subject_id=d["si"],
        subject_relation=d.get("sr", ""),
        caveat_name=d.get("cv", ""),
        caveat_context=d.get("cc", {}),
        expiration=exp,
    )


def update_to_wire(u: Update) -> Dict[str, Any]:
    return {"t": u.update_type.value, "r": rel_to_wire(u.relationship)}


def update_from_wire(d: Dict[str, Any]) -> Update:
    return Update(UpdateType(d["t"]), rel_from_wire(d["r"]))


def strategy_to_wire(cs: Strategy) -> Dict[str, Any]:
    d: Dict[str, Any] = {"req": cs.requirement.value}
    if cs.revision is not None:
        d["rev"] = cs.revision
    return d


def strategy_from_wire(d: Dict[str, Any]) -> Strategy:
    return Strategy(Requirement(d["req"]), d.get("rev"))


# ---------------------------------------------------------------------------
# Client connection
# ---------------------------------------------------------------------------


class Conn:
    """One connection to a wire server; requests are serialized under a
    lock (one outstanding request per Conn — callers wanting parallelism
    open more Conns, which the router's per-replica handles do)."""

    def __init__(
        self, addr: Tuple[str, int], *,
        connect_timeout: float = 2.0, io_timeout: float = 30.0,
    ) -> None:
        self.addr = addr
        self._sock = socket.create_connection(addr, timeout=connect_timeout)
        self._sock.settimeout(io_timeout)
        self._lock = threading.Lock()

    def request(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            send_frame(self._sock, msg)
            out = recv_frame(self._sock)
        if out is None:
            raise WireClosed("connection closed before response")
        if isinstance(out, dict) and out.get("ok") is False:
            raise_error_frame(out)
        return out

    def stream(self, msg: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
        """Send one request, yield response frames until a frame carries
        ``eof`` or the connection closes.  The lock is held for the whole
        stream — a streaming Conn is single-purpose."""
        with self._lock:
            send_frame(self._sock, msg)
            while True:
                out = recv_frame(self._sock)
                if out is None:
                    return
                if isinstance(out, dict) and out.get("ok") is False:
                    raise_error_frame(out)
                if isinstance(out, dict) and out.get("eof"):
                    return
                yield out

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class WireServer:
    """Threaded framed-JSON server: one accept loop, one thread per
    connection.  ``handler(msg, sock)`` returns a response dict, or None
    when it already streamed its own frames on ``sock``.  A handler
    exception becomes a classified error frame; the connection stays up
    (one bad request must not sever a router's replica handle)."""

    def __init__(
        self, handler, *, host: str = "127.0.0.1", port: int = 0,
        name: str = "wire",
    ) -> None:
        self._handler = handler
        self._sock = socket.create_server((host, port))
        self._sock.settimeout(0.25)  # accept loop polls the closed flag
        self.host, self.port = self._sock.getsockname()[:2]
        self._closed = False
        self._conns: set = set()
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True, name=f"{name}-accept"
        )
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                c, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                if self._closed:
                    c.close()
                    return
                self._conns.add(c)
            threading.Thread(
                target=self._serve, args=(c,), daemon=True
            ).start()

    def _serve(self, c: socket.socket) -> None:
        try:
            while not self._closed:
                msg = recv_frame(c)
                if msg is None:
                    return
                try:
                    out = self._handler(msg, c)
                except (WireClosed, OSError):
                    return  # handler aborted the connection (kill path)
                except BaseException as e:
                    out = error_frame(e)
                if out is not None:
                    send_frame(c, out)
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            with self._lock:
                self._conns.discard(c)
            try:
                c.close()
            except OSError:
                pass

    def close(self, *, abort: bool = False) -> None:
        """Stop accepting.  ``abort=True`` hard-closes live connections —
        the crash-simulation path (fleet/replica.py ``die``): peers see
        a reset mid-request, exactly what a killed process looks like."""
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        if abort:
            with self._lock:
                conns = list(self._conns)
            for c in conns:
                try:
                    c.setsockopt(
                        socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0),
                    )
                except OSError:
                    pass
                try:
                    c.close()
                except OSError:
                    pass
