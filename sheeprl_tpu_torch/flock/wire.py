"""FLK1 socket framing: length-prefixed frames over localhost TCP or a
Unix-domain socket (the subset of sheeprl_tpu/flock/wire.py that the
serving tier speaks). Pickle-free end to end — control payloads are JSON,
array payloads are `data/wire.py` trees.

Frame layout (little-endian):

    magic(4) = b"FLK1" | kind(1) | flags(1) | reserved(2) | length(8)
    payload[length]

Kinds keep the reference's committed values, so a port client can talk to
a reference server and back:

    HELLO/WELCOME  handshake; WELCOME carries the serving contract
    BYE            client leaves
    ERROR          typed rejection, JSON {error, kind?}
    REQUEST        u32 meta_len | meta_json | pack_tree obs blob
    RESPONSE       u32 meta_len | meta_json | pack_tree action blob
    SHED           JSON {id, retry_after_ms, reason}: retry after the hint
    RELOAD         JSON {path}; reply JSON {ok, version, error}
    PROFILE        JSON {seconds?, dir?}; reply PROFILE JSON {ok, dir?,
                   trace?, seconds?, error?, pid}: a bounded on-demand
                   torch.profiler window (`telemetry/trace.py`)

Transport addresses serialize as `tcp:HOST:PORT` or `unix:PATH`.
"""

from __future__ import annotations

import json
import socket
import struct

__all__ = [
    "MAGIC",
    "MAX_FRAME_BYTES",
    "FrameError",
    "KIND_NAMES",
    "connect",
    "format_address",
    "parse_address",
    "recv_frame",
    "recv_json",
    "register_kind",
    "send_frame",
    "send_json",
]

MAGIC = b"FLK1"
_HEADER = struct.Struct("<4sBBHQ")
# guards against a corrupt length field allocating without bound
MAX_FRAME_BYTES = 1 << 30

# value -> wire name for every registered frame kind (diagnostics only —
# the VALUE is the protocol)
KIND_NAMES: dict[int, str] = {}


def register_kind(value: int, name: str) -> int:
    """Claim a frame-kind value. Kinds are a single u8 on the wire, so the
    registry rejects a value collision and an out-of-range value. Returns
    `value` so kinds read as constants at the definition site."""
    if not 1 <= value <= 255:
        raise ValueError(f"frame kind {value} out of u8 range [1, 255]")
    if value in KIND_NAMES and KIND_NAMES[value] != name:
        raise ValueError(
            f"frame kind {value} already registered as {KIND_NAMES[value]!r} "
            f"(attempted {name!r})"
        )
    other = {v for v, n in KIND_NAMES.items() if n == name and v != value}
    if other:
        raise ValueError(
            f"frame-kind name {name!r} already registered as value {other}"
        )
    KIND_NAMES[value] = name
    return value


HELLO = register_kind(1, "hello")
WELCOME = register_kind(2, "welcome")
BYE = register_kind(10, "bye")
ERROR = register_kind(11, "error")
REQUEST = register_kind(12, "request")
RESPONSE = register_kind(13, "response")
SHED = register_kind(14, "shed")
RELOAD = register_kind(15, "reload")
# 16 = "health" is claimed by serve/server.py at import time.

# open a bounded profiler window on a live process; registered here, where
# the registry lives, so that telemetry/ needs no part of the flock
PROFILE = register_kind(17, "profile")


class FrameError(ConnectionError):
    """Malformed frame or protocol violation on a socket."""


def send_frame(sock: socket.socket, kind: int, payload: bytes = b"") -> None:
    sock.sendall(_HEADER.pack(MAGIC, kind, 0, 0, len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    """Exactly n bytes, or None on clean EOF at a frame boundary."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if got == 0:
                return None
            raise FrameError("connection closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> tuple[int, bytes] | None:
    """-> (kind, payload), or None on clean EOF (peer went away)."""
    header = _recv_exact(sock, _HEADER.size)
    if header is None:
        return None
    magic, kind, _flags, _rsvd, length = _HEADER.unpack(header)
    if magic != MAGIC:
        raise FrameError(f"bad frame magic {magic!r} (expected {MAGIC!r})")
    if length > MAX_FRAME_BYTES:
        raise FrameError(f"frame length {length} exceeds cap")
    payload = _recv_exact(sock, length) if length else b""
    if length and payload is None:
        raise FrameError("connection closed before frame payload")
    return kind, payload or b""


def send_json(sock: socket.socket, kind: int, obj: dict) -> None:
    send_frame(sock, kind, json.dumps(obj).encode())


def recv_json(sock: socket.socket, expected_kind: int) -> dict:
    frame = recv_frame(sock)
    if frame is None:
        raise FrameError("connection closed awaiting reply")
    kind, payload = frame
    if kind == ERROR:
        raise FrameError(
            f"peer error: {json.loads(payload.decode()).get('error')}"
        )
    if kind != expected_kind:
        raise FrameError(
            f"expected {KIND_NAMES.get(expected_kind)}, got {KIND_NAMES.get(kind, kind)}"
        )
    return json.loads(payload.decode())


def format_address(kind: str, *parts) -> str:
    if kind == "tcp":
        host, port = parts
        return f"tcp:{host}:{port}"
    if kind == "unix":
        (path,) = parts
        return f"unix:{path}"
    raise ValueError(f"unknown transport {kind!r}")


def parse_address(addr: str):
    """-> ('tcp', host, port) | ('unix', path)."""
    if addr.startswith("tcp:"):
        host, _, port = addr[4:].rpartition(":")
        return ("tcp", host, int(port))
    if addr.startswith("unix:"):
        return ("unix", addr[5:])
    raise ValueError(f"unparseable address {addr!r}")


def connect(addr: str, timeout: float | None = None) -> socket.socket:
    parsed = parse_address(addr)
    if parsed[0] == "tcp":
        sock = socket.create_connection(parsed[1:], timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    else:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        sock.connect(parsed[1])
    return sock
