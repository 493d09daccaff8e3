"""Length-prefixed, CRC-trailered RPC framing for the serving front door.

The port's copy of ``flextree_tpu/serving/rpc.py``: the same frames byte
for byte (``encode_frame`` of a payload is the JAX package's), so a
replica or front door of either package talks to the other's.

The serving stack's control plane is already cross-process (heartbeats
and endpoint files ride :mod:`..runtime.ctrlfile`'s trailered files on a
shared directory); this module gives the request path the same
discipline over a TCP byte stream.  A frame is::

    [4-byte big-endian payload length N][N payload bytes]

where the payload reuses the control-file format exactly — one compact
JSON line followed by a ``{"len": ..., "crc32": ...}`` trailer line
(:func:`..runtime.ctrlfile.control_trailer`) — so the same
property holds on the wire that holds on disk: truncation or corruption
at ANY byte offset parse-refuses, it never half-parses into a plausible
message.  A violated frame raises :class:`RpcTornFrame`; since a byte
stream past a framing violation cannot be re-synchronized, the owning
connection is dead from that point (the caller's retry machinery treats
it like a reset).

Error taxonomy (the JAX package's codes, which travel on the wire):

- ``FT_RPC_TIMEOUT`` (:class:`RpcTimeout`) — no response inside the
  deadline (attempt budget or propagated request deadline);
- ``FT_RPC_CONN_REFUSED`` (:class:`RpcConnRefused`) — connect refused,
  reset, or EOF: the replica process is gone or never there;
- ``FT_RPC_TORN_FRAME`` (:class:`RpcTornFrame`) — framing violation:
  short read, CRC/length mismatch, or an oversized-length header;
- ``FT_RPC_SHED`` (:class:`RpcShed`) — the request was refused under
  admission pressure (front door or replica), loudly and immediately.

:class:`RpcConnection` multiplexes one socket: every request frame
carries a ``corr`` correlation id, responses may arrive in ANY order
(continuous batching finishes requests out of submission order), and a
single reader thread routes each response to the waiter that owns its
``corr``.  All sends go through one write lock so concurrent callers
never interleave partial frames.

Everything here is host-side stdlib networking — no tensors — so the
whole protocol is unit-testable against an in-memory
``socket.socketpair()``.
"""

from __future__ import annotations

import base64
import binascii
import json
import socket
import struct
import threading

from ..runtime.ctrlfile import control_trailer

__all__ = [
    "RpcError",
    "RpcTimeout",
    "RpcConnRefused",
    "RpcTornFrame",
    "RpcShed",
    "MAX_FRAME_BYTES",
    "MAX_KV_CHUNK_BYTES",
    "encode_frame",
    "decode_frame_payload",
    "send_frame",
    "recv_frame",
    "chunk_blob",
    "join_chunks",
    "RpcConnection",
]

#: refuse any frame claiming more than this many payload bytes: a torn
#: or adversarial length header must fail fast, not allocate gigabytes
#: and stall the reader until the peer's OOM kills it
MAX_FRAME_BYTES = 8 * 1024 * 1024

#: raw bytes per KV-transfer chunk: base64 inflates 4/3 and the JSON
#: envelope adds a trailer, so 2 MiB raw rides well under the 8 MiB
#: frame cap while keeping a multi-block migration to a handful of
#: frames — a streamed KV transfer is many bounded frames, never one
#: frame sized to the payload
MAX_KV_CHUNK_BYTES = 2 * 1024 * 1024

_LEN = struct.Struct(">I")


class RpcError(RuntimeError):
    """Base of the RPC failure taxonomy (``code`` leads every message;
    each subclass's code is the JAX package's)."""

    code = "FT_RPC_ERROR"

    def __str__(self) -> str:  # the code leads, grep-stable
        base = super().__str__()
        return f"{self.code}: {base}" if base else self.code


class RpcTimeout(RpcError):
    """No response inside the deadline (attempt or propagated)."""

    code = "FT_RPC_TIMEOUT"


class RpcConnRefused(RpcError):
    """Connect refused / reset / EOF — the peer process is gone."""

    code = "FT_RPC_CONN_REFUSED"


class RpcTornFrame(RpcError):
    """Framing violation: short read, CRC mismatch, oversized header.
    The owning connection cannot be trusted past this point."""

    code = "FT_RPC_TORN_FRAME"


class RpcShed(RpcError):
    """Refused under admission pressure — loud, immediate, retryable
    elsewhere (or surfaced to the caller as the availability trade)."""

    code = "FT_RPC_SHED"


# --------------------------------------------------------------------------
# framing
# --------------------------------------------------------------------------


def encode_frame(payload: dict) -> bytes:
    """``payload`` -> one wire frame (length prefix + body + trailer)."""
    body = (json.dumps(payload, sort_keys=True) + "\n").encode("utf-8")
    trailer = (
        json.dumps(control_trailer(body), sort_keys=True) + "\n"
    ).encode("utf-8")
    raw = body + trailer
    if len(raw) > MAX_FRAME_BYTES:
        raise RpcTornFrame(
            f"refusing to encode {len(raw)}-byte frame "
            f"(max {MAX_FRAME_BYTES})"
        )
    return _LEN.pack(len(raw)) + raw


def decode_frame_payload(raw: bytes) -> dict:
    """Verify and parse one frame's payload bytes (body + trailer).

    The SAME acceptance rule as ``runtime.ctrlfile``: the trailer is the
    last newline-terminated line and must agree byte-for-byte with the
    body it certifies; anything else is :class:`RpcTornFrame` — there is
    no legacy trailer-less fallback to hide a clean truncation in."""
    if not raw.endswith(b"\n"):
        raise RpcTornFrame("frame missing terminal newline (truncated)")
    stripped = raw.rstrip(b"\n")
    nl = stripped.rfind(b"\n")
    if nl < 0:
        raise RpcTornFrame("frame has no trailer line")
    body, trailer_line = raw[: nl + 1], stripped[nl + 1 :]
    try:
        trailer = json.loads(trailer_line)
    except ValueError as e:
        raise RpcTornFrame(f"unparseable trailer: {e}") from e
    if not isinstance(trailer, dict):
        raise RpcTornFrame("trailer is not an object")
    expect = control_trailer(body)
    if (
        trailer.get("len") != expect["len"]
        or trailer.get("crc32") != expect["crc32"]
    ):
        raise RpcTornFrame(
            f"trailer mismatch: wire {trailer.get('len')}/"
            f"{trailer.get('crc32')} vs computed {expect['len']}/"
            f"{expect['crc32']}"
        )
    try:
        payload = json.loads(body)
    except ValueError as e:
        raise RpcTornFrame(f"unparseable body under valid CRC: {e}") from e
    if not isinstance(payload, dict):
        raise RpcTornFrame("frame body is not an object")
    return payload


def send_frame(sock: socket.socket, payload: dict) -> None:
    """Encode and send one frame; connection-level failures map to
    :class:`RpcConnRefused`."""
    try:
        sock.sendall(encode_frame(payload))
    except socket.timeout as e:
        raise RpcTimeout(f"send stalled: {e}") from e
    except OSError as e:
        raise RpcConnRefused(f"send failed: {e}") from e


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(min(n - got, 1 << 16))
        except socket.timeout as e:
            raise RpcTimeout(f"recv stalled at {got}/{n} bytes: {e}") from e
        except OSError as e:
            raise RpcConnRefused(f"recv failed: {e}") from e
        if not chunk:
            if got == 0:
                raise RpcConnRefused("peer closed (EOF at frame boundary)")
            raise RpcTornFrame(f"peer closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(
    sock: socket.socket, *, max_frame: int = MAX_FRAME_BYTES
) -> dict:
    """Read one frame; raises the typed taxonomy, never returns garbage.

    ``RpcConnRefused`` at a frame BOUNDARY is a clean close; everything
    mid-frame is torn.  An oversized length header is refused before a
    single payload byte is read."""
    header = _recv_exact(sock, _LEN.size)
    (length,) = _LEN.unpack(header)
    if length == 0 or length > max_frame:
        raise RpcTornFrame(
            f"refusing frame header claiming {length} bytes "
            f"(max {max_frame})"
        )
    return decode_frame_payload(_recv_exact(sock, length))


def chunk_blob(blob: bytes, *, chunk_bytes: int = MAX_KV_CHUNK_BYTES) -> list:
    """Split a binary payload into base64 strings, each from at most
    ``chunk_bytes`` raw bytes, for streaming over JSON frames.  Always at
    least one chunk (an empty payload is one empty chunk) so a transfer
    has a well-defined ``total`` and a final frame to hang the metadata
    on."""
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    if not blob:
        return [""]
    return [
        base64.b64encode(blob[i : i + chunk_bytes]).decode("ascii")
        for i in range(0, len(blob), chunk_bytes)
    ]


def join_chunks(chunks) -> bytes:
    """Reassemble :func:`chunk_blob` output; undecodable base64 is a
    framing-class violation (:class:`RpcTornFrame`) — the CRC check in
    ``migration.unpack_kv`` guards the CONTENT, this guards the
    transport encoding."""
    try:
        return b"".join(
            base64.b64decode(c.encode("ascii"), validate=True)
            for c in chunks
        )
    except (binascii.Error, UnicodeEncodeError, AttributeError) as e:
        raise RpcTornFrame(f"undecodable KV chunk: {e}") from e


# --------------------------------------------------------------------------
# the multiplexed connection
# --------------------------------------------------------------------------


class RpcConnection:
    """One socket, many in-flight calls, responses in any order.

    ``call()`` assigns a correlation id, sends under the write lock, and
    blocks on its own waiter slot; the reader thread routes each inbound
    frame to the waiter owning its ``corr``.  When the stream dies (EOF,
    reset, torn frame) EVERY outstanding waiter fails with the same
    typed error — the front door's retry loop treats the batch of
    failures like the connection reset it is.
    """

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._wlock = threading.Lock()
        self._lock = threading.Lock()
        # corr -> {event, reply|error}
        self._waiters: dict[int, dict] = {}  # guarded-by: _lock
        self._next_corr = 0  # guarded-by: _lock
        self._dead: RpcError | None = None  # guarded-by: _lock
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True, name="ft-rpc-reader"
        )
        self._reader.start()

    @classmethod
    def connect(
        cls, host: str, port: int, *, timeout_s: float = 1.0
    ) -> "RpcConnection":
        try:
            sock = socket.create_connection((host, port), timeout=timeout_s)
        except socket.timeout as e:
            raise RpcTimeout(f"connect to {host}:{port}: {e}") from e
        except OSError as e:
            raise RpcConnRefused(f"connect to {host}:{port}: {e}") from e
        sock.settimeout(None)  # per-call deadlines live on the waiters
        return cls(sock)

    @property
    def dead(self) -> RpcError | None:
        return self._dead

    def _read_loop(self) -> None:
        while True:
            try:
                payload = recv_frame(self._sock)
            except RpcError as e:
                self._fail_all(e)
                # a dead stream is never read again: its socket closes
                # here, not when the collector finds the connection
                self.close()
                return
            corr = payload.get("corr")
            with self._lock:
                waiter = self._waiters.pop(corr, None)
            if waiter is not None:
                waiter["reply"] = payload
                waiter["event"].set()
            # an unmatched corr (waiter timed out and left) is dropped:
            # the replica-side idempotency store makes the orphaned
            # result safe to lose

    def _fail_all(self, err: RpcError) -> None:
        with self._lock:
            if self._dead is None:
                self._dead = err
            waiters, self._waiters = self._waiters, {}
        for waiter in waiters.values():
            waiter["error"] = err
            waiter["event"].set()

    def call(self, payload: dict, *, timeout_s: float) -> dict:
        """Send ``payload`` (a ``corr`` id is stamped in) and wait for
        the matching response; :class:`RpcTimeout` when the deadline
        lapses, the connection's fatal error when it died instead."""
        if self._dead is not None:
            raise self._dead
        event = threading.Event()
        waiter: dict = {"event": event, "reply": None, "error": None}
        with self._lock:
            corr = self._next_corr
            self._next_corr += 1
            self._waiters[corr] = waiter
        framed = dict(payload, corr=corr)
        try:
            # the blocking send under _wlock is the design: the write
            # lock IS the frame serializer (partial frames from two
            # callers must never interleave), it is held for exactly one
            # sendall, and no other lock ever nests inside it
            with self._wlock:
                send_frame(self._sock, framed)  # concurrency: ok — see above
        except RpcError as e:
            with self._lock:
                self._waiters.pop(corr, None)
            self._fail_all(e)
            raise
        if not event.wait(timeout_s):
            with self._lock:
                self._waiters.pop(corr, None)
            raise RpcTimeout(
                f"no response for corr={corr} within {timeout_s:.3f}s"
            )
        if waiter["error"] is not None:
            raise waiter["error"]
        return waiter["reply"]

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
