"""Torn-proof control files: length+CRC32-trailered JSON on a shared dir.

The port's copy of ``flextree_tpu/runtime/ctrlfile.py``, byte for byte the
same file format: a file written by either package reads in the other.

Every cross-process truth of the runtime — the supervisor's heartbeat
beats, the serving replicas' endpoint files, the prefix handoff document
— is a small JSON file in a shared directory, written with the atomic
tmp + ``os.replace`` discipline.  The replace makes a *well-behaved*
writer invisible mid-write; it does not protect against a truncated
flush on a dying filesystem, a half-copied directory, or a scribbler —
and a truncation that still parses as valid JSON (a cut that lands
exactly on a line boundary) would be silently *accepted*.

The fix is an end-of-file integrity trailer:

- :func:`write_control_json` writes the payload as ONE compact JSON line
  followed by a trailer line ``{"len": N, "crc32": "xxxxxxxx"}`` naming
  the byte length and CRC32 of the payload line (newline included) —
  then atomically replaces the target.  ``head -1 file`` is still the
  human-readable payload.
- :func:`read_control_json` refuses any file whose trailer is missing,
  malformed, or disagrees with the payload bytes — truncation at EVERY
  byte offset is detected, pinned by the truncate-at-every-offset test —
  and **rereads** before giving up: with atomic writers a mismatch is
  transient (a non-atomic scribbler mid-line), so the reader retries a
  bounded number of times and only then reports the file torn (a
  ``torn_control_file`` flight event + ``None``, never an exception on
  the polling thread).

Writers and readers must pair: a trailer-less file (hand-written, or
from a pre-trailer checkout) is REFUSED, because accepting it would
re-open the exact hole the trailer closes — a truncation that cuts the
trailer off cleanly would read as a valid legacy file.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import zlib

__all__ = [
    "write_control_json",
    "read_control_json",
    "control_trailer",
]


def control_trailer(body: bytes) -> dict:
    """The integrity trailer for a payload line (newline included)."""
    return {"len": len(body), "crc32": f"{zlib.crc32(body) & 0xFFFFFFFF:08x}"}


def write_control_json(dir: str, path: str, payload: dict) -> None:
    """Atomically write ``payload`` to ``path`` with an integrity trailer.

    The tmp file lives in ``dir`` (same filesystem as ``path``, so the
    ``os.replace`` stays atomic); a failed write never leaves the tmp
    behind."""
    body = (json.dumps(payload, sort_keys=True) + "\n").encode("utf-8")
    trailer = (json.dumps(control_trailer(body), sort_keys=True) + "\n").encode(
        "utf-8"
    )
    fd, tmp = tempfile.mkstemp(dir=dir, suffix=".ctrl.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(body + trailer)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _parse(raw: bytes) -> dict | None:
    """Payload dict iff ``raw`` is a trailered control file whose trailer
    verifies; None otherwise (missing/malformed/mismatched trailer, or a
    payload that is not a JSON object)."""
    # the trailer is the LAST newline-terminated line; everything before
    # it is the payload bytes the trailer certifies.  The terminator is
    # part of the format: a file missing its final newline lost at least
    # one byte, so truncation at EVERY offset — including the last — is
    # refused.
    if not raw.endswith(b"\n"):
        return None
    stripped = raw.rstrip(b"\n")
    nl = stripped.rfind(b"\n")
    if nl < 0:
        return None  # one line: no trailer at all
    body, trailer_line = raw[: nl + 1], stripped[nl + 1 :]
    try:
        trailer = json.loads(trailer_line)
    except ValueError:
        return None
    if not isinstance(trailer, dict):
        return None
    expect = control_trailer(body)
    if (
        trailer.get("len") != expect["len"]
        or trailer.get("crc32") != expect["crc32"]
    ):
        return None
    try:
        payload = json.loads(body)
    except ValueError:
        return None  # CRC of garbage that collided is not worth modeling
    return payload if isinstance(payload, dict) else None


#: paths whose torn state was already reported (edge detection: a
#: persistently unparseable file — a stuck legacy artifact in a reused
#: dir — must not spam one flight event per poll; cleared the moment the
#: path reads clean again)
_torn_reported: set = set()


def read_control_json(
    path: str,
    *,
    rereads: int = 2,
    reread_delay_s: float = 0.005,
    _sleep=time.sleep,
) -> dict | None:
    """Read a trailered control file; ``None`` when absent or torn.

    A trailer mismatch triggers up to ``rereads`` re-reads (with atomic
    writers a mismatch is a transient race with a non-atomic scribbler;
    re-reads stop early when the bytes are not changing — a static bad
    file cannot heal by waiting); a mismatch that SURVIVES the rereads is
    recorded as a ``torn_control_file`` flight event ONCE per torn
    episode — parse-refuse, never a ``JSONDecodeError`` on the polling
    thread — and reads as absent, so the caller's next poll sees the
    eventual replace."""
    saw_bytes = False
    prev_raw = None
    for attempt in range(max(0, rereads) + 1):
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return None  # absent: the common pre-first-publish case
        saw_bytes = saw_bytes or bool(raw)
        payload = _parse(raw)
        if payload is not None:
            _torn_reported.discard(path)
            return payload
        if raw == prev_raw:
            break  # static content: nobody is mid-write, stop waiting
        prev_raw = raw
        if attempt < rereads:
            _sleep(reread_delay_s)
    if saw_bytes and path not in _torn_reported:
        _torn_reported.add(path)
        from ..obs import record_event

        record_event(
            "torn_control_file",
            path=os.path.basename(path),
            bytes=len(raw),
            rereads=rereads,
        )
    return None
