"""Checkpoint/resume in the JAX package's file format.

The port's own copy of ``flextree_tpu/utils/checkpoint.py``, for trees of
tensors (dicts, lists and tuples of ``torch.Tensor`` or arrays):

- **Format**: one ``.npz`` per checkpoint, every leaf a named array plus
  a JSON structure descriptor that records each leaf's dtype and CRC32 —
  byte for byte the JAX package's, so a checkpoint written by either
  package restores in the other.  bfloat16 leaves are stored as raw
  2-byte values under the dtype name ``"bfloat16"``, as NumPy stores the
  JAX package's.
- **Durable-atomic writes**: a temporary file fsynced, ``os.replace``,
  then the directory fsynced.
- **Rotation**: ``save_train_state`` names files ``ckpt_{step:08d}.npz``
  and prunes beyond ``max_to_keep``.
- **Integrity**: every leaf is re-checksummed on restore; a mismatch or an
  unreadable archive raises :class:`CheckpointCorrupt`, and
  ``restore_train_state`` falls back to the next-newest checkpoint that
  verifies.

Restores return NumPy arrays, or tensors on ``device`` when one is given
(the JAX package's ``mesh=``/``specs=`` placement has no counterpart on
one card).
"""

from __future__ import annotations

import json
import logging
import os
import re
import tempfile
import zlib

import numpy as np
import torch

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "save_train_state",
    "restore_train_state",
    "latest_checkpoint",
    "list_checkpoints",
    "verify_checkpoint",
    "CheckpointCorrupt",
]

log = logging.getLogger("flextree_tpu_torch.ckpt")


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed integrity verification: unreadable/truncated
    archive, missing leaves, or a per-leaf checksum mismatch."""


_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")


def _to_numpy(x):
    """A leaf as a host NumPy array; bfloat16 as raw 2-byte values with
    the dtype name to restore."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view("V2"), "bfloat16"
        a = x.numpy()
        return a, str(a.dtype)
    a = np.asarray(x)
    return a, str(a.dtype)


def _encode(tree, leaves: list):
    """Replace leaves with indices into ``leaves``; keep container shape."""
    if isinstance(tree, dict):
        for key in tree:
            if not isinstance(key, str):
                raise TypeError(
                    f"checkpoint dict keys must be strings (JSON structure "
                    f"descriptor); got {key!r} ({type(key).__name__})"
                )
        return {"t": "dict",
                "items": {k: _encode(v, leaves) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {"t": kind, "items": [_encode(v, leaves) for v in tree]}
    if tree is None:
        return {"t": "none"}
    a, dtype = _to_numpy(tree)
    leaves.append(a)
    return {"t": "leaf", "i": len(leaves) - 1, "dtype": dtype,
            "crc": _leaf_crc(a)}


def _decode(node, leaves, device):
    t = node["t"]
    if t == "dict":
        return {k: _decode(v, leaves, device) for k, v in node["items"].items()}
    if t == "list":
        return [_decode(v, leaves, device) for v in node["items"]]
    if t == "tuple":
        return tuple(_decode(v, leaves, device) for v in node["items"])
    if t == "none":
        return None
    return _restore_leaf(leaves[node["i"]], node.get("dtype"), device)


def _leaf_crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def _verify_leaves(node, leaves, path: str):
    """Walk the structure descriptor, re-checksumming every leaf."""
    t = node["t"]
    if t == "dict":
        for v in node["items"].values():
            _verify_leaves(v, leaves, path)
    elif t in ("list", "tuple"):
        for v in node["items"]:
            _verify_leaves(v, leaves, path)
    elif t == "leaf" and "crc" in node:  # pre-integrity checkpoints lack crc
        if node["i"] >= len(leaves):
            raise CheckpointCorrupt(
                f"{path}: leaf_{node['i']} missing (truncated archive)"
            )
        if _leaf_crc(leaves[node["i"]]) != node["crc"]:
            raise CheckpointCorrupt(
                f"{path}: leaf_{node['i']} checksum mismatch (corrupt data)"
            )


def _restore_leaf(a: np.ndarray, dtype_str: str | None, device):
    """A stored array back in its recorded dtype: NumPy without a device,
    else a tensor on ``device``."""
    if dtype_str == "bfloat16":
        if device is not None:
            raw = np.ascontiguousarray(a).view(np.int16)
            return torch.from_numpy(raw.copy()).view(torch.bfloat16).to(device)
        import ml_dtypes  # noqa: F401  registers bfloat16 with NumPy

    if dtype_str is not None and str(a.dtype) != dtype_str:
        target = np.dtype(dtype_str)
        if a.dtype.kind == "V" and a.dtype.itemsize == target.itemsize:
            a = a.view(target)
        else:
            a = a.astype(target)
    if device is None:
        return a
    return torch.from_numpy(np.array(a)).to(device)


def _fsync_dir(dirpath: str) -> None:
    """fsync a directory so a just-committed rename survives host crash."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:  # platforms without O_RDONLY directories
        return
    try:
        os.fsync(fd)
    except OSError:  # filesystems without directory fsync: already committed
        pass
    finally:
        os.close(fd)


def save_checkpoint(path: str | os.PathLike, tree) -> str:
    """Write ``tree`` (dict/list/tuple tree of tensors or arrays) to
    ``path``, durable-atomically: temporary file fsynced, ``os.replace``,
    then the directory fsynced."""
    path = os.fspath(path)
    leaves: list[np.ndarray] = []
    structure = _encode(tree, leaves)
    arrays = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    arrays["__structure__"] = np.frombuffer(
        json.dumps(structure).encode(), dtype=np.uint8
    )
    dirpath = os.path.dirname(path) or "."
    os.makedirs(dirpath, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirpath, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(dirpath)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def restore_checkpoint(path: str | os.PathLike, device=None, *,
                       verify: bool = True):
    """Load a checkpoint: NumPy arrays, or tensors on ``device``.

    ``verify`` (default on) re-checksums every leaf against the CRC32s the
    save recorded; an unreadable archive or a mismatch raises
    :class:`CheckpointCorrupt`."""
    path = os.fspath(path)
    try:
        with open(path, "rb") as fh, np.load(fh) as data:
            structure = json.loads(bytes(data["__structure__"]).decode())
            leaves = [data[f"leaf_{i}"] for i in range(len(data.files) - 1)]
    except FileNotFoundError:
        raise
    except Exception as e:  # truncated zip, missing keys, bad JSON, ...
        raise CheckpointCorrupt(f"unreadable checkpoint {path}: {e}") from e
    if verify:
        _verify_leaves(structure, leaves, path)
    return _decode(structure, leaves, device)


def list_checkpoints(ckpt_dir: str | os.PathLike) -> list[tuple[int, str]]:
    """Sorted [(step, path)] of checkpoints in ``ckpt_dir``."""
    ckpt_dir = os.fspath(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return []
    found = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return sorted(found)


def latest_checkpoint(ckpt_dir: str | os.PathLike) -> str | None:
    ckpts = list_checkpoints(ckpt_dir)
    return ckpts[-1][1] if ckpts else None


def save_train_state(ckpt_dir: str | os.PathLike, state: dict, *,
                     max_to_keep: int = 3) -> str:
    """Save a train state keyed by its ``state['step']``; prune old ones.
    The just-written file is never pruned, and stale higher-step files (a
    fresh run reusing an old directory) go first, so a later resume finds
    this state.  A data-parallel mesh's state holds one error-feedback
    tree a rank (``state["ef"]`` a list); the file holds the first rank's,
    what the JAX package's ``device_get`` of its replicated ``ef`` reads,
    so a resumed run gives that tree to every rank, as the JAX one does.
    On a mesh whose ranks hold slices the list is assembled first, slice
    by slice from the first rank that holds it
    (:func:`..parallel.zero.checkpoint_ef`, the trainer's ``state_pack``)."""
    if isinstance(state.get("ef"), list):
        state = dict(state, ef=state["ef"][0])
    step = int(state["step"])
    path = os.path.join(os.fspath(ckpt_dir), f"ckpt_{step:08d}.npz")
    save_checkpoint(path, state)
    if max_to_keep is not None and max_to_keep > 0:
        others = [(s, p) for s, p in list_checkpoints(ckpt_dir) if p != path]
        stale = [(s, p) for s, p in others if s > step]
        fresh = [(s, p) for s, p in others if s <= step]
        keep_others = max_to_keep - 1
        for _, old in stale + fresh[: max(0, len(fresh) - keep_others)]:
            os.unlink(old)
    return path


def verify_checkpoint(path: str | os.PathLike) -> bool:
    """Whether ``path`` loads and passes leaf-checksum verification."""
    try:
        restore_checkpoint(path)
        return True
    except (CheckpointCorrupt, FileNotFoundError):
        return False


def restore_train_state(ckpt_dir_or_path: str | os.PathLike, device=None, *,
                        on_fallback=None):
    """Restore the newest train state from a directory (or an exact path).

    When the newest checkpoint in a directory is truncated or corrupt it
    falls back to the next-newest that verifies, calling
    ``on_fallback(bad_path, exc)`` for each rejected file; only when every
    checkpoint fails does it raise :class:`CheckpointCorrupt`.  An exact
    file path gets no fallback."""
    path = os.fspath(ckpt_dir_or_path)
    if not os.path.isdir(path):
        return restore_checkpoint(path, device)
    ckpts = list_checkpoints(path)
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints in {path}")
    last_exc = None
    for _, p in reversed(ckpts):
        try:
            return restore_checkpoint(p, device)
        except CheckpointCorrupt as e:
            log.warning("checkpoint %s failed verification (%s); falling "
                        "back", p, e)
            if on_fallback is not None:
                on_fallback(p, e)
            last_exc = e
    raise CheckpointCorrupt(
        f"every checkpoint in {path} failed verification"
    ) from last_exc
