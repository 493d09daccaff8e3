"""KV migration payloads: block-shaped K/V packed for the replica wire.

The port's copy of ``flextree_tpu/serving/migration.py``, byte for byte
the same wire format: on the same float32 input both packages' ``pack_kv``
give the same ``meta`` and the same ``blob``, and each package unpacks
the other's payload.

Prefill/decode disaggregation ships a sequence's KV blocks from the
prefill replica that computed them to the decode replica that will own
the sequence.  This module is the wire format — the pure function pair
``pack_kv`` / ``unpack_kv`` between the engine's block-granular export
(``kv_cache.export_blocks``, per layer ``(n, bs, H, Dh)``, moved to the
host as float32 numpy once per export) and bytes:

- **a codec per hop, from ``ops/quantize.py``**: ``f32`` ships the
  float32 bytes verbatim — a bfloat16 pool's values are exact in
  float32, so an f32 migration lands the pool's bits and the greedy
  decode stays bitwise against the colocated engine.  ``int8`` ships
  block-scaled 8-bit (``encode_int8`` at step 0, salt 0: the JAX
  package's bits) at ~4x less wire, with a per-element error bounded by
  ``Codec.error_bound(amax, 1, widths=(1,))`` = ``amax/127`` for the one
  migration hop (one encode, one decode, no accumulation).
- **refuse, don't guess**: the decode side verifies the whole-payload
  CRC, every per-tensor CRC, the declared geometry and the byte counts
  before a single element lands in its pool.  Any mismatch raises
  :class:`MigrationError` (``FT_MIGRATION_REFUSED``) and the payload is
  dropped.

Tensor order on the wire is fixed (layer-major, K before V); the meta
dict travels in the RPC JSON body, the blob rides base64-chunked frames
(``rpc.chunk_blob``).
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from ..ops.quantize import decode_int8, encode_int8, get_codec

__all__ = [
    "MigrationError",
    "pack_kv",
    "unpack_kv",
    "migration_error_bound",
]


class MigrationError(RuntimeError):
    """A migration payload failed verification (or packing hit an
    unsupported codec) — the decode side refuses the handoff and the
    prefill side falls back to releasing its export.  Its code is the
    JAX package's."""

    code = "FT_MIGRATION_REFUSED"

    def __init__(self, msg: str):
        super().__init__(f"{self.code}: {msg}")


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _tensors(kv: dict):
    """Fixed wire order: layer-major, K before V."""
    for layer, (k, v) in enumerate(zip(kv["k"], kv["v"])):
        yield layer, "k", k
        yield layer, "v", v


def pack_kv(kv: dict, *, codec: str = "f32") -> tuple[dict, bytes]:
    """Pack block-shaped K/V into ``(meta, blob)`` for the wire.

    ``kv`` is ``export_blocks`` output: per-layer ``(n, bs, H, Dh)``.
    ``meta`` declares the geometry, codec, and per-tensor byte spans +
    CRCs; ``blob`` is the concatenated tensor payload in fixed order.
    The f32 codec emits each tensor's float32 bytes verbatim (bitwise);
    int8 emits ``encode_int8``'s (q, scales) pair per tensor, flattened,
    with the tensor's amax recorded so the receiver can state the
    documented error bound without re-deriving it.
    """
    c = get_codec(codec)
    if c.name not in ("f32", "int8"):
        raise MigrationError(
            f"codec {c.name!r} is not a migration codec (f32 | int8)"
        )
    first = np.asarray(kv["k"][0])
    n, bs, heads, dh = first.shape
    tensors, parts = [], []
    for layer, part, arr in _tensors(kv):
        a = np.ascontiguousarray(np.asarray(arr, dtype=np.float32))
        if a.shape != (n, bs, heads, dh):
            raise MigrationError(
                f"layer {layer} {part} shaped {a.shape}, expected "
                f"{(n, bs, heads, dh)}"
            )
        if c.name == "f32":
            payload = a.tobytes()
            entry = {"layer": layer, "part": part, "nbytes": len(payload)}
        else:
            flat = a.reshape(-1)
            q, scales = encode_int8(
                torch.from_numpy(flat if flat.flags.writeable else flat.copy()),
                0, salt=0, block=c.block,
            )
            qb = q.numpy().tobytes()
            sb = scales.numpy().tobytes()
            payload = qb + sb
            entry = {
                "layer": layer,
                "part": part,
                "nbytes": len(payload),
                "nbytes_q": len(qb),
                "length": int(flat.shape[0]),
                "amax": float(np.max(np.abs(flat))) if flat.size else 0.0,
            }
        entry["crc32"] = _crc(payload)
        tensors.append(entry)
        parts.append(payload)
    blob = b"".join(parts)
    meta = {
        "codec": c.name,
        "codec_block": c.block,
        "n_blocks": int(n),
        "block_size": int(bs),
        "n_heads": int(heads),
        "head_dim": int(dh),
        "n_layers": len(kv["k"]),
        "nbytes": len(blob),
        "crc32": _crc(blob),
        "tensors": tensors,
    }
    return meta, blob


def unpack_kv(meta: dict, blob: bytes) -> dict:
    """Verify and decode a migration payload back to block-shaped K/V.

    Refuses loudly (:class:`MigrationError`) on: whole-blob CRC or byte
    count drift, per-tensor CRC drift, tensor count vs declared layers,
    byte spans that do not reconstruct the declared geometry, unknown
    codec.  On success returns ``{"k": [np (n, bs, H, Dh) f32], "v":
    [...]}`` ready for ``kv_cache.write_imported``: writable arrays, each
    its own copy of the payload.
    """
    try:
        codec = get_codec(meta["codec"])
        n = int(meta["n_blocks"])
        bs = int(meta["block_size"])
        heads = int(meta["n_heads"])
        dh = int(meta["head_dim"])
        layers = int(meta["n_layers"])
        tensors = list(meta["tensors"])
    except (KeyError, TypeError, ValueError) as e:
        raise MigrationError(f"malformed migration meta: {e}") from None
    if len(blob) != int(meta.get("nbytes", -1)):
        raise MigrationError(
            f"payload is {len(blob)} bytes, meta declares {meta.get('nbytes')}"
        )
    if _crc(blob) != int(meta.get("crc32", -1)):
        raise MigrationError("payload CRC mismatch — corrupt migration blob")
    if len(tensors) != 2 * layers:
        raise MigrationError(
            f"{len(tensors)} tensors declared for {layers} layers "
            f"(expected {2 * layers})"
        )
    shape = (n, bs, heads, dh)
    count = int(np.prod(shape))
    out = {"k": [None] * layers, "v": [None] * layers}
    off = 0
    for i, entry in enumerate(tensors):
        try:
            layer, part = int(entry["layer"]), str(entry["part"])
            nbytes, crc = int(entry["nbytes"]), int(entry["crc32"])
        except (KeyError, TypeError, ValueError) as e:
            raise MigrationError(f"malformed tensor entry {i}: {e}") from None
        if not (0 <= layer < layers and part in ("k", "v")):
            raise MigrationError(f"tensor entry {i} addresses {part}@{layer}")
        if out[part][layer] is not None:
            raise MigrationError(f"duplicate tensor {part}@{layer}")
        payload = blob[off : off + nbytes]
        if len(payload) != nbytes:
            raise MigrationError(
                f"tensor {part}@{layer} truncated: {len(payload)}/{nbytes} bytes"
            )
        off += nbytes
        if _crc(payload) != crc:
            raise MigrationError(f"tensor {part}@{layer} CRC mismatch")
        if codec.name == "f32":
            if nbytes != count * 4:
                raise MigrationError(
                    f"tensor {part}@{layer} is {nbytes} bytes, shape "
                    f"{shape} needs {count * 4}"
                )
            arr = np.frombuffer(bytearray(payload), np.float32).reshape(shape)
        else:
            try:
                nbytes_q = int(entry["nbytes_q"])
                length = int(entry["length"])
            except (KeyError, TypeError, ValueError) as e:
                raise MigrationError(
                    f"malformed int8 tensor entry {i}: {e}"
                ) from None
            blk = codec.block
            padded = -(-length // blk) * blk
            if length != count or nbytes_q != padded:
                raise MigrationError(
                    f"tensor {part}@{layer} int8 geometry drift: length "
                    f"{length} (want {count}), q bytes {nbytes_q} (want {padded})"
                )
            if nbytes != nbytes_q + (padded // blk) * 4:
                raise MigrationError(
                    f"tensor {part}@{layer} is {nbytes} bytes, int8 + "
                    f"scales need {nbytes_q + (padded // blk) * 4}"
                )
            q = torch.frombuffer(bytearray(payload[:nbytes_q]),
                                 dtype=torch.int8)
            scales = torch.frombuffer(bytearray(payload[nbytes_q:]),
                                      dtype=torch.float32)
            arr = decode_int8(q, scales, length, block=blk).numpy() \
                .reshape(shape)
        out[part][layer] = arr
    if off != len(blob):
        raise MigrationError(
            f"{len(blob) - off} trailing bytes after the declared tensors"
        )
    return out


def migration_error_bound(meta: dict) -> float:
    """The documented per-element absolute error bound of one unpacked
    payload: 0 for f32, ``max(amax)/127`` across tensors for int8 — one
    migration hop is one encode + one decode with no accumulation, i.e.
    ``Codec.error_bound(amax, n=1, widths=(1,))``."""
    codec = get_codec(meta["codec"])
    if not codec.lossy:
        return 0.0
    amax = max(
        (float(t.get("amax", 0.0)) for t in meta.get("tensors", ())),
        default=0.0,
    )
    return codec.error_bound(amax, 1, widths=(1,))
