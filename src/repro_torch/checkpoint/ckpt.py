"""Checkpoints in the reference's format (``repro/checkpoint/ckpt.py``),
written and read without the ``msgpack`` and ``zstandard`` packages.

A file is ``RSK1``, a codec byte, then the compressed MessagePack of a
flat map: one entry per tensor, keyed by its path in the saved tree
(dict keys sorted at every level, list items as ``#i``), each
``{"dtype", "shape", "data"}`` with the raw little-endian bytes, and
the plain-Python ``meta`` last under ``__meta__``. The port writes the
zlib codec ``d`` at level 6, so its files are the reference's byte for
byte when the tensors are equal. It reads ``d`` (and, as the reference
does, an untagged zlib stream); a ``z`` (zstd) file or a legacy zstd
frame raises, naming the codec and the ``zstandard`` package the port
does not use.

Saves are atomic (a temporary file, fsync, rename); ``step=`` saves
into ``<path>/ckpt_<step>.rsk`` and keeps the newest ``keep``.
``restore`` puts the tensors on ``device`` (``None`` means CUDA).
"""
from __future__ import annotations

import os
import re
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import msgpack
from repro_torch.device import resolve

_MAGIC = b"RSK1"
_CODEC_ZSTD = b"z"
_CODEC_ZLIB = b"d"
_ZSTD_FRAME_MAGIC = b"\x28\xb5\x2f\xfd"   # legacy untagged zstd files
# the reserved payload key of the plain-Python metadata
_META_KEY = "__meta__"


def _compress(raw: bytes) -> bytes:
    return _MAGIC + _CODEC_ZLIB + zlib.compress(raw, level=6)


def _decompress(buf: bytes) -> bytes:
    if buf[:4] == _MAGIC:
        codec, body = buf[4:5], buf[5:]
        if codec == _CODEC_ZLIB:
            return zlib.decompress(body)
        if codec == _CODEC_ZSTD:
            raise ImportError(
                "checkpoint was written with the zstd codec (b'z'); reading "
                "it needs the 'zstandard' package, which the port does not "
                "use: save it again with the zlib codec (b'd')")
        raise ValueError(f"unknown checkpoint codec tag {codec!r}")
    if buf[:4] == _ZSTD_FRAME_MAGIC:
        raise ImportError("legacy zstd checkpoint: reading it needs the "
                          "'zstandard' package, which the port does not use")
    return zlib.decompress(buf)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = val

    def fix(node):
        if isinstance(node, dict) and node and all(
                k.startswith("#") for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save(path: str, tree, step: Optional[int] = None, keep: int = 3,
         meta: Optional[Dict[str, Any]] = None) -> str:
    """Atomic save of a tree of tensors or arrays; with ``step`` the file
    is ``<path>/ckpt_<step>.rsk`` and only the newest ``keep`` stay.
    ``meta`` holds plain Python values (``restore(...,
    return_meta=True)`` reads it back). Returns the file's path."""
    if step is not None:
        os.makedirs(path, exist_ok=True)
        final = os.path.join(path, f"ckpt_{step:08d}.rsk")
    else:
        final = path
        os.makedirs(os.path.dirname(final) or ".", exist_ok=True)
    flat = _flatten(tree)
    assert _META_KEY not in flat, f"{_META_KEY!r} is a reserved tree key"
    payload = {}
    for k, v in flat.items():
        arr = np.ascontiguousarray(_host(v))
        payload[k] = {"dtype": str(arr.dtype), "shape": list(arr.shape),
                      "data": arr.tobytes()}
    if meta is not None:
        payload[_META_KEY] = meta
    comp = _compress(msgpack.packb(payload))
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        f.write(comp)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    if step is not None and keep:
        ckpts = sorted(f for f in os.listdir(path)
                       if re.fullmatch(r"ckpt_\d+\.rsk", f))
        for old in ckpts[:-keep]:
            os.remove(os.path.join(path, old))
    return final


def latest_step(path: str) -> Optional[int]:
    """The newest step saved under directory ``path``, or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := re.fullmatch(r"ckpt_(\d+)\.rsk", f))]
    return max(steps) if steps else None


def restore(path: str, step: Optional[int] = None, *, device=None,
            return_meta: bool = False):
    """Load a checkpoint as a tree of tensors on ``device`` (``None``
    means CUDA); with ``return_meta=True`` returns ``(tree, meta)``, meta
    None for a file saved without it."""
    dev = resolve(device)
    if step is not None:
        path = os.path.join(path, f"ckpt_{step:08d}.rsk")
    with open(path, "rb") as f:
        payload = msgpack.unpackb(_decompress(f.read()))
    meta = payload.pop(_META_KEY, None)
    flat = {}
    for k, v in payload.items():
        arr = np.frombuffer(v["data"], dtype=np.dtype(v["dtype"]))
        flat[k] = torch.from_numpy(arr.reshape(v["shape"]).copy()).to(dev)
    tree = _unflatten(flat)
    return (tree, meta) if return_meta else tree
