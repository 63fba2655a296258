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

Both ways stream a leaf at a time: the writer feeds each entry to one
zlib stream as it comes (the bytes are those of compressing the whole
payload at once), and the reader inflates the file piece by piece and
keeps each tensor as it is read, so neither holds more than the largest
leaf beside what it keeps.

A tree sharded across ranks (``shardings``: a ``Placement`` per leaf,
``runtime.steps.train_state_shardings``) is saved whole: leaf by leaf,
every rank sends its block to the mesh's first rank (``dist.gather``),
which puts the leaf together on the host and writes the file in the
same format (so the file does not say on how many ranks it was
written); the others wait for it at a barrier. ``restore(..., mesh=,
shardings=)`` has every rank read the file and keep only its own blocks,
on whatever mesh the run restarts on.

The format holds a leaf of less than 4 GiB (a MessagePack bin's
length is 32 bits, in the reference's files too): llama3-8b's stacked
feed-forward leaves in float32 (7.5 GB each) do not fit, and saving them
raises ``ValueError``.
"""
from __future__ import annotations

import math
import os
import re
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import msgpack
from repro_torch.device import resolve
from repro_torch.distribution import sharding as shd

_MAGIC = b"RSK1"
_CODEC_ZSTD = b"z"
_CODEC_ZLIB = b"d"
_ZSTD_FRAME_MAGIC = b"\x28\xb5\x2f\xfd"   # legacy untagged zstd files
# the reserved payload key of the plain-Python metadata
_META_KEY = "__meta__"


_CHUNK = 1 << 24     # bytes read from a file, or inflated, at a time
_MAX_LEAF = 1 << 32  # a MessagePack bin's length is 32 bits


class _Inflate:
    """The inflated payload of an open checkpoint file, read in order:
    ``take(n)`` gives its next ``n`` bytes."""

    def __init__(self, f):
        head = f.read(5)
        if head[:4] == _MAGIC:
            codec = head[4:5]
            if codec == _CODEC_ZSTD:
                raise ImportError(
                    "checkpoint was written with the zstd codec (b'z'); "
                    "reading it needs the 'zstandard' package, which the "
                    "port does not use: save it again with the zlib codec "
                    "(b'd')")
            if codec != _CODEC_ZLIB:
                raise ValueError(f"unknown checkpoint codec tag {codec!r}")
            head = b""
        elif head[:4] == _ZSTD_FRAME_MAGIC:
            raise ImportError("legacy zstd checkpoint: reading it needs the "
                              "'zstandard' package, which the port does not "
                              "use")
        # else an untagged zlib stream, which ``head`` begins
        self.f, self.tail = f, head
        self.z, self.buf = zlib.decompressobj(), bytearray()

    def take(self, n: int) -> bytearray:
        while len(self.buf) < n:
            src = self.tail or self.f.read(_CHUNK)
            if src:
                self.buf += self.z.decompress(src, max(n - len(self.buf),
                                                       _CHUNK))
                self.tail = self.z.unconsumed_tail
            else:
                more = self.z.flush()
                if not more:
                    raise ValueError("checkpoint data ends early")
                self.buf += more
        if len(self.buf) == n:
            out, self.buf = self.buf, bytearray()
        else:
            out = self.buf[:n]
            del self.buf[:n]
        return out


def _write(final: str, entries, n: int, meta) -> None:
    """The file of ``n`` entries (``(key, array)`` pairs, drawn one at a
    time) and ``meta`` last, written atomically (a temporary file, fsync,
    rename): ``RSK1``, ``d`` and the zlib stream of the payload's
    MessagePack."""
    pk = msgpack.packb
    comp = zlib.compressobj(6)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC + _CODEC_ZLIB)
        f.write(comp.compress(msgpack.map_header(n + (meta is not None))))
        for k, h in entries:
            arr = np.ascontiguousarray(h).reshape(h.shape)   # 0-d stays 0-d
            f.write(comp.compress(
                pk(k) + msgpack.map_header(3) + pk("dtype")
                + pk(str(arr.dtype)) + pk("shape") + pk(list(arr.shape))
                + pk("data") + msgpack.bin_header(arr.nbytes)))
            f.write(comp.compress(arr.reshape(-1).view(np.uint8)))
        if meta is not None:
            f.write(comp.compress(pk(_META_KEY) + pk(meta)))
        f.write(comp.flush())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


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


def _gathered(x: torch.Tensor, pl) -> Optional[np.ndarray]:
    """The whole leaf of every rank's block ``x`` (placed by ``pl``), on
    the host of the mesh's first rank, None elsewhere: every rank of the
    mesh sends its block there (``dist.gather``), which puts each in its
    place."""
    mesh, dims = pl.mesh, pl.spec.dims()
    lead = int(mesh.devices.flat[0])
    group = mesh.group(mesh.axis_names)
    if not dims or group is None:
        return _host(x) if mesh.rank == lead else None
    x = x.contiguous()
    blocks = ([torch.empty_like(x) for _ in range(mesh.size)]
              if mesh.rank == lead else None)
    dist.gather(x, blocks, dst=lead, group=group)
    if blocks is None:
        return None
    shape = list(x.shape)
    for d, axes in dims:
        shape[d] *= mesh.axis_size(axes)
    full = None
    for r, b in zip(mesh.devices.flat, blocks):
        at, h = mesh.coords(int(r)), _host(b)
        if full is None:
            full = np.empty(shape, h.dtype)
        where = [slice(None)] * len(shape)
        for d, axes in dims:       # the block's place, row-major
            i = int(np.ravel_multi_index([at[a] for a in axes],
                                         [mesh.shape[a] for a in axes]))
            where[d] = slice(i * x.shape[d], (i + 1) * x.shape[d])
        full[tuple(where)] = h
    return full


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes


def save(path: str, tree, step: Optional[int] = None, keep: int = 3,
         meta: Optional[Dict[str, Any]] = None, shardings=None) -> str:
    """Atomic save of a tree of tensors or arrays; with ``step`` the file
    is ``<path>/ckpt_<step>.rsk`` and only the newest ``keep`` stay.
    ``meta`` holds plain Python values (``restore(...,
    return_meta=True)`` reads it back). Returns the file's path.

    With ``shardings`` (a ``Placement`` per leaf of ``tree``, whose
    leaves are this rank's blocks, all on one mesh) every rank must call
    it: each leaf is gathered to the mesh's first rank, which writes, and
    every rank returns after the write."""
    if step is not None:
        final = os.path.join(path, f"ckpt_{step:08d}.rsk")
    else:
        final = path
    flat = _flatten(tree)
    assert _META_KEY not in flat, f"{_META_KEY!r} is a reserved tree key"
    if shardings is None:
        writes = True
        sizes = {k: _nbytes(v) for k, v in flat.items()}
        entries = ((k, _host(v)) for k, v in flat.items())
    else:
        places = list(_flatten(shardings).values())
        sizes = {k: _nbytes(x) * math.prod(pl.mesh.axis_size(axes)
                                           for _, axes in pl.spec.dims())
                 for (k, x), pl in zip(flat.items(), places)}
        mesh = places[0].mesh
        writes = mesh.rank == int(mesh.devices.flat[0])
        entries = ((k, _gathered(x, pl))
                   for (k, x), pl in zip(flat.items(), places))
    big = {k: n for k, n in sizes.items() if n >= _MAX_LEAF}
    if big:             # on every rank, before any leaf is gathered
        raise ValueError(f"leaves of 4 GiB or more do not fit the "
                         f"checkpoint format (a MessagePack bin): {big}")
    if writes:
        os.makedirs(path if step is not None
                    else os.path.dirname(final) or ".", exist_ok=True)
        _write(final, entries, len(flat), meta)
        if step is not None and keep:
            ckpts = sorted(f for f in os.listdir(path)
                           if re.fullmatch(r"ckpt_\d+\.rsk", f))
            for old in ckpts[:-keep]:
                os.remove(os.path.join(path, old))
    else:
        for _ in entries:       # this rank's part in each leaf's gather
            pass
    if shardings is not None:
        dist.barrier()
    return final


def latest_step(path: str) -> Optional[int]:
    """The newest step saved under directory ``path``, or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := re.fullmatch(r"ckpt_(\d+)\.rsk", f))]
    return max(steps) if steps else None


def restore(path: str, step: Optional[int] = None, *, device=None,
            mesh=None, shardings=None, return_meta: bool = False):
    """Load a checkpoint as a tree of tensors on ``device`` (``None``
    means CUDA); with ``return_meta=True`` returns ``(tree, meta)``, meta
    None for a file saved without it. With a ``mesh`` (a ``TrainMesh``;
    the tensors go to its device) and ``shardings`` (a ``Placement`` on it
    per leaf) each leaf is cut to this rank's block as it is read: the
    reshard onto whatever mesh exists now."""
    if mesh is not None and shardings is None:
        raise ValueError("restoring onto a mesh needs its shardings")
    dev = None if mesh is not None else resolve(device)
    places = None if mesh is None else _flatten(shardings)
    if step is not None:
        path = os.path.join(path, f"ckpt_{step:08d}.rsk")
    flat, meta = {}, None
    with open(path, "rb") as f:
        r = msgpack.StreamReader(_Inflate(f).take)
        for _ in range(r.map_len()):
            k, v = r.obj(), r.obj()
            if k == _META_KEY:
                meta = v
                continue
            x = torch.from_numpy(np.frombuffer(
                v["data"], dtype=np.dtype(v["dtype"])).reshape(v["shape"]))
            if places is None:
                flat[k] = x.to(dev)
            else:
                pl = places[k]
                flat[k] = shd.shard_tensor(x, pl.spec, pl.mesh)
            del v, x
    tree = _unflatten(flat)
    return (tree, meta) if return_meta else tree
