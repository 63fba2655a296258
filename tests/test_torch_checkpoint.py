"""The port's checkpoint format (``checkpoint.msgpack``,
``checkpoint.ckpt``) and warehouse persistence (``warehouse.tiers.
save_warehouse`` / ``load_warehouse``) against the reference's, on the
CPU. This machine's ``msgpack`` package is the oracle of the bytes; the
port uses no package of its own for them.

- ``msgpack.packb`` equals ``msgpack.packb(obj, use_bin_type=True)`` on
  every width of int (both signs, each boundary), str and bin lengths
  across their 8 / 16 / 32-bit headers, float64, bool, nil, arrays and
  maps, and on the payloads the reference's ``ckpt.save`` builds;
  ``unpackb`` reads them back as ``msgpack.unpackb(raw=False)`` does.
- ``ckpt``: the ``RSK1`` + ``d`` header, atomic saves, ``step=`` with
  retention and ``latest_step``, ``#i`` list keys, meta; a file the
  reference saves with zlib restores in the port, and the port's
  restores in the reference; a ``z`` file and a legacy zstd frame raise
  by name.
- The warehouse (tests/test_warehouse.py:407): a ``TieredStore`` saved
  by the port loads in the reference's ``load_warehouse`` and the
  reference's zlib save loads in the port, each with every column, code
  and scale bit for bit and the same answers; with equal contents (the
  spill given the reference's draws) the two files are byte-identical.
"""
import os
import zlib

import jax.numpy as jnp
import msgpack as MP
import numpy as np
import pytest
import torch

import repro.checkpoint.ckpt as RCK
import repro.warehouse as RW
from _torch_parity import ref_plan
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint import msgpack as PM
from repro_torch.warehouse import (Filter, GroupBy, SegmentStore,
                                   TieredStore, TopK, WindowAgg,
                                   load_warehouse, save_warehouse,
                                   windows_for)
from test_torch_sharded import _eq, _rows, _same_answer
from test_torch_tiers import _ref_draws
from _torch_threads import cap_torch_threads

cap_torch_threads()

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
        2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
        -2 ** 31 - 1, -2 ** 63]
SIZES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


def _objects():
    yield from INTS
    yield from (None, True, False, 0.0, -1.5, 1e300, float("inf"))
    for n in SIZES:
        yield "x" * n
        yield b"\x01" * n
        if n <= 256:
            yield list(range(n))
            yield {f"k{i}": i for i in range(n)}
    yield {"a": [1, {"b": b"", "c": [None, -3.25]}], "é": "ü"}


@pytest.mark.parametrize("obj", list(_objects()), ids=repr)
def test_packb_matches_msgpack(obj):
    raw = MP.packb(obj, use_bin_type=True)
    assert PM.packb(obj) == raw
    assert PM.unpackb(raw) == MP.unpackb(raw, raw=False)


def test_unpackb_reads_float32_and_refuses_the_rest():
    assert PM.unpackb(b"\xca" + np.float32(0.5).byteswap().tobytes()) == 0.5
    with pytest.raises(ValueError, match="0xd5"):
        PM.unpackb(MP.packb(MP.ExtType(1, b"ab")))
    with pytest.raises(ValueError, match="after"):
        PM.unpackb(b"\x01\x02")
    with pytest.raises(ValueError, match="ends early"):
        PM.unpackb(b"\xda\x00\x05ab")


def _tree():
    rng = np.random.default_rng(0)
    return {"w": rng.random((3, 4)).astype(np.float32),
            "layers": [{"b": np.arange(5, dtype=np.int32)},
                       {"b": np.zeros((2, 0), np.int8)}],
            "flag": np.array([True, False])}


def _meta():
    return {"n_rows": 70000, "t_max": -1, "name": "x", "scale": 0.25}


def test_save_restore_roundtrip_and_retention(tmp_path):
    tree = _tree()
    path = ckpt.save(str(tmp_path / "a" / "one.rsk"), tree, meta=_meta())
    with open(path, "rb") as f:
        assert f.read(5) == b"RSK1d"
    back, meta = ckpt.restore(path, device="cpu", return_meta=True)
    assert meta == _meta()
    _eq(back["w"], tree["w"])
    assert isinstance(back["layers"], list) and len(back["layers"]) == 2
    _eq(back["layers"][0]["b"], tree["layers"][0]["b"])
    assert back["layers"][1]["b"].shape == (2, 0)
    assert back["flag"].dtype == torch.bool
    assert ckpt.restore(path, device="cpu").keys() == back.keys()
    d = str(tmp_path / "steps")
    assert ckpt.latest_step(d) is None
    for step in (1, 5, 7, 12):
        ckpt.save(d, {"x": np.full(2, step, np.int32)}, step=step, keep=2)
    assert sorted(os.listdir(d)) == ["ckpt_00000007.rsk", "ckpt_00000012.rsk"]
    assert ckpt.latest_step(d) == 12
    _eq(ckpt.restore(d, 7, device="cpu")["x"], [7, 7])
    with pytest.raises(AssertionError, match="reserved"):
        ckpt.save(str(tmp_path / "bad.rsk"), {"__meta__": np.zeros(1)})


def test_files_cross_load_and_match_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(RCK, "zstd", None)          # the reference in zlib
    tree = _tree()
    mine = ckpt.save(str(tmp_path / "port.rsk"), tree, meta=_meta())
    theirs = RCK.save(str(tmp_path / "ref.rsk"), tree, meta=_meta())
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    rtree, rmeta = RCK.restore(mine, return_meta=True)
    ptree, pmeta = ckpt.restore(theirs, device="cpu", return_meta=True)
    assert rmeta == pmeta == _meta()
    _eq(np.asarray(rtree["w"]), tree["w"])
    _eq(ptree["layers"][0]["b"], tree["layers"][0]["b"])


def test_zstd_files_raise_by_name(tmp_path):
    path = str(tmp_path / "z.rsk")
    with open(path, "wb") as f:
        f.write(b"RSK1z" + b"\x00" * 8)
    with pytest.raises(ImportError, match="zstandard"):
        ckpt.restore(path, device="cpu")
    with open(path, "wb") as f:
        f.write(b"\x28\xb5\x2f\xfd" + b"\x00" * 8)
    with pytest.raises(ImportError, match="zstandard"):
        ckpt.restore(path, device="cpu")
    with open(path, "wb") as f:
        f.write(b"RSK1q" + zlib.compress(b"\x80"))
    with pytest.raises(ValueError, match="codec"):
        ckpt.restore(path, device="cpu")
    # an untagged zlib stream reads, as in the reference
    with open(path, "wb") as f:
        f.write(zlib.compress(PM.packb({"__meta__": {"a": 1}})))
    assert ckpt.restore(path, device="cpu", return_meta=True) == ({}, {"a": 1})


def test_streams_a_leaf_at_a_time(tmp_path, monkeypatch):
    """Save and restore stream: read and inflated a few bytes at a time
    (``_CHUNK`` of 7, so every head and leaf spans pieces), the reference's
    file and the port's restore alike, untagged streams too; the heads
    written alone are ``packb``'s."""
    for n in SIZES + [2 ** 16 + 3]:
        assert PM.map_header(n) == MP.packb({i: 0 for i in range(n)})[
            :len(PM.map_header(n))]
        assert PM.bin_header(n) + b"\x01" * n == MP.packb(b"\x01" * n)
    monkeypatch.setattr(RCK, "zstd", None)
    monkeypatch.setattr(ckpt, "_CHUNK", 7)
    tree = _tree()
    mine = ckpt.save(str(tmp_path / "port.rsk"), tree, meta=_meta())
    theirs = RCK.save(str(tmp_path / "ref.rsk"), tree, meta=_meta())
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        raw = a.read()
        assert raw == b.read()
    untagged = str(tmp_path / "untagged.rsk")
    with open(untagged, "wb") as f:
        f.write(raw[5:])
    for path in (mine, untagged):
        back, meta = ckpt.restore(path, device="cpu", return_meta=True)
        assert meta == _meta()
        _eq(back["w"], tree["w"])
        _eq(back["layers"][0]["b"], tree["layers"][0]["b"])
        assert back["layers"][1]["b"].shape == (2, 0)
    with open(untagged, "wb") as f:
        f.write(raw[5:-9])
    with pytest.raises(ValueError, match="ends early"):
        ckpt.restore(untagged, device="cpu")
    # a leaf of 4 GiB is refused before anything is written (a view
    # that holds no memory of its own)
    huge = torch.zeros(1, dtype=torch.uint8).expand(1 << 32)
    with pytest.raises(ValueError, match="4 GiB"):
        ckpt.save(str(tmp_path / "huge.rsk"), {"x": huge})
    assert not os.path.exists(tmp_path / "huge.rsk")


# ---------------------------------------------------------------------------
# the warehouse
# ---------------------------------------------------------------------------

def _tiered(n=4096, chunk=512, seed=13, keep=2048):
    """The same store on both sides, its oldest chunks spilled with the
    reference's draws so the cold tiers are equal."""
    rows = _rows(n, seed=seed)
    rstore = RW.SegmentStore(out_dim=3, chunk_rows=chunk)
    rstore.append_rows({k: jnp.asarray(v) for k, v in rows.items()})
    pstore = SegmentStore(out_dim=3, chunk_rows=chunk, device="cpu")
    pstore.append_rows(rows)
    rt = RW.TieredStore(rstore, seed=1)
    pt = TieredStore(pstore, seed=1, device="cpu")
    n_chunks = (n - keep) // chunk
    assert pt.spill(keep, draws=_ref_draws(1, 0, n_chunks)) == rt.spill(keep)
    return rt, pt


def _plan(ts):
    return (Filter("quality", "ge", 0.5),
            WindowAgg(window=256, value="quality", agg="mean",
                      num_windows=windows_for(ts, 256)),
            TopK(4, by="quality"))


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _same_tier(pt, rt):
    assert (pt.n_cold, pt.hot.n_rows, pt.hot.t_max, pt.hot.chunk_rows,
            pt.seed) == (rt.n_cold, rt.hot.n_rows, rt.hot.t_max,
                         rt.hot.chunk_rows, rt.seed)
    for mine, theirs in ((pt.hot.columns, rt.hot.columns),
                         (pt.cold_q, rt.cold_q),
                         (pt.cold_scales, rt.cold_scales),
                         (pt.cold_int, rt.cold_int)):
        assert set(mine) == set(theirs)
        for k in theirs:
            _eq(mine[k], theirs[k], k)
            assert _dtype(mine[k]) == _dtype(theirs[k])


def test_warehouse_files_cross_load(tmp_path, monkeypatch):
    monkeypatch.setattr(RCK, "zstd", None)
    rt, pt = _tiered()
    mine = save_warehouse(str(tmp_path / "port.rsk"), pt)
    theirs = RW.save_warehouse(str(tmp_path / "ref.rsk"), rt)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    back_r = RW.load_warehouse(mine)
    back_p = load_warehouse(theirs, device="cpu")
    _same_tier(pt, back_r)
    _same_tier(back_p, rt)
    assert list(back_p.hot.columns) == list(pt.hot.columns)
    plan = _plan(pt)
    _same_answer(back_p.query(plan), rt.query(ref_plan(plan)))
    _same_answer(pt.query(plan), back_r.query(ref_plan(plan)))


def test_warehouse_roundtrip_bit_exact(tmp_path):
    """tests/test_warehouse.py:407 on the port: the tiers restore bit for
    bit and every plan answers as before the save, also with nothing
    spilled; a reference file in its default zstd codec raises by
    name."""
    _, pt = _tiered(seed=14)
    for ts in (pt, TieredStore(SegmentStore(out_dim=3, chunk_rows=64,
                                            device="cpu"), device="cpu")):
        if not ts.n_rows:
            ts.hot.append_rows(_rows(100, seed=3))
        path = save_warehouse(str(tmp_path / "w.rsk"), ts)
        back = load_warehouse(path, device="cpu")
        _same_tier(back, ts)
        for plan in (_plan(ts),
                     (GroupBy("category", "out", agg="sum", num_groups=4),)):
            _same_answer(back.query(plan), ts.query(plan))
    if RCK.zstd is not None:
        rt, _ = _tiered(seed=15)
        path = RW.save_warehouse(str(tmp_path / "z.rsk"), rt)
        with pytest.raises(ImportError, match="zstandard"):
            load_warehouse(path, device="cpu")
