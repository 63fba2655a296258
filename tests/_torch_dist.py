"""Worlds of gloo ranks for the port's distributed warehouse tests.

``run_world(fn, world, tmp)`` spawns ``world`` ranks
(``launch.mesh.spawn_world``, under a deadline), each with one torch
thread, joined through a ``file://`` store under ``tmp`` with a short
collective timeout; rank ``r`` runs ``fn(r, world, **kw)`` and its
result is written to a file that the test process reads back, one per
rank.

``scenario(store, ...)`` is the sequence of calls the tests hold a
distributed store to: the same calls on the stacked store in the test
process (``group=None``) and on every rank of a world (``group`` the
world) give results that must be equal bit for bit. The op log
(``op_log``) is numpy, so the test process also replays it on the
reference's store.

Spawned ranks import this module by name: it imports numpy, torch and
``repro_torch`` only, never JAX (the card's machine has none).
"""
from __future__ import annotations

import datetime
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import (check_backend, init_shard_group,
                                     spawn_world)
from repro_torch.runtime.elastic import rebalance
from repro_torch.warehouse import (Filter, GroupBy, MultiGroupBy, Project,
                                   ShardedStore, ShardedTieredStore,
                                   StandingQueries, TopK, WindowAgg,
                                   to_host, windows_for)
from repro_torch.warehouse import query as Q

D = 3
SHARDS = 8
TIMEOUT_S = 60          # a collective that waits longer fails its rank
DEADLINE_S = 240        # a world still running after this is killed


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------

def _rank_main(rank, fn, world, init_file, out_dir, kw, timeout_s, device):
    torch.set_num_threads(1)
    init_shard_group(device, init_method=f"file://{init_file}", rank=rank,
                     world_size=world,
                     timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, world, **kw)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_world(fn, world, tmp, *, deadline=DEADLINE_S, timeout_s=TIMEOUT_S,
              device="cpu", **kw):
    """``fn(rank, world, **kw)`` on ``world`` ranks (gloo on the CPU;
    ``device=None``: NCCL, a card a rank); the ranks' results in rank
    order and the world's wall seconds."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    init_file = tmp / "pg_init"
    if init_file.exists():
        init_file.unlink()
    t0 = time.monotonic()
    spawn_world(_rank_main, world, (fn, world, str(init_file), str(tmp), kw,
                                    timeout_s, device), deadline=deadline)
    results = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
               for r in range(world)]
    return results, time.monotonic() - t0


def same(got, want, path="answer"):
    """Bit-for-bit equality of nested results (dicts, lists, tuples,
    arrays of the same dtype and shape, scalars)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (path, got.dtype, want.dtype, got.shape, want.shape)
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
            path
    else:
        assert got == want, (path, got, want)


def cat_ranks(locals_):
    """The ranks' local tier arrays (``_tier_arrays``) joined along the
    shard axis in rank order; every rank's per-shard depths must agree."""
    first = locals_[0]
    out = {part: {k: np.concatenate([loc[part][k] for loc in locals_])
                  for k in first[part]}
           for part in ("cold_q", "cold_scales", "cold_int", "hot")}
    for loc in locals_:
        same(loc["n_cold_by_shard"], first["n_cold_by_shard"])
    out["n_cold_by_shard"] = first["n_cold_by_shard"]
    return out


def close(got, want, path="answer", rtol=1e-5):
    """``same``, but float arrays within ``rtol`` of ``want``, relative
    (the answers of nonnegative columns, where that is relative to the
    sum of magnitudes)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            close(got[k], want[k], f"{path}/{k}", rtol)
    elif isinstance(want, np.ndarray) and want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0,
                                   err_msg=path)
    else:
        same(got, want, path)


def same_ranks(ranks, want, exact_views=True):
    """Every rank's ``scenario`` result equals ``want`` (the stacked
    store's), the ranks' local tier arrays joined in rank order. With
    ``exact_views`` false, the answers over the tiers' two-tier views
    (dequantized values, whose float32 sums depend on their order) are
    held within ``close``'s tolerance instead."""
    def split(res):
        res = dict(res)
        local = res.pop("tier_local")
        res["ref_tier"] = dict(res["ref_tier"])
        views = {}
        if not exact_views:
            res["tier"] = dict(res["tier"])
            views = {k: res["tier"].pop(k) for k in list(res["tier"])
                     if k.startswith("plan")}
            views["ref"] = res["ref_tier"].pop("answers")
        return res, local, res["ref_tier"].pop("local"), views
    glob, local, ref_local, views = split(want)
    parts = [split(r) for r in ranks]
    for g, _, _, v in parts:
        same(g, glob)
        close(v, views, "views")
    same(cat_ranks([p[1] for p in parts]), local, "tier_local")
    same(cat_ranks([p[2] for p in parts]), ref_local, "ref_tier/local")


# ---------------------------------------------------------------------------
# the op log and the plans
# ---------------------------------------------------------------------------

def rows(n, seed=0, t0=0, d=D, streams=None):
    """``tests/test_warehouse.py``'s ``_random_rows`` (numpy)."""
    rng = np.random.default_rng(seed)
    out = {
        "stream_id": rng.integers(0, 4, n).astype(np.int32),
        "t": (t0 + np.arange(n)).astype(np.int32),
        "category": rng.integers(0, 4, n).astype(np.int32),
        "k": rng.integers(0, d, n).astype(np.int32),
        "quality": rng.random(n).astype(np.float32),
        "on_core_s": (rng.random(n) * 20).astype(np.float32),
        "cloud_core_s": (rng.random(n) * 5).astype(np.float32),
        "buffer_s": (rng.random(n) * 40).astype(np.float32),
        "out": rng.random((n, d)).astype(np.float32),
    }
    if streams is not None:
        out["stream_id"] = (np.arange(n, dtype=np.int32) * 7) % streams
    return out


def _traces(rng, shape, d=D):
    return {"c": rng.integers(0, 4, shape).astype(np.int32),
            "k": rng.integers(0, d, shape).astype(np.int32),
            "qual": rng.random(shape).astype(np.float32),
            "on_s": (rng.random(shape) * 20).astype(np.float32),
            "cl_s": (rng.random(shape) * 5).astype(np.float32),
            "buffer_s": (rng.random(shape) * 40).astype(np.float32)}


def op_log(seed=0, grid=None):
    """Every kind of ingest, as ``(method, kwargs)`` in numpy: rows from
    16 streams, a single-stream fused run, a 5-stream fused run, pool
    ticks (slot v as stream v, and real ids with inactive slots), more
    rows. The first op lands before the registry is attached. ``grid``
    snaps every float to a multiple of ``1 / grid``, so that every sum
    of them is exact in float32, whatever its order."""
    rng = np.random.default_rng(seed)
    ops = [("append_rows", {"rows": rows(700, seed=seed + 1, streams=16)})]
    T = 130
    ops.append(("ingest_fused", {
        "traces": _traces(rng, (3, 50)),
        "out_vecs": rng.random((T, D)).astype(np.float32),
        "stream_id": 13, "t0": 700}))
    ops.append(("ingest_fused_multi", {
        "traces": _traces(rng, (2, 5, 40)),
        "out_vecs": rng.random((5, 70, D)).astype(np.float32),
        "stream_base": 3, "t0": 900}))
    for t in range(4):
        V = 6
        kw = {"traces": _traces(rng, (V,)),
              "quality": rng.random(V).astype(np.float32),
              "out_vecs": rng.random((V, D)).astype(np.float32),
              "t": 1000 + t}
        if t % 2:
            kw["stream_ids"] = rng.permutation(40)[:V].astype(np.int32)
            kw["valid"] = rng.random(V) < 0.6
        ops.append(("ingest_tick", kw))
    ops.append(("append_rows", {"rows": rows(500, seed=seed + 2, t0=1100,
                                             streams=24)}))
    if grid is None:
        return ops

    def snap(x):
        if isinstance(x, dict):
            return {k: snap(v) for k, v in x.items()}
        if isinstance(x, np.ndarray) and x.dtype == np.float32:
            return (np.round(x * grid) / grid).astype(np.float32)
        return x
    return [(method, snap(kw)) for method, kw in ops]


def apply(store, op, convert):
    """Run one logged op on ``store``, arrays through ``convert``."""
    method, kw = op
    kw = {k: ({c: convert(x) for c, x in v.items()} if isinstance(v, dict)
              else convert(v) if isinstance(v, np.ndarray)
              and k not in ("valid", "stream_ids") else v)
          for k, v in kw.items()}
    if method == "append_rows":
        return store.append_rows(kw["rows"])
    return getattr(store, method)(**kw)


def plans(nw):
    """test_torch_sharded's plans: TopK, row plans, every agg."""
    return (
        (Filter("quality", "ge", 0.4), Filter("stream_id", "ne", 3),
         WindowAgg(window=250, value="on_core_s", agg="mean",
                   num_windows=nw), TopK(7, by="on_core_s")),
        (Filter("buffer_s", "lt", 30.0),
         GroupBy("category", "cloud_core_s", agg="sum", num_groups=4)),
        (Project(("t", "quality", "k")), Filter("quality", "le", 0.9),
         TopK(11, by="quality", largest=False)),
        (Filter("stream_id", "eq", 5), TopK(9, by="quality")),
        (Filter("quality", "ge", 0.5), Project(("t", "quality"))),
        (Filter("quality", "gt", 2.0), Project(("t", "k"))),
        (Filter("quality", "ge", 0.3),
         MultiGroupBy(keys=("t", "category"), value="on_core_s", agg="mean",
                      nums=(nw, 4), windows=(500, 0)),
         TopK(5, by="on_core_s")),
        (GroupBy("category", "out", agg="sum", num_groups=4),),
        (GroupBy("category", "k", agg="sum", num_groups=4),),
    ) + tuple((Filter("quality", "ge", 0.2),
               GroupBy("category", "on_core_s", agg=agg, num_groups=4))
              for agg in ("sum", "mean", "count", "max", "min"))


# the compressed merge's plans and their partials' shapes
COMPRESSED = (((GroupBy("category", "out", agg="sum", num_groups=4),),
               (4, D)),
              ((WindowAgg(500, "quality", agg="mean", num_windows=8),),
               (8,)))

STANDING = (
    (Filter("quality", "ge", 0.3),
     GroupBy("category", "quality", agg="sum", num_groups=4)),
    (GroupBy("category", "quality", agg="max", num_groups=4),),
    (WindowAgg(window=128, value="on_core_s", agg="count", num_windows=16),),
    (MultiGroupBy(keys=("k", "category"), value="out", agg="mean",
                  nums=(D, 4), windows=(0, 0)),),
)
# a plan on K1's path (its plain version here): the port's stores only
KERNEL_STANDING = (Filter("quality", "lt", 0.8),
                   GroupBy("stream_id", "on_core_s", agg="sum",
                           num_groups=64))
SUB = ((GroupBy("stream_id", "buffer_s", agg="max", num_groups=64),),
       Filter("buffer_s", "ge", 30.0))


def is_row_plan(plan) -> bool:
    return Q.split_plan(Q.normalize(plan)[0])[1] is None


def host_answer(plan, answer):
    """An answer as host numpy: a row plan's surviving rows
    (``to_host``), else the whole table and its mask."""
    table, mask = answer
    if is_row_plan(plan):
        return to_host(table, mask)
    return {**{k: v.cpu().numpy() for k, v in table.items()},
            "__mask__": mask.cpu().numpy()}


# ---------------------------------------------------------------------------
# the scenario
# ---------------------------------------------------------------------------

class TableDraws:
    """A tier's ``spill(draws=)`` from precomputed uniforms (every
    shard's, by column name): what a rank is given in place of the
    reference's ``jax.random`` draws."""

    def __init__(self, table):
        self.table = table

    def __call__(self, name, S, n_chunks, width):
        u = self.table[name]
        assert u.shape == (S, n_chunks, width), (name, u.shape)
        return u


def _store(group, n_shards=SHARDS, chunk=64, d=D, device="cpu"):
    return ShardedStore(out_dim=d, n_shards=n_shards, chunk_rows=chunk,
                        device=device, group=group)


def fill(store, ops, convert=torch.as_tensor):
    """The op log into ``store`` with a registry attached after the first
    op; returns the registry and its handles."""
    apply(store, ops[0], convert)
    reg = StandingQueries(store)
    handles = [reg.register(p, use_kernel=False) for p in STANDING]
    handles.append(reg.register(KERNEL_STANDING))
    reg.subscribe(SUB[0], SUB[1], name="buffer-watch", use_kernel=False)
    for op in ops[1:]:
        apply(store, op, convert)
    return reg, handles


def _store_state(store, reg, handles, nw):
    out = {"rows": store.host_rows(), "counts": store.n_rows_by_shard.copy(),
           "capacity": store.capacity, "t_max": store.t_max,
           "telemetry": store.telemetry().summary()}
    for i, p in enumerate(plans(nw)):
        for uk in (False, None):
            out[f"plan{i}/{uk}"] = host_answer(p, store.query(
                p, use_kernel=uk))
    if reg is not None:
        for h in handles:
            out[f"standing{h}"] = host_answer(STANDING[0],
                                              reg.answer(h))
        out["alerts"] = [(a.name, a.fired, a.table) for a in reg.poll()]
    return out


def scenario(group, ops, *, compressed_draws, tier_draws, halves=None,
             device="cpu"):
    """Every call the tests hold, on an 8-shard store on ``device``
    (stacked when ``group`` is None); returns ``{case: host numpy}``.
    ``halves`` is the group of the first half of the ranks
    (``rebalance`` onto it)."""
    store = _store(group, device=device)
    reg, handles = fill(store, ops)
    nw = windows_for(store, 250)
    res = {"main": _store_state(store, reg, handles, nw)}
    for i, (p, _) in enumerate(COMPRESSED):
        res[f"compressed{i}/seed"] = host_answer(p, store.query(
            p, compressed=True, seed=3))
        for uk in (False, None):
            res[f"compressed{i}/ref/{uk}"] = host_answer(p, store.query(
                p, compressed=True, draws=compressed_draws[i],
                use_kernel=uk))
    # rebalance 8 -> 4 -> 8, registry replayed each time
    four = rebalance(store, 4, device=device, group=group)
    res["rebalance4"] = _store_state(four, four.standing, handles, nw)
    eight = rebalance(four, 8, device=device, group=group)
    res["rebalance8"] = _store_state(eight, eight.standing, handles, nw)
    if halves is not None:
        half = rebalance(store, 4, device=device, group=halves)
        res["rebalance_half"] = None if half is None else {
            "rows": half.host_rows(), "counts": half.n_rows_by_shard.copy(),
            "capacity": half.capacity, "shards": half.shards}
    # the tier with its own draws over the main store: answers over the
    # two-tier view, standing answers unmoved by the spill
    tier = ShardedTieredStore(store, seed=5, device=device)
    res["spilled"] = tier.spill(keep_hot=64)
    res["tier"] = {f"plan{i}": host_answer(p, tier.query(p))
                   for i, p in enumerate(plans(nw))}
    res["tier"]["standing"] = [host_answer(STANDING[0], reg.answer(h))
                               for h in handles]
    res["tier"]["max_cold_scale"] = tier.max_cold_scale()
    res["tier"]["telemetry"] = tier.telemetry().summary()
    res["tier_local"] = _tier_arrays(tier)
    # the reference's draws: a fresh store, two spills
    res["ref_tier"] = ref_tier_case(group, tier_draws, device)
    return res


def _tier_arrays(tier):
    """This rank's cold arrays and hot columns (the test concatenates the
    ranks' in rank order)."""
    def host(arrays):
        return {k: v.cpu().numpy().copy() for k, v in arrays.items()}
    return {"cold_q": host(tier.cold_q), "cold_scales": host(tier.cold_scales),
            "cold_int": host(tier.cold_int), "hot": host(tier.hot.columns),
            "n_cold_by_shard": tier.n_cold_by_shard.copy()}


TIER_CHUNK = 32


def tier_rows():
    """The reference-draw tier's two batches: ragged, an empty shard."""
    a = rows(700, seed=31, d=2)
    a["stream_id"] = (np.arange(700, dtype=np.int32) % 7) * 1
    b = rows(300, seed=32, t0=700, d=2, streams=5)
    return a, b


def ref_tier_case(group, tier_draws, device="cpu"):
    """Two batches and two spills (keep_hot 64, then 32) on a 2-wide
    store, ``tier_draws[i]`` the i-th spill's ``draws``; the tier's
    arrays, the view's answers and its telemetry."""
    store = _store(group, chunk=TIER_CHUNK, d=2, device=device)
    tier = ShardedTieredStore(store, seed=7, device=device)
    a, b = tier_rows()
    out = {}
    store.append_rows(a)
    out["spill0"] = tier.spill(64, draws=tier_draws[0])
    store.append_rows(b)
    out["spill1"] = tier.spill(32, draws=tier_draws[1])
    out["local"] = _tier_arrays(tier)
    nw = tier.t_max // 256 + 1
    out["answers"] = {i: host_answer(p, tier.query(p, use_kernel=uk))
                      for i, (p, uk) in enumerate(
                          (p, uk) for p in tier_plans(nw)
                          for uk in (False, None))}
    out["telemetry"] = tier.telemetry().summary()
    return out


def tier_plans(nw):
    return ((GroupBy("category", "quality", agg="mean", num_groups=4),),
            (Filter("on_core_s", "gt", 5.0),
             GroupBy("k", "buffer_s", agg="sum", num_groups=4)),
            (WindowAgg(256, "cloud_core_s", agg="max", num_windows=nw),),
            (GroupBy("category", "out", agg="sum", num_groups=4),),
            (Filter("quality", "ge", 0.5), TopK(6, by="on_core_s")))


# ---------------------------------------------------------------------------
# rank entry points
# ---------------------------------------------------------------------------

def rank_scenario(rank, world, *, ops, compressed_draws, tier_draws):
    """``scenario`` on this world, plus the refusals: a group's size that
    does not divide the shards, a backend that does not fit the device,
    a rebalance onto a count the group does not divide."""
    halves = dist.new_group(ranks=list(range(world // 2)))
    res = scenario(dist.group.WORLD, ops, compressed_draws=compressed_draws,
                   tier_draws=tier_draws, halves=halves)
    errors = {}
    for what, call in (
            ("shards", lambda: _store(dist.group.WORLD,
                                      n_shards=world + 1)),
            ("backend", lambda: check_backend(dist.group.WORLD,
                                              torch.device("cuda"))),
            ("rebalance", lambda: rebalance(_store(dist.group.WORLD), world
                                            + 1, device="cpu",
                                            group=dist.group.WORLD))):
        try:
            call()
            errors[what] = None
        except ValueError as e:
            errors[what] = str(e)
    res["errors"] = errors
    res["shards"] = _store(dist.group.WORLD).shards
    return res


def rank_card(rank, world, *, ops, compressed_draws):
    """``scenario`` on CUDA over this NCCL world (the tiers with their own
    draws), and the refusals of a gloo group by a CUDA store and of the
    NCCL group by a CPU store."""
    res = {"scenario": scenario(dist.group.WORLD, ops,
                                compressed_draws=compressed_draws,
                                tier_draws=[None, None], device="cuda")}
    gloo = dist.new_group(backend="gloo")
    for what, group, device in (("gloo", gloo, "cuda"),
                                ("nccl", dist.group.WORLD, "cpu")):
        try:
            _store(group, device=device)
            res[what] = None
        except ValueError as e:
            res[what] = str(e)
    return res


def rank_fails(rank, world, *, how, wait):
    """A world where rank 1 breaks: it raises before the first
    collective (``raise``), or skips it and sleeps ``wait`` seconds
    (``skip``) while the others wait in it until their timeout."""
    store = _store(dist.group.WORLD)
    store.append_rows(rows(100))
    if rank == 1:
        if how == "raise":
            raise RuntimeError("rank 1 fails on purpose")
        time.sleep(wait)
    store.host_rows()
    return {}


def rank_psum(rank, world, *, cases):
    """``compressed_psum`` over the world for each case ``(x, r, err)``
    (every rank's inputs stacked on a leading axis; this rank takes its
    own row): its ``(mean, new residual)`` per case."""
    from repro_torch.distribution.compression import compressed_psum
    return [tuple(v.numpy() for v in compressed_psum(
        torch.as_tensor(x[rank]), torch.as_tensor(r[rank]),
        torch.as_tensor(e[rank]))) for x, r, e in cases]


def rank_grads(rank, world, *, grads, errs, draws):
    """``compress_grads_across_pods`` of numpy leaves over the world."""
    from repro_torch.distribution.compression import \
        compress_grads_across_pods

    def tensors(d):
        return {k: torch.as_tensor(v) for k, v in d.items()}
    g, e = compress_grads_across_pods(tensors(grads), tensors(errs),
                                      tensors(draws))
    return ({k: v.numpy() for k, v in g.items()},
            {k: v.numpy() for k, v in e.items()})


# ---------------------------------------------------------------------------
# training across ranks
# ---------------------------------------------------------------------------

# the train step's tolerances (tests/test_torch_train.py): the loss and
# the clipped norm relative, the moments of each leaf's largest magnitude;
# the rate within one float32 ulp
LOSS_TOL = GRAD_TOL = 1e-5
ULP32 = 2.0 ** -23


def flat(tree, prefix=""):
    """{path: numpy} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    return {prefix[:-1]: np.asarray(tree)}


def update_bound(m, v, count, lr, tol=GRAD_TOL):
    """Per element, how far one AdamW update (b1 0.9, b2 0.95, eps 1e-8)
    may move from the reference's when the moments are within ``tol``
    of each leaf's largest magnitude of the reference's ``m`` and ``v``.

    The update is p - lr (s + wd p), s = m^ / (sqrt(v^) + eps), m^ and v^
    the moments over their bias corrections bc1 and bc2. With the moments
    within t_m and t_v, s moves by at most (t_m / bc1 + |m^| sqrt(t_v /
    bc2) / d) / d, d = max(sqrt(v^) - sqrt(t_v / bc2), 0) + eps."""
    m, v = m.astype(np.float64), v.astype(np.float64)
    bc1, bc2 = 1 - 0.9 ** count, 1 - 0.95 ** count
    t_m = tol * float(np.abs(m).max()) / bc1
    t_s = np.sqrt(tol * float(np.abs(v).max()) / bc2)
    d = np.maximum(np.sqrt(v / bc2) - t_s, 0.0) + 1e-8
    return lr * (t_m + np.abs(m / bc1) * t_s / d) / d


def close_state(got, want, lr, what, tol=GRAD_TOL):
    """The moments within ``tol`` of each leaf's largest magnitude, the
    params within that plus ``update_bound`` of the one update at rate
    ``lr``; counts equal."""
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys(), what
    count = int(w["opt/count"])
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, \
            (what, k)
        if w[k].dtype.kind == "i":
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} {k}")
            continue
        if not w[k].size:
            continue
        err = np.abs(g[k].astype(np.float64) - w[k])
        bound = tol * float(np.abs(w[k]).max())
        if k.startswith("params/"):
            bound = bound + update_bound(w["opt/m/" + k[7:]],
                                         w["opt/v/" + k[7:]], count, lr,
                                         tol)
        bad = err > bound
        assert not bad.any(), (what, k, float(err.max()),
                               float(np.max(err - bound)))


def held(run, ref, what, tol=GRAD_TOL):
    """A sharded run's metrics and whole state against the reference's
    (the moments within ``tol``, ``close_state``): runs whose updates but
    the last have rate 0."""
    for n, (m, r) in enumerate(zip(run["metrics"], ref["metrics"])):
        for key, rel in (("loss", LOSS_TOL), ("gnorm", LOSS_TOL),
                         ("lr", ULP32)):
            assert abs(m[key] - r[key]) <= rel * abs(r[key]) + 1e-30, \
                (what, n, key, m[key], r[key])
    assert all(r["lr"] == 0 for r in ref["metrics"][:-1]), what
    close_state(run["state"], ref["state"], ref["metrics"][-1]["lr"], what,
                tol)


def same_bits(a, b, what):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys(), what
    for k in fa:
        x, y = np.atleast_1d(fa[k]), np.atleast_1d(fb[k])
        assert x.dtype == y.dtype and np.array_equal(
            x.view(np.uint8), y.view(np.uint8)), (what, k)


def reduced_model(arch, opts, cfg=None):
    """The reduced ``arch`` (with ``cfg``'s fields replaced, a dict) and
    run options ``opts`` (a dict)."""
    import dataclasses
    from repro_torch.configs.base import get
    from repro_torch.models.model import Model
    from repro_torch.models.options import RunOptions
    return Model(dataclasses.replace(get(arch).reduced(), **(cfg or {})),
                 RunOptions(**opts))


def train_setup(arch, opts, mesh_shape, names=("data", "model"),
                device="cpu", cfg=None):
    """``reduced_model`` and a ``TrainMesh`` of ``mesh_shape`` over this
    world."""
    from repro_torch.launch.mesh import TrainMesh
    return (reduced_model(arch, opts, cfg),
            TrainMesh(mesh_shape, names, device=device))


def my_rows(model, mesh, batch):
    """This rank's rows of a global numpy batch, as tensors on the mesh's
    device."""
    from repro_torch.data.tokens import local_rows
    axes = model.batch_axes(mesh)
    rows = local_rows(len(next(iter(batch.values()))), mesh.index(axes),
                      mesh.axis_size(axes), model.opts.microbatches)
    return {k: torch.as_tensor(v[rows], device=mesh.device)
            for k, v in batch.items()}


def whole_state(model, state, mesh):
    """Every leaf of a sharded train state gathered whole: numpy on rank
    0, None elsewhere (every rank must call it)."""
    from repro_torch.checkpoint.ckpt import _flatten, _unflatten
    from repro_torch.distribution.sharding import full_tensor
    from repro_torch.runtime.steps import train_state_shardings
    out = {}
    for (k, x), pl in zip(_flatten(state).items(),
                          _flatten(train_state_shardings(model, mesh))
                          .values()):
        full = full_tensor(x, pl.spec, pl.mesh)
        out[k] = full.cpu().numpy().copy()
    return _unflatten(out) if dist.get_rank() == 0 else None


def host(tree):
    """A tree of tensors as numpy."""
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def whole_grads(model, state, mesh, batch):
    """The gradient of ``batch``'s global loss at ``state`` (this rank's
    blocks; ``runtime.steps.value_and_grad`` with the step's layout),
    every leaf gathered whole: numpy in ``leaves`` order on rank 0, None
    elsewhere."""
    from repro_torch.distribution import sharding as shd
    from repro_torch.runtime.steps import value_and_grad
    specs = model.param_specs(mesh)
    layout = shd.StepLayout(mesh, specs, model.batch_axes(mesh))
    _, grads = value_and_grad(model, state["params"],
                              my_rows(model, mesh, batch), layout)
    out = [shd.full_tensor(g, spec, mesh).numpy().copy()
           for g, spec in zip(grads, shd.tree_leaves(specs))]
    return out if dist.get_rank() == 0 else None


def sharded_steps(case, device="cpu"):
    """``case``: ``arch``, ``opts``, ``mesh`` (its shape, over ``("data",
    "model")`` unless ``names``), ``state`` (a whole train state, numpy),
    ``batches`` (global, numpy), ``kw`` (the step's arguments), and
    optionally ``cfg`` (fields of the reduced config replaced) and
    ``grads`` (True: also the first batch's whole gradient at the initial
    state, ``whole_grads``). The sharded step from that state over those
    batches: each step's metrics (the same on every rank), the bytes the
    step moved, and the whole final state (rank 0)."""
    from repro_torch.convert import params_from_arrays
    from repro_torch.runtime.steps import make_train_step, shard_train_state
    model, mesh = train_setup(case["arch"], case["opts"], case["mesh"],
                              case.get("names", ("data", "model")), device,
                              case.get("cfg"))
    state = shard_train_state(model, params_from_arrays(case["state"], "cpu"),
                              mesh)
    out = {}
    if case.get("grads"):
        out["grads"] = whole_grads(model, state, mesh, case["batches"][0])
    step = make_train_step(model, mesh=mesh, **case["kw"])
    metrics = []
    with heads_seen() as seen, rows_seen() as rows:
        for b in case["batches"]:
            state, m = step(state, my_rows(model, mesh, b))
            metrics.append({k: float(v) for k, v in m.items()})
    return {**out, "metrics": metrics, "bytes": dict(step.layout.bytes),
            "heads": sorted(set(seen)),
            "rows": {k: sorted(set(v)) for k, v in rows.items()},
            "state": whole_state(model, state, mesh)}


@contextmanager
def rows_seen():
    """The shapes of the residual stream between the blocks (``"stream"``:
    each layer's input and output, ``transformer._block_fwd``) and of the
    rows a sequence-split step keeps for a gathered activation that
    autograd saves (``"kept"``: ``StepLayout._pack`` of a tensor that
    ``ModelSplit.f`` gathered), in lists."""
    from repro_torch.distribution import sharding as shd
    from repro_torch.models import transformer
    rows = {"stream": [], "kept": []}
    block, pack = transformer._block_fwd, shd.StepLayout._pack

    def block_(lp, x, *a, **kw):
        out = block(lp, x, *a, **kw)
        rows["stream"] += [tuple(x.shape), tuple(out[0].shape)]
        return out

    def pack_(self, t):
        saved = pack(self, t)
        kept = saved.kept
        if kept is not None and getattr(kept.regather, "__name__",
                                        "") == "gather_rows":
            rows["kept"].append(tuple(kept.shard.shape))
        return saved
    transformer._block_fwd = block_
    shd.StepLayout._pack = pack_
    try:
        yield rows
    finally:
        transformer._block_fwd = block
        shd.StepLayout._pack = pack


@contextmanager
def heads_seen():
    """The head counts the model path hands K3 (``("attention", q heads,
    kv heads)``, through ``attend``) and K4 (``("ssd", heads, groups)``,
    through ``ssd.ssd_scan``) inside the block, in a list."""
    from repro_torch.models import ssd, transformer, whisper
    seen = []
    attend, scan = transformer.attend, ssd.ssd_scan

    def attend_(q, k, v, **kw):
        seen.append(("attention", q.shape[2], k.shape[2]))
        return attend(q, k, v, **kw)

    def scan_(x, dt, A, Bm, Cm, **kw):
        seen.append(("ssd", x.shape[2], Bm.shape[2]))
        return scan(x, dt, A, Bm, Cm, **kw)
    transformer.attend = whisper.attend = attend_
    ssd.ssd_scan = scan_
    try:
        yield seen
    finally:
        transformer.attend = whisper.attend = attend
        ssd.ssd_scan = scan


def plain_steps(case, device="cpu"):
    """The same steps without a mesh, on this rank's device."""
    from repro_torch.convert import params_from_arrays
    from repro_torch.runtime.steps import make_train_step
    model = reduced_model(case["arch"], case["opts"], case.get("cfg"))
    state = params_from_arrays(case["state"], device)
    step = make_train_step(model, **case["kw"])
    metrics = []
    for b in case["batches"]:
        state, m = step(state, {k: torch.as_tensor(v, device=device)
                                for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "state": host(state)}


def rank_train(rank, world, *, cases, plain=False):
    """``sharded_steps`` of every case (and, with ``plain`` or the case's
    own ``plain``, the same steps without a mesh, in this rank)."""
    return [{**sharded_steps(c), **({"plain": plain_steps(c)}
                                    if plain or c.get("plain") else {})}
            for c in cases]


def rank_train_card(rank, world, *, cases):
    """``sharded_steps`` of every case on this rank's card over NCCL."""
    return [sharded_steps(c, device=None) for c in cases]


def rank_elastic_save(rank, world, *, arch, opts, mesh, ckpt_dir, batch,
                      kw):
    """A fresh sharded state (``init_train_state(..., mesh=)``, seed 0),
    one step, saved whole under ``ckpt_dir`` at step 1; the whole state
    (rank 0)."""
    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.runtime.steps import (init_train_state, make_train_step,
                                           train_state_shardings)
    model, m = train_setup(arch, opts, mesh)
    state = init_train_state(model, torch.Generator().manual_seed(0), "cpu",
                             m)
    state, _ = make_train_step(model, mesh=m, **kw)(state,
                                                    my_rows(model, m, batch))
    CK.save(ckpt_dir, state, step=1,
            shardings=train_state_shardings(model, m))
    return whole_state(model, state, m)


def rank_elastic_restore(rank, world, *, arch, opts, mesh, ckpt_dir, batch,
                         kw):
    """``restore_elastic`` onto ``mesh``: this rank's blocks, the whole
    restored state (rank 0), then one step's metrics and state; and the
    refusals of the production meshes, larger than this world."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime.elastic import restore_elastic
    from repro_torch.runtime.steps import make_train_step
    model, m = train_setup(arch, opts, mesh)
    state, step = restore_elastic(ckpt_dir, model, m)
    out = {"step": step, "local": host(state),
           "restored": whole_state(model, state, m), "refused": []}
    for multi_pod in (False, True):
        try:
            make_production_mesh(multi_pod=multi_pod, device="cpu")
        except ValueError as e:
            out["refused"].append(str(e))
    state, met = make_train_step(model, mesh=m, **kw)(
        state, my_rows(model, m, batch))
    out["metrics"] = {k: float(v) for k, v in met.items()}
    out["state"] = whole_state(model, state, m)
    return out


def rank_raises(rank, world, *, arch, opts, batch, kw):
    """Rank 1 raises before its first step; the others wait for it in the
    step's first gather until the world is ended."""
    from repro_torch.runtime.steps import init_train_state, make_train_step
    model, m = train_setup(arch, opts, (world, 1))
    state = init_train_state(model, torch.Generator().manual_seed(0), "cpu",
                             m)
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    make_train_step(model, mesh=m, **kw)(state, my_rows(model, m, batch))
    return {}


# ---------------------------------------------------------------------------
# serving across ranks
# ---------------------------------------------------------------------------

def serve_rows(model, mesh, n_rows):
    """This rank's rows of a global batch of ``n_rows`` (all of them
    where they do not split over the batch's axes) and whether they
    split."""
    from repro_torch.data.tokens import local_rows
    axes = model.batch_axes(mesh)
    n = mesh.axis_size(axes)
    if n_rows % n:
        return np.arange(n_rows), False
    return local_rows(n_rows, mesh.index(axes), n), n > 1


def _gather_dim(x, dim, mesh, axes):
    from repro_torch.distribution.sharding import _all_gather
    axes = tuple(a for a in mesh.axis_names if a in axes)
    return _all_gather(x, dim, mesh.group(axes), mesh.axis_size(axes))


def cache_arrays(cache):
    """A serving cache's leaves as numpy by name (the layers' and the
    top level's; a float8 leaf widened to float32)."""
    out = {}
    for k, v in {**cache.get("layers", {}), **cache}.items():
        if k == "layers":
            continue
        if v.is_floating_point() and v.element_size() == 1:
            v = v.float()
        out[k] = v.cpu().numpy().copy()
    return out


def whole_cache(model, cache, layout, rows_split):
    """A serving cache across ranks gathered whole (every rank must call
    it), as numpy (``cache_arrays``): k and v over their slots where
    ``slot_split`` cut them, the SSM state's heads and the conv caches'
    columns where the SSM splits, whisper's xk and xv heads where the
    heads split, then every per-row leaf over the batch's ranks where
    the rows split (``rows_split``)."""
    from repro_torch.models.transformer import slot_split, splits
    mesh = layout.mesh
    plan = splits(layout, model.cfg, model.opts).plan
    ssp = (slot_split(layout, cache["slot_pos"].shape[0])
           if "slot_pos" in cache else None)
    whole = {}
    for k, v in {**cache.get("layers", {}), **cache}.items():
        if k in ("layers", "pos", "slot_pos"):
            continue
        if k in ("k", "v") and ssp is not None:
            v = _gather_dim(v, 2, mesh, ("model",))
        if plan is not None and plan.ssm and k in ("ssm", "conv_x", "conv_b",
                                                   "conv_c"):
            v = _gather_dim(v, 2 if k == "ssm" else 3, mesh, ("model",))
        if plan is not None and plan.attn and k in ("xk", "xv"):
            v = _gather_dim(v, 3, mesh, ("model",))
        if rows_split:
            v = _gather_dim(v, 1, mesh, layout.batch_axes)
        whole[k] = v
    for k in ("pos", "slot_pos"):
        if k in cache:
            whole[k] = cache[k]
    return cache_arrays(whole)


def serve_steps(case, device="cpu"):
    """``case``: ``arch``, ``opts``, ``mesh`` (over ``("data", "model")``
    unless ``names``), ``params`` (whole, numpy), ``batch`` (the global
    prefill batch, numpy), ``cache_len``, ``steps`` (decode steps), and
    optionally ``cfg``. The prefill and ``steps`` decode steps across
    ranks (``make_prefill_step`` / ``make_decode_step`` with the mesh):
    each step's tokens and logits (whole, every rank), the whole cache
    after the prefill and after the last step (rank 0), each step's
    bytes, and the heads the kernels saw."""
    from repro_torch.convert import params_from_arrays
    from repro_torch.distribution import sharding as shd
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd as SSD
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    model, mesh = train_setup(case["arch"], case["opts"], case["mesh"],
                              case.get("names", ("data", "model")), device,
                              case.get("cfg"))
    params = shd.shard_tree(params_from_arrays(case["params"], "cpu"),
                            model.param_shardings(mesh))
    n_rows = len(next(iter(case["batch"].values())))
    rows, split = serve_rows(model, mesh, n_rows)
    batch = {k: torch.as_tensor(v[rows], device=mesh.device)
             for k, v in case["batch"].items()}
    prefill = make_prefill_step(model, mesh, logits=True)
    decode = make_decode_step(model, mesh, logits=True)
    axes = model.batch_axes(mesh)
    FA.LAUNCHES = SSD.LAUNCHES = 0

    def whole(x):
        return (_gather_dim(x, 0, mesh, axes) if split else x).cpu().numpy()
    steps = []
    with heads_seen() as seen:
        tok, cache, lg = prefill(params, batch, cache_len=case["cache_len"])
        steps.append({"tokens": whole(tok), "logits": whole(lg)})
        caches = [whole_cache(model, cache, prefill.layout, split)]
        for _ in range(case["steps"]):
            tok, cache, lg = decode(params, cache, tok)
            steps.append({"tokens": whole(tok), "logits": whole(lg)})
    caches.append(whole_cache(model, cache, decode.layout, split))
    return {"steps": steps, "caches": caches if mesh.rank == 0 else None,
            "bytes": {"prefill": dict(prefill.layout.bytes),
                      "decode": dict(decode.layout.bytes)},
            "heads": sorted(set(seen)),
            "launches": {"k3": FA.LAUNCHES, "k4": SSD.LAUNCHES}}


def plain_serve(case, device="cpu"):
    """``serve_steps``' steps without a mesh, on this rank's device:
    each step's tokens and logits, the caches after the prefill and
    after the last step (numpy)."""
    from repro_torch.convert import params_from_arrays
    model = reduced_model(case["arch"], case["opts"], case.get("cfg"))
    params = params_from_arrays(case["params"], device)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in case["batch"].items()}
    tok, cache, lg = model.prefill(params, batch,
                                   cache_len=case["cache_len"], logits=True)
    steps = [{"tokens": tok.cpu().numpy(), "logits": lg.cpu().numpy()}]
    caches = [cache_arrays(cache)]
    for _ in range(case["steps"]):
        tok, cache, lg = model.decode_step(params, cache, tok, logits=True)
        steps.append({"tokens": tok.cpu().numpy(),
                      "logits": lg.cpu().numpy()})
    caches.append(cache_arrays(cache))
    return {"steps": steps, "caches": caches}


def decode_with_and_without(case, device="cpu"):
    """``case`` as ``serve_steps``'. A prefill across ranks without
    ``seq_shard_activations``, then one decode step from a copy of its
    cache by the model with the flag and by the model without it: each
    one's token, logits (whole), cache (whole, rank 0) and bytes."""
    import dataclasses
    from repro_torch.convert import params_from_arrays
    from repro_torch.distribution import sharding as shd
    from repro_torch.models.model import Model
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    model, mesh = train_setup(case["arch"], case["opts"], case["mesh"],
                              device=device, cfg=case.get("cfg"))
    params = shd.shard_tree(params_from_arrays(case["params"], "cpu"),
                            model.param_shardings(mesh))
    rows, split = serve_rows(model, mesh, len(case["batch"]["tokens"]))
    batch = {k: torch.as_tensor(v[rows], device=mesh.device)
             for k, v in case["batch"].items()}
    tok, cache = make_prefill_step(model, mesh)(params, batch,
                                                cache_len=case["cache_len"])
    out = {}
    for seq in (False, True):
        m = Model(model.cfg, dataclasses.replace(
            model.opts, seq_shard_activations=seq))
        step = make_decode_step(m, mesh, logits=True)
        c = {k: ({j: x.clone() for j, x in v.items()} if isinstance(v, dict)
                 else v.clone()) for k, v in cache.items()}
        t, c, lg = step(params, c, tok)
        out[seq] = {"token": t.cpu().numpy(), "logits": lg.cpu().numpy(),
                    "cache": whole_cache(m, c, step.layout, split),
                    "bytes": dict(step.layout.bytes)}
    return out


def rank_serve(rank, world, *, cases):
    """``serve_steps`` of every case (and, with the case's ``plain``,
    ``plain_serve`` in this rank), or where the case says ``pair``,
    ``decode_with_and_without``."""
    return [decode_with_and_without(c) if c.get("pair") else
            {**serve_steps(c), **({"plain": plain_serve(c)}
                                  if c.get("plain") else {})}
            for c in cases]


def rank_serve_card(rank, world, *, cases):
    """``serve_steps`` of every case on this rank's card over NCCL."""
    return [serve_steps(c, device=None) for c in cases]


def rank_serve_cli(rank, world):
    """``launch.serve.serve`` of the reduced qwen1.5-0.5b over a (world /
    2, 2) mesh (params from ``init_params(..., mesh=)``, seed 0), and
    without a mesh in this rank on the same draws: both runs' outputs
    and the mesh run's ``per_step_bytes``."""
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import per_step_bytes, serve
    from repro_torch.runtime.steps import init_params
    model = reduced_model("qwen1.5-0.5b", dict(
        remat="none", layer_loop="scan", compute_dtype="float32",
        q_chunk=16, kv_chunk=16))
    kw = dict(requests=8, batch=4, prompt_len=12, gen=4, log=lambda s: None)
    corpus = SyntheticCorpus(model.cfg.vocab, 0)
    mesh = make_host_mesh(2, "cpu")
    stats = serve(model, init_params(model, torch.Generator().manual_seed(0),
                                     mesh=mesh), corpus, mesh=mesh, **kw)
    plain = serve(model, init_params(model, torch.Generator().manual_seed(0),
                                     "cpu"), corpus, **kw)
    return {"outputs": stats["outputs"], "plain": plain["outputs"],
            "per": per_step_bytes(stats, 2, 4)}


def rank_step_bytes(rank, world, *, cases):
    """For each case (``arch``, ``opts``, ``mesh``, ``shapes``: the
    ``ShapeSpec`` of a ``"train"``, a ``"prefill"`` and a ``"decode"``
    step), the bytes one sharded step of each kind counts on this rank
    (``StepLayout.bytes``): a train step, a prefill of the shape's
    batch, and one decode step against a cache of the decode shape's
    length (filled by a prefill of half of it)."""
    from repro_torch.runtime.steps import (init_train_state, make_decode_step,
                                           make_prefill_step, make_train_step)
    out = []
    for case in cases:
        model, mesh = train_setup(case["arch"], case["opts"], case["mesh"])
        state = init_train_state(model, torch.Generator().manual_seed(0),
                                 "cpu", mesh)
        rng = np.random.default_rng(0)
        res = {}
        for kind, shape in case["shapes"].items():
            B, S = shape.global_batch, shape.seq_len
            prompt = S // 2 if kind == "decode" else S
            toks = rng.integers(0, model.cfg.vocab, (B, prompt)).astype(
                np.int32)
            batch = my_rows(model, mesh, {"tokens": toks})
            if kind == "train":
                step = make_train_step(model, mesh=mesh)
                step(state, batch)
            elif kind == "prefill":
                step = make_prefill_step(model, mesh)
                step(state["params"], batch)
            else:
                tok, cache = make_prefill_step(model, mesh)(
                    state["params"], batch, cache_len=S)
                step = make_decode_step(model, mesh)
                step(state["params"], cache, tok)
            res[kind] = dict(step.layout.bytes)
        out.append(res)
    return out
