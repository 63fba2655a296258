"""The port's warehouse spread over ranks (``ShardedStore(...,
group=)``, ``launch.mesh``) against the port's stacked store and the
reference's ``ShardedStore``, on the CPU.

Worlds of 2 and 4 gloo ranks (``tests/_torch_dist.py``: spawned under a
deadline, a ``file://`` store, one torch thread a rank) hold 8 shards,
4 and 2 a rank. Every rank runs ``_torch_dist.scenario``: the op log
(every kind of ingest: rows, a single- and a multi-stream fused run,
pool ticks plain and masked) with a registry attached after its first
op, then queries, a compressed merge, ``rebalance`` 8 -> 4 -> 8 (and
onto half the ranks), a ``ShardedTieredStore`` spill with its own
draws and one with the reference's. The test process runs the same
scenario on the stacked store (``group=None``) and replays the op log
on the reference's stacked store (``mesh=None``, whose semantics are
its mesh path's: tests/test_sharded_warehouse.py:1-10).

- Against the stacked store, on every rank, bit for bit: every stored
  row, the per-shard counts, the capacity, ``t_max`` and the flight
  recorder; every plan's answer on both of the port's paths (float
  sums included: each shard's partial is computed on its rank as on the
  stacked store and the merge adds the gathered partials in shard
  order); a row TopK's global row ids; the surviving rows of a row
  plan (``to_host``; a group's row plan returns only those); the
  compressed merge at a seed and with given draws; every standing
  answer (engine and K1 paths) and the alerts; the rebalanced stores;
  the tiers' cold codes, scales and integer columns (the ranks' blocks
  in rank order), their views' answers and ``max_cold_scale``.
- Against the reference, where ``tests/test_torch_sharded.py`` and
  ``tests/test_torch_sharded_tiers.py`` hold the stacked store to it,
  at their tolerances (bit for bit): rows, counts and capacity, every
  plan, the compressed merge given the reference's draws, the standing
  answers on the engine path and the alerts, ``rebalance``'s rows, and
  the tier spilled with the reference's draws.
- The refusals: a shard count the group does not divide, a backend that
  does not fit the store's device, a ``rebalance`` onto such a count;
  and a broken rank (one that raises, one that skips a collective)
  fails its world within the deadline instead of hanging it.
"""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist as TD
import repro.warehouse as RW
from _torch_parity import ref_plan
from repro.runtime.elastic import rebalance as ref_rebalance
from _torch_threads import cap_torch_threads

cap_torch_threads()

WORLDS = (2, 4)
same = TD.same


def _ref_draws(n_shards, shape, seed=0):
    """The reference's compressed-merge uniforms (its default key)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_shards)
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(keys))


class _Recorded:
    """The reference tier's draws for one spill (tests/
    test_torch_sharded_tiers.py's ``_ref_draws``), each column's kept so
    the ranks can be given the same uniforms as a table."""

    def __init__(self, seed, spills, n_shards):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), spills)
        self.keys = jax.random.split(key, n_shards)
        self.table = {}

    def __call__(self, name, S, n_chunks, width):
        out = [jax.vmap(lambda k: jax.random.uniform(k, (width,)))(
            jax.random.split(k, n_chunks)) for k in self.keys]
        self.table[name] = torch.tensor(np.stack([np.asarray(o)
                                                  for o in out]))
        return self.table[name]


@functools.lru_cache(maxsize=None)
def _stacked():
    """The scenario on the port's stacked store, and the inputs the
    worlds need: the reference's draws for the compressed merge and
    the uniforms the reference tier drew."""
    ops = TD.op_log()
    cdraws = [_ref_draws(TD.SHARDS, shape) for _, shape in TD.COMPRESSED]
    rec = [_Recorded(7, i, TD.SHARDS) for i in range(2)]
    res = TD.scenario(None, ops, compressed_draws=cdraws, tier_draws=rec)
    tdraws = [TD.TableDraws(r.table) for r in rec]
    return ops, cdraws, tdraws, res


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's per-rank results and wall seconds."""
    ops, cdraws, tdraws, _ = _stacked()
    return {w: TD.run_world(TD.rank_scenario, w,
                            tmp_path_factory.mktemp(f"world{w}"), ops=ops,
                            compressed_draws=cdraws, tier_draws=tdraws)
            for w in WORLDS}


@functools.lru_cache(maxsize=None)
def _reference():
    """The op log on the reference's stacked store, its registry
    attached after the first op as ``_torch_dist.fill`` attaches the
    port's (the K1-path plan left out)."""
    ops = TD.op_log()
    store = RW.ShardedStore(out_dim=TD.D, n_shards=TD.SHARDS, chunk_rows=64,
                            mesh=None)
    TD.apply(store, ops[0], jnp.asarray)
    reg = RW.StandingQueries(store)
    handles = [reg.register(ref_plan(p)) for p in TD.STANDING]
    reg.subscribe(ref_plan(TD.SUB[0]), ref_plan((TD.SUB[1],))[0],
                  name="buffer-watch")
    for op in ops[1:]:
        TD.apply(store, op, jnp.asarray)
    return store, reg, handles


def _ref_answer(plan, answer):
    table, mask = answer
    table = {k: np.asarray(v) for k, v in table.items()}
    mask = np.asarray(mask)
    if TD.is_row_plan(plan):
        return {k: v[mask] for k, v in table.items()}
    return {**table, "__mask__": mask}


def _ranks(worlds, w):
    results, _ = worlds[w]
    return results


# ---------------------------------------------------------------------------
# the group, the refusals, a broken rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", WORLDS)
def test_each_rank_holds_its_block_and_refuses_what_does_not_fit(worlds, w):
    k = TD.SHARDS // w
    for r, res in enumerate(_ranks(worlds, w)):
        assert res["shards"] == range(r * k, (r + 1) * k)
        err = res["errors"]
        assert err["shards"] == (f"{w + 1} shards do not split over a "
                                 f"group of {w} ranks")
        assert err["backend"] == ("a store on cuda needs a nccl group; "
                                  "this group's backend is gloo")
        assert err["rebalance"] == err["shards"]
    # the whole world, spawn to results, well inside the suite's budget
    assert worlds[w][1] < 60


@pytest.mark.parametrize("how", ("raise", "skip"))
def test_a_broken_rank_fails_its_world_within_the_deadline(tmp_path, how):
    t0 = time.monotonic()
    with pytest.raises(mp.ProcessRaisedException) as err:
        TD.run_world(TD.rank_fails, 2, tmp_path, deadline=90, timeout_s=5,
                     how=how, wait=120)
    assert time.monotonic() - t0 < 60
    if how == "raise" and err.value.error_index == 1:
        # else rank 0 saw its peer's connection close first and raised
        assert "rank 1 fails on purpose" in str(err.value)


# ---------------------------------------------------------------------------
# against the stacked store, bit for bit, on every rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("case", ("rows", "counts", "capacity", "t_max",
                                  "telemetry"))
def test_rows_and_counts_equal_the_stacked_store(worlds, w, case):
    want = _stacked()[3]["main"][case]
    for res in _ranks(worlds, w):
        same(res["main"][case], want, case)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("i", range(14))
def test_plans_equal_the_stacked_store(worlds, w, i):
    """Plan i on both paths: aggregations (float sums too), TopK row ids,
    the surviving rows of row plans."""
    want = _stacked()[3]["main"]
    for res in _ranks(worlds, w):
        for uk in (False, None):
            same(res["main"][f"plan{i}/{uk}"], want[f"plan{i}/{uk}"],
                 (i, uk))


@pytest.mark.parametrize("w", WORLDS)
def test_compressed_merge_equals_the_stacked_store(worlds, w):
    want = _stacked()[3]
    keys = [k for k in want if k.startswith("compressed")]
    assert len(keys) == 6
    for res in _ranks(worlds, w):
        for k in keys:
            same(res[k], want[k], k)


@pytest.mark.parametrize("w", WORLDS)
def test_standing_answers_and_alerts_equal_the_stacked_store(worlds, w):
    want = _stacked()[3]["main"]
    keys = [k for k in want if k.startswith("standing")] + ["alerts"]
    assert len(keys) == 6
    for res in _ranks(worlds, w):
        for k in keys:
            same(res["main"][k], want[k], k)
    (name, fired, _), = want["alerts"]
    assert name == "buffer-watch" and 0 < fired.sum() < len(fired)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("to", ("rebalance4", "rebalance8"))
def test_rebalance_equals_the_stacked_store(worlds, w, to):
    """Rows, counts, capacity, every plan and the replayed registry."""
    want = _stacked()[3][to]
    for res in _ranks(worlds, w):
        same(res[to], want, to)


@pytest.mark.parametrize("w", WORLDS)
def test_rebalance_onto_half_the_ranks(worlds, w):
    want = _stacked()[3]["rebalance4"]
    k = 4 // (w // 2)
    for r, res in enumerate(_ranks(worlds, w)):
        half = res["rebalance_half"]
        if r >= w // 2:
            assert half is None
            continue
        assert half["shards"] == range(r * k, (r + 1) * k)
        for case in ("rows", "counts", "capacity"):
            same(half[case], want[case], case)


@pytest.mark.parametrize("w", WORLDS)
def test_tier_with_its_own_draws_equals_the_stacked_tier(worlds, w):
    """The per-shard generators on each rank draw what the stacked tier
    draws: the codes, scales, integer columns and compacted hot columns
    bit for bit; the view's answers; the spill leaves the standing
    answers as they were."""
    want = _stacked()[3]
    ranks = _ranks(worlds, w)
    same(TD.cat_ranks([r["tier_local"] for r in ranks]), want["tier_local"])
    assert want["spilled"] > 0
    for res in ranks:
        same(res["spilled"], want["spilled"])
        same(res["tier"], want["tier"], "tier")
        same(res["tier"]["standing"],
             [want["main"][f"standing{h}"] for h in range(5)])


@pytest.mark.parametrize("w", WORLDS)
def test_tier_with_the_reference_draws_equals_the_stacked_tier(worlds, w):
    want = _stacked()[3]["ref_tier"]
    ranks = _ranks(worlds, w)
    same(TD.cat_ranks([r["ref_tier"]["local"] for r in ranks]), want["local"])
    for res in ranks:
        got = {k: v for k, v in res["ref_tier"].items() if k != "local"}
        same(got, {k: v for k, v in want.items() if k != "local"})


# ---------------------------------------------------------------------------
# against the reference's ShardedStore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", WORLDS)
def test_rows_equal_the_reference(worlds, w):
    rstore = _reference()[0]
    rr = rstore.host_rows()
    for res in _ranks(worlds, w):
        main = res["main"]
        assert main["capacity"] == rstore.capacity
        same(main["counts"], np.asarray(rstore.n_rows_by_shard))
        for k in rr:
            same(main["rows"][k], np.asarray(rr[k]), k)


@pytest.mark.parametrize("w", WORLDS)
def test_plans_equal_the_reference(worlds, w):
    rstore = _reference()[0]
    nw = int(rstore.t_max) // 250 + 1
    for i, plan in enumerate(TD.plans(nw)):
        want = _ref_answer(plan, rstore.query(ref_plan(plan)))
        for res in _ranks(worlds, w):
            for uk in (False, None):
                same(res["main"][f"plan{i}/{uk}"], want, (i, uk))


@pytest.mark.parametrize("w", WORLDS)
def test_compressed_merge_equals_the_reference_given_its_draws(worlds, w):
    rstore = _reference()[0]
    for i, (plan, _) in enumerate(TD.COMPRESSED):
        want = _ref_answer(plan, rstore.query(ref_plan(plan),
                                              compressed=True))
        for res in _ranks(worlds, w):
            for uk in (False, None):
                same(res[f"compressed{i}/ref/{uk}"], want, (i, uk))


@pytest.mark.parametrize("w", WORLDS)
def test_standing_answers_and_alerts_equal_the_reference(worlds, w):
    """The engine-path registrations bit for bit; the alert's mask."""
    _, reg, handles = _reference()
    ralerts = reg.poll()
    for res in _ranks(worlds, w):
        for h, rh in enumerate(handles):
            same(res["main"][f"standing{h}"],
                 _ref_answer(TD.STANDING[h], reg.answer(rh)), h)
        (name, fired, _), = res["main"]["alerts"]
        assert name == ralerts[0].name
        same(fired, np.asarray(ralerts[0].fired))


@pytest.mark.parametrize("w", WORLDS)
def test_rebalance_rows_equal_the_reference(worlds, w):
    rstore = _reference()[0]
    four = ref_rebalance(rstore, 4, mesh=None)
    eight = ref_rebalance(four, 8, mesh=None)
    for res in _ranks(worlds, w):
        for key, ref in (("rebalance4", four), ("rebalance8", eight)):
            got = res[key]
            assert got["capacity"] == ref.capacity
            same(got["counts"], np.asarray(ref.n_rows_by_shard))
            rr = ref.host_rows()
            for k in rr:
                same(got["rows"][k], np.asarray(rr[k]), (key, k))


@pytest.mark.parametrize("w", WORLDS)
def test_tier_equals_the_reference_given_its_draws(worlds, w):
    """tests/test_torch_sharded_tiers.py's ragged case, spread over the
    ranks: every array of the tier and the view's answers."""
    rhot = RW.ShardedStore(out_dim=2, n_shards=TD.SHARDS,
                           chunk_rows=TD.TIER_CHUNK, mesh=None)
    rt = RW.ShardedTieredStore(rhot, seed=7)
    a, b = TD.tier_rows()
    rhot.append_rows(a)
    spills = [rt.spill(64)]
    rhot.append_rows(b)
    spills.append(rt.spill(32))
    nw = int(rt.t_max) // 256 + 1
    want = [_ref_answer(p, rt.query(ref_plan(p)))
            for p in TD.tier_plans(nw) for _ in (False, None)]
    ranks = _ranks(worlds, w)
    got = TD.cat_ranks([r["ref_tier"]["local"] for r in ranks])
    same(got["n_cold_by_shard"], np.asarray(rt.n_cold_by_shard))
    for part, theirs in (("cold_q", rt.cold_q), ("cold_scales",
                                                 rt.cold_scales),
                         ("cold_int", rt.cold_int), ("hot", rhot.columns)):
        for k in theirs:
            same(got[part][k], np.asarray(theirs[k]), (part, k))
    for res in ranks:
        assert [res["ref_tier"]["spill0"], res["ref_tier"]["spill1"]] \
            == spills
        for i, wa in enumerate(want):
            same(res["ref_tier"]["answers"][i], wa, i)
