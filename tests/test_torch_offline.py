"""The port's offline phase against the reference (``repro.core.offline``
and the modules it drives), on the CPU.

- ``fit``: configs, power, cost and the placement tables are the same
  numpy computation on both sides, so they are compared exactly; the
  KMeans centers (torch vs jax Lloyd steps) to 1e-6 with the same
  assignment;
- the forecaster with the reference's params carried across:
  ``forecast`` and ``forecast_from_labels`` to 1e-6 (the port evaluates
  the online forecast in float64, one float32 rounding from the
  reference), and ``train_forecaster`` from the same init for 3 epochs
  to 1e-5 (the same hand-written Adam, gradients from autograd instead
  of ``jax.grad``, so float32 sums round in another order);
- the copied workload configs equal the reference's field by field.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_fitted, ref_fitted
from repro.configs import workloads as RWL
from repro.core import categories as RC
from repro.core import forecaster as RF
from repro.core import knobs as RK
from repro.data import stream as RD
from repro_torch.configs import workloads as PWL
from repro_torch.convert import forecaster_from_arrays
from repro_torch.core import categories as PC
from repro_torch.core import forecaster as PF
from repro_torch.core import knobs as PK
from repro_torch.core.offline import fit
from repro_torch.data import stream as PD
from _torch_threads import cap_torch_threads

cap_torch_threads()


@functools.lru_cache(maxsize=None)
def _port_fit():
    return fit(PWL.COVID, n_cores=8, days_unlabeled=2.0, seed=0,
               device="cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", sorted(RWL.WORKLOADS))
def test_workload_copy_equals_reference(name):
    ref, got = RWL.WORKLOADS[name], PWL.WORKLOADS[name]
    assert sorted(PWL.WORKLOADS) == sorted(RWL.WORKLOADS)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert PK.enumerate_configs(got) == RK.enumerate_configs(ref)


def test_stream_copy_is_identical():
    ref = RD.generate(RWL.COVID, days=0.2, seed=5)
    got = PD.generate(PWL.COVID, days=0.2, seed=5)
    np.testing.assert_array_equal(got.difficulty, ref.difficulty)
    np.testing.assert_array_equal(got.arrival, ref.arrival)
    power = np.linspace(0.3, 1.0, 6).astype(np.float32)
    np.testing.assert_array_equal(got.quality(power, seed=2),
                                  ref.quality(power, seed=2))


def test_fit_tables_exact():
    ref, got = ref_fitted(), _port_fit()
    assert got.configs == ref.configs
    for k in ("power", "cost", "place_rt", "place_on", "place_cl",
              "place_valid"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                      err_msg=k)
    for k in ("n_split", "interval_segments", "horizon_segments",
              "n_cores"):
        assert getattr(got, k) == getattr(ref, k), k
    np.testing.assert_allclose(got.centers, ref.centers, rtol=0, atol=1e-6)


def test_kmeans_matches_reference():
    rng = np.random.default_rng(11)
    Q = np.concatenate([rng.normal(m, 0.05, (150, 5))
                        for m in (0.2, 0.5, 0.8)]).astype(np.float32)
    rc, ra = RC.kmeans(Q, 3, seed=4)
    pc, pa = PC.kmeans(Q, 3, seed=4, device="cpu")
    np.testing.assert_allclose(pc.numpy(), np.asarray(rc), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))


def test_classifiers_match_reference():
    f = ref_fitted()
    centers = f.centers
    rng = np.random.default_rng(2)
    for _ in range(20):
        vec = rng.random(centers.shape[1]).astype(np.float32)
        k = int(rng.integers(centers.shape[1]))
        q = np.float32(rng.random())
        assert int(PC.classify_full(torch.tensor(vec),
                                    torch.tensor(centers))) == \
            int(RC.classify_full(jnp.asarray(vec), jnp.asarray(centers)))
        assert int(PC.classify_1d(torch.tensor(q), k,
                                  torch.tensor(centers))) == \
            int(RC.classify_1d(jnp.asarray(q), k, jnp.asarray(centers)))


def test_forecast_with_carried_params():
    f = ref_fitted()
    params = forecaster_from_arrays(_np_tree(f.forecaster), device="cpu")
    C, S, I = f.centers.shape[0], f.n_split, f.interval_segments
    rng = np.random.default_rng(9)
    hist = rng.dirichlet(np.ones(C), (5, S)).astype(np.float32)
    want = np.asarray(RF.forecast(f.forecaster, jnp.asarray(hist)))
    got = PF.forecast(params, torch.tensor(hist)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for seed in range(4):
        buf = np.random.default_rng(seed).integers(0, C, S * I)
        buf = buf.astype(np.int32)
        want = np.asarray(RF.forecast_from_labels(
            f.forecaster, jnp.asarray(buf), C, n_split=S, interval=I))
        got = PF.forecast_from_labels(params, torch.tensor(buf), C,
                                      n_split=S, interval=I)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_make_dataset_is_the_reference():
    labels = np.random.default_rng(3).integers(0, 4, 3000)
    want = RF.make_dataset(labels, 4, interval=40, n_split=8, horizon=300)
    got = PF.make_dataset(labels, 4, interval=40, n_split=8, horizon=300)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_train_forecaster_from_same_init():
    f = ref_fitted()
    C, S = f.centers.shape[0], f.n_split
    labels = np.random.default_rng(5).integers(0, C, 6000)
    X, Y = RF.make_dataset(labels, C, interval=60, n_split=S, horizon=400)
    init = RF.init_forecaster(jax.random.PRNGKey(7), S, C)
    want, wm = RF.train_forecaster(init, X, Y, epochs=3)
    got, gm = PF.train_forecaster(
        forecaster_from_arrays(_np_tree(init), device="cpu"), X, Y,
        epochs=3)
    for layer in want:
        for p in ("w", "b"):
            np.testing.assert_allclose(got[layer][p].numpy(),
                                       np.asarray(want[layer][p]), rtol=0,
                                       atol=1e-5, err_msg=f"{layer}.{p}")
    assert gm["val_mse"] == pytest.approx(wm["val_mse"], abs=1e-5)


def test_fit_forecaster_trains_and_forecasts():
    """The port's own fit: its forecaster (a torch-drawn init, so its
    weights differ from the reference's) trains to a loss of the same
    order and gives distributions."""
    got, ref = _port_fit(), ref_fitted()
    assert got.forecast_metrics["val_mse"] <= \
        2.0 * ref.forecast_metrics["val_mse"] + 0.05
    C, S, I = got.centers.shape[0], got.n_split, got.interval_segments
    r = PF.forecast_from_labels(got.forecaster,
                                torch.zeros(S * I, dtype=torch.int64), C,
                                n_split=S, interval=I)
    assert r.shape == (C,) and abs(float(r.sum()) - 1.0) < 1e-5


def test_port_fitted_tables_on_cpu():
    t = port_fitted().tables(buffer_gb=4.0, cloud_budget=10.0)
    assert t.centers.device.type == "cpu"
    assert t.rank_pos.dtype == torch.int64
    ref = ref_fitted()
    np.testing.assert_array_equal(
        t.rank_pos.numpy(), np.argsort(np.argsort(-ref.power)))
