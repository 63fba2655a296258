"""The Transform stage against the reference on the CPU:
``BackboneVETL`` (``core/vetl_serving.py``) and the single-stream
``Skyscraper`` (``core/api.py``), with the reference's three backbones'
params carried across (``convert.backbone_from_arrays``).

- ``proc_fn`` qualities for every knob configuration of
  ``examples/serve_vetl.py`` (sampling 1/2/4, resolution 1/2, model size
  small/medium/large), and ``proc_batch`` on a mixed batch of streams;
- ``Skyscraper.fit`` with the clock pinned: both modules read a fake
  ``time.perf_counter`` that each ``proc_fn`` call advances by a fixed
  cost of its knobs, so the profiled runtimes, the Pareto-kept configs
  and their costs are equal, and the categories' centers agree;
- ``Skyscraper.process`` over 60 segments with the reference's fitted
  state (configs, cost, power, centers, forecaster) carried across
  (``convert.fitted_skyscraper``), replanning every 25 segments: the
  (k, category) trace exactly, qualities and buffer seconds within
  1e-5, and the plans bit for bit.

Segments are the example's (8, 32, 32, 3) float32 frames with (8, 16)
tokens from numpy seeds. Tolerance 1e-5 on qualities (mean top-1
probabilities of float32 forwards summed in other orders) and centers.
"""
import itertools

import jax
import numpy as np
import pytest

from repro.core import api as RA
from repro.core.vetl_serving import BackboneVETL as RefJob
from repro_torch.convert import backbone_from_arrays, fitted_skyscraper
from repro_torch.core import api as PA
from repro_torch.core.vetl_serving import SIZES, BackboneVETL
from _torch_threads import cap_torch_threads

cap_torch_threads()

KNOBS = {"sample_every": (1, 2, 4), "resolution": (1, 2),
         "model_size": ("small", "medium", "large")}
CONFIGS = [dict(zip(KNOBS, v)) for v in itertools.product(*KNOBS.values())]
TOL = 1e-5


def _segments(n, seed):
    rng = np.random.default_rng(seed)
    return [{"frames": rng.normal(0, 1, (8, 32, 32, 3)).astype(np.float32),
             "tokens": rng.integers(0, 200, (8, 16))} for _ in range(n)]


@pytest.fixture(scope="module")
def jobs():
    ref = RefJob(arch="qwen1.5-0.5b")
    port = BackboneVETL(arch="qwen1.5-0.5b", device="cpu")
    backbone_from_arrays(port, {name: jax.tree.map(np.asarray, params)
                                for name, (_, params) in ref.models.items()},
                         device="cpu")
    return ref, port


def test_backbone_sizes_match(jobs):
    ref, port = jobs
    assert set(port.models) == set(SIZES) == set(ref.models)
    for name in SIZES:
        rc, pc = ref.models[name][0].cfg, port.models[name][0].cfg
        assert (pc.n_layers, pc.d_model, pc.n_heads, pc.n_kv_heads, pc.d_ff,
                pc.hd, pc.vocab) == (rc.n_layers, rc.d_model, rc.n_heads,
                                     rc.n_kv_heads, rc.d_ff, rc.hd, rc.vocab)


@pytest.mark.parametrize("knobs", CONFIGS,
                         ids=lambda kv: "-".join(map(str, kv.values())))
def test_proc_fn_quality_matches(jobs, knobs):
    ref, port = jobs
    for seg in _segments(2, 3):
        r_out, r_q = ref.proc_fn(seg, knobs)
        p_out, p_q = port.proc_fn(seg, knobs)
        assert p_out == r_out
        assert abs(p_q - r_q) <= TOL


def test_proc_batch_matches(jobs):
    ref, port = jobs
    segs = _segments(6, 4)
    knob_list = [CONFIGS[i] for i in (0, 5, 0, 17, 5, 9)]
    r_res, r_q = ref.proc_batch(segs, knob_list)
    p_res, p_q = port.proc_batch(segs, knob_list)
    assert p_res == r_res
    np.testing.assert_allclose(p_q, r_q, rtol=0, atol=TOL)


class _Clock:
    """A pinned ``time`` module: ``perf_counter`` reads a counter that
    the wrapped ``proc_fn`` advances by a fixed cost of its knobs."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def wrap(self, proc_fn):
        def timed(seg, kv):
            size = {"small": 1, "medium": 2, "large": 3}[kv["model_size"]]
            self.now += (1e-3 * size / kv["sample_every"]
                         * (1.25 if kv["resolution"] == 1 else 1.0))
            return proc_fn(seg, kv)
        return timed


def _handle(cls, **kw):
    sky = cls(segment_seconds=1.0, n_categories=3, **kw)
    sky.set_resources(num_cores=2, buffer_gb=0.5)
    for name, domain in KNOBS.items():
        sky.register_knob(name, domain)
    return sky


@pytest.fixture(scope="module")
def fits(jobs):
    ref_job, port_job = jobs
    mp = pytest.MonkeyPatch()
    clocks = _Clock(), _Clock()
    mp.setattr(RA, "time", clocks[0])
    mp.setattr(PA, "time", clocks[1])
    try:
        unlabeled = _segments(40, 1)
        ref = _handle(RA.Skyscraper).fit(
            unlabeled, clocks[0].wrap(ref_job.proc_fn), plan_segments=25)
        port = _handle(PA.Skyscraper, device="cpu").fit(
            unlabeled, clocks[1].wrap(port_job.proc_fn), plan_segments=25)
    finally:
        mp.undo()
    return ref, port


def test_fit_with_pinned_clock_matches(fits):
    ref, port = fits
    assert port.configs == ref.configs
    np.testing.assert_array_equal(port.cost, ref.cost)
    np.testing.assert_allclose(port.centers, ref.centers, rtol=0, atol=TOL)
    np.testing.assert_allclose(port.tables.power.numpy(),
                               np.asarray(ref.tables.power), rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(port.tables.rank_pos.numpy(),
                                  np.asarray(ref.tables.rank_pos))
    assert (port.n_split, port.interval) == (ref.n_split, ref.interval)


def test_process_traces_match(jobs, fits):
    ref_job, port_job = jobs
    ref, _ = fits
    ref.proc_fn = ref_job.proc_fn
    port = fitted_skyscraper(_handle(PA.Skyscraper, device="cpu"), {
        "configs": ref.configs, "cost": ref.cost,
        "power": np.asarray(ref.tables.power), "centers": ref.centers,
        "forecaster": jax.tree.map(np.asarray, ref.forecaster),
        "n_split": ref.n_split, "interval": ref.interval},
        port_job.proc_fn, plan_segments=25)
    np.testing.assert_array_equal(port.alpha.numpy(), np.asarray(ref.alpha))
    trace = {"k": [], "category": [], "quality": [], "buffer_s": []}
    for t, seg in enumerate(_segments(60, 2)):
        r_info, r_out = ref.process(seg)
        p_info, p_out = port.process(seg)
        assert p_out == r_out and p_info["config"] == r_info["config"]
        for key in trace:
            trace[key].append((p_info[key], r_info[key]))
        if t in (24, 49):          # right after each replan
            np.testing.assert_array_equal(port.alpha.numpy(),
                                          np.asarray(ref.alpha))
    for key in ("k", "category"):
        got, want = zip(*trace[key])
        assert list(got) == list(want), key
    for key in ("quality", "buffer_s"):
        got, want = zip(*trace[key])
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=key)
    assert len(set(k for k, _ in trace["k"])) > 1, "the knobs must switch"
