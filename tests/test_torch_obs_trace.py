"""The port's dispatch tracer (``repro_torch.obs``) on the CPU: span
records and Chrome-trace output, the report's regression gates
(ceilings, host-class-gated span floors, topology skips, disappearing
engines), the driver, and parity with the reference's ``repro.obs``:

- the port's engines are the 54 of the committed ``OBS.json`` (and of
  the reference's ``traceable_engine_names()``), none skipped;
- ``compare`` returns the reference's list on every synthetic report;
- ``validate_chrome_trace`` returns the reference's problems;
- importing ``repro_torch.obs.__main__`` runs nothing; the CLI without
  ``--device`` raises where no card is visible.

The host-synchronisation counter needs the card: ``test_torch_cuda.py``.
"""
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import cap_torch_threads
from repro.obs import run as R_RUN
from repro.obs import trace as R_TRACE
from repro_torch.obs import engines as E
from repro_torch.obs import traceable_engine_names, validate_chrome_trace
from repro_torch.obs.run import (SPAN_FLOOR_US, SPAN_GROWTH, _CEILINGS,
                                 compare, main, run_obs)
from repro_torch.obs.trace import SpanRecorder, trace_all, trace_engine

cap_torch_threads()

ROOT = Path(__file__).resolve().parents[1]
SKIPPED = {}        # engine -> reason: the port has a counterpart of each
RECORD_KEYS = ("cold_us", "span_us", "span_min_us", "new_executables",
               "recompiles", "arg_bytes", "out_bytes", "host_transfers",
               "launches")


def _obs_names():
    return set(json.loads((ROOT / "OBS.json").read_text())["engines"])


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def test_engine_names_are_the_reference_reports():
    names = traceable_engine_names()
    assert len(_obs_names()) == 54
    assert names == _obs_names() - set(SKIPPED)
    assert names == R_TRACE.traceable_engine_names() - set(SKIPPED)


def test_constants_are_the_references():
    assert SPAN_FLOOR_US == R_RUN.SPAN_FLOOR_US == 5000.0
    assert SPAN_GROWTH == R_RUN.SPAN_GROWTH == 0.20
    assert _CEILINGS == R_RUN._CEILINGS


def test_skip_engine_records_its_reason():
    def builder(dev):
        raise E.SkipEngine("no such path")
    rec = SpanRecorder()
    assert trace_engine("x", builder, rec, 0, device="cpu") == {
        "skipped": "no such path"}
    assert rec.events == []


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def test_trace_subset_records_and_chrome_trace():
    records, trace = trace_all(only="switch_step", reps=2, device="cpu")
    assert set(records) == {"switch_step", "switch_step_multi"}
    for name, rec in records.items():
        for key in RECORD_KEYS:
            assert key in rec, f"{name} missing {key}"
        assert rec["recompiles"] == 0 and rec["new_executables"] == 0
        assert rec["host_transfers"] == 0
        assert rec["launches"] == {}          # the CPU launches no kernel
        assert rec["span_us"] >= rec["span_min_us"] > 0
        assert rec["arg_bytes"] > 0 and rec["out_bytes"] > 0
    assert validate_chrome_trace(trace) == []
    # cold + reps warm spans per engine
    assert len(trace["traceEvents"]) == 3 * len(records)
    warm = [e for e in trace["traceEvents"] if e["cat"] == "dispatch"]
    assert all("launches" in e["args"] for e in warm)
    json.dumps(trace)                         # round-trips


def test_trace_all_defaults_to_cuda_and_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trace_all(only="switch_step", reps=1)


def test_span_recorder_clamps_duration():
    rec = SpanRecorder()
    t = rec.origin
    rec.span("zero", "cat", t, t, tid=0)      # zero-length span
    ev = rec.chrome_trace()["traceEvents"][0]
    assert ev["dur"] > 0                      # clamped, still renders
    ref = R_TRACE.SpanRecorder()
    ref.span("zero", "cat", ref.origin, ref.origin, tid=0)
    assert ev == ref.chrome_trace()["traceEvents"][0]


def test_tree_bytes_walks_tensors_arrays_and_dataclasses():
    from repro_torch.obs.trace import _tree_bytes
    t = E.demo_tables("cpu")
    tree = ({"a": torch.zeros(3, 2), "b": [np.zeros(4, np.int16), 7]}, t)
    want = 24 + 8 + sum(v.numel() * v.element_size()
                        for v in vars(t).values())
    assert _tree_bytes(tree) == want


# ---------------------------------------------------------------------------
# validate_chrome_trace, against the reference's
# ---------------------------------------------------------------------------

TRACES = {
    "empty": {},
    "not_a_list": {"traceEvents": {"a": 1}},
    "missing_and_negative": {"traceEvents": [
        {"ph": "X", "ts": 0.0, "pid": 0, "tid": 0, "dur": -1.0}]},
    "unserializable": {"traceEvents": [
        {"name": "x", "ph": "X", "ts": 0.0, "pid": 0, "tid": 0,
         "args": {"a": np.float32(1.0)}}]},
    "clean": {"traceEvents": [
        {"name": "x", "ph": "X", "ts": 0.0, "pid": 0, "tid": 0,
         "dur": 1.0}], "displayTimeUnit": "ms"},
    "instant_without_dur": {"traceEvents": [
        {"name": "x", "ph": "i", "ts": 0.0, "pid": 0, "tid": 0}]},
}


@pytest.mark.parametrize("case", sorted(TRACES))
def test_validate_chrome_trace_matches_reference(case):
    got = validate_chrome_trace(copy.deepcopy(TRACES[case]))
    assert got == R_TRACE.validate_chrome_trace(copy.deepcopy(TRACES[case]))
    if case == "empty":
        assert got == ["traceEvents missing or not a list"]
    if case == "missing_and_negative":
        assert any("missing 'name'" in p for p in got)
        assert any("negative dur" in p for p in got)
    if case == "unserializable":
        assert any("serializable" in p for p in got)
    if case in ("clean", "instant_without_dur"):
        assert got == []


# ---------------------------------------------------------------------------
# compare gates (synthetic reports: each gate in isolation), against the
# reference's
# ---------------------------------------------------------------------------

def _report(**eng):
    rec = {"span_us": 6000.0, "cold_us": 1e5, "new_executables": 1,
           "recompiles": 0, "host_transfers": 0}
    rec.update(eng)
    return {"schema": 1, "topology": {"n_devices": 1},
            "host": {"host_cores": 4.0}, "engines": {"e": rec},
            "n_engines": 1, "n_skipped": 0}


def _host(report, cores):
    report["host"] = {"host_cores": cores}
    return report


def _topo(report, topo):
    report["topology"] = topo
    return report


def _engines(report, engines):
    report["engines"] = engines
    return report


def _cases():
    base = _report()
    cases = {"clean": (copy.deepcopy(base), base)}
    for key in ("new_executables", "recompiles", "host_transfers"):
        cases[f"ceiling_{key}"] = (
            _report(**{key: base["engines"]["e"][key] + 1}), base)
    cases["span_within_20pct"] = (_report(span_us=7100.0), base)
    cases["span_over_20pct"] = (_report(span_us=7300.0), base)
    tiny = _report(span_us=SPAN_FLOOR_US / 10)
    cases["micro_span_baseline"] = (_report(span_us=SPAN_FLOOR_US), tiny)
    cases["host_class_change"] = (_host(_report(span_us=50_000.0), 1.0),
                                  base)
    cases["host_class_change_ceiling"] = (
        _host(_report(span_us=50_000.0, recompiles=2), 1.0), base)
    cases["topology_change"] = (
        _topo(_report(recompiles=5, span_us=1e6), {"n_devices": 8}), base)
    cases["cpu_vs_card"] = (
        _topo(_report(recompiles=5), {"n_devices": 1, "device": "cuda"}),
        _topo(_report(), {"n_devices": 1, "device": "cpu"}))
    cases["disappeared"] = (_engines(copy.deepcopy(base), {}), base)
    cases["now_skipped"] = (
        _engines(copy.deepcopy(base), {"e": {"skipped": "no mesh"}}), base)
    base_skip = _engines(copy.deepcopy(base), {"e": {"skipped": "no mesh"}})
    cases["baseline_skipped"] = (copy.deepcopy(base_skip), base_skip)
    cases["missing_host"] = (_engines(_report(), {}), {"engines": {}})
    return cases


CASES = _cases()
WANT = {"clean": 0, "ceiling_new_executables": 1, "ceiling_recompiles": 1,
        "ceiling_host_transfers": 1, "span_within_20pct": 0,
        "span_over_20pct": 1, "micro_span_baseline": 0,
        "host_class_change": 0, "host_class_change_ceiling": 1,
        "topology_change": 0, "cpu_vs_card": 0, "disappeared": 1,
        "now_skipped": 1, "baseline_skipped": 0, "missing_host": 0}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_matches_reference(case):
    new, old = CASES[case]
    got = compare(copy.deepcopy(new), copy.deepcopy(old))
    assert got == R_RUN.compare(copy.deepcopy(new), copy.deepcopy(old))
    assert len(got) == WANT[case], got
    if case.startswith("ceiling_"):
        assert case[len("ceiling_"):] in got[0] and "ceiling" in got[0]
    if case == "span_over_20pct":
        assert "span_us" in got[0]
    if case == "disappeared":
        assert "disappeared" in got[0]
    if case == "now_skipped":
        assert "skipped" in got[0]


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def test_obs_main_writes_reports_and_self_compare_passes(tmp_path):
    out, trace = tmp_path / "OBS.json", tmp_path / "TRACE.json"
    argv = ["--only", "switch_step", "--smoke", "--device", "cpu",
            "--json", str(out), "--trace", str(trace)]
    assert main(argv) == 0
    report = json.loads(out.read_text())
    assert report["n_engines"] == 2 and report["engines"]
    assert validate_chrome_trace(json.loads(trace.read_text())) == []
    assert main(argv + ["--compare", str(out)]) == 0


def test_obs_main_every_engine_on_the_cpu(tmp_path, capsys):
    """The whole CLI run the README names: every engine of ``OBS.json``
    traced, no kernel library loaded, no host sync on the CPU, both
    files written; a second run gated against the first passes every
    ceiling. Its span floors may flag an engine above ``SPAN_FLOOR_US``
    whose span grew by more than ``SPAN_GROWTH`` between the two runs,
    which host load alone does (the fused runs, the replans), so only a
    floor may fail there."""
    out, trace = tmp_path / "OBS_TORCH.json", tmp_path / "T.json"
    argv = ["--device", "cpu", "--smoke", "--json", str(out),
            "--trace", str(trace)]
    assert main(argv) == 0
    report = json.loads(out.read_text())
    assert set(report["engines"]) == _obs_names()
    assert report["n_skipped"] == len(SKIPPED) == 0
    assert report["topology"] == {"n_devices": 1, "device": "cpu"}
    for name, rec in report["engines"].items():
        assert rec["recompiles"] == 0, name
        assert rec["host_transfers"] == 0, name
        assert rec["new_executables"] == 0, name
        assert rec["span_us"] > 0 and rec["arg_bytes"] > 0, name
    events = json.loads(trace.read_text())["traceEvents"]
    assert len(events) == 2 * 54
    capsys.readouterr()
    rc = main(argv + ["--compare", str(out)])
    regs = [ln for ln in capsys.readouterr().out.splitlines()
            if "REGRESSION" in ln]
    assert rc == (1 if regs else 0)
    assert all(r.endswith("[floor]") for r in regs), regs


def test_obs_main_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--smoke", "--json", str(tmp_path / "o.json"),
              "--trace", str(tmp_path / "t.json")])
    assert not any(tmp_path.iterdir())


def test_obs_main_fails_on_a_regression(tmp_path):
    out, trace = tmp_path / "OBS.json", tmp_path / "TRACE.json"
    argv = ["--only", "pool_shift", "--smoke", "--device", "cpu",
            "--json", str(out), "--trace", str(trace)]
    assert main(argv) == 0
    base = json.loads(out.read_text())
    base["engines"]["pool_shift"]["host_transfers"] = -1
    base["engines"]["gone"] = {"span_us": 1.0}
    old = tmp_path / "OLD.json"
    old.write_text(json.dumps(base))
    assert main(argv + ["--compare", str(old)]) == 1


def test_obs_run_marks_topology_and_host():
    report, _ = run_obs(only="switch_step", reps=1, with_syncs=False,
                        device="cpu")
    assert report["topology"] == {"n_devices": 1, "device": "cpu"}
    assert report["host"]["host_cores"] >= 1.0
    assert all("host_transfers" not in r for r in report["engines"].values())


def test_importing_main_module_runs_nothing(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", "import repro_torch.obs.__main__"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == ""
    assert not any(tmp_path.iterdir())
