"""Each example of the PyTorch/CUDA port (``examples/*_torch.py``) runs
on the CPU through its ``main([..., "--device", "cpu"])`` at a small
size, passes its own asserts and prints its headline. The examples'
import rules (no JAX, nothing of ``repro``) are checked in
``test_torch_hygiene.py``."""
import importlib.util
import tempfile
from pathlib import Path

import pytest

from _torch_threads import cap_torch_threads

cap_torch_threads()

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

# example -> (small-size arguments, the headline it prints last)
CASES = {
    "quickstart_torch": ([], "OK: Skyscraper adapted the knob"),
    "serve_vetl_torch": (["--fit-segments", "12", "--serve-segments", "10"],
                         "OK: served with content-adaptive knobs"),
    "vetl_ingest_torch": (["--days", "0.1", "--fit-days", "1.0"],
                          "OK: content-adaptive ingestion beat"),
    "vetl_query_torch": (["--days", "0.1", "--fit-days", "1.0",
                          "--shard-days", "0.02", "--chunk-rows", "512"],
                         "OK: ingest -> store -> query -> spill"),
    "vetl_alerts_torch": ([], "OK: standing answers exact"),
    "vetl_observe_torch": ([], "OK: flight recorder + dispatch tracer"),
    "vetl_pool_scale_torch": ([], "ok"),
}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_port_example_is_covered():
    assert {p.stem for p in EXAMPLES.glob("*_torch.py")} == \
        set(CASES) | {"train_lm_torch"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_cpu(name, capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    args, headline = CASES[name]
    _load(name).main(args + ["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith(headline), out[-3:]
    if name == "vetl_query_torch":
        spilled = [ln for ln in out if "spilled" in ln]
        assert spilled and "spilled 0 rows" not in spilled[0]
