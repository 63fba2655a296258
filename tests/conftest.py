import os
import sys

# smoke tests and benches must see ONE device (the dry-run sets its own
# XLA_FLAGS before importing jax) — do NOT force a device count here.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))
# repo root, so tests can reuse benchmark fixtures (benchmarks.*)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Property tests use hypothesis (requirements-dev.txt). In hermetic
# environments without it, fall back to the minimal deterministic
# property runner so the suite still collects and exercises the
# properties. The real package always wins when installed.
try:
    import hypothesis  # noqa: F401
except ImportError:
    import _hypothesis_fallback as _hf
    sys.modules["hypothesis"] = _hf
    sys.modules["hypothesis.strategies"] = _hf.strategies


def pytest_configure(config):
    # tests of CUDA kernels: they skip, with a reason, where no card is
    # visible (decided inside the ``cuda`` fixture, never at import)
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
