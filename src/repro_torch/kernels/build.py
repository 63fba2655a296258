"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with
``nvcc`` into ``build/repro_torch/<name>-<hash>.so`` at the repository
root; the hash covers the source, the shared headers ``csrc/*.cuh``
(found through ``-I csrc``) and the flags, so an edited source or
header builds anew and an unchanged one loads from the last build. No
PyTorch header is included, which keeps a build to seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# what nvcc and ptxas reported for each library built in this process
BUILD_LOG: Dict[str, str] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def command(src: Path, out: Path) -> list:
    """The nvcc command line that builds ``src`` into ``out``."""
    return [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def sources() -> Tuple[str, ...]:
    """The names of every kernel source under ``csrc/``."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built first if needed."""
    return load_all((name,))[name]


def load_all(names) -> Dict[str, ctypes.CDLL]:
    """The ctypes handles of ``csrc/<name>.cu`` for each name, building
    the missing ones with one nvcc process each, all started together.
    nvcc writes a temporary file that is renamed when it is complete,
    and its output (ptxas's register counts) goes to ``BUILD_LOG``."""
    builds = []
    for name in names:
        if name in _LIBS:
            continue
        out = _target(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        builds.append((name, tmp, out, subprocess.Popen(
            command(CSRC / f"{name}.cu", tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, out, proc in builds:
        BUILD_LOG[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{BUILD_LOG[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return {name: _LIBS[name] for name in names}
