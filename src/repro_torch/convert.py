"""Carry a fit across from plain arrays: the port's ``Fitted`` from numpy.

The reference draws its forecaster init from ``jax.random``, which
torch cannot reproduce, so tests that hold both sides to the same run
build ``arrays`` from the reference's ``Fitted`` (``np.asarray`` on each
table, ``jax.tree.map(np.asarray, fitted.forecaster)`` on the params)
and hand them here. Both sides then compute the same thing.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.workloads import WORKLOADS
from repro_torch.core.offline import Fitted
from repro_torch.device import resolve

TABLES = ("power", "cost", "place_rt", "place_on", "place_cl",
          "place_valid", "centers")
SCALARS = ("n_split", "interval_segments", "horizon_segments", "n_cores")


def forecaster_from_arrays(tree: Dict, device=None) -> Dict:
    """``{"l1": {"w", "b"}, ...}`` of arrays -> the same tree of float32
    tensors on ``device`` (``None`` means CUDA)."""
    dev = resolve(device)
    return {layer: {p: torch.as_tensor(np.array(v, np.float32),
                                       device=dev)
                    for p, v in params.items()}
            for layer, params in tree.items()}


def fitted_from_arrays(workload_name: str, arrays: Dict,
                       device=None) -> Fitted:
    """``arrays`` holds ``configs`` (list of knob dicts), the tables
    named in ``TABLES`` (numpy), ``forecaster`` (a tree of arrays) and
    the integers in ``SCALARS``. The workload comes by name from the
    port's own ``WORKLOADS``."""
    dev = resolve(device)
    tables = {k: np.array(arrays[k]) for k in TABLES}
    return Fitted(workload=WORKLOADS[workload_name],
                  configs=[dict(c) for c in arrays["configs"]],
                  forecaster=forecaster_from_arrays(arrays["forecaster"],
                                                    dev),
                  device=dev, **tables,
                  **{k: int(arrays[k]) for k in SCALARS})
