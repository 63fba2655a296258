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


def params_from_arrays(tree: Dict, device=None) -> Dict:
    """A model param tree of arrays (the reference's ``Model.init``
    output through ``jax.tree.map(np.asarray, ...)``) -> the same nested
    dict of tensors on ``device`` (``None`` means CUDA), dtypes kept."""
    dev = resolve(device)
    return {k: (params_from_arrays(v, dev) if isinstance(v, dict)
                else torch.as_tensor(np.array(v), device=dev))
            for k, v in tree.items()}


def backbone_from_arrays(job, trees: Dict[str, Dict], device=None):
    """Load one reference param tree per model size (``{"small": tree,
    ...}``) into the port's ``BackboneVETL`` ``job``, in place; returns
    ``job``."""
    for name, tree in trees.items():
        model, _ = job.models[name]
        job.models[name] = (model, params_from_arrays(tree, device))
    return job


def fitted_skyscraper(sky, arrays: Dict, proc_fn, *,
                      plan_segments: int = 512):
    """Install a reference ``Skyscraper``'s fitted state in the port's
    handle ``sky`` (after its knobs and resources are set): ``arrays``
    holds ``configs``, ``cost``, ``power`` (the kept configs' mean
    qualities, the reference's ``tables.power``), ``centers``,
    ``forecaster`` (a tree of arrays), ``n_split`` and ``interval``.
    Returns ``sky``, planned and ready to ``process``."""
    sky._install(configs=arrays["configs"], cost=np.asarray(arrays["cost"]),
                 power=np.asarray(arrays["power"]),
                 centers=np.asarray(arrays["centers"]),
                 forecaster=forecaster_from_arrays(arrays["forecaster"],
                                                   sky.device),
                 n_split=int(arrays["n_split"]),
                 interval=int(arrays["interval"]), proc_fn=proc_fn,
                 plan_segments=plan_segments)
    return sky
