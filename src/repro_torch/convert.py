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
    dict of tensors on ``device`` (``None`` means CUDA), dtypes kept.
    Every family's leaves go across by name, the MoE's stacked router
    (L,d,E) and experts' ``w_gate``, ``w_up`` (L,E,d,f) and ``w_down``
    (L,E,f,d) among them."""
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


def switch_tables_from_arrays(fields: Dict, device=None):
    """A reference ``SwitchTables`` (one stream's, or V streams' stacked
    by ``stack_tables``) as ``{field: array}`` -> the port's
    ``SwitchTables`` on ``device``: float fields float32, ``place_valid``
    bool, ``rank_pos`` int64."""
    from repro_torch.core.switcher import SwitchTables
    dev = resolve(device)

    def t(name):
        a = np.asarray(fields[name])
        dtype = {"place_valid": torch.bool,
                 "rank_pos": torch.int64}.get(name, torch.float32)
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)
    return SwitchTables(**{f: t(f) for f in SwitchTables.__dataclass_fields__})


def pool_state_from_arrays(pool, arrays: Dict) -> None:
    """Load a reference ``SkyscraperPool``'s carried state into the
    port's ``pool`` of the same slot capacity, in place: ``arrays``
    holds ``tables`` ({field: (cap, ...) array}), ``state`` ({leaf:
    array}), ``bufs``, ``alpha``, ``active`` and ``priority``."""
    cap = pool.cap
    tables = switch_tables_from_arrays(arrays["tables"], pool.device)
    for f in type(tables).__dataclass_fields__:
        assert getattr(tables, f).shape[0] == cap, f
        getattr(pool.tables, f).copy_(getattr(tables, f))
    for k, v in arrays["state"].items():
        pool.state[k].copy_(torch.as_tensor(np.array(v)).to(
            pool.state[k].dtype))
    pool._bufs.copy_(torch.as_tensor(np.array(arrays["bufs"])).to(
        pool._bufs.dtype))
    pool._alpha.copy_(torch.as_tensor(np.array(arrays["alpha"],
                                               np.float32)))
    pool._active_np[:] = np.asarray(arrays["active"], bool)
    pool._priority_np[:] = np.asarray(arrays["priority"], np.float32)
    pool._active.copy_(torch.as_tensor(pool._active_np))
    pool._priority.copy_(torch.as_tensor(pool._priority_np))


def cold_tier_from_arrays(tiered, codes: Dict, scales: Dict, ints: Dict
                          ) -> None:
    """Install a reference ``TieredStore``'s cold tier (int8 ``codes``
    and per-chunk ``scales`` of each float column, the integer columns
    ``ints``, all as arrays) in the port's ``tiered``, in place; its hot
    tier is left as it is."""
    dev = tiered.hot.device

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)
    tiered.cold_q = {k: t(v, torch.int8) for k, v in codes.items()}
    tiered.cold_scales = {k: t(v, torch.float32) for k, v in scales.items()}
    tiered.cold_int = {k: t(v) for k, v in ints.items()}
    tiered.n_cold = int(next(iter(ints.values())).shape[0])
    tiered._mat_cache = None
