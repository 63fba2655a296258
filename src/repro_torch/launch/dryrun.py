"""The dry run's account of every (arch x shape x production mesh) cell,
without XLA: the port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out build/dryrun_torch.json

For each cell (``configs/shapes.py``: 10 configs x 4 shapes, the same
skips as the reference's, ``applicable`` / ``skip_reason``) it runs one
rank's step of the port on the ``meta`` device, over
``launch.mesh.production_shape()`` ((16, 16) over ``("data",
"model")``, or (2, 16, 16) over ``("pod", "data", "model")``) seen from
that rank (``launch.mesh.AccountMesh``): the train step
(``runtime.steps.make_train_step(..., mesh=)``), the prefill or the
decode step (``make_prefill_step`` / ``make_decode_step`` with the
mesh), on this rank's blocks of the params (and moments), its rows of
the batch and its block of the cache. Nothing is computed and nothing
needs a card, as the reference needs no TPU: the collectives take the
counting path of the mesh's groups (``sharding.CountingGroup``) and the
kernels K3 and K4 their ``meta`` shape path. The numbers are reckoned
by the code that runs on the cards.

A record holds:

- ``memory``: the bytes of the step's arguments (params, moments and
  counts for train; the batch, or the cache and the token) and of what
  it returns, on this rank; and ``saved_bytes``, the bytes autograd
  saves for the backward in this rank's train step (0 for a prefill or
  a decode step, which save nothing): counted by the step's
  ``saved_tensors_hooks`` (``StepLayout.saved_as_shards``), each
  storage once, the params' own storages not at all, at the peak of
  what the saves hold, as the layer loop keeps them all until the
  backward (a gathered leaf or row block kept as this rank's block
  counts that block). It is the port's counterpart of the reference's
  ``temp_bytes`` but not the same thing: not the compiler's scratch,
  and it leaves out the backward's own temporaries (the gradients, the
  re-gathers, the kernels' workspaces) and the allocator's slack, so it
  is a lower bound on the activations' memory, not a peak. Under
  ``remat`` ``full`` or ``dots`` torch's checkpoint keeps the layers'
  saves out of sight of the hooks (it recomputes them in the backward),
  so there the count holds only what the step saves outside the
  layers;
- ``collectives``: the bytes the step's ``StepLayout.bytes`` counts on
  this rank, gathered, reduced and moved over ``"model"``;
- ``flops``: the products by ``torch.utils.flop_counter.FlopCounterMode``
  (2 a multiply-add), and apart from them K3's and K4's operations by
  the kernels' own count (``kernels.flash_attention.work``,
  ``kernels.ssd.work``, forward and backward);
- ``roofline``: the three terms for one H100 SXM, the dense bf16 peak of
  989 TFLOP/s for every operation, HBM at 3.35 TB/s for the memory term
  (the arguments and outputs read or written once: a lower bound) and
  NVLink at 450 GB/s each way for the collectives. A 256- or 512-rank
  mesh spans hosts whose links are slower than NVLink, so the collective
  term is a lower bound too;
- the analytic part, as the reference's: ``model_flops_global`` (6 N
  tokens for train, 2 N tokens for prefill, 2 N B for decode, N the
  active parameters), ``model_flops_per_device``, ``useful_ratio``
  (that over the reckoned operations) and ``params_b``.

What the reference's record has and this one has not, because it comes
from XLA's compiler: ``compile_s`` and ``lower_s`` (nothing is lowered
or compiled here; ``account_s`` is the account's own seconds),
``temp_bytes`` (the compiler's scratch), ``code_bytes`` (its
executable), ``hlo`` (``hlo_analysis.analyze``'s count of the HLO
text's ops) and ``hlo_text`` (``as_text``).

``--seq-shard`` is the reference's flag: ``seq_shard_activations``, the
train steps and prefills split their residual stream's rows over
``"model"`` (``models/transformer.splits``); tag its records with
``--tag``, as the reference's are.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import get, registry
from repro_torch.configs.shapes import SHAPES, applicable, skip_reason
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssd as SSD
from repro_torch.launch.mesh import AccountMesh, MeshShape, production_shape
from repro_torch.models.model import Model, _leaves, _set
from repro_torch.models.options import RunOptions
from repro_torch.models.transformer import slot_split, splits
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.steps import (make_decode_step, make_prefill_step,
                                       make_train_step)

PEAK_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
LINK_BYTES_PER_S = 450e9        # H100 SXM NVLink, each way
OPTS_KEYS = ("remat", "layer_loop", "microbatches", "moe_sharding", "fsdp",
             "param_dtype", "fsdp_pods", "capacity_factor", "q_chunk")


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _block(shape, spec, mesh):
    """A leaf's block on one rank: each sharded dim over its axes."""
    shape = list(shape)
    for d, axes in spec.dims():
        shape[d] //= mesh.axis_size(axes)
    return tuple(shape)


def local_params(model: Model, mesh) -> Dict:
    """This rank's blocks of the params on ``meta``."""
    specs = model.param_specs(mesh)
    out: Dict = {}
    for path, meta in _leaves(model.meta()):
        spec = specs
        for k in path:
            spec = spec[k]
        _set(out, path, torch.empty(_block(meta.shape, spec, mesh),
                                    dtype=getattr(torch, meta.dtype),
                                    device="meta"))
    return out


def local_rows(n_rows: int, layout) -> int:
    """The rows of a global batch this rank runs: its share where they
    split over the batch's axes, else all."""
    return n_rows // layout.n_batch if n_rows % layout.n_batch == 0 \
        else n_rows


def local_cache(model: Model, batch: int, seq_len: int, layout) -> Dict:
    """This rank's block of a decode cache of ``seq_len`` on ``meta``,
    as ``make_prefill_step`` leaves it across ranks: its rows, k and v
    its block of the slots (``slot_split``), the SSM state's heads and
    the conv caches' columns where the SSM splits, whisper's xk and xv
    heads where the heads split."""
    cm = model.cache_meta(batch, seq_len)
    plan = splits(layout, model.cfg, model.opts).plan
    sp = layout.split
    rows = local_rows(batch, layout)
    Sc = cm["slot_pos"].shape[0] if "slot_pos" in cm else 0
    out: Dict = {}
    for path, meta in _leaves(cm):
        shape, name = list(meta.shape), path[-1]
        if len(shape) > 1:
            shape[1] = rows
        if name in ("k", "v") and slot_split(layout, Sc) is not None:
            shape[2] //= sp.m
        if plan is not None and plan.ssm and name == "ssm":
            shape[2] //= sp.m
        if plan is not None and plan.ssm and name.startswith("conv_"):
            shape[3] //= sp.m
        if plan is not None and plan.attn and name in ("xk", "xv"):
            shape[3] //= sp.m
        _set(out, path, torch.empty(shape, dtype=getattr(torch, meta.dtype),
                                    device="meta"))
    return out


def _local_batch(model: Model, shape, layout) -> Dict:
    spec = model.input_specs(shape)["batch"]
    return {k: torch.empty((local_rows(v.shape[0], layout),) + v.shape[1:],
                           dtype=v.dtype, device="meta")
            for k, v in spec.items()}


def run_step(model: Model, shape, mesh, cache_len=None) -> Dict:
    """One rank's step of ``shape`` on ``meta`` over ``mesh`` (an
    ``AccountMesh``): argument and output bytes, the layout's bytes, the
    products' FLOPs and K3's and K4's operations. ``cache_len``: a
    prefill's room for decode steps (the reference's cells have none)."""
    for ops in (FA.META_OPS, SSD.META_OPS):
        ops.update(forward=0, backward=0)
    with FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            step = make_train_step(model, mesh=mesh)
            params = local_params(model, mesh)
            state = {"params": params, "opt": adamw_init(params),
                     "step": torch.zeros((), dtype=torch.int32,
                                         device="meta")}
            batch = _local_batch(model, shape, step.layout)
            args = _nbytes(state) + _nbytes(batch)
            out = step(state, batch)
        elif shape.kind == "prefill":
            step = make_prefill_step(model, mesh)
            params = local_params(model, mesh)
            batch = _local_batch(model, shape, step.layout)
            args = _nbytes(params) + _nbytes(batch)
            out = step(params, batch, cache_len=cache_len)
        else:
            step = make_decode_step(model, mesh)
            params = local_params(model, mesh)
            cache = local_cache(model, shape.global_batch, shape.seq_len,
                                step.layout)
            token = torch.empty((local_rows(shape.global_batch,
                                            step.layout),),
                                dtype=torch.int32, device="meta")
            args = _nbytes(params) + _nbytes(cache) + _nbytes(token)
            out = step(params, cache, token)
    attn = FA.META_OPS["forward"] + FA.META_OPS["backward"]
    scan = SSD.META_OPS["forward"] + SSD.META_OPS["backward"]
    products = fc.get_total_flops()
    return {"memory": {"argument_bytes": args, "output_bytes": _nbytes(out),
                       "saved_bytes": step.layout.saved["peak"]},
            "collectives": dict(step.layout.bytes),
            "flops": {"products": products, "attention": attn, "scan": scan,
                      "total": products + attn + scan}}


def roofline_terms(flops: float, mem_bytes: float, coll_bytes: float
                   ) -> Dict:
    t = {"compute_s": flops / PEAK_FLOP_PER_S,
         "memory_s": mem_bytes / HBM_BYTES_PER_S,
         "collective_s": coll_bytes / LINK_BYTES_PER_S}
    dom = max(t, key=t.get)
    return {**t, "dominant": dom.split("_")[0], "bound_s": t[dom]}


def account_cell(arch_name: str, shape_name: str, layout: MeshShape,
                 opts: RunOptions, *, cfg=None, rank: int = 0) -> Dict:
    """The record of one cell: ``arch_name`` (or the config ``cfg``) at
    ``shape_name`` over ``layout`` (a ``MeshShape``), seen from
    ``rank``."""
    cfg = cfg or get(arch_name)
    shape = SHAPES[shape_name]
    model = Model(cfg, opts)
    mesh = AccountMesh(layout.devices.shape, layout.axis_names,
                       layout.devices.reshape(-1), rank)
    n_dev = mesh.size
    out = {"arch": arch_name, "shape": shape_name,
           "mesh": "x".join(str(s) for s in mesh.devices.shape),
           "n_devices": int(n_dev), "rank": rank,
           "opts": {k: v for k, v in dataclasses.asdict(opts).items()
                    if k in OPTS_KEYS}}
    t0 = time.time()
    out.update(run_step(model, shape, mesh))
    out["account_s"] = round(time.time() - t0, 2)
    coll = out["collectives"]
    out["roofline"] = roofline_terms(
        out["flops"]["total"], out["memory"]["argument_bytes"]
        + out["memory"]["output_bytes"], sum(coll.values()))
    N = cfg.param_count()
    Na = cfg.param_count(active_only=True)
    if shape.kind == "train":
        mf = 6.0 * Na * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        mf = 2.0 * Na * shape.global_batch * shape.seq_len
    else:
        mf = 2.0 * Na * shape.global_batch
    out["model_flops_global"] = mf
    out["model_flops_per_device"] = mf / n_dev
    out["useful_ratio"] = (mf / n_dev) / max(out["flops"]["total"], 1.0)
    out["params_b"] = round(N / 1e9, 3)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--layer-loop", default="scan",
                    choices=["scan", "unroll"])
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--moe-shard", default="tp", choices=["tp", "cap", "ep"])
    ap.add_argument("--moe-group", type=int, default=0)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--param-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--kv-dtype", default="",
                    choices=["", "bfloat16", "float8_e4m3fn"])
    ap.add_argument("--fsdp-pods", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--capacity-factor", type=float, default=1.25)
    ap.add_argument("--out", default="build/dryrun_torch.json")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)

    opts = RunOptions(remat=args.remat, layer_loop=args.layer_loop,
                      microbatches=args.microbatches,
                      moe_sharding=args.moe_shard, moe_group=args.moe_group,
                      fsdp=not args.no_fsdp, param_dtype=args.param_dtype,
                      kv_cache_dtype=args.kv_dtype,
                      fsdp_pods=args.fsdp_pods,
                      seq_shard_activations=args.seq_shard,
                      q_chunk=args.q_chunk,
                      capacity_factor=args.capacity_factor)
    archs = sorted(registry()) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r.get("arch"), r.get("shape"), r.get("mesh"), r.get("tag"))
            for r in results}
    for multi in meshes:
        layout = production_shape(multi_pod=multi)
        mesh_name = "x".join(str(s) for s in layout.devices.shape)
        for a in archs:
            cfg = get(a)
            for s in shapes:
                if (a, s, mesh_name, args.tag) in done:
                    continue
                if not applicable(cfg, SHAPES[s]):
                    rec = {"arch": a, "shape": s, "mesh": mesh_name,
                           "tag": args.tag,
                           "skipped": skip_reason(cfg, SHAPES[s])}
                    print(f"[skip] {a} x {s} x {mesh_name}: "
                          f"{rec['skipped']}")
                else:
                    print(f"[account] {a} x {s} x {mesh_name} ...",
                          flush=True)
                    try:
                        rec = account_cell(a, s, layout, opts)
                        rec["tag"] = args.tag
                        rl = rec["roofline"]
                        print(f"  ok {rec['account_s']}s "
                              f"dom={rl['dominant']} "
                              f"comp={rl['compute_s']:.4f}s "
                              f"mem={rl['memory_s']:.4f}s "
                              f"coll={rl['collective_s']:.4f}s "
                              f"useful={rec['useful_ratio']:.2f}",
                              flush=True)
                    except Exception as e:   # noqa: BLE001
                        rec = {"arch": a, "shape": s, "mesh": mesh_name,
                               "tag": args.tag, "error": str(e)[:500],
                               "trace": traceback.format_exc()[-2000:]}
                        print(f"  ERROR: {str(e)[:200]}", flush=True)
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_err = sum(1 for r in results if "error" in r)
    print(f"done: {len(results)} records, {n_err} errors -> {args.out}")
    return results


if __name__ == "__main__":
    main()
