"""V-ETL serving launcher: batched requests through prefill + decode, the
port of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --requests 16 --prompt-len 32 --gen 8 [--device cpu]

``--arch`` takes any decoder config of the zoo (dense, vlm, moe, ssm,
hybrid). The CLI serves the reduced config, as the reference's does;
``serve`` runs the same request loop for any model and parameters the
port runs (``chip_smoke.py`` calls it at the published configs). The
CLI refuses the encoder-decoder family (whisper-large-v3) by name: its
prefill needs encoder frames, which the CLI does not draw (the
reference's CLI fails on it with ``KeyError: 'frames'``). ``serve``
takes them from a ``frames`` callable.

Across cards, one process a card under ``torchrun``:

    torchrun --nproc-per-node=4 -m repro_torch.launch.serve \
        --arch qwen1.5-0.5b --model-axis 4 [--device cpu]

With ``WORLD_SIZE`` > 1 in the environment the process joins the world
(``launch.mesh.init_shard_group``: NCCL on the card, gloo with
``--device cpu``), lays it out as (world / model axis, model axis) over
``("data", "model")`` and serves with ``serve(..., mesh=)``: each rank
its block of the params (``runtime.steps.init_params``) and its rows of
each batch, the ranks of a model group their heads, hidden columns and
vocab rows (``make_prefill_step`` / ``make_decode_step``). Rank 0
prints the line: seconds, tokens/s, the peak memory a rank, and the
bytes a rank gathered, reduced and moved over ``"model"`` for a prefill
and for a decode step.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import get
from repro_torch.data.tokens import SyntheticCorpus, local_rows
from repro_torch.device import resolve
from repro_torch.distribution.sharding import _all_gather
from repro_torch.launch.mesh import init_shard_group, make_host_mesh
from repro_torch.models.model import Model
from repro_torch.models.options import RunOptions
from repro_torch.runtime.steps import (init_params, make_decode_step,
                                       make_prefill_step)


def serve(model: Model, params: Dict, corpus: SyntheticCorpus, *,
          requests: int, batch: int, prompt_len: int, gen: int,
          frames: Optional[Callable[[int, int], torch.Tensor]] = None,
          log: Callable[[str], None] = print, mesh=None) -> Dict:
    """Answer ``requests`` prompts of ``prompt_len`` corpus tokens in
    batches of ``batch``: one prefill with room for ``gen`` tokens, then
    ``gen - 1`` decode steps, so ``gen`` tokens per request. An
    encoder-decoder model needs ``frames``: ``frames(b, row0)`` gives the
    (b, S_enc, d_model) encoder frames of the batch of b requests from
    request ``row0``, and the prefill takes ``{"frames", "tokens"}``.
    Returns the token count, the wall seconds (each batch ends in a host
    read of its tokens), the part of them spent drawing prompts on the
    host (the device is idle then), each batch's generated tokens, and
    the prefill's and decode step's ``layout`` (None without a mesh).

    With a ``mesh`` (a ``TrainMesh``; every rank calls ``serve`` alike)
    ``params`` are this rank's blocks (``runtime.steps.init_params(...,
    mesh=)``): each rank draws each batch, serves its rows of it (all of
    them where they do not split over the batch's axes) through
    ``make_prefill_step`` / ``make_decode_step`` with the mesh, and the
    generated tokens are gathered over the batch's ranks, so every rank
    returns every request's."""
    if model.cfg.family == "encdec" and frames is None:
        raise ValueError(f"{model.cfg.name} is an encoder-decoder model: "
                         "serve needs its encoder frames (frames=)")
    dev = params["embed"].device
    prefill = make_prefill_step(model, mesh)
    decode = make_decode_step(model, mesh)
    axes = () if mesh is None else model.batch_axes(mesh)
    n = 1 if mesh is None else mesh.axis_size(axes)
    total, outputs, draw_s = 0, [], 0.0
    t0 = time.time()
    for r0 in range(0, requests, batch):
        b = min(batch, requests - r0)
        split = n > 1 and b % n == 0
        rows = (local_rows(b, mesh.index(axes), n) if split
                else slice(None))
        t_draw = time.time()
        toks = torch.as_tensor(corpus.batch(b, prompt_len, r0)[rows],
                               device=dev)
        draw_s += time.time() - t_draw
        inputs = {"tokens": toks}
        if frames is not None:
            inputs["frames"] = frames(b, r0)[rows]
        nxt, cache = prefill(params, inputs, cache_len=prompt_len + gen)
        outs = [nxt]
        for _ in range(gen - 1):
            nxt, cache = decode(params, cache, nxt)
            outs.append(nxt)
        generated = torch.stack(outs, 1)
        if split:
            generated = _all_gather(generated, 0, mesh.group(axes), n)
        generated = generated.cpu().numpy()
        total += b * gen
        outputs.append(generated)
        log(f"batch {r0 // batch}: generated {generated[0][:8]}...")
    return {"tokens": total, "seconds": time.time() - t0,
            "draw_seconds": draw_s, "outputs": outputs,
            "prefill_layout": prefill.layout, "decode_layout": decode.layout}


def per_step_bytes(stats: Dict, batches: int, gen: int) -> Dict:
    """The bytes a rank gathered, reduced and moved over ``"model"`` for
    one prefill and for one decode step, from ``serve``'s layouts."""
    return {"prefill": {k: v / batches for k, v in
                        stats["prefill_layout"].bytes.items()},
            "decode": {k: v / (batches * max(gen - 1, 1)) for k, v in
                       stats["decode_layout"].bytes.items()}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get(args.arch).reduced()
    if cfg.family == "encdec":
        raise ValueError(f"the serve CLI does not serve {args.arch}: an "
                         "encoder-decoder model needs encoder frames, which "
                         "the CLI does not draw; call serve(..., frames=)")
    world = int(os.environ.get("WORLD_SIZE", 1))
    if args.model_axis < 1 or world % args.model_axis:
        raise ValueError(f"a world of {world} ranks does not divide by "
                         f"--model-axis {args.model_axis}")
    joined = world > 1 and not dist.is_initialized()
    dev = init_shard_group(args.device) if joined else resolve(args.device)
    try:
        return _run(args, cfg, dev, world)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(args, cfg, dev, world):
    opts = RunOptions(remat="none", layer_loop="scan",
                      compute_dtype="float32", q_chunk=64, kv_chunk=64)
    model = Model(cfg, opts)
    gen = torch.Generator().manual_seed(args.seed)
    if world > 1:
        mesh = make_host_mesh(args.model_axis, dev)
        params = init_params(model, gen, mesh=mesh)
    else:
        mesh, params = None, model.init(gen, dev)
    corpus = SyntheticCorpus(cfg.vocab, args.seed)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    stats = serve(model, params, corpus, requests=args.requests,
                  batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                  mesh=mesh, log=say)
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB"
            if dev.type == "cuda" else "not measured")
    moved = ""
    if mesh is not None:
        per = per_step_bytes(stats, -(-args.requests // args.batch),
                             args.gen)
        moved = "; bytes a rank gathered/reduced/model: " + "; ".join(
            f"{step} " + "/".join(f"{v:.0f}" for v in per[step].values())
            for step in ("prefill", "decode"))
    say(f"[serve] {stats['tokens']} tokens in {stats['seconds']:.2f}s "
        f"({stats['tokens'] / stats['seconds']:.1f} tok/s on {dev.type} "
        f"reduced config, mesh "
        f"{'none' if mesh is None else tuple(mesh.devices.shape)}, peak "
        f"{peak} a rank{moved})")
    return stats


if __name__ == "__main__":
    main()
