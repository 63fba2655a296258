"""Fault-tolerant training launcher: the port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --reduced --steps 200 --ckpt-dir /tmp/ckpt [--device cpu]

- auto-resumes from the latest checkpoint (restart after a crash);
- periodic atomic checkpoints with retention (``checkpoint/ckpt.py``, the
  reference's format, so either package resumes the other's run);
- ``--simulate-failure N`` ends the process with exit code 42 at step N,
  on every rank (the restart test uses it);
- elastic: a resumed run is resharded onto whatever world it restarts
  on (``checkpoint/ckpt.py``'s files hold the whole state).

Across cards, one process a card under ``torchrun``:

    torchrun --nproc-per-node=N -m repro_torch.launch.train \
        --arch llama3-8b --model-axis 2 ...

With ``WORLD_SIZE`` > 1 in the environment the process joins the world
(``launch.mesh.init_shard_group``: NCCL on the card, gloo with
``--device cpu``), lays it out as (world / model axis, model axis)
(``make_host_mesh``; the world must divide by ``--model-axis``), cuts
the train state into its blocks (``runtime/steps.py``) and runs its
rows of each global batch; the ranks of a model group split each
layer's heads, hidden columns and vocab between them; with
``--seq-shard`` (``RunOptions.seq_shard_activations``) also the rows of
the residual stream between the blocks (sequence parallelism). Rank 0
prints the log, each logged step with the bytes a rank gathered, reduced
and moved over ``"model"`` a step so far.

The reference's flags and run options: ``remat="none"``, float32
compute, microbatches from ``--microbatches``, a warmup of 20 steps.
``--device`` defaults to CUDA, as every entry point of the port; the
weights are drawn from ``--seed`` on the CPU, so a seed gives the same
model on either device and on any number of ranks. On the card every
family trains: the attention runs kernel K3 both ways (the forward and
its backward kernel), the SSM and hybrid families' scan kernel K4 both
ways (its five forward passes and its backward kernel).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt as CK
from repro_torch.configs.base import get
from repro_torch.data.tokens import local_rows, make_batch_iter
from repro_torch.device import resolve
from repro_torch.launch.mesh import init_shard_group, make_host_mesh
from repro_torch.models.model import Model
from repro_torch.models.options import RunOptions
from repro_torch.runtime.steps import (init_train_state, make_train_step,
                                       train_state_shardings)


WARMUP = 20                 # the reference launcher's warmup steps


def train_options(seq: int, microbatches: int = 1) -> RunOptions:
    """The run options the reference launcher builds for ``--seq``:
    no remat, float32 compute, chunks of at most the sequence."""
    return RunOptions(remat="none", layer_loop="scan",
                      compute_dtype="float32", microbatches=microbatches,
                      q_chunk=min(128, seq), kv_chunk=min(128, seq))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--simulate-failure", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    world = int(os.environ.get("WORLD_SIZE", 1))
    if args.model_axis < 1 or world % args.model_axis:
        raise ValueError(f"a world of {world} ranks does not divide by "
                         f"--model-axis {args.model_axis}")
    joined = world > 1 and not dist.is_initialized()
    dev = init_shard_group(args.device) if joined else resolve(args.device)
    try:
        return _run(args, dev, world)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(args, dev, world):
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, dataclasses.replace(
        train_options(args.seq, args.microbatches),
        seq_shard_activations=args.seq_shard))
    mesh = make_host_mesh(args.model_axis, dev) if world > 1 else None
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    shardings = None if mesh is None else train_state_shardings(model, mesh)

    start = 0
    if args.ckpt_dir and (CK.latest_step(args.ckpt_dir) is not None):
        start = CK.latest_step(args.ckpt_dir)
        state = CK.restore(args.ckpt_dir, start, device=dev, mesh=mesh,
                           shardings=shardings)
        say(f"[train] resumed from step {start}")
    else:
        state = init_train_state(
            model, torch.Generator().manual_seed(args.seed), dev, mesh)
        say("[train] fresh init")

    step_fn = make_train_step(model, peak_lr=args.lr, warmup=WARMUP,
                              total_steps=args.steps, mesh=mesh)
    rows = None
    if mesh is not None:
        axes = model.batch_axes(mesh)
        rows = local_rows(args.batch, mesh.index(axes), mesh.axis_size(axes),
                          args.microbatches)
    it = make_batch_iter(cfg, global_batch=args.batch, seq_len=args.seq,
                         seed=args.seed, device=dev, rows=rows)
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = next(it)
        if args.simulate_failure and step == args.simulate_failure:
            print(f"[train] SIMULATED FAILURE at step {step}", flush=True)
            os._exit(42)
        state, metrics = step_fn(state, batch)
        if (step + 1) % args.log_every == 0 or step == start:
            loss = float(metrics["loss"])
            losses.append(loss)
            moved = "" if mesh is None else " bytes/step " + " ".join(
                f"{k} {v / (step + 1 - start):.0f}"
                for k, v in step_fn.layout.bytes.items())
            say(f"step {step + 1:5d} loss {loss:8.4f} "
                f"gnorm {float(metrics['gnorm']):7.3f} "
                f"({(time.time() - t0):.1f}s){moved}", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            CK.save(args.ckpt_dir, state, step=step + 1,
                    shardings=shardings)
    if args.ckpt_dir:
        CK.save(args.ckpt_dir, state, step=args.steps, shardings=shardings)
    say(f"[train] done: final loss {losses[-1] if losses else 'n/a'}")
    return losses


if __name__ == "__main__":
    main()
