"""Fault-tolerant training launcher: the port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --reduced --steps 200 --ckpt-dir /tmp/ckpt [--device cpu]

- auto-resumes from the latest checkpoint (restart after a crash);
- periodic atomic checkpoints with retention (``checkpoint/ckpt.py``, the
  reference's format, so either package resumes the other's run);
- ``--simulate-failure N`` ends the process with exit code 42 at step N
  (the restart test uses it).

The reference's flags and run options: ``remat="none"``, float32
compute, microbatches from ``--microbatches``, a warmup of 20 steps. One
card, so ``--model-axis`` must be 1 (the reference's elastic reshard onto
a new mesh has no counterpart). ``--device`` defaults to CUDA, as every
entry point of the port; the weights are drawn from ``--seed`` on the
CPU, so a seed gives the same model on either device. On the card the
attention runs kernel K3 both ways (the forward and its backward
kernel); the SSM and hybrid families' K4 has no backward yet and refuses
a gradient, so they train on the CPU only.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.checkpoint import ckpt as CK
from repro_torch.configs.base import get
from repro_torch.data.tokens import make_batch_iter
from repro_torch.device import resolve
from repro_torch.models.model import Model
from repro_torch.models.options import RunOptions
from repro_torch.runtime.steps import init_train_state, make_train_step


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
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--simulate-failure", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    if args.model_axis != 1:
        raise ValueError(f"--model-axis {args.model_axis}: the port trains "
                         "on one card, so the model axis is 1")
    dev = resolve(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, train_options(args.seq, args.microbatches))

    start = 0
    if args.ckpt_dir and (CK.latest_step(args.ckpt_dir) is not None):
        start = CK.latest_step(args.ckpt_dir)
        state = CK.restore(args.ckpt_dir, start, device=dev)
        print(f"[train] resumed from step {start}")
    else:
        state = init_train_state(
            model, torch.Generator().manual_seed(args.seed), dev)
        print("[train] fresh init")

    step_fn = make_train_step(model, peak_lr=args.lr, warmup=WARMUP,
                              total_steps=args.steps)
    it = make_batch_iter(cfg, global_batch=args.batch, seq_len=args.seq,
                         seed=args.seed, device=dev)
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
            print(f"step {step + 1:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['gnorm']):7.3f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            CK.save(args.ckpt_dir, state, step=step + 1)
    if args.ckpt_dir:
        CK.save(args.ckpt_dir, state, step=args.steps)
    print(f"[train] done: final loss {losses[-1] if losses else 'n/a'}")
    return losses


if __name__ == "__main__":
    main()
