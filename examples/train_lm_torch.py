"""End-to-end training script of the PyTorch/CUDA port: the counterpart of
``examples/train_lm.py`` over ``repro_torch.launch.train.main``. Trains a
reduced model of ``--arch`` (qwen1.5-0.5b by default, as the reference)
for a few hundred steps with checkpointing and auto-resume, on the card
unless ``--device cpu``. Every family of the zoo trains on the card: the
attention through K3 and its backward kernel, the SSM and hybrid
families' scan through K4 and its backward kernel.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] \
        [--arch mamba2-370m] [--device cpu]
"""
import sys
import os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--device", default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    args = ap.parse_args(argv)

    losses = train_main([
        "--arch", args.arch, "--reduced",
        "--steps", str(args.steps),
        "--batch", "16", "--seq", "128", "--lr", "3e-3",
        "--microbatches", "2",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
        "--log-every", "20",
        *(["--device", args.device] if args.device else []),
    ])
    assert losses[-1] < losses[0], "loss did not decrease"
    print(f"OK: loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{args.steps} steps; checkpoints in {args.ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()
