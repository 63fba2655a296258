"""Quickstart of the PyTorch/CUDA port: the counterpart of
``examples/quickstart.py``, the paper's EV-counting example (App. F) on
synthetic frames with toy UDFs, on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

A Skyscraper instance is provisioned, one knob is registered (detector
interval), fit() profiles the configs offline, and process() ingests
segments with content-adaptive knob switching.
"""
import sys
import os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np

from repro_torch.core.api import Skyscraper


def make_segments(n=120, seed=0):
    """Synthetic 'traffic' segments: difficulty follows a day cycle."""
    rng = np.random.default_rng(seed)
    segs = []
    for t in range(n):
        difficulty = 0.5 + 0.45 * np.sin(2 * np.pi * t / n)
        segs.append({
            "frames": rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32),
            "difficulty": float(np.clip(difficulty, 0, 1)),
        })
    return segs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    # --- the user's UDF DAG: detector (knob-controlled) + tracker -------
    def proc_frame(segment, knobs):
        interval = knobs["det_interval"]
        frames = segment["frames"][::interval]
        # toy "yolo": mean-pool detector + toy "kcf" tracker
        dets = np.tanh(frames.mean(axis=(1, 2, 3)))
        ev_count = float((dets > 0).sum())
        # quality: running the detector more often handles difficult
        # (occluded) content better, reported by the UDF itself
        power = 1.0 / interval
        qual = 1.0 - segment["difficulty"] * (1.0 - 0.85 * power)
        return {"ev_count": ev_count}, qual

    sky = Skyscraper(fps=30, segment_seconds=2.0, n_categories=3,
                     device=args.device)
    sky.set_resources(num_cores=4, buffer_gb=1.0)
    sky.register_knob("det_interval", [1, 2, 4, 8])

    train = make_segments(100, seed=1)
    sky.fit(train, proc_frame, plan_segments=40)
    print(f"offline done: {len(sky.configs)} Pareto configs, "
          f"centers=\n{np.round(sky.centers, 3)}")

    total_ev, quals, used = 0.0, [], []
    for seg in make_segments(120, seed=2):
        info, out = sky.process(seg)
        total_ev += out["ev_count"]
        quals.append(info["quality"])
        used.append(info["config"]["det_interval"])
    print(f"ingested 120 segments: EV count={total_ev:.0f}, "
          f"mean quality={np.mean(quals):.3f}")
    print(f"knob usage histogram (det_interval -> segments): "
          f"{ {v: used.count(v) for v in sorted(set(used))} }")
    assert len(set(used)) > 1, "expected content-adaptive switching"
    print("OK: Skyscraper adapted the knob to the content.")
    return used


if __name__ == "__main__":
    main()
