"""V-ETL serving with an assigned-arch backbone, the PyTorch/CUDA port's
counterpart of ``examples/serve_vetl.py``: batched segment requests flow
through the Skyscraper switcher, which picks {sampling, resolution,
model-size} knobs per segment; the heavy UDF is a transformer forward
(``repro_torch.models``, K3 on the card) whose mean top-1 certainty is
the quality signal (paper §5.2's certainty proxy). The resolution knob
runs the frame-preprocessing kernel K2. On the card unless ``--device
cpu``.

    PYTHONPATH=src python examples/serve_vetl_torch.py [--device cpu] \
        [--fit-segments 40] [--serve-segments 60]
"""
import sys
import os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np

from repro_torch.core.api import Skyscraper
from repro_torch.core.vetl_serving import BackboneVETL


def make_segments(n, seed=0):
    rng = np.random.default_rng(seed)
    segs = []
    for t in range(n):
        segs.append({
            "frames": rng.normal(0, 1, (8, 32, 32, 3)).astype(np.float32),
            "tokens": rng.integers(0, 200, (8, 16)),
        })
    return segs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--fit-segments", type=int, default=40)
    ap.add_argument("--serve-segments", type=int, default=60)
    args = ap.parse_args(argv)

    job = BackboneVETL(arch="qwen1.5-0.5b", device=args.device)
    sky = Skyscraper(segment_seconds=1.0, n_categories=3,
                     device=args.device)
    sky.set_resources(num_cores=2, buffer_gb=0.5)
    sky.register_knob("sample_every", [1, 2, 4])
    sky.register_knob("resolution", [1, 2])
    sky.register_knob("model_size", ["small", "medium", "large"])

    print("== offline: profiling knob configs on the backbone ==")
    sky.fit(make_segments(args.fit_segments, seed=1), job.proc_fn,
            plan_segments=25)
    print(f"{len(sky.configs)} Pareto configs kept "
          f"(costs {np.round(sky.cost, 4)} core-s/segment)")

    print(f"== online: serving {args.serve_segments} segments ==")
    sizes, quals = [], []
    for seg in make_segments(args.serve_segments, seed=2):
        info, out = sky.process(seg)
        sizes.append(info["config"]["model_size"])
        quals.append(info["quality"])
    hist = {v: sizes.count(v) for v in sorted(set(sizes))}
    print(f"model-size usage: {hist}; mean certainty {np.mean(quals):.3f}")
    print("OK: served with content-adaptive knobs over a PyTorch backbone.")
    return hist


if __name__ == "__main__":
    main()
