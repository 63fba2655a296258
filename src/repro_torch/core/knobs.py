"""Knob semantics for the paper's workloads (§5.2, App. J): every knob
configuration maps to (a) per-task duration multipliers for the placement
simulator and (b) a scalar *power* in (0,1] — the config's intrinsic
ability to handle difficult content. Ground-truth segment quality is
qual = 1 - difficulty * (1 - power): cheap configs are only penalized on
difficult content, matching the paper's premise.

A copy of ``repro/core/knobs.py`` (plain Python and numpy), so the port
computes the same configs, powers and costs without importing ``repro``.
"""
from __future__ import annotations

import itertools
from typing import Dict, List

from repro_torch.configs.workloads import WorkloadCfg

SIZE_MULT = {"small": 0.35, "medium": 0.65, "large": 1.0}
SIZE_POW = {"small": 0.75, "medium": 0.9, "large": 1.0}


def enumerate_configs(w: WorkloadCfg) -> List[Dict]:
    """Cartesian product of the workload's knob values, one dict per
    config (the K axis of every fitted table)."""
    names = list(w.knobs)
    out = []
    for vals in itertools.product(*(w.knobs[n] for n in names)):
        out.append(dict(zip(names, vals)))
    return out


def task_multipliers(w: WorkloadCfg, kv: Dict) -> Dict[str, float]:
    """Per-task compute multipliers a knob setting induces on the
    workload's DAG (frame rate, tiling, detection interval, ...)."""
    m: Dict[str, float] = {}
    if w.name == "covid":
        fr = kv["frame_rate"] / 30.0
        m = {"decode": 1.0, "yolo": fr * kv["tiling"] / kv["det_interval"],
             "kcf": fr, "homography": fr, "mask_cls": fr / kv["det_interval"]}
    elif w.name == "mot":
        fr = kv["frame_rate"] / 30.0
        sz = SIZE_MULT[kv["model_size"]]
        hist = 0.7 + 0.3 * kv["history"]
        m = {"decode": 1.0, "detect": fr * kv["tiling"],
             "embed": fr * sz, "graph_tf": fr * sz * hist}
    elif w.name.startswith("mosei"):
        act = 1.0 / (1 + kv["sent_skip"])
        frac = kv["frac_frames"] / 6.0
        sz = SIZE_MULT[kv["model_size"]]
        m = {"asr": 1.0, "glove": act, "face": act * frac,
             "acoustic": act * frac, "fuse_cls": act * sz}
    return m


def config_power(w: WorkloadCfg, kv: Dict) -> float:
    """Scalar 'power' of a knob setting: the 1-D accuracy proxy the
    quality model discounts by content difficulty (Eq. 5)."""
    if w.name == "covid":
        return ((kv["frame_rate"] / 30.0) ** 0.25
                * (1.0 / kv["det_interval"]) ** 0.3
                * (1.0 if kv["tiling"] == 4 else 0.82))
    if w.name == "mot":
        return ((kv["frame_rate"] / 30.0) ** 0.25
                * (1.0 if kv["tiling"] == 4 else 0.85)
                * (0.8 + 0.05 * kv["history"])
                * SIZE_POW[kv["model_size"]])
    # mosei
    return ((1.0 / (1 + kv["sent_skip"])) ** 0.3
            * (kv["frac_frames"] / 6.0) ** 0.3
            * SIZE_POW[kv["model_size"]])


def config_work(w: WorkloadCfg, kv: Dict, fps: float = 30.0) -> float:
    """On-prem core-seconds per segment when everything runs locally.

    DAG task times are per frame at the source rate; the knob multipliers
    already fold in frame-rate / interval / size scaling, so per-segment
    work = sum(on_ms * mult) * fps * segment_seconds / 1e3.
    """
    m = task_multipliers(w, kv)
    total_ms = sum(on_ms * m.get(name, 1.0)
                   for name, _, on_ms, _, _, _ in w.dag)
    return total_ms / 1e3 * fps * w.segment_seconds


# Even the most powerful config degrades somewhat on difficult content
# (e.g. YOLO certainty drops under heavy occlusion at any resolution) —
# this keeps every config's quality discriminative across categories,
# which is the premise of the paper's 1-D content classifier (Eq. 5).
QUALITY_DISCOUNT = 0.85


def quality(power, difficulty):
    """Eq. 5 quality model: clip(1 - difficulty*(1 - 0.85*power), 0, 1)."""
    import numpy as np
    return np.clip(1.0 - difficulty * (1.0 - QUALITY_DISCOUNT * power),
                   0.0, 1.0)
