"""The paper's own V-ETL workloads (§5.2), re-synthesized.

Each workload defines: the knob space (name -> domain), the synthetic
stream generator parameters (content categories with diurnal/spike
dynamics and per-(category, config) ground-truth quality), and the
resource provisioning grid used in Fig. 4 / Table 2.

Real sources (Shibuya streams, CMU-MOSEI, Twitch counts) are not
available offline; generators match the published statistics instead:
category dwell times (COVID 42 s, MOT 43 s, MOSEI-HIGH 30 s,
MOSEI-LONG 24 s), diurnal periodicity, and the HIGH/LONG spike shapes.

A copy of ``repro/configs/workloads.py``: the port keeps its own so it
never imports ``repro``; ``tests/test_torch_offline.py`` holds the two
equal field by field.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class WorkloadCfg:
    name: str
    knobs: Dict[str, tuple]
    # latent content states ("easy"/"medium"/"hard"/...), their base rates
    n_latent: int
    dwell_seconds: float            # mean category dwell time (paper §5.3)
    diurnal: bool                   # day/night cycle (traffic cams)
    spike: str                      # none | high | long
    segment_seconds: float = 2.0    # knob switcher period (paper: 2 s)
    # UDF DAG: list of (task_name, deps, onprem_ms, cloud_ms, mb_in, mb_out)
    dag: Tuple = ()


# --- COVID: YOLOv5 detector + KCF tracker + homography (detect-to-track) ---
COVID = WorkloadCfg(
    name="covid",
    knobs={
        "frame_rate": (30, 15, 10, 5, 1),
        "det_interval": (1, 5, 30, 60),
        "tiling": (1, 4),            # 1x1 / 2x2 tiles
    },
    n_latent=3,
    dwell_seconds=42.0,
    diurnal=True,
    spike="none",
    dag=(
        ("decode", (), 1.6, 1.6, 0.0, 2.7),
        ("yolo", ("decode",), 86.0, 35.0, 0.20, 0.01),
        ("kcf", ("yolo",), 9.0, 6.0, 0.20, 0.01),
        ("homography", ("kcf",), 2.0, 2.0, 0.01, 0.01),
        ("mask_cls", ("yolo",), 30.0, 14.0, 0.05, 0.01),
    ),
)

# --- MOT: TransMOT graph-transformer tracker -------------------------------
MOT = WorkloadCfg(
    name="mot",
    knobs={
        "frame_rate": (30, 15, 10, 5),
        "tiling": (1, 4),
        "history": (1, 2, 3, 5),
        "model_size": ("small", "medium", "large"),
    },
    n_latent=3,
    dwell_seconds=43.0,
    diurnal=True,
    spike="none",
    dag=(
        ("decode", (), 1.6, 1.6, 0.0, 2.7),
        ("detect", ("decode",), 86.0, 35.0, 0.20, 0.02),
        ("embed", ("detect",), 40.0, 18.0, 0.10, 0.02),
        ("graph_tf", ("embed",), 120.0, 45.0, 0.05, 0.01),
    ),
)

# --- MOSEI: multimodal sentiment over many Twitch-like streams -------------
def _mosei(spike: str, dwell: float) -> WorkloadCfg:
    return WorkloadCfg(
        name=f"mosei-{spike}",
        knobs={
            "sent_skip": (0, 1, 2, 3, 4, 5, 6),
            "frac_frames": (1, 2, 3, 4, 5, 6),   # sixths of each sentence
            "model_size": ("small", "medium", "large"),
        },
        n_latent=5,
        dwell_seconds=dwell,
        diurnal=False,
        spike=spike,
        segment_seconds=7.0,   # paper: 7 s for MOSEI
        dag=(
            ("asr", (), 60.0, 30.0, 0.30, 0.01),
            ("glove", ("asr",), 5.0, 4.0, 0.01, 0.01),
            ("face", (), 70.0, 30.0, 0.20, 0.02),
            ("acoustic", (), 25.0, 12.0, 0.30, 0.01),
            ("fuse_cls", ("glove", "face", "acoustic"), 45.0, 20.0, 0.02, 0.01),
        ),
    )


MOSEI_HIGH = _mosei("high", 30.0)
MOSEI_LONG = _mosei("long", 24.0)

WORKLOADS = {w.name: w for w in (COVID, MOT, MOSEI_HIGH, MOSEI_LONG)}

# Fig. 4 provisioning grid: (vCPUs, USD/h) Google-Cloud-equivalents.
SERVER_GRID = ((4, 0.14), (8, 0.27), (16, 0.54), (32, 1.07), (60, 2.51))
ONPREM_DISCOUNT = 1.8        # App. L: cloud VM is 1.8x an on-prem core
CLOUD_COST_PER_CORE_S = 0.27 / 3600 / 8 * 1.8   # lambda-equivalent $/core-s
