"""V-ETL Transform over a model-zoo backbone: the port of
``repro/core/vetl_serving.py``.

A V-ETL job whose UDF is a transformer forward. Knobs map to the
paper's families (§5.2):

- ``sample_every``: temporal sampling (frame-rate knob),
- ``resolution``: frame downsample factor, through kernel K2,
- ``model_size``: small / medium / large backbone variants.

Quality is the mean top-1 certainty of the model on the segment's
tokens (the paper's certainty-as-quality proxy). The backbone is the
reduced qwen1.5-0.5b decoder at the reference's ``SIZES``; its attention
is kernel K3 on the card.

A segment is ``{"frames": (F,H,W,C) float, "tokens": (F,S) integer}``,
as tensors on the job's device (numpy arrays are moved there).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import get
from repro_torch.device import resolve
from repro_torch.kernels.frame_preproc import downsample
from repro_torch.models.model import Model
from repro_torch.models.options import RunOptions

SIZES = {"small": (1, 32), "medium": (2, 48), "large": (3, 64)}


class BackboneVETL:
    """A V-ETL job: frames -> (stub frontend) -> backbone -> certainty."""

    def __init__(self, arch: str = "qwen1.5-0.5b", seed: int = 0,
                 device=None):
        self.device = resolve(device)
        base = get(arch).reduced()
        opts = RunOptions(remat="none", layer_loop="scan",
                          compute_dtype="float32", q_chunk=64, kv_chunk=64)
        self.models: Dict[str, Tuple[Model, dict]] = {}
        for name, (layers, width) in SIZES.items():
            cfg = dataclasses.replace(
                base, n_layers=layers, d_model=width, n_heads=4,
                n_kv_heads=min(base.n_kv_heads, 4) or 4, d_ff=2 * width,
                head_dim=width // 4, vocab=base.vocab)
            m = Model(cfg, opts)
            # every size from the same seed, as the reference's one key
            gen = torch.Generator().manual_seed(seed)
            self.models[name] = (m, m.init(gen, self.device))

    def _tensor(self, x):
        return torch.as_tensor(x, device=self.device)

    def _certainty(self, name: str, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (..., F, S) -> mean top-1 probability over the last two
        axes, one value per leading index (a scalar for (F, S))."""
        m, params = self.models[name]
        lead = tokens.shape[:-2]
        logits = m.forward_logits(params,
                                  {"tokens": tokens.reshape(-1,
                                                            tokens.shape[-1])})
        top = torch.softmax(logits, dim=-1).amax(dim=-1)
        return top.reshape(lead + (-1,)).mean(dim=-1)

    def proc_fn(self, segment, knobs):
        """segment: dict(frames=(F,H,W,C), tokens=(F,S)). Returns
        (detections stub, quality)."""
        sample = knobs.get("sample_every", 1)
        frames = self._tensor(segment["frames"])[::sample]
        tokens = self._tensor(segment["tokens"])[::sample]
        res = knobs.get("resolution", 1)
        if res > 1:
            frames = downsample(frames, res, block=16)
        cert = self._certainty(knobs.get("model_size", "small"), tokens)
        # certainty as the quality proxy; the frames go through the
        # pixel path (the downsample kernel) above
        return {"n_frames": frames.shape[0]}, float(cert)

    def proc_batch(self, segments, knob_list):
        """Multi-stream Transform: per-stream segments and knobs. Streams
        whose knobs select the same backbone and sampling (and whose
        token shapes agree) run as one batched forward. Returns
        (results, qualities) in input order."""
        groups: Dict[tuple, list] = {}
        for i, (seg, kv) in enumerate(zip(segments, knob_list)):
            gkey = (kv.get("model_size", "small"), kv.get("sample_every", 1),
                    tuple(seg["tokens"].shape))
            groups.setdefault(gkey, []).append(i)
        results = [None] * len(segments)
        quals = [0.0] * len(segments)
        for (name, sample, _), idxs in groups.items():
            toks = torch.stack([self._tensor(segments[i]["tokens"])[::sample]
                                for i in idxs])
            certs = self._certainty(name, toks).tolist()
            for j, i in enumerate(idxs):
                frames = self._tensor(segments[i]["frames"])[::sample]
                res = knob_list[i].get("resolution", 1)
                if res > 1:
                    frames = downsample(frames, res, block=16)
                results[i] = {"n_frames": frames.shape[0]}
                quals[i] = float(certs[j])
        return results, quals
