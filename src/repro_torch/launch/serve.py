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
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import get
from repro_torch.data.tokens import SyntheticCorpus
from repro_torch.device import resolve
from repro_torch.models.model import Model
from repro_torch.models.options import RunOptions


def serve(model: Model, params: Dict, corpus: SyntheticCorpus, *,
          requests: int, batch: int, prompt_len: int, gen: int,
          frames: Optional[Callable[[int, int], torch.Tensor]] = None,
          log: Callable[[str], None] = print) -> Dict:
    """Answer ``requests`` prompts of ``prompt_len`` corpus tokens in
    batches of ``batch``: one prefill with room for ``gen`` tokens, then
    ``gen - 1`` decode steps, so ``gen`` tokens per request. An
    encoder-decoder model needs ``frames``: ``frames(b, row0)`` gives the
    (b, S_enc, d_model) encoder frames of the batch of b requests from
    request ``row0``, and the prefill takes ``{"frames", "tokens"}``.
    Returns the token count, the wall seconds (each batch ends in a host
    read of its tokens), the part of them spent drawing prompts on the
    host (the device is idle then) and each batch's generated tokens."""
    if model.cfg.family == "encdec" and frames is None:
        raise ValueError(f"{model.cfg.name} is an encoder-decoder model: "
                         "serve needs its encoder frames (frames=)")
    dev = params["embed"].device
    total, outputs, draw_s = 0, [], 0.0
    t0 = time.time()
    for r0 in range(0, requests, batch):
        b = min(batch, requests - r0)
        t_draw = time.time()
        toks = torch.as_tensor(corpus.batch(b, prompt_len, r0), device=dev)
        draw_s += time.time() - t_draw
        inputs = {"tokens": toks}
        if frames is not None:
            inputs["frames"] = frames(b, r0)
        nxt, cache = model.prefill(params, inputs,
                                   cache_len=prompt_len + gen)
        outs = [nxt]
        for _ in range(gen - 1):
            nxt, cache = model.decode_step(params, cache, nxt)
            outs.append(nxt)
        generated = torch.stack(outs, 1).cpu().numpy()
        total += b * gen
        outputs.append(generated)
        log(f"batch {r0 // batch}: generated {generated[0][:8]}...")
    return {"tokens": total, "seconds": time.time() - t0,
            "draw_seconds": draw_s, "outputs": outputs}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get(args.arch).reduced()
    if cfg.family == "encdec":
        raise ValueError(f"the serve CLI does not serve {args.arch}: an "
                         "encoder-decoder model needs encoder frames, which "
                         "the CLI does not draw; call serve(..., frames=)")
    dev = resolve(args.device)
    opts = RunOptions(remat="none", layer_loop="scan",
                      compute_dtype="float32", q_chunk=64, kv_chunk=64)
    model = Model(cfg, opts)
    params = model.init(torch.Generator().manual_seed(args.seed), dev)
    corpus = SyntheticCorpus(cfg.vocab, args.seed)
    stats = serve(model, params, corpus, requests=args.requests,
                  batch=args.batch, prompt_len=args.prompt_len, gen=args.gen)
    print(f"[serve] {stats['tokens']} tokens in {stats['seconds']:.2f}s "
          f"({stats['tokens'] / stats['seconds']:.1f} tok/s on {dev.type} "
          f"reduced config)")
    return stats


if __name__ == "__main__":
    main()
