"""Runtime options (orthogonal to ``ArchConfig``): the port's copy of
``repro/models/options.py`` with the fields a one-card run reads, the
kv cache's dtype, the MoE's capacity factor and token-group size, and
the training knobs (``remat``, ``microbatches``, ``aux_loss_weight``)
among them. The reference's
mesh-only knobs (``moe_sharding``, ``fsdp``, ``rules()`` and the like)
have no counterpart on one card. Also the stated tolerance of logits at
the default bfloat16 compute dtype (``bf16_logit_tolerance``, with
``bf16_boundaries``)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RunOptions:
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kv_cache_dtype: str = ""       # "" -> compute_dtype; e.g. float8_e4m3fn
    remat: str = "full"            # none | full | dots (training only;
                                   # transformer.remat)
    layer_loop: str = "scan"       # scan | unroll: both are a layer loop here
    q_chunk: int = 512             # the reference's attention chunking;
    kv_chunk: int = 1024           # K3 picks its own tiles
    ssd_chunk: int = 256           # SSD chunk length (K4's Q)
    microbatches: int = 1          # train step: gradient accumulation
    moe_group: int = 0             # GShard token-group size (0 = whole seq)
    capacity_factor: float = 1.25  # MoE expert capacity, of K * S / E
    aux_loss_weight: float = 0.01  # the MoE load-balance loss in lm_loss


# one ulp of bfloat16 relative to the value, at most (8 significant bits)
BF16_ULP = 2.0 ** -7


def bf16_logit_tolerance(n_layers: int, max_abs_logit: float) -> float:
    """How far two bfloat16 forwards of the same model and params may put
    their logits apart when they differ only in their float32 arithmetic
    (sums in another order, 3xTF32 products in a kernel).

    Derivation. Inside a layer both forwards accumulate in float32 (the
    matmuls, K3, K4), so before a rounding their values differ by far less
    than a bfloat16 ulp. The residual stream is rounded to bfloat16 at
    each layer boundary: the two round to the same value or to neighbours
    one ulp apart, at most BF16_ULP of the value. A difference in the
    stream is carried by the later layers at a gain of about one
    (pre-norm residual blocks whose branches are scaled by 1/sqrt(fan-in))
    and adds to those of later boundaries: the embedding's and the
    ``n_layers`` boundaries leave the final stream at most n_layers + 1
    ulps apart, which the head carries into the logits as that many ulps
    of their magnitude; the logits' own rounding to bfloat16 adds one
    more. So |logits - logits'| <= (n_layers + 2) BF16_ULP max|logit|,
    with ``n_layers`` the boundaries the stream crosses
    (``bf16_boundaries``)."""
    return (n_layers + 2) * BF16_ULP * max_abs_logit


def bf16_boundaries(cfg) -> int:
    """The ``n_layers`` of ``bf16_logit_tolerance`` for the model ``cfg``:
    its layers, and for an encoder-decoder model also the encoder's.

    Derivation. The encoder's stream is rounded to bfloat16 where the
    frames come in and at each of its n_enc layer boundaries, and its
    normed output once more: the two forwards' encoder outputs end at
    most n_enc + 2 ulps apart. Every decoder layer reads that output
    through the cross-attention's k and v, a softmax-weighted mean of v
    whose weights move by about as much, and carries the difference into
    the decoder's stream at a gain of about one, as the stream carries
    its own; it adds to the decoder's n_layers + 1 and the logits' own
    rounding. So an encoder-decoder model counts n_layers + n_enc + 2."""
    return cfg.n_layers + (cfg.n_enc_layers + 2 if cfg.n_enc_layers else 0)
