"""Common layers: the port of ``repro/models/layers.py`` (norms, MLP
variants, embeddings, logits and the sinusoidal positions). The
reference's ``shard(...)`` constraints change no value, so they are gone
(across cards each rank runs its own rows: ``distribution/sharding.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x, w, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * w).to(dt)


def layer_norm(x, w, b, eps: float = 1e-5):
    """The reference's formula: float32 upcast, mean, the biased variance
    ``((x - mu) ** 2).mean``, ``rsqrt``; the result in x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * w + b).to(dt)


def padded_vocab(vocab: int, multiple: int = 256) -> int:
    return -(-vocab // multiple) * multiple


def mlp(params, x, kind: str):
    """kind: swiglu (w_gate, w_up, w_down) | relu2 / gelu (w_up, w_down,
    gelu with optional b_up, b_down)."""
    if kind == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif kind == "relu2":
        h = torch.relu(x @ params["w_up"]) ** 2
    elif kind == "gelu":
        h = x @ params["w_up"]
        if "b_up" in params:
            h = h + params["b_up"]
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh") @ params["w_down"]
        return h + params["b_down"] if "b_down" in params else h
    else:
        raise ValueError(kind)
    return h @ params["w_down"]


def embed_tokens(table, tokens):
    """table (Vp, d); tokens (B, S) integer."""
    return table[tokens.long()]


def lm_logits(x, head, vocab: int):
    """x (..., d) @ head (d, Vp) -> (..., Vp), padded columns at -1e30."""
    logits = x @ head
    vp = head.shape[-1]
    if vp != vocab:
        logits[..., vocab:] = NEG_INF
    return logits


def softmax_xent(logits, labels, vocab: int):
    """Mean next-token cross entropy in float32: logits (B,S,Vp), their
    padded columns at -1e30 (``lm_logits``), labels (B,S) integer. The
    reference's formula: log-sum-exp minus the gold logit. ``vocab`` is
    the reference's argument; the padded columns need no further mask."""
    del vocab
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def sinusoid_div(d: int, device=None):
    """(d/2,) float32 frequencies exp(-2i log(10000) / d), the log and the
    division in float32 as the reference computes them."""
    c = -torch.log(torch.tensor(10000.0, device=device)) / d
    return torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                  device=device) * c)


def sinusoidal_positions(n: int, d: int, device=None):
    """(n, d) float32: sin at the even columns, cos at the odd ones."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    ang = pos * sinusoid_div(d, device)
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe
