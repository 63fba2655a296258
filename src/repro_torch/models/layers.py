"""Common layers: the port of ``repro/models/layers.py`` (norms, MLP
variants, embeddings, logits and the sinusoidal positions).

Where the reference's ``shard(...)`` constraints split a product over
``"model"`` (``mlp``'s hidden ``"tensor"`` columns, ``lm_logits``'s
``"vocab"`` columns), the functions take ``sp``, the train step's
``sharding.ModelSplit`` (None: the whole product, as without a mesh):
``mlp`` column-parallel then row-parallel with one ``g``;
``embed_tokens`` a vocab-parallel lookup (rows outside this rank's give
0, then ``g``); ``lm_logits`` this rank's vocab columns;
``softmax_xent`` the vocab-parallel cross entropy (``_VocabXent``);
``rms_norm_split`` a norm over a dim split over the group. A
sequence-split ``sp`` (``sp.seq``) turns ``f`` and ``g`` into a gather
and a scatter of rows, so ``mlp`` takes and returns this rank's rows,
``embed_tokens`` returns them and ``lm_logits`` gathers every row."""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x, w, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * w).to(dt)


def rms_norm_split(x, w, sp, n: int, eps: float = 1e-5):
    """``rms_norm`` of a last dim of ``n`` columns split over the model
    group: x and w are this rank's columns; the sum of squares is summed
    over the group both ways (each rank's gradient of it is its own)."""
    dt = x.dtype
    x = x.float()
    ss = sp.sum((x * x).sum(-1, keepdim=True))
    x = x * torch.rsqrt(ss / n + eps)
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


def mlp(params, x, kind: str, sp=None):
    """kind: swiglu (w_gate, w_up, w_down) | relu2 / gelu (w_up, w_down,
    gelu with optional b_up, b_down). With ``sp`` the hidden columns are
    this rank's (w_gate, w_up, b_up its columns, w_down its rows): x
    enters through ``f``, the row-parallel product's parts are summed by
    ``g``, and ``b_down`` is added once, after the sum."""
    if sp is not None:
        x = sp.f(x)
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
        if sp is not None:
            h = sp.g(h)
        return h + params["b_down"] if "b_down" in params else h
    else:
        raise ValueError(kind)
    y = h @ params["w_down"]
    return y if sp is None else sp.g(y)


def embed_tokens(table, tokens, sp=None):
    """table (Vp, d); tokens (B, S) integer. With ``sp`` the table is
    this rank's rows of the vocab: a token outside them gives 0, and
    ``g`` sums the ranks' lookups (each token's row from the one rank
    that holds it)."""
    if sp is None:
        return table[tokens.long()]
    rows = table.shape[0]
    t = tokens.long() - sp.index * rows
    ok = (t >= 0) & (t < rows)
    x = table[t.clamp(0, rows - 1)]
    return sp.g(torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device)))


def lm_logits(x, head, vocab: int, sp=None):
    """x (..., d) @ head (d, Vp) -> (..., Vp), padded columns at -1e30.
    With ``sp`` the head is this rank's vocab columns and x enters
    through ``f``: (..., Vp / m), the columns past ``vocab`` masked at
    their global index."""
    lo = 0
    if sp is not None:
        x = sp.f(x)
        lo = sp.index * head.shape[-1]
    logits = x @ head
    if lo + head.shape[-1] > vocab:
        logits[..., max(vocab - lo, 0):] = NEG_INF
    return logits


def softmax_xent(logits, labels, vocab: int, sp=None):
    """Mean next-token cross entropy in float32: logits (B,S,Vp), their
    padded columns at -1e30 (``lm_logits``), labels (B,S) integer. The
    reference's formula: log-sum-exp minus the gold logit. ``vocab`` is
    the reference's argument; the padded columns need no further mask.
    With ``sp`` the logits are this rank's vocab columns
    (``_VocabXent``)."""
    del vocab
    if sp is not None:
        return _VocabXent.apply(logits, labels, sp)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


class _VocabXent(torch.autograd.Function):
    """The vocab-parallel cross entropy: each rank's (B,S,V/m) columns;
    the row max (all-reduced MAX), the sum of exp (SUM) and the gold
    logit (SUM: the one rank that holds it gives it, the others 0) over
    the model group give every rank the same mean. The backward is local:
    softmax minus the one-hot, over this rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, sp):
        lf = logits.float()
        cols = lf.shape[-1]
        mx = sp.all_reduce(lf.amax(-1, keepdim=True), dist.ReduceOp.MAX)
        se = sp.all_reduce(torch.exp(lf - mx).sum(-1, keepdim=True))
        lse = torch.log(se) + mx
        t = labels.long() - sp.index * cols
        ok = (t >= 0) & (t < cols)
        t = t.clamp(0, cols - 1)
        gold = torch.gather(lf, -1, t[..., None])[..., 0]
        gold = sp.all_reduce(torch.where(ok, gold, torch.zeros_like(gold)))
        ctx.save_for_backward(lf, lse, t, ok)
        ctx.dtype = logits.dtype
        return (lse[..., 0] - gold).mean()

    @staticmethod
    def backward(ctx, g):
        lf, lse, t, ok = ctx.saved_tensors
        p = torch.exp(lf - lse)
        p.scatter_add_(-1, t[..., None], -ok[..., None].to(p.dtype))
        return (p * (g / t.numel())).to(ctx.dtype), None, None


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
