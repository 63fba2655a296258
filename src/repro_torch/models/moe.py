"""Top-k MoE FFN: the port of ``repro/models/moe.py``, GShard/Switch-style
capacity dispatch through one-hot einsums.

The router runs in float32 (x and the router in x's dtype, widened, so
a bfloat16 product is exact and summed in float32, as the reference's
``preferred_element_type``), then softmax, top-k with renormalised
gates and the Switch load-balance loss. Each expert keeps
C = ceil(K * S * capacity_factor / E) slots; a token's slot is its
place in a float32 cumsum over the batch row, first choices counted
before second ones, and a token past an expert's capacity is dropped
there. The expert products are ``torch.einsum``, as the reference
computes them outside any kernel. The reference's ``shard`` annotations
change no value and are not ported (``distribution/sharding.py``).

Across ranks (a ``layout`` whose batch is split over n > 1 ranks) the
load-balance loss stays the global batch's: a product of means is not
the mean of the ranks' products, so the token count and the per-expert
first-choice counts are summed over the batch's ranks first, and each
rank returns its share, E * sum_e (its probs' sum_e / N) (count_e / N)
with N the global token count; the shares sum to the global loss and
their gradients to its gradient. The capacity is per sequence, so the
dispatch is each rank's own.

Across the model group (``sp``, the train step's
``sharding.ModelSplit``) every rank holds the same tokens, so the
routing, the dispatch positions and the aux loss are computed alike on
each, and each of the reference's ``RunOptions.moe_sharding`` rules
reduces to a partial of ``y`` on each rank and one ``g``:

- ``"tp"``: each rank's ``expert_ff`` columns of every expert;
- ``"cap"``: each rank's share of the C capacity slots (the expert
  weights whole on every rank, their gradients summed over the group);
- ``"ep"``: each rank's E / m experts.

The experts' input enters through ``f``, and so does the gate, so the
router's gradient through the combine weights, a part on each rank,
comes out whole. The reference's ``"expert"`` rule would want an
all-to-all only if the batch's rows ran over ``"model"``; they do not
(the rules put ``"batch"`` on ``("pod", "data")``), so each rank
dispatches the tokens it already has to its own experts.

Sequence-split (``sp.seq``: each rank holds its rows of ``x``), the
router runs on this rank's rows and its logits are gathered (each rank
then routes every token alike, as without the split, and keeps its own
rows of their gradient), ``f`` gathers the experts' input and ``g``
scatters ``y`` back to rows; the router's gradient is then a part on
each rank, summed over the group (``transformer.layer_modes``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def route(probs: torch.Tensor, k: int):
    """The router's choice: the ``k`` largest of ``probs`` along the last
    axis, largest first, ties toward the lower index, as
    ``jax.lax.top_k`` orders them (a stable descending sort;
    ``torch.topk`` promises no order on ties). Returns (values, int64
    indices)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p, x, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, group_size: int = 0,
            layout=None, sp=None, sharding: str = "tp"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d). p: router (d,E), w_gate/w_up (E,d,f), w_down (E,f,d).
    Returns (y (B,S,d) in x's dtype, the float32 aux load-balance loss).

    ``group_size`` splits a sequence longer than it (and a multiple of
    it) into token groups before dispatch (GShard's group dim), so the
    dispatch tensors scale with the group, not S. With ``sp`` the
    experts' products are this rank's part under ``sharding`` (the
    module's docstring): w_gate, w_up and w_down its ``expert_ff``
    columns (``"tp"``) or its experts (``"ep"``), or whole
    (``"cap"``)."""
    E, K = n_experts, top_k
    seq = sp is not None and sp.seq
    if seq:         # this rank's rows: route them, then gather every row
        logits = sp.gather_alike(x.float() @ p["router"].to(x.dtype).float())
        x = sp.f(x)
    B0, S0, d = x.shape
    regroup = group_size and S0 > group_size and S0 % group_size == 0
    if regroup:
        x = x.reshape(B0 * (S0 // group_size), group_size, d)
    B, S, _ = x.shape
    C = max(1, int(-(-K * S * capacity_factor // E)))

    if seq:
        logits = logits.reshape(B, S, E)
    else:
        logits = x.float() @ p["router"].to(x.dtype).float()    # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = route(probs, K)                                 # (B,S,K)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    xd = x if sp is None or seq else sp.f(x)     # the experts' input
    if sp is not None:
        gate = sp.sum_grads(gate)

    # load-balance aux loss (Switch): E * sum_e fraction_e * prob_e
    if layout is None or layout.n_batch == 1:
        me = probs.mean(dim=(0, 1))
        ce = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    else:       # this rank's share of the global batch's loss
        sums = layout.batch_sum(torch.cat([
            F.one_hot(idx[..., 0], E).float().sum(dim=(0, 1)),
            torch.full((1,), B * S, dtype=torch.float32,
                       device=x.device)]))
        me = probs.sum(dim=(0, 1)) / sums[E]
        ce = sums[:E] / sums[E]
    aux = E * torch.sum(me * ce)

    onehot = F.one_hot(idx, E).float()                          # (B,S,K,E)
    # dispatch position: first-choice slots counted before second-choice
    oh_flat = onehot.permute(0, 2, 1, 3).reshape(B, K * S, E)
    pos = torch.cumsum(oh_flat, dim=1) - 1.0                    # (B,K*S,E)
    pos = pos.reshape(B, K, S, E).permute(0, 2, 1, 3)           # (B,S,K,E)
    keep = (pos < C) & (onehot > 0)
    # one-hot of a float position (-1 and positions past C: all zero)
    cs = torch.arange(C, dtype=torch.float32, device=x.device)
    slot = (pos[..., None] == cs).to(x.dtype)                   # (B,S,K,E,C)
    disp_k = torch.where(keep[..., None], slot, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
    dispatch = disp_k.sum(dim=2)                                # (B,S,E,C)
    combine = (disp_k * gate[..., None, None].to(x.dtype)).sum(dim=2)
    del slot, disp_k

    if sp is not None and sharding == "ep":       # this rank's experts
        e0, e1 = sp.part(E)
        dispatch, combine = dispatch[:, :, e0:e1], combine[:, :, e0:e1]
    elif sp is not None and sharding == "cap":    # this rank's slots
        c0, c1 = sp.span(C)
        dispatch, combine = dispatch[..., c0:c1], combine[..., c0:c1]

    xe = torch.einsum("bsec,bsd->ebcd", dispatch, xd)           # (E,B,C,d)
    g = torch.einsum("ebcd,edf->ebcf", xe, p["w_gate"].to(x.dtype))
    u = torch.einsum("ebcd,edf->ebcf", xe, p["w_up"].to(x.dtype))
    h = F.silu(g) * u
    del g, u
    ye = torch.einsum("ebcf,efd->ebcd", h, p["w_down"].to(x.dtype))
    y = torch.einsum("bsec,ebcd->bsd", combine, ye)
    if regroup:
        y = y.reshape(B0, S0, d)
    if sp is not None:
        y = sp.g(y)
    return y, aux.float()
