"""Forecasting model (paper §3.3, App. H/K): a small MLP mapping the
recent history of per-interval content-category histograms to the
category histogram of the next planned interval.

Port of ``repro/core/forecaster.py``. The parameters are a plain dict of
tensors, ``{"l1": {"w", "b"}, "l2": ..., "l3": ...}``, the same tree as
the reference, so ``repro_torch.convert`` carries weights across as they
are. Architecture (App. K): input -> 16 (ReLU) -> 8 (ReLU) -> |C|
(softmax). Trained 40 epochs with the reference's hand-written Adam,
20% validation split, best-val weights kept.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve

LAYERS = ("l1", "l2", "l3")


def init_forecaster(generator: torch.Generator, n_split: int,
                    n_categories: int, *, device=None) -> Dict:
    """Init the tiny MLP on ``device`` (``None`` means CUDA); draws come
    from ``generator`` (a CPU ``torch.Generator``), so they differ from
    the reference's ``jax.random`` draws: tests that need both sides on
    one init carry the reference's params across
    (``convert.forecaster_from_arrays``)."""
    device = resolve(device)
    d_in = n_split * n_categories

    def lin(i, o):
        w = torch.randn((i, o), generator=generator) / np.sqrt(i)
        return {"w": w.to(device=device, dtype=torch.float32),
                "b": torch.zeros((o,), device=device)}

    return {"l1": lin(d_in, 16), "l2": lin(16, 8),
            "l3": lin(8, n_categories)}


def forecast(params, hist: torch.Tensor) -> torch.Tensor:
    """hist (..., n_split, |C|) -> predicted histogram (..., |C|)."""
    x = hist.reshape(hist.shape[:-2] + (-1,))
    x = torch.relu(x @ params["l1"]["w"] + params["l1"]["b"])
    x = torch.relu(x @ params["l2"]["w"] + params["l2"]["b"])
    return torch.softmax(x @ params["l3"]["w"] + params["l3"]["b"], dim=-1)


def history_histogram(label_buf: torch.Tensor, n_categories: int, *,
                      n_split: int, interval: int) -> torch.Tensor:
    """(..., n_split * interval) most recent labels, oldest first -> the
    (..., n_split, |C|) per-sub-interval category histograms (a leading
    axis batches streams). The mean is a sum of 0/1 values (exact in any
    order) divided by ``interval``, as ``jnp.mean`` does."""
    oh = torch.nn.functional.one_hot(label_buf.long(), n_categories)
    counts = oh.to(torch.float32).reshape(
        label_buf.shape[:-1] + (n_split, interval, n_categories)).sum(-2)
    # a tensor divisor: CUDA divides by a Python number through its
    # reciprocal, which rounds differently
    return counts / torch.tensor(float(interval), device=counts.device)


def forecast_from_labels(params, label_buf: torch.Tensor, n_categories: int,
                         *, n_split: int, interval: int) -> torch.Tensor:
    """``forecast`` on a fixed-shape rolling label buffer ((hist,) or
    (V, hist) for V streams at once), evaluated in float64 and rounded
    to float32 once at the end.

    The card and the CPU sum a float32 matmul in different orders and
    round ``exp`` differently, and a last-bit change of the forecast can
    move the LP's plan and through it a switcher decision. In float64
    those differences sit far below float32's rounding, so the online
    loop takes the same decisions on every device; the result stays
    within a float32 rounding of the reference's float32 forecast."""
    hist = history_histogram(label_buf, n_categories, n_split=n_split,
                             interval=interval)
    p64 = {n: {k: v.double() for k, v in layer.items()}
           for n, layer in params.items()}
    return forecast(p64, hist.double()).float()


def _loss(params, X, Y):
    pred = forecast(params, X)
    return ((pred - Y) ** 2).sum(-1).mean()


def _flat(params):
    return [params[n][p] for n in LAYERS for p in ("w", "b")]


def _unflat(leaves):
    it = iter(leaves)
    return {n: {"w": next(it), "b": next(it)} for n in LAYERS}


def _adam_step(params, opt, X, Y, lr: float):
    """One step of the reference's hand-written Adam (``forecaster.py:69``),
    with the gradient from autograd. Returns new tensors; nothing is
    updated in place, so a kept ``best`` tree stays valid."""
    leaves = [p.detach().requires_grad_(True) for p in _flat(params)]
    loss = _loss(_unflat(leaves), X, Y)
    grads = torch.autograd.grad(loss, leaves)
    t = opt["t"] + 1
    tt = torch.tensor(t, dtype=torch.int32)
    c1 = 1 - torch.tensor(0.9) ** tt
    c2 = 1 - torch.tensor(0.999) ** tt
    new_p, new_m, new_v = [], [], []
    with torch.no_grad():
        for p, g, m, v in zip(leaves, grads, opt["m"], opt["v"]):
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mhat = m / c1.to(m.device)
            vhat = v / c2.to(v.device)
            new_p.append((p - lr * mhat / (torch.sqrt(vhat) + 1e-8)).detach())
            new_m.append(m)
            new_v.append(v)
    return _unflat(new_p), {"m": new_m, "v": new_v, "t": t}


def train_forecaster(params, X, Y, *, epochs: int = 40, lr: float = 3e-3,
                     val_frac: float = 0.2, batch: int = 64, seed: int = 0):
    """X (n, n_split, |C|), Y (n, |C|) numpy. Returns (best params,
    metrics). The batch order comes from the same numpy generator as the
    reference's, so both sides see the same batches."""
    device = params["l1"]["w"].device
    n = X.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_val = max(1, int(n * val_frac))
    vi, ti = perm[:n_val], perm[n_val:]

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    Xt, Yt = dev(X[ti]), dev(Y[ti])
    Xv, Yv = dev(X[vi]), dev(Y[vi])
    opt = {"m": [torch.zeros_like(p) for p in _flat(params)],
           "v": [torch.zeros_like(p) for p in _flat(params)], "t": 0}
    best, best_val = params, float("inf")
    nt = Xt.shape[0]
    for _ in range(epochs):
        order = rng.permutation(nt)
        for i in range(0, nt, batch):
            idx = torch.as_tensor(order[i:i + batch], device=device)
            params, opt = _adam_step(params, opt, Xt[idx], Yt[idx], lr)
        with torch.no_grad():
            val = float(_loss(params, Xv, Yv))
        if val < best_val:
            best, best_val = params, val
    with torch.no_grad():
        mae = float((forecast(best, Xv) - Yv).abs().mean())
    return best, {"val_mse": best_val, "val_mae": mae}


def make_dataset(labels: np.ndarray, n_categories: int, *,
                 interval: int, n_split: int, horizon: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """labels (T,) per-segment category ids -> (X, Y) histogram pairs
    (numpy, the same code as the reference).

    interval: segments per input sub-interval; n_split sub-intervals of
    history predict the histogram of the next ``horizon`` segments.
    """
    T = len(labels)
    oh = np.eye(n_categories, dtype=np.float32)[labels]
    X, Y = [], []
    span = interval * n_split
    step = max(1, interval // 2)
    for t in range(span, T - horizon, step):
        hist = oh[t - span:t].reshape(n_split, interval, n_categories).mean(1)
        X.append(hist)
        Y.append(oh[t:t + horizon].mean(0))
    return np.stack(X), np.stack(Y)
