"""Content categories (paper §3.2): KMeans over |K|-dim quality vectors.

Port of ``repro/core/categories.py``. The KMeans++ seeding stays the
same numpy code (so both sides start from the same centers); the Lloyd
step and the classifiers are torch ops on the caller's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve


def kmeans_pp_init(Q: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """KMeans++ seeding (offline, numpy)."""
    rng = np.random.default_rng(seed)
    n = Q.shape[0]
    centers = [Q[rng.integers(n)]]
    for _ in range(k - 1):
        d2 = np.min(
            [np.sum((Q - c) ** 2, axis=1) for c in centers], axis=0)
        s = d2.sum()
        if not np.isfinite(s) or s <= 1e-12:
            centers.append(Q[rng.integers(n)])   # degenerate: uniform pick
            continue
        centers.append(Q[rng.choice(n, p=d2 / s)])
    return np.stack(centers)


def _lloyd_step(centers: torch.Tensor, Q: torch.Tensor):
    d = ((Q[:, None, :] - centers[None]) ** 2).sum(-1)
    assign = torch.argmin(d, dim=1)
    oh = torch.nn.functional.one_hot(assign, centers.shape[0]).to(Q.dtype)
    counts = oh.sum(0)
    sums = oh.T @ Q
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp_min(counts, 1.0)[:, None], centers)
    return new, assign


def kmeans(Q, k: int, iters: int = 50, seed: int = 0, *, device=None):
    """Q (n, d) -> (centers (k, d), assignment (n,)) as tensors on
    ``device`` (``None`` means CUDA; see ``repro_torch.device.resolve``)."""
    device = resolve(device)
    Qn = np.asarray(Q, np.float32)
    centers = torch.as_tensor(kmeans_pp_init(Qn, k, seed), device=device)
    Qt = torch.as_tensor(Qn, device=device)
    for _ in range(iters):
        centers, _ = _lloyd_step(centers, Qt)
    # order centers by mean quality (ascending difficulty) for determinism
    order = torch.argsort(centers.mean(1), stable=True)
    centers = centers[order]
    _, assign = _lloyd_step(centers, Qt)
    return centers, assign


def classify_full(vec: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Full-vector nearest center (offline labeling)."""
    return torch.argmin(((centers - vec[None]) ** 2).sum(-1))


def classify_1d(qual, k_idx, centers: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 5: argmin_c |centers[c, k_cur] - qual|."""
    return torch.argmin(torch.abs(centers[:, k_idx] - qual))
