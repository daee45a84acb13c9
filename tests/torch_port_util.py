"""Shared helpers of the tests/test_torch_*.py files: inputs are made with
numpy from a seed and handed to both the JAX package and the PyTorch port."""
import numpy as np


def random_coverage(rng, p, L, scale=10.0, degraded=False):
    """Plausible coverage matrix: smooth positive envelope with
    sample-specific degradation ramps (same recipe as tests/conftest.py)."""
    t = np.linspace(0, 1, L)
    base = scale * (0.25 + np.abs(np.sin(np.pi * t)
                                  + 0.3 * rng.standard_normal(L) * 0.05))
    rows = []
    for j in range(p):
        amp = 0.5 + rng.random() * 1.5
        row = amp * base
        if degraded and j % 2 == 1:
            row = row * np.exp(-2.0 * (1 - t) * rng.random())
        rows.append(row)
    return np.round(np.maximum(np.vstack(rows), 0.0), 3)


def make_bucket_np(mats, W, dtype=np.float64):
    """Pad (p, L_i) matrices into a (G, p, W) array + (G, W) length mask."""
    G, p = len(mats), mats[0].shape[0]
    F = np.zeros((G, p, W), dtype=dtype)
    mask = np.zeros((G, W), dtype=bool)
    for i, m in enumerate(mats):
        F[i, :, :m.shape[1]] = m
        mask[i, :m.shape[1]] = True
    return F, mask


def degraded_bucket(seed, p, lengths, W, dtype):
    rng = np.random.default_rng(seed)
    mats = [random_coverage(rng, p, L, degraded=(i % 2 == 0)).astype(dtype)
            for i, L in enumerate(lengths)]
    return make_bucket_np(mats, W, dtype=dtype)


def to_np(t):
    return t.detach().cpu().numpy()
