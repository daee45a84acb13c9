"""``dryrun_multichip(n)``: the port's counterpart of
``__graft_entry__.py::dryrun_multichip``.  An ``n``-shard gene mesh fit on
small shapes, held against the same fit on one device: one
``sharded_iteration_step`` on a single bucket, then a whole
``DegNormEngine.run`` over several buckets and one outlier gene just past
``EngineConfig.seqpar_width``, whose bucket is column-sharded
(parallel/seqpar.py).  On a machine with fewer cards
than shards, the shards share the cards in turn (all ``n`` on one card of a
one-card machine); on the CPU they are CPU devices.

The shards' own kernels launch as the whole bucket's, but PyTorch's batched
products and reductions may pick another algorithm for a shard's smaller
batch on a card, so the check is the engine's parity gate (DI atol 5e-3,
adjusted counts rtol 5e-3, baseline-selection flags equal), and whether the
bits are equal is reported beside it.  The fit is not bit-equal where it
has a column-sharded bucket (its reductions sum the columns in another
order), so ``bit_equal`` is the gene-sharded step's."""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from degnorm_tpu_torch.config import EngineConfig, NMFConfig
from degnorm_tpu_torch.parallel.seqpar import CHUNK
from degnorm_tpu_torch.parallel.sharded import (make_mesh, shard_bucket,
                                                sharded_iteration_step)


def _dataset(n_genes: int, p: int, seed: int, outlier: int = 0):
    """Integral coverage of ``n_genes`` genes of 200-3000 bases (two bucket
    widths) and read counts, from ``seed``; with ``outlier``, one more gene
    of that many bases last."""
    rng = np.random.default_rng(seed)
    cov = OrderedDict()
    lengths = [int(rng.integers(200, 3000)) for _ in range(n_genes)]
    for i, L in enumerate(lengths + ([outlier] if outlier else [])):
        t = np.linspace(0, 1, L)
        base = (np.abs(np.sin(np.pi * t)) + 0.2) * (2 + 8 * rng.random())
        rows = [base * (0.5 + 1.5 * rng.random())
                * (np.exp(-2 * (1 - t) * rng.random()) if j % 2 else 1.0)
                for j in range(p)]
        cov[f"g{i}"] = np.round(np.vstack(rows) * 10).astype(np.float32)
    X = np.round(np.abs(rng.standard_normal((len(cov), p))) * 300 + 30)
    return cov, X


def _held(name: str, rho, x_adj, ran, rho1, x_adj1, ran1) -> float:
    """Hold a sharded result to the one-device one at the parity gate;
    returns the largest DI difference (0.0: the bits are equal where DI's
    and the adjusted counts' are)."""
    rho, x_adj, rho1, x_adj1 = (np.asarray(a, np.float64)
                                for a in (rho, x_adj, rho1, x_adj1))
    if not (np.isfinite(rho).all() and np.isfinite(x_adj).all()):
        raise AssertionError(f"dryrun_multichip: {name} is not finite")
    if not np.array_equal(np.asarray(ran), np.asarray(ran1)):
        raise AssertionError(f"dryrun_multichip: {name}'s baseline-selection "
                             "flags differ from one device's")
    d = float(np.abs(rho - rho1).max())
    r = float(np.abs(x_adj / x_adj1 - 1).max())
    if d > 5e-3 or r > 5e-3:
        raise AssertionError(f"dryrun_multichip: {name} differs from one "
                             f"device's by DI {d}, adjusted counts {r}")
    return max(d, 0.0 if np.array_equal(x_adj, x_adj1) else r)


def dryrun_multichip(n_shards: int, devices: Optional[Sequence] = None,
                     n_genes: int = 96, p: int = 4, seed: int = 3) -> Dict:
    """Run the gene-sharded step and the fit (its outlier column-sharded)
    over ``n_shards`` shards on ``devices`` (default: every visible card, in
    turn; the CPU where there is none) and hold each against one device
    (see the module docstring).  Raises past the gate, or where the outlier
    is not column-sharded; returns what it compared."""
    from degnorm_tpu_torch.engine import DegNormEngine
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [torch.device("cpu")])
    devices = list(devices)
    mesh = make_mesh([devices[s % len(devices)] for s in range(n_shards)])
    first = mesh.devices[0]
    nmf_cfg = NMFConfig(nmf_iter=8, degnorm_iter=2)
    # the outlier's column-sharded bucket at 8,192 bases, not the default
    # 32,768: a bucket is 64 genes or more, and the CPU runs it too
    eng_cfg = EngineConfig(device=str(first), bucket_widths=(1024, 4096),
                           seqpar_width=8192)

    # one iteration of one bucket through sharded_iteration_step
    G, W = 8 * n_shards, 1024
    cov, X = _dataset(G, p, seed)
    F = np.zeros((G, p, W), np.float32)
    mask = np.zeros((G, W), bool)
    for i, m in enumerate(cov.values()):
        L = min(m.shape[1], W)
        F[i, :, :L], mask[i, :L] = m[:, :L], True
    xw = torch.from_numpy(X).to(first)
    scale = torch.ones(p, dtype=torch.float64, device=first)
    ds = torch.zeros(G, dtype=torch.int32, device=first)
    got = sharded_iteration_step(shard_bucket(F, mask, mesh), xw, scale, ds,
                                 nmf_cfg, eng_cfg, mesh)
    one = make_mesh([first])
    want = sharded_iteration_step(shard_bucket(F, mask, one), xw, scale, ds,
                                  nmf_cfg, eng_cfg, one)
    host = [t.cpu().numpy() for t in got + want]
    step_diff = _held("the step", host[0], host[1], host[5], host[6],
                      host[7], host[11])
    step_equal = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, want))

    # a whole fit over several buckets, and an outlier gene past
    # seqpar_width in a bucket of its own, column-sharded
    cov, X = _dataset(4 * G, p, seed + 1,
                      outlier=eng_cfg.seqpar_width + CHUNK)
    engine = DegNormEngine(nmf_cfg, eng_cfg, mesh=mesh)
    fit = engine.run(cov, X)
    n_col = sum(g is not None for g in engine._col_groups)
    if n_shards > 1 and n_col != 1:
        raise AssertionError(f"dryrun_multichip: {n_col} column-sharded "
                             "buckets, not the outlier's one")
    ref = DegNormEngine(nmf_cfg, eng_cfg).run(cov, X)
    fit_diff = _held("the fit", fit.rho, fit.x_adj,
                     fit.ran_baseline_selection, ref.rho, ref.x_adj,
                     ref.ran_baseline_selection)
    fit_equal = all(np.array_equal(getattr(fit, f), getattr(ref, f))
                    for f in ("rho", "x_adj", "ran_baseline_selection"))
    return {"shards": n_shards, "devices": [str(d) for d in mesh.devices],
            "step_genes": G, "fit_genes": len(cov), "samples": p,
            "outlier_bases": eng_cfg.seqpar_width + CHUNK,
            "column_sharded_buckets": n_col,
            "bit_equal": step_equal, "fit_bit_equal": fit_equal,
            "step_max_diff": step_diff, "fit_max_diff": fit_diff}
