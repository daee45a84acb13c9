"""Per-iteration DegNorm checkpointing.

The reference has NO checkpointing inside the NMF iterations (SURVEY.md
§5.4) — a crash loses everything since the last ETL artifact.  Here the
outer-loop state (DI scores, adjusted counts, scale factors, baseline
tracker) is snapshotted after every DegNorm iteration, and ``run`` can
resume mid-loop.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from degnorm_tpu_torch.core.degnorm import GlobalState
from degnorm_tpu_torch.parallel.distributed import is_coordinator


def checkpoint_path(output_dir: str) -> str:
    return os.path.join(output_dir, "degnorm_checkpoint.npz")


def save_checkpoint(output_dir: str, iteration: int, state,
                    ran_baseline_selection: np.ndarray,
                    genes) -> str:
    """Snapshot GlobalState after ``iteration`` (0-based, completed),
    in the JAX package's npz format (same keys), so either package resumes
    the other's run.

    Multi-process: only the coordinator writes (every process reaches this
    point with the same state and would race ``os.replace`` on one shared
    path); every process loads the shared checkpoint on resume."""
    path = checkpoint_path(output_dir)
    if not is_coordinator():
        return path
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp,
        iteration=np.int64(iteration),
        x=state.x, x_weighted=state.x_weighted, x_adj=state.x_adj,
        rho=state.rho, norm_factors=state.norm_factors,
        scale_factors=state.scale_factors,
        ran_baseline_selection=ran_baseline_selection,
        genes=np.array(list(genes), dtype=object))
    # numpy appends .npz to the tmp name
    actual_tmp = tmp if os.path.exists(tmp) else tmp + ".npz"
    os.replace(actual_tmp, path)
    return path


def load_checkpoint(output_dir: str, genes) -> Optional[Dict]:
    """Load a checkpoint if present and its gene set matches; else None."""
    path = checkpoint_path(output_dir)
    if not os.path.isfile(path):
        return None
    with np.load(path, allow_pickle=True) as z:
        saved_genes = list(z["genes"])
        if saved_genes != list(genes):
            return None
        state = GlobalState(
            x=z["x"], x_weighted=z["x_weighted"], x_adj=z["x_adj"],
            rho=z["rho"], norm_factors=z["norm_factors"],
            scale_factors=z["scale_factors"])
        return {"iteration": int(z["iteration"]), "state": state,
                "ran_baseline_selection": z["ran_baseline_selection"]}
