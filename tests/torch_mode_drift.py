"""DI drift of ``trim_fast`` against the default fit, in both packages, on
the CPU: a second witness beside chip_smoke.py's phase ``modes``.

The first N genes of chip_smoke.py's narrow workload (20,480 genes x 8, its
own copy of the bench generator; the subset has its own scale factors) at
``nmf_iter=50`` and 5 DegNorm iterations, bucket widths 1024 and 4096, go
through:
  * the JAX package's engine on its interpret-mode kernels
    (``use_pallas=True, pallas_interpret=True, gram_mode="vpu"``), with and
    without ``trim_fast``;
  * the port's engine on its plain versions (the fused plain loop), with
    and without ``trim_fast``.
It prints one JSON line: each package's drift (DI max and mean, decision
flips, genes with a flip) of trim_fast from its default fit, and the
drift of the port's trim_fast fit from the JAX package's.

Not a test (pytest does not collect it); run it from the repository root:
    JAX_PLATFORMS=cpu python tests/torch_mode_drift.py [N]
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = int(sys.argv[1]) if len(sys.argv) > 1 else 256
NMF_ITER, DEGNORM_ITER = 50, 5
WIDTHS = (1024, 4096)


def drift(a, b):
    d = np.abs(a.rho - b.rho)
    flips = a.ran_baseline_selection != b.ran_baseline_selection
    return dict(di_drift_max=float(d.max()), di_drift_mean=float(d.mean()),
                decision_flips=int(flips.sum()),
                genes_with_flips=int(flips.any(axis=1).sum()))


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    import chip_smoke
    from degnorm_tpu import engine as jengine
    from degnorm_tpu.config import EngineConfig as JEng, NMFConfig as JNmf
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch import engine as tengine

    cov, X = chip_smoke.synth_dataset(chip_smoke.N_GENES, chip_smoke.P_SAMPLES)
    names = list(cov)[:N]
    cov = {g: cov[g] for g in names}
    X = X[:N]
    nmf_kw = dict(nmf_iter=NMF_ITER, degnorm_iter=DEGNORM_ITER)
    fits, secs = {}, {}
    for fast in (False, True):
        t0 = time.perf_counter()
        fits["jax", fast] = jengine.DegNormEngine(
            JNmf(**nmf_kw),
            JEng(device_loop=False, use_pallas=True, pallas_interpret=True,
                 gram_mode="vpu", bucket_widths=WIDTHS, trim_fast=fast)
        ).run(cov, X)
        secs["jax", fast] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fits["port", fast] = tengine.DegNormEngine(
            NMFConfig(**nmf_kw),
            EngineConfig(device="cpu", bucket_widths=WIDTHS, trim_fast=fast)
        ).run(cov, X)
        secs["port", fast] = time.perf_counter() - t0
    print(json.dumps(dict(
        genes=N, samples=chip_smoke.P_SAMPLES, nmf_iter=NMF_ITER,
        degnorm_iter=DEGNORM_ITER, torch=torch.__version__,
        jax=jax.__version__,
        jax_trim_fast_vs_default=drift(fits["jax", True], fits["jax", False]),
        port_trim_fast_vs_default=drift(fits["port", True],
                                        fits["port", False]),
        port_vs_jax_default=drift(fits["port", False], fits["jax", False]),
        port_vs_jax_trim_fast=drift(fits["port", True], fits["jax", True]),
        seconds={f"{k}{'_trim_fast' if f else ''}": round(v, 1)
                 for (k, f), v in secs.items()})))


if __name__ == "__main__":
    main()
