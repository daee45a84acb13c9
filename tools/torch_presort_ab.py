"""The JAX engine's exit-round reorder on the port's fits: the A/B behind
leaving it out of the port (PERF.md §6, ROADMAP "Not carried over").

    python3 tools/torch_presort_ab.py [OUT.json]

Runs on the card.  The JAX engine permutes each bucket's genes after the
first DegNorm iteration by their trim rounds, ascending and stable
(``_reorder_by_exit_round``, degnorm_tpu/engine.py:1080-1099), so that the
genes still active in later rounds sit together, and presorts them by the
initial DI; both are result-invariant and exist because the TPU grid runs
gene blocks in order.  For each case (``chip_smoke.py``'s phases fit and
fit_wide, and phase wide_p's p = 64 fit, on their data and seeds): one fit of
one DegNorm iteration reads each gene's ``rounds_active``; a cold fit at full
depth; then steady refits in turns as packed and with every bucket permuted
on the device by those rounds (plain, permuted, permuted, plain), each
permuted fit bit-equal to the packed one.  The long tail is also profiled in
each order (kernel 4's device ms).  Prints one JSON line a case and writes
the whole record (with the trim rounds) to OUT.json where given.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

CASES = ("fit", "fit_wide", "fit_p64")


def permute(engine, perms):
    """Permute each one-device bucket's slots on the device: coverage, mask
    and gene ids, and the host's lengths and gene indices (which
    ``_ds_starts`` and the estimates read)."""
    import torch
    for k, sh in enumerate(engine._shards):
        perm = perms[sh.bucket]
        pt = torch.from_numpy(perm).to(engine._device_F[k].device)
        engine._device_F[k] = engine._device_F[k][pt].contiguous()
        engine._device_mask[k] = engine._device_mask[k][pt].contiguous()
        engine._device_idx[k] = engine._device_idx[k][pt.to(
            engine._device_idx[k].device)]
        b = engine._buckets[sh.bucket]
        b.lengths = b.lengths[perm]
        b.gene_indices = b.gene_indices[perm]


def case_data(case):
    """The data and engine config of one of CASES."""
    from degnorm_tpu_torch import EngineConfig
    narrow = EngineConfig(bucket_widths=cs.BUCKET_WIDTHS)
    if case == "fit":
        return cs.synth_dataset(cs.N_GENES, cs.P_SAMPLES), narrow
    if case == "fit_wide":
        return (cs.synth_dataset(cs.WIDE_GENES, cs.P_SAMPLES, seed=cs.SEED + 1,
                                 lengths_fn=cs.synth_long_lengths),
                EngineConfig())
    return cs.synth_dataset(cs.N_GENES, cs.WIDE_P_FIT_P), narrow


def run_case(case):
    """One case; returns its record."""
    import torch
    from degnorm_tpu_torch import NMFConfig
    from degnorm_tpu_torch.engine import DegNormEngine
    (cov, X), cfg = case_data(case)
    # each gene's trim rounds in the first DegNorm iteration, by slot
    first = DegNormEngine(NMFConfig(nmf_iter=cs.NMF_ITER, degnorm_iter=1), cfg)
    first.run(cov, X)
    perms, moved = {}, 0
    for sh, r in zip(first._shards, first._last_results):
        gi = first._buckets[sh.bucket].gene_indices
        ra = np.where(gi >= 0, r.rounds_active.cpu().numpy(), 0)
        perm = np.argsort(ra, kind="stable")
        perms[sh.bucket] = perm
        moved += int((perm != np.arange(len(perm))).sum())
    del first
    torch.cuda.empty_cache()
    engine = DegNormEngine(
        NMFConfig(nmf_iter=cs.NMF_ITER, degnorm_iter=cs.DEGNORM_ITER), cfg)
    t0 = time.perf_counter()
    base = engine.run(cov, X)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    inverse = {b: np.argsort(p) for b, p in perms.items()}
    secs = {"plain": [], "permuted": []}
    rounds, prof = {}, {}
    now = "plain"
    for order in ("plain", "permuted", "permuted", "plain"):
        if order != now:
            permute(engine, perms if order == "permuted" else inverse)
            now = order
        t0 = time.perf_counter()
        res = engine.run(cov, X, reuse_device_data=True)
        torch.cuda.synchronize()
        secs[order].append(round(time.perf_counter() - t0, 4))
        rounds[order] = [list(r) for r in engine.trim_rounds]
        same = {f: bool(np.array_equal(getattr(res, f), getattr(base, f)))
                for f in ("rho", "x_adj", "ran_baseline_selection")}
        if not all(same.values()):
            raise AssertionError(f"{case} {order}: the fit differs: {same}")
        if case == "fit_wide" and order not in prof:
            p = cs.profile_fit(engine, cov, X, secs[order][-1])
            prof[order] = (p["port_kernels"]["nmf_streamed_kernel"]
                           ["device_ms"] if isinstance(p, dict) else p)
    return dict(case=case, genes=len(cov), samples=X.shape[1],
                slots_moved=moved, cold_s=round(cold, 3), steady_s=secs,
                gain=round(1 - min(secs["permuted"]) / min(secs["plain"]), 4),
                gain_each_turn=[round(1 - a / b, 4) for a, b in zip(
                    secs["permuted"], secs["plain"][::-1])],
                kernel4_device_ms=prof, trim_rounds=rounds, bit_equal=True)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("torch_presort_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    recs = []
    for case in CASES:
        rec = run_case(case)
        print(json.dumps({k: v for k, v in rec.items()
                          if k != "trim_rounds"}), flush=True)
        recs.append(rec)
    if argv:
        with open(argv[0], "w") as f:
            json.dump({"card": cs.smi_line(), "cases": recs}, f)
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
