"""Bit comparison of the port's fits between two trees of the repo.

    python3 tools/torch_fit_bits.py save TREE OUT.npz [CASE ...]
    python3 tools/torch_fit_bits.py compare A.npz B.npz

``save`` runs, on the card, the fits of ``TREE`` (a checkout of the repo:
its ``degnorm_tpu_torch`` and its ``chip_smoke.py`` come first on the path)
on ``chip_smoke.py``'s data, made from its seeds, and saves each fit's DI
(rho), adjusted counts and baseline-selection flags:

* ``fit``: the narrow dataset on one device (phase ``fit``'s config);
* ``fit_wide``: the long tail on one device (phase ``fit_wide``'s);
* ``long_tail_cols``: the long tail on two shards of the card, its W=65536
  bucket column-sharded (phases ``mesh`` and ``seqpar``);
* ``ttn_cols``: the TTN-like genes on two shards, column-sharded (phase
  ``seqpar``);
* ``narrow_x64``: the narrow genes at 64 samples on one device, phase
  ``wide_p`` (b)'s parity subset (its first PARITY_GENES genes,
  NARROW_X64_ITER iterations: the wide kernels 1-4);
* ``long_tail_x48``: the long tail at 48 samples (TAIL_X48_GENES here),
  phase ``wide_p`` (c)'s parity subset (PARITY_WIDE_GENES of either width,
  1 iteration: the wide kernels 2 and 4);
* ``panel_x256``: phase ``panels``' fit, its narrow genes at 256 samples
  with the default bucket widths (PANEL_FIT_GENES here, PANEL_ITER
  iterations: the panel instances of kernels 1-4);
* ``panel_x768``: phase ``panels``' fit past 640 samples, narrow genes at
  768 samples with the default bucket widths (BIG_GENES here, PANEL_ITER
  iterations: every bucket streams, kernels 2 and 4 on clusters of six
  blocks);
* ``panel_x768_resident``: phase ``panels``' resident fit past 640
  samples, RES_GENES genes of 50-64 bases at 768 samples with RES_WIDTHS
  (one bucket of W = 64, resident: kernel 2 on clusters of six blocks,
  kernels 1 and 3 past their cluster layout; no gene enters the trim
  rounds; 1 iteration).

Every case by default; naming CASEs saves only those.

``compare`` prints one JSON object: for each array, whether the two files
hold the same bits, the largest absolute and relative differences and how
many values differ (of ``*.ran``: the baseline-selection flags that
flipped).  Run ``save`` for
both trees in one call to the card, so that both fits meet the same card.
"""
import json
import os
import sys

import numpy as np

CASES = ("fit", "fit_wide", "long_tail_cols", "ttn_cols", "narrow_x64",
         "long_tail_x48", "panel_x256", "panel_x768", "panel_x768_resident")
# the sizes of the cases on phases wide_p's and panels' fits, fixed here so
# that trees whose chip_smoke.py cut them (or predates the p = 768 fit)
# still compare
NARROW_X64_ITER, TAIL_X48_GENES = 5, 2048
PANEL_FIT_GENES = 2048
BIG_P, BIG_GENES = 768, 512
RES_GENES = 1024
RES_WIDTHS = (64, 256, 512, 1024, 2048, 4096, 8192, 16384, 65536)


def resident_lengths(n, rng):
    """Genes of 50-64 bases (a bucket of W = 64 under RES_WIDTHS)."""
    return rng.integers(50, 65, n)


def save(tree, out, cases=CASES):
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import chip_smoke as cs
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.engine import DegNormEngine
    from degnorm_tpu_torch.parallel import make_mesh
    if os.path.dirname(os.path.abspath(cs.__file__)) != os.path.abspath(tree):
        raise RuntimeError(f"chip_smoke.py not taken from {tree}")
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh([dev] * 2)
    nmf = NMFConfig(nmf_iter=cs.NMF_ITER, degnorm_iter=cs.DEGNORM_ITER)

    def narrow():
        return cs.synth_dataset(cs.N_GENES, cs.P_SAMPLES)

    def wide():
        return cs.synth_dataset(cs.WIDE_GENES, cs.P_SAMPLES, seed=cs.SEED + 1,
                                lengths_fn=cs.synth_long_lengths)

    def ttn():
        return cs.synth_dataset(
            cs.TTN_GENES, cs.P_SAMPLES, seed=cs.SEED + 3,
            lengths_fn=lambda n, rng: rng.integers(*cs.TTN_LENGTHS, n,
                                                   endpoint=True))

    def narrow_x64():
        # phase wide_p's parity subset of its fit (b)
        cov, X = cs.synth_dataset(cs.N_GENES, cs.WIDE_P_FIT_P)
        keys = list(cov)[:cs.PARITY_GENES]
        return {k: cov[k] for k in keys}, X[:cs.PARITY_GENES]

    def long_tail_x48():
        # ... and of its fit (c)
        cov, X = cs.synth_dataset(TAIL_X48_GENES, cs.WIDE_P_TAIL_P,
                                  seed=cs.SEED + 1,
                                  lengths_fn=cs.synth_long_lengths)
        lens = np.array([m.shape[1] for m in cov.values()])
        pick = np.concatenate([
            np.flatnonzero(lens <= cs.WIDE_WIDTHS[0])[
                :cs.PARITY_WIDE_GENES[0]],
            np.flatnonzero(lens > cs.WIDE_WIDTHS[0])[
                :cs.PARITY_WIDE_GENES[1]]])
        keys = list(cov)
        return {keys[i]: cov[keys[i]] for i in pick}, X[pick]

    # case -> (its data, made when the case runs; config; mesh; NMF config)
    runs = {
        "fit": (narrow, EngineConfig(bucket_widths=cs.BUCKET_WIDTHS), None,
                nmf),
        "fit_wide": (wide, EngineConfig(), None, nmf),
        "long_tail_cols": (wide, EngineConfig(), mesh, nmf),
        "ttn_cols": (ttn, EngineConfig(), mesh, nmf),
        "narrow_x64": (narrow_x64,
                       EngineConfig(bucket_widths=cs.BUCKET_WIDTHS), None,
                       NMFConfig(nmf_iter=cs.NMF_ITER,
                                 degnorm_iter=NARROW_X64_ITER)),
        "long_tail_x48": (long_tail_x48, EngineConfig(), None,
                          NMFConfig(nmf_iter=cs.NMF_ITER,
                                    degnorm_iter=cs.WIDE_P_ITER["c"])),
        "panel_x256": (lambda: cs.synth_dataset(PANEL_FIT_GENES,
                                                cs.PANEL_FIT_P),
                       EngineConfig(), None,
                       NMFConfig(nmf_iter=cs.NMF_ITER,
                                 degnorm_iter=cs.PANEL_ITER)),
        "panel_x768": (lambda: cs.synth_dataset(BIG_GENES, BIG_P),
                       EngineConfig(), None,
                       NMFConfig(nmf_iter=cs.NMF_ITER,
                                 degnorm_iter=cs.PANEL_ITER)),
        "panel_x768_resident": (
            lambda: cs.synth_dataset(RES_GENES, BIG_P,
                                     lengths_fn=resident_lengths),
            EngineConfig(bucket_widths=RES_WIDTHS), None,
            NMFConfig(nmf_iter=cs.NMF_ITER, degnorm_iter=1)),
    }
    arrays = {}
    for case in cases:
        data, cfg, m, nmf_case = runs[case]
        cov, X = data()
        res = DegNormEngine(nmf_case, cfg, mesh=m).run(cov, X)
        torch.cuda.synchronize()
        arrays[f"{case}.rho"] = res.rho
        arrays[f"{case}.x_adj"] = res.x_adj
        arrays[f"{case}.ran"] = res.ran_baseline_selection
        print(f"saved {case} of {tree}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **arrays)


def compare(a_path, b_path):
    a, b = np.load(a_path), np.load(b_path)
    out = {}
    for k in a.files:
        x, y = a[k], b[k]
        same = x.shape == y.shape and bool(np.array_equal(x, y))
        rec = {"same_bits": same}
        if x.shape == y.shape:
            d = np.abs(x.astype(np.float64) - y.astype(np.float64))
            rec.update(
                max_abs_diff=float(d.max()) if d.size else 0.0,
                max_rel_diff=float((d / np.maximum(np.abs(
                    y.astype(np.float64)), 1e-30)).max()) if d.size else 0.0,
                values_differing=int((x != y).sum()))
        out[k] = rec
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    cmd, args = sys.argv[1:2], sys.argv[2:]
    if cmd == ["compare"] and len(args) == 2:
        compare(*args)
    elif (cmd == ["save"] and len(args) >= 2
          and all(c in CASES for c in args[2:])):
        save(args[0], args[1], tuple(args[2:]) or CASES)
    else:
        sys.exit(__doc__)
