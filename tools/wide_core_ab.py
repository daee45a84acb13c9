"""Times the wide kernels 1, 3 and 4 (``csrc/wide.cuh``'s core) of this
tree and of other trees of the repo, each built and timed in a process of
its own, on one card:

    python3 tools/wide_core_ab.py [TREE ...]

Each TREE is a checkout of the repo (e.g. a parent commit's ``git
archive``, or a copy with another version of the core), timed with its own
sources as they are.  Prints one JSON line a tree: CUDA-event ms of kernel
4 on 256 genes x p x 16,384 columns of raw int16 + scale (p = 48, 64, 96,
128), and of kernels 1 and 3 with their branches (1w, 1aw: nmf_tol; 3w,
3aw: trim_fast, 3bw: nmf_tol) on 1,024 narrow genes at 48 x 1024, 64 x
1024, 96 x 512 and 128 x 512, on ``chip_smoke.py``'s data (its seeds; every p the
first p samples of one dataset made at 128), with the card's name and power
limit and the wide and resident instances that spill registers in the
build.  Compare trees only within one run.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(tree):
    """The timings of one tree's build (run in its own process)."""
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.ops import build, cuda_nmf, cuda_stream, cuda_trim
    build.get_lib(verbose=True)
    spilled = {r["kernel"]: r["spill_bytes"]
               for r in cs.ptxas_report(str(build.build_info.get("log", "")))
               if r["spill_bytes"] and ("wide" in r["kernel"]
                                         or "_res_" in r["kernel"])}
    dev = torch.device("cuda")
    nmf_cfg = NMFConfig(nmf_iter=cs.NMF_ITER)
    eng = EngineConfig(bucket_widths=cs.BUCKET_WIDTHS)
    out = {}
    nkw = baseline._nmf_kwargs(nmf_cfg, EngineConfig())
    raw_top, lm = cs.small_wide_bucket(256, 128, 16384, cs.SEED + 128, dev)
    for p in (48, 64, 96, 128):
        raw = raw_top[:, :p].contiguous()
        scale = torch.linspace(0.8, 1.25, p, device=dev)
        F = raw.to(torch.float32) / scale[None, :, None]
        colmax = (F * lm[:, None, :]).amax(dim=1)
        hi = (colmax > 0.1 * colmax.amax(dim=1, keepdim=True)) & lm
        del F, colmax
        out[f"4w_p{p}_W16384"] = cs.time_ms(
            lambda: cuda_stream.nmf_masked_streamed_cuda(
                raw, hi, scale=scale, **nkw), 2)
    del raw_top, lm
    torch.cuda.empty_cache()
    base = list(cs.synth_dataset(1024, 128, seed=cs.SEED + 128)[0].values())
    rng = np.random.default_rng(cs.SEED + 11)
    plain = dataclasses.replace(eng, use_kernels=False)
    for p, W in ((48, 1024), (64, 1024), (96, 512), (128, 512)):
        F, lm, _ = cs.resident_bucket(1024, p, W, dev, rng, mats=base)
        ti = baseline.trim_inputs(F, lm, nmf_cfg, plain)
        act = ~ti.bailed
        nk = baseline._nmf_kwargs(nmf_cfg, eng)
        targs = (ti.Fm, ti.bin_id, ti.bin_count, ti.K0, ti.E0, ti.rho0,
                 ti.u0, ti.n_hi, ti.n_bins0, ti.active0)
        tkw = baseline.trim_kwargs(nmf_cfg, eng)
        # each instance: 1w, 1aw (nmf_tol), 3w, 3aw (trim_fast), 3bw
        # (nmf_tol)
        runs = {
            "1w": lambda: cuda_nmf.nmf_masked_cuda(
                ti.Fm, ti.hi, gene_active=act, **nk),
            "1aw": lambda: cuda_nmf.nmf_masked_cuda(
                ti.Fm, ti.hi, gene_active=act, nmf_tol=cs.MODE_TOL, **nk),
            "3w": lambda: cuda_trim.trim_loop_cuda(*targs, **tkw),
            "3aw": lambda: cuda_trim.trim_loop_cuda(*targs, **tkw,
                                                    trim_fast=True),
            "3bw": lambda: cuda_trim.trim_loop_cuda(*targs, **tkw,
                                                    nmf_tol=cs.MODE_TOL)}
        for name, fn in runs.items():
            out[f"{name}_p{p}_W{W}"] = cs.time_ms(
                fn, 3 if name.startswith("1") else 2)
        del F, lm, ti, targs
        torch.cuda.empty_cache()
    out = {k: round(v, 3) for k, v in out.items()}
    print(json.dumps({"tree": tree, "ms": out,
                      "wide_spills": spilled, "smi": cs.smi_line()}),
          flush=True)


def main(trees):
    for tree in [REPO] + [os.path.abspath(t) for t in trees]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", tree], capture_output=True, text=True)
        line = (r.stdout.strip().splitlines() or [""])[-1]
        print(json.dumps({"tree": tree, "rc": r.returncode,
                          "result": json.loads(line) if r.returncode == 0
                          else r.stderr[-2000:]}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2])
    else:
        main(sys.argv[1:])
