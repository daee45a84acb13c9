"""Times the panel instances of kernels 4, 3 and 1 (p > 128: ``csrc/panel.cuh``,
``csrc/stream_panel.cu``, ``csrc/trim_panel.cu``, ``csrc/nmf_panel.cu``) of
this tree and of other trees of the repo, each built and timed in a process
of its own, on one card:

    python3 tools/panel_ab.py [TREE ...]

Each TREE is a checkout of the repo (e.g. a parent commit's ``git
archive``, or a copy with another version of the core), timed with its own
sources as they are.  Prints one JSON line a tree: CUDA-event ms of kernel
4 on 64 genes x p x 16,384 columns of raw int16 + scale (p = 129, 192,
256) and on 16 genes at p = 512, of kernel 3 (default and nmf_tol=1e-4) on
512 narrow genes of 200-299 bases at 256 x 256 (``chip_smoke.py`` phase
``panels``' shapes and data: its seeds, every p the first p samples of one
dataset made at 512), and of kernels 1 and 3 on such genes resident past
256 samples, each held against its plain version (RESIDENT: 288 x 224,
where genes enter the trim loop, and 384 x 160, 512 x 128, 640 x 96, where
none has the 200 columns to), with the card's name and power limit and the
panel instances that spill registers in the build; for this tree also
kernel 4's plain version at p = 256 and 512.  Compare trees only within
one run, and run them in turns (``A B B A``) to see the drift of the
card.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM = ((64, 129), (64, 192), (64, 256), (16, 512))
W_STREAM = 16384
TRIM = (512, 256, 256)
RESIDENT = ((288, 224), (384, 160), (512, 128), (640, 96))
RESIDENT_GENES = 512


def time_resident(cs, dev, nmf_cfg, eng, out):
    """Kernels 1 and 3 (default) on RESIDENT_GENES genes at each RESIDENT
    shape, the first p samples of chip_smoke's resident dataset, held
    against their plain versions by ``chip_smoke.check_kernels_at`` (which
    raises where they disagree) and timed by it."""
    import torch
    from degnorm_tpu_torch.ops import cuda_nmf
    base = list(cs.synth_dataset(RESIDENT_GENES, 640, seed=cs.SEED + 640,
                                 lengths_fn=cs.short_lengths)[0].values())
    rng = np.random.default_rng(cs.SEED + 13)
    for p, W in RESIDENT:
        F, lm, raw = cs.resident_bucket(RESIDENT_GENES, p, W, dev, rng,
                                        mats=base)
        rec = cs.check_kernels_at(F, lm, nmf_cfg, eng, raw, branches=False)
        tag = f"{RESIDENT_GENES}x{p}x{W}"
        for k, name in (("1p", "nmf_masked"), ("3p", "trim_loop")):
            out[f"{k}_{tag}"] = rec[name]["ms"]
            out[f"{k}_plain_{tag}"] = rec[name]["plain_ms"]
        out[f"entered_{tag}"] = rec["trim_loop"]["entered"]
        out[f"mean_rounds_{tag}"] = rec["trim_loop"]["mean_rounds"]
        # (a tree before the cluster layout has the block layout alone)
        out[f"layout_{tag}"] = ("cluster" if hasattr(cuda_nmf, "panel_cluster")
                                and cuda_nmf.panel_cluster(p) else "block")
        del F, lm, raw, rec
        torch.cuda.empty_cache()


def one(tree, plain):
    """The timings of one tree's build (run in its own process)."""
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.ops import build
    if os.path.dirname(os.path.abspath(cs.__file__)) != os.path.abspath(tree):
        raise RuntimeError(f"chip_smoke.py not taken from {tree}")
    build.get_lib(verbose=True)
    spilled = {r["kernel"]: r["spill_bytes"]
               for r in cs.ptxas_report(str(build.build_info.get("log", "")))
               if r["spill_bytes"] and "panel" in r["kernel"]}
    dev = torch.device("cuda")
    nmf_cfg = NMFConfig(nmf_iter=cs.NMF_ITER)
    out = {}
    eng = EngineConfig(bucket_widths=cs.BUCKET_WIDTHS)
    time_resident(cs, dev, nmf_cfg, eng, out)
    time_stream_trim(cs, dev, nmf_cfg, eng, plain, out)
    out = {k: round(v, 3) if isinstance(v, float) else v
           for k, v in out.items()}
    print(json.dumps({"tree": tree, "ms": out,
                      "panel_spills": spilled, "smi": cs.smi_line()}),
          flush=True)


def time_stream_trim(cs, dev, nmf_cfg, eng, plain, out):
    """Kernel 4 at STREAM (its plain version too where ``plain``), kernel 3
    and its nmf_tol branch at TRIM."""
    import torch
    from degnorm_tpu_torch import EngineConfig
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.ops import cuda_stream, cuda_trim
    nkw = baseline._nmf_kwargs(nmf_cfg, EngineConfig())
    G_top = max(g for g, _ in STREAM)
    p_top = max(p for _, p in STREAM)
    raw_top, lm = cs.small_wide_bucket(G_top, p_top, W_STREAM, cs.SEED + p_top,
                                       dev)
    for G, p in STREAM:
        raw = raw_top[:G, :p].contiguous()
        scale = torch.linspace(0.8, 1.25, p, device=dev)
        F = raw.to(torch.float32) / scale[None, :, None]
        colmax = (F * lm[:G, None, :]).amax(dim=1)
        hi = (colmax > 0.1 * colmax.amax(dim=1, keepdim=True)) & lm[:G]
        del colmax
        out[f"4p_{G}x{p}x{W_STREAM}"] = cs.time_ms(
            lambda: cuda_stream.nmf_masked_streamed_cuda(
                raw, hi, scale=scale, **nkw), 1)
        if plain and p in (256, 512):
            out[f"4p_plain_{G}x{p}x{W_STREAM}"] = cs.time_ms(
                lambda: cuda_stream.nmf_masked_streamed_plain(F, hi, **nkw), 1)
        del raw, F, hi
        torch.cuda.empty_cache()
    del raw_top, lm
    G, p, W = TRIM
    base = list(cs.synth_dataset(G, p_top, seed=cs.SEED + p_top,
                                 lengths_fn=cs.short_lengths)[0].values())
    rng = np.random.default_rng(cs.SEED + 13)
    F, lm, _ = cs.resident_bucket(G, p, W, dev, rng, mats=base)
    ti = baseline.trim_inputs(F, lm, nmf_cfg,
                              dataclasses.replace(eng, use_kernels=False))
    targs = (ti.Fm, ti.bin_id, ti.bin_count, ti.K0, ti.E0, ti.rho0, ti.u0,
             ti.n_hi, ti.n_bins0, ti.active0)
    tkw = baseline.trim_kwargs(nmf_cfg, eng)
    out[f"3p_{G}x{p}x{W}"] = cs.time_ms(
        lambda: cuda_trim.trim_loop_cuda(*targs, **tkw), 2)
    out[f"3bp_{G}x{p}x{W}"] = cs.time_ms(
        lambda: cuda_trim.trim_loop_cuda(*targs, **tkw, nmf_tol=cs.MODE_TOL),
        2)


def main(trees):
    trees = [REPO] + [os.path.abspath(t) for t in trees]
    for i, tree in enumerate(trees):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", tree, str(int(i == 0))],
                           capture_output=True, text=True)
        line = (r.stdout.strip().splitlines() or [""])[-1]
        print(json.dumps({"tree": tree, "rc": r.returncode,
                          "result": json.loads(line) if r.returncode == 0
                          else r.stderr[-2000:]}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2], sys.argv[3] == "1")
    else:
        main(sys.argv[1:])
