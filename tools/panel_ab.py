"""Times the panel instances of kernels 4, 3, 2 and 1 (p > 128:
``csrc/panel.cuh``, ``csrc/phase.cuh``, ``csrc/stream_panel.cu``,
``csrc/trim_panel.cu``, ``csrc/ratio_panel.cu``, ``csrc/nmf_panel.cu``) of
this tree and of other
trees of the repo, each built and timed in a process of its own, on one
card:

    python3 tools/panel_ab.py [--parts PART,...] [--turns] [TREE ...]

Each TREE is a checkout of the repo (e.g. a parent commit's ``git
archive``, or a copy with another version of the core), timed with its own
sources as they are.  Prints one JSON line a run: CUDA-event ms of

* ``stream``: kernel 4 on 64 genes x p x 16,384 columns of raw int16 +
  scale (p = 129, 192, 256) and on 16 genes at p = 512 (``chip_smoke.py``
  phase ``panels``' shapes and data: its seeds, every p the first p
  samples of one dataset made at 512);
* ``trim``: kernel 3 (default and nmf_tol=1e-4) on 512 narrow genes of
  200-299 bases at 256 x 256;
* ``resident``: kernels 1 and 3 on such genes resident past 256 samples,
  each held against its plain version (RESIDENT: 288 x 224, where genes
  enter the trim loop, and 384 x 160, 512 x 128, 640 x 96, where none has
  the 200 columns to);
* ``ratio``: kernel 2 on the raw int16 form of such genes at 512 x 256 x
  256 and 512 x 512 x 128 (RATIO);
* ``big``: kernel 4 past 640 samples (BIG: 64 x 768 x 16,384, a full
  bucket, and 4 x 700 x 2,048), raw int16 + scale;
* ``past``: kernels 4 and 2 past 1,152 samples (PAST: 4 x 1,153 x 2,048, 8
  and 64 x 1,222 x 16,384, 2 x 4,096 x 1,024; ``chip_smoke.py`` phase
  ``panels``' shapes and data), raw int16 (+ scale for kernel 4);
* ``loop``: kernel 1 past 640 samples in both branches (1p-b, and 1ap-b
  at nmf_tol=1e-4 with the iterations each gene ran) on resident genes of
  200-299 bases (LOOP: 512 x 704 x 64, and 256 genes at 768 x 64, 1,024 x
  64 and 1,153 x 56, ``chip_smoke.py`` phase ``panels``' shapes);
* ``trimphase``: kernel 3 past 640 samples (3p-b, and its trim_fast and
  nmf_tol rounds, 3ap-b and 3bp-b) on such resident genes: at 512 x 704 x
  64 with the default floors, where no gene enters (the bucket step alone,
  over TRIM_LIGHT_REPS calls by CUDA events and by the host's clock), and
  with the kernel's min_gene_len and min_bins lowered to TRIM_FLOORS and
  its rounds capped at TRIM_ROUNDS at 256 x 768 x 64 and 256 x 1,024 x 64
  (every mode) and on 1,024 genes of 50-64 bases at 768 x 64 with every
  gene that does not bail active (the p = 768 resident fit's bucket; the
  default mode): ``chip_smoke.py`` phase ``panels``' shapes and data;

each tree's outputs of ``past``, ``loop`` and ``trimphase`` (K, E, u of
kernels 4 and 1, the row sums of kernel 2, kernel 1's iterations, kernel
3's K, rho, ran_bs, rounds and iterations) saved to a temporary
directory and compared bit for bit with this tree's first run
(``past_bits``);

every part by default, with the card's name and power limit and the panel
and phased instances that spill registers in the build; for this tree also the plain
versions of kernel 4 at p = 256 and 512, at BIG and at PAST, of kernel 2 at
RATIO and PAST, and of kernel 1 at LOOP.  Compare trees only within one run.  ``--turns`` runs
the trees in turns, this tree, the others, the others again, this tree
(``A B B A``), to see the drift of the card; each tree is built once.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM = ((64, 129), (64, 192), (64, 256), (16, 512))
W_STREAM = 16384
TRIM = (512, 256, 256)
RESIDENT = ((288, 224), (384, 160), (512, 128), (640, 96))
RESIDENT_GENES = 512
RATIO = ((512, 256, 256), (512, 512, 128))
BIG = ((64, 768, 16384), (4, 700, 2048))
PAST = ((4, 1153, 2048), (8, 1222, 16384), (64, 1222, 16384),
        (2, 4096, 1024))
LOOP = ((512, 704, 64), (256, 768, 64), (256, 1024, 64), (256, 1153, 56))
TRIM_PHASE = ((512, 704, 64, False), (256, 768, 64, True),
              (256, 1024, 64, True))
TRIM_FLOORS = (8, 2)          # min_gene_len, min_bins where lowered
TRIM_ROUNDS = 4
TRIM_LIGHT_REPS = 50
PARTS = ("resident", "stream", "trim", "ratio", "big", "past", "loop",
         "trimphase")


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
        out[f"layout_{tag}"] = layout(cuda_nmf, p, "loop")
        del F, lm, raw, rec
        torch.cuda.empty_cache()


def layout(cuda_nmf, p, kind):
    """The layout a tree's kernels of ``kind`` take at p: a tree before the
    cluster layout has the block layout alone, one before the cut by kind
    a cut at PCL_MAX_P for kernels 1, 3 and 4 (kernel 2: blocks)."""
    if not hasattr(cuda_nmf, "panel_cluster"):
        return "block"
    if (kind in ("stream", "ratio") and hasattr(cuda_nmf, "panel_phase")
            and cuda_nmf.panel_phase(p)):
        return "phase"
    if kind == "nmf":   # kernel 1: phased past its cut since the cut by kernel
        if "nmf" in getattr(cuda_nmf, "WORKSPACE_KINDS", ()):
            return "phase" if cuda_nmf.panel_phase(p, "nmf") else "cluster"
        kind = "loop"
    if not hasattr(cuda_nmf, "pcl_max_p"):
        return ("cluster" if cuda_nmf.panel_cluster(p) and kind != "ratio"
                else "block")
    return ("cluster" if cuda_nmf.panel_cluster(
        p, "stream" if kind == "ratio" else kind) else "block")


def time_ratio(cs, dev, plain, out):
    """Kernel 2 (its plain version too where ``plain``) on the raw int16
    form of RATIO's shapes: 512 narrow genes of 200-299 bases, the first p
    samples of chip_smoke's resident dataset made at 512."""
    import torch
    from degnorm_tpu_torch import EngineConfig
    from degnorm_tpu_torch.ops import cuda_nmf
    base = list(cs.synth_dataset(512, 512, seed=cs.SEED + 512,
                                 lengths_fn=cs.short_lengths)[0].values())
    rng = np.random.default_rng(cs.SEED + 13)
    kw = dict(power_iters=EngineConfig().power_iters_cold)
    for G, p, W in RATIO:
        F, lm, raw = cs.resident_bucket(G, p, W, dev, rng, mats=base)
        tag = f"{G}x{p}x{W}"
        out[f"2p_{tag}"] = cs.time_ms(
            lambda: cuda_nmf.ratio_rowsums_cuda(raw, lm, **kw), 3)
        out[f"layout_2p_{tag}"] = layout(cuda_nmf, p, "ratio")
        if plain:
            out[f"2p_plain_{tag}"] = cs.time_ms(
                lambda: cuda_nmf.ratio_rowsums_plain(F, lm, **kw), 1)
        del F, lm, raw
        torch.cuda.empty_cache()


def time_big(cs, dev, nmf_cfg, plain, out):
    """Kernel 4 at BIG on raw int16 + scale (its plain version too where
    ``plain``), on chip_smoke's ``small_wide_bucket`` data at each shape's
    seed."""
    import torch
    from degnorm_tpu_torch import EngineConfig
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream
    nkw = baseline._nmf_kwargs(nmf_cfg, EngineConfig())
    for G, p, W in BIG:
        raw, lm = cs.small_wide_bucket(G, p, W, cs.SEED + p, dev)
        scale = torch.linspace(0.8, 1.25, p, device=dev)
        F = raw.to(torch.float32) / scale[None, :, None]
        colmax = (F * lm[:, None, :]).amax(dim=1)
        hi = (colmax > 0.1 * colmax.amax(dim=1, keepdim=True)) & lm
        del colmax
        tag = f"{G}x{p}x{W}"
        out[f"4p_{tag}"] = cs.time_ms(
            lambda: cuda_stream.nmf_masked_streamed_cuda(
                raw, hi, scale=scale, **nkw), 1)
        out[f"layout_4p_{tag}"] = layout(cuda_nmf, p, "stream")
        if plain:
            out[f"4p_plain_{tag}"] = cs.time_ms(
                lambda: cuda_stream.nmf_masked_streamed_plain(F, hi, **nkw), 1)
        del raw, F, hi
        torch.cuda.empty_cache()


def time_past(cs, dev, nmf_cfg, plain, out, arrays):
    """Kernels 4 (raw int16 + scale) and 2 (raw int16) at PAST, on
    chip_smoke's ``small_wide_bucket`` data (each (p, W) made at its
    largest G, a smaller G its first genes), their plain versions too where
    ``plain``; the outputs into ``arrays``."""
    import torch
    from degnorm_tpu_torch import EngineConfig
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream
    nkw = baseline._nmf_kwargs(nmf_cfg, EngineConfig())
    rkw = dict(power_iters=EngineConfig().power_iters_cold)
    top, made = {}, {}
    for G, p, W in PAST:
        top[p, W] = max(G, top.get((p, W), 0))
    for G, p, W in PAST:
        if (p, W) not in made:
            made = {(p, W): cs.small_wide_bucket(top[p, W], p, W,
                                                 cs.SEED + p, dev)}
        raw, lm = (x[:G].contiguous() for x in made[p, W])
        scale = torch.linspace(0.8, 1.25, p, device=dev)
        F = raw.to(torch.float32) / scale[None, :, None]
        colmax = (F * lm[:, None, :]).amax(dim=1)
        hi = (colmax > 0.1 * colmax.amax(dim=1, keepdim=True)) & lm
        del colmax
        tag = f"{G}x{p}x{W}"

        def k4():
            return cuda_stream.nmf_masked_streamed_cuda(raw, hi, scale=scale,
                                                        **nkw)

        def k2():
            return cuda_nmf.ratio_rowsums_cuda(raw, lm, **rkw)

        for name, res in zip(("K", "E", "u"), k4()):
            arrays[f"4p_{tag}.{name}"] = res.cpu().numpy()
        for name, res in zip(("cov", "est"), k2()):
            arrays[f"2p_{tag}.{name}"] = res.cpu().numpy()
        out[f"4p_{tag}"] = cs.time_ms(k4, 1, warm=False)
        out[f"2p_{tag}"] = cs.time_ms(k2, 2, warm=False)
        out[f"layout_4p_{tag}"] = layout(cuda_nmf, p, "stream")
        out[f"layout_2p_{tag}"] = layout(cuda_nmf, p, "ratio")
        if plain:
            out[f"4p_plain_{tag}"] = cs.time_ms(
                lambda: cuda_stream.nmf_masked_streamed_plain(F, hi, **nkw), 1,
                warm=False)
            out[f"2p_plain_{tag}"] = cs.time_ms(
                lambda: cuda_nmf.ratio_rowsums_plain(raw, lm, **rkw), 1,
                warm=False)
        del raw, lm, scale, F, hi
        torch.cuda.empty_cache()


def time_loop(cs, dev, nmf_cfg, eng, plain, out, arrays):
    """Kernel 1 at LOOP in its default branch and at nmf_tol=MODE_TOL (the
    iterations each gene ran too), on chip_smoke's ``resident_bucket`` of
    narrow genes of 200-299 bases made at 1,153 samples (every p its first
    p samples), every bailed gene inactive, its plain versions too where
    ``plain``; the outputs into ``arrays``."""
    import torch
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.ops import cuda_nmf
    G_top = max(g for g, _, _ in LOOP)
    p_top = max(p for _, p, _ in LOOP)
    base = list(cs.synth_dataset(G_top, p_top, seed=cs.SEED + p_top,
                                 lengths_fn=cs.short_lengths)[0].values())
    rng = np.random.default_rng(cs.SEED + 13)
    plain_cfg = dataclasses.replace(eng, use_kernels=False)
    nkw = baseline._nmf_kwargs(nmf_cfg, eng)
    for G, p, W in LOOP:
        F, lm, _ = cs.resident_bucket(G, p, W, dev, rng, mats=base)
        ti = baseline.trim_inputs(F, lm, nmf_cfg, plain_cfg)
        act = ~ti.bailed
        tag = f"{G}x{p}x{W}"
        for k, kw in (("1p", {}), ("1ap", dict(nmf_tol=cs.MODE_TOL))):
            it = torch.zeros(G, dtype=torch.int32, device=dev)
            res = cuda_nmf.nmf_masked_cuda(ti.Fm, ti.hi, gene_active=act,
                                           iters_out=it, **nkw, **kw)
            for name, r in zip(("K", "E", "u", "iters"), (*res, it)):
                arrays[f"{k}_{tag}.{name}"] = r.cpu().numpy()
            out[f"{k}_{tag}"] = cs.time_ms(
                lambda: cuda_nmf.nmf_masked_cuda(
                    ti.Fm, ti.hi, gene_active=act, **nkw, **kw), 1,
                warm=False)
            if plain:
                out[f"{k}_plain_{tag}"] = cs.time_ms(
                    lambda: cuda_nmf.nmf_masked_plain(
                        ti.Fm, ti.hi, gene_active=act, **nkw, **kw), 1,
                    warm=False)
        out[f"layout_1p_{tag}"] = layout(cuda_nmf, p, "nmf")
        del F, lm, ti, act
        torch.cuda.empty_cache()


def time_trimphase(cs, dev, nmf_cfg, eng, plain, out, arrays):
    """Kernel 3 at TRIM_PHASE in each mode (the bucket without rounds in
    the default one) and on the p = 768 resident fit's bucket, its plain
    version too where ``plain``; the outputs into ``arrays``."""
    import time
    import torch
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.ops import cuda_trim
    modes = (("3p", {}), ("3ap", dict(trim_fast=True)),
             ("3bp", dict(nmf_tol=cs.MODE_TOL)))
    plain_cfg = dataclasses.replace(eng, use_kernels=False)
    p_top = max(p for _, p, _, _ in TRIM_PHASE)
    base = list(cs.synth_dataset(512, p_top, seed=cs.SEED + p_top,
                                 lengths_fn=cs.short_lengths)[0].values())
    rng = np.random.default_rng(cs.SEED + 13)

    def run(tag, F, lm, lowered, all_active, modes):
        ti = baseline.trim_inputs(F, lm, nmf_cfg, plain_cfg)
        tkw = baseline.trim_kwargs(nmf_cfg, eng)
        act = ti.active0
        if lowered:
            mgl, mb = TRIM_FLOORS
            act = ~ti.bailed
            if not all_active:
                act &= ((ti.n_hi >= mgl) & (ti.rho0.amin(dim=1) <= 0.2)
                        & (ti.rho0.amax(dim=1) > 0.1))
            tkw = dict(tkw, min_gene_len=mgl, min_bins=mb,
                       max_rounds=TRIM_ROUNDS)
        targs = (ti.Fm, ti.bin_id, ti.bin_count, ti.K0, ti.E0, ti.rho0,
                 ti.u0, ti.n_hi, ti.n_bins0, act)
        out[f"entered_{tag}"] = int(act.sum())
        for k, kw in modes:
            it = torch.zeros(F.shape[0], dtype=torch.int32, device=dev)
            res = cuda_trim.trim_loop_cuda(*targs, iters_out=it, **tkw, **kw)
            for name, r in zip(("K", "rho", "ran_bs", "rounds", "iters"),
                               (*res, it)):
                arrays[f"{k}_{tag}.{name}"] = r.cpu().numpy()
            out[f"rounds_{k}_{tag}"] = int(res[3].sum())
            fn = (lambda: cuda_trim.trim_loop_cuda(*targs, **tkw, **kw))
            reps = 1 if lowered else TRIM_LIGHT_REPS
            out[f"{k}_{tag}"] = cs.time_ms(fn, reps)
            if not lowered:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                out[f"{k}_host_{tag}"] = (time.perf_counter() - t0) * 1e3 / reps
            if plain:
                out[f"{k}_plain_{tag}"] = cs.time_ms(
                    lambda: cuda_trim.trim_loop_plain(*targs, **tkw, **kw), 1,
                    warm=False)

    for G, p, W, lowered in TRIM_PHASE:
        F, lm, _ = cs.resident_bucket(G, p, W, dev, rng, mats=base)
        run(f"{G}x{p}x{W}", F, lm, lowered, False,
            modes if lowered else modes[:1])
        del F, lm
        torch.cuda.empty_cache()
    cov, _ = cs.synth_dataset(1024, 768, lengths_fn=cs.resident_lengths)
    F = np.zeros((1024, 768, 64), np.float32)
    lens = np.zeros(1024, np.int64)
    for i, m in enumerate(cov.values()):
        F[i, :, :m.shape[1]] = m
        lens[i] = m.shape[1]
    lm = torch.from_numpy(np.arange(64)[None, :] < lens[:, None]).to(dev)
    run("1024x768x64", torch.from_numpy(F).to(dev), lm, True, True,
        modes[:1])


def past_bits(a_path, b_path):
    """Per array of two ``time_past`` files: the same bits, or the largest
    difference relative to max(|value|, 1) and how many values differ."""
    a, b = np.load(a_path), np.load(b_path)
    out = {}
    for k in a.files:
        x, y = a[k], b[k]
        if x.shape == y.shape and np.array_equal(x, y):
            out[k] = True
            continue
        d = (np.abs(x.astype(np.float64) - y.astype(np.float64))
             / np.maximum(np.abs(y.astype(np.float64)), 1.0))
        out[k] = {"max_rel": float(d.max()), "differing": int((x != y).sum())}
    return out


def one(tree, plain, parts, save):
    """The timings of one tree's build (run in its own process)."""
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.ops import build
    if os.path.dirname(os.path.abspath(cs.__file__)) != os.path.abspath(tree):
        raise RuntimeError(f"chip_smoke.py not taken from {tree}")
    build.get_lib(verbose=True)
    report = cs.ptxas_report(str(build.build_info.get("log", "")))
    spilled = {r["kernel"]: r["spill_bytes"] for r in report
               if r["spill_bytes"] and ("panel" in r["kernel"]
                                        or "phase" in r["kernel"])}
    dev = torch.device("cuda")
    nmf_cfg = NMFConfig(nmf_iter=cs.NMF_ITER)
    out = {}
    eng = EngineConfig(bucket_widths=cs.BUCKET_WIDTHS)
    if "resident" in parts:
        time_resident(cs, dev, nmf_cfg, eng, out)
    if "stream" in parts or "trim" in parts:
        time_stream_trim(cs, dev, nmf_cfg, eng, plain, out, parts)
    if "ratio" in parts:
        time_ratio(cs, dev, plain, out)
    if "big" in parts:
        time_big(cs, dev, nmf_cfg, plain, out)
    arrays = {}
    if "past" in parts:
        time_past(cs, dev, nmf_cfg, plain, out, arrays)
    if "loop" in parts:
        time_loop(cs, dev, nmf_cfg, eng, plain, out, arrays)
    if "trimphase" in parts:
        time_trimphase(cs, dev, nmf_cfg, eng, plain, out, arrays)
    np.savez(save, **arrays)
    out = {k: round(v, 3) if isinstance(v, float) else v
           for k, v in out.items()}
    print(json.dumps({"tree": tree, "ms": out, "panel_spills": spilled,
                      "smi": cs.smi_line()}), flush=True)


def time_stream_trim(cs, dev, nmf_cfg, eng, plain, out, parts=PARTS):
    """Kernel 4 at STREAM (its plain version too where ``plain``), kernel 3
    and its nmf_tol branch at TRIM (each where ``parts`` names it)."""
    import torch
    from degnorm_tpu_torch import EngineConfig
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.ops import cuda_stream, cuda_trim
    nkw = baseline._nmf_kwargs(nmf_cfg, EngineConfig())
    G_top = max(g for g, _ in STREAM)
    p_top = max(p for _, p in STREAM)
    raw_top, lm = cs.small_wide_bucket(G_top, p_top, W_STREAM, cs.SEED + p_top,
                                       dev)
    for G, p in STREAM if "stream" in parts else ():
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
    if "trim" not in parts:
        return
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


def main(args):
    parts = PARTS
    if args[:1] == ["--parts"]:
        parts, args = tuple(args[1].split(",")), args[2:]
        if not set(parts) <= set(PARTS):
            sys.exit(__doc__)
    turns = args[:1] == ["--turns"]
    others = [os.path.abspath(t) for t in args[turns:]]
    trees = [REPO] + others + (others + [REPO] if turns else [])
    with tempfile.TemporaryDirectory() as tmp:
        saves = [os.path.join(tmp, f"past_{i}.npz") for i in range(len(trees))]
        for i, tree in enumerate(trees):
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--one", tree, str(int(tree == REPO)),
                                ",".join(parts), saves[i]],
                               capture_output=True, text=True)
            line = (r.stdout.strip().splitlines() or [""])[-1]
            rec = {"tree": tree, "rc": r.returncode,
                   "result": json.loads(line) if r.returncode == 0
                   else r.stderr[-2000:]}
            if ({"past", "loop", "trimphase"} & set(parts)
                    and r.returncode == 0
                    and i > 0):
                rec["past_bits"] = past_bits(saves[i], saves[0])
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2], sys.argv[3] == "1", tuple(sys.argv[4].split(",")),
            sys.argv[5])
    else:
        main(sys.argv[1:])
