"""Times the wide kernels 1, 3, 4 (``csrc/wide.cuh``'s core), 2
(``csrc/ratio_wide.cuh``) and 4c and 2c (``csrc/stream_cols_wide.cuh``) of
this tree and of other trees of the repo, each built and timed in a
process of its own, on one card:

    python3 tools/wide_core_ab.py [--parts PART,...] [--profile] [--turns]
                                  [TREE ...]

Each TREE is a checkout of the repo (e.g. a parent commit's ``git
archive``, or a copy with another version of the core), timed with its own
sources as they are.  Prints one JSON line a run: CUDA-event ms of

* ``core``: kernel 4 on 256 genes x p x 16,384 columns of raw int16 + scale
  (p = 48, 64, 96, 128), and kernels 1 and 3 with their branches (1w, 1aw:
  nmf_tol; 3w, 3aw: trim_fast, 3bw: nmf_tol) on 1,024 narrow genes at 48 x
  1024, 64 x 1024, 96 x 512 and 128 x 512;
* ``ratio``: kernel 2 (2w) on the raw int16 form of 1,024 narrow genes at
  RATIO_RESIDENT (every PMAX) and of long genes at RATIO_LONG (256 x 48 x
  16,384 and 16 x 64 x 65,536), and for this tree its plain version;
* ``cols``: kernels 4c and 2c's wide instances (4cw, 2cw) on
  ``chip_smoke.py``'s column-sharded bucket of 64 genes x p x 65,536 cut
  in two shards of the card (p = 33, 48, 64, 96, 128; 4c on raw int16 +
  scale with every 7th gene inactive, 2c on raw int16), a call over both
  shards, and for this tree their plain versions;

the outputs of ``ratio`` and ``cols`` compared bit for bit with this
tree's first run (``bits``: the largest difference relative to
max(|value|, 1) where they differ);

every part by default, on ``chip_smoke.py``'s data (its seeds; every p the
first p samples of one dataset made at 128), with the card's name and power
limit and the wide and resident instances that spill registers in the
build.  ``--profile``: the ``cols`` part also profiles one call of each
kernel at every p (``torch.profiler``, CUDA activity) and prints its
device milliseconds by kernel (``by_kernel``: name, launches, ms).
``--turns`` runs the trees in turns (this tree, the others, the
others again, this tree: A B B A).  Compare trees only within one run.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("core", "ratio", "cols")
COLS_P = (33, 48, 64, 96, 128)
RATIO_RESIDENT = ((48, 1024), (64, 1024), (96, 512), (128, 512))
RATIO_LONG = ((256, 48, 16384), (16, 64, 65536))


def time_ratio(cs, dev, plain, out, arrays):
    """Kernel 2 at RATIO_RESIDENT (chip_smoke's ``resident_bucket`` of 1,024
    narrow genes) and RATIO_LONG (``small_wide_bucket``), raw int16, its
    plain version too where ``plain``; the outputs into ``arrays``."""
    import torch
    from degnorm_tpu_torch import EngineConfig
    from degnorm_tpu_torch.ops import cuda_nmf
    kw = dict(power_iters=EngineConfig().power_iters_cold)
    base = list(cs.synth_dataset(1024, 128, seed=cs.SEED + 128)[0].values())
    rng = np.random.default_rng(cs.SEED + 11)
    shapes = [(1024, p, W) for p, W in RATIO_RESIDENT] + list(RATIO_LONG)
    for G, p, W in shapes:
        if (p, W) in RATIO_RESIDENT:
            _, lm, raw = cs.resident_bucket(G, p, W, dev, rng, mats=base)
        else:
            raw, lm = cs.small_wide_bucket(G, p, W, cs.SEED + p, dev)
        tag = f"{G}x{p}x{W}"
        for name, r in zip(("cov", "est"),
                           cuda_nmf.ratio_rowsums_cuda(raw, lm, **kw)):
            arrays[f"2w_{tag}.{name}"] = r.cpu().numpy()
        out[f"2w_{tag}"] = cs.time_ms(
            lambda: cuda_nmf.ratio_rowsums_cuda(raw, lm, **kw), 5)
        if plain:
            Ff = raw.to(torch.float32)
            out[f"2w_plain_{tag}"] = cs.time_ms(
                lambda: cuda_nmf.ratio_rowsums_plain(Ff, lm, **kw), 2)
            del Ff
        del raw, lm
        torch.cuda.empty_cache()


def by_kernel(fn):
    """Device milliseconds of one call of ``fn`` by kernel, largest first:
    [name (cut to 60 characters), launches, ms]."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t:
            rows.append([e.key[:60], e.count, round(t / 1e3, 3)])
    return sorted(rows, key=lambda r: -r[2])[:6]


def time_cols(cs, dev, plain, out, arrays, prof=None):
    """Kernels 4c and 2c's wide instances at 64 x p x 65,536 on two column
    shards of the card (``chip_smoke.check_colsharded_at``'s data and
    arguments), their plain versions too where ``plain``; the outputs
    (shard 0's K, E, u; 2c's row sums) into ``arrays``; where ``prof`` is a
    dict, one call of each by kernel (``by_kernel``) into it."""
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream
    from degnorm_tpu_torch.ops.cuda_trim import run_steps
    from degnorm_tpu_torch.parallel import make_mesh
    from degnorm_tpu_torch.parallel.seqpar import ColumnGroup
    G, W = cs.COLS_WIDE_GENES, cs.COLS_WIDE_W
    mesh = make_mesh([dev] * 2)
    lengths = np.random.default_rng(cs.SEED + 11).integers(W // 2, W + 1, G)
    raw_top, lm = cs.synth_wide_bucket(lengths, max(COLS_P), W,
                                       cs.SEED + 11, dev)
    power = EngineConfig().power_iters_cold
    for p in COLS_P:
        raw = raw_top[:, :p].contiguous()
        group = ColumnGroup(mesh, W, genes=G)
        cols = group.columns()
        shards = cs.cut_columns(raw, lm, len(cols))
        act = torch.ones(G, dtype=torch.bool, device=dev)
        act[6::7] = False
        nkw = dict(baseline._nmf_kwargs(NMFConfig(nmf_iter=cs.NMF_ITER),
                                        EngineConfig()),
                   gene_active=act,
                   scale=torch.linspace(0.8, 1.25, p, device=dev))

        def nmf(fn):
            return run_steps(fn(Fs, ms, c, **nkw)
                             for (Fs, ms), c in zip(shards, cols))

        def ratio(fn):
            return run_steps(fn(Fs, ms, c, power_iters=power)
                             for (Fs, ms), c in zip(shards, cols))
        got = nmf(cuda_stream.nmf_masked_colsharded_cuda)[0]
        for name, r in zip("KEu", got):
            arrays[f"4cw_p{p}.{name}"] = r.cpu().numpy()
        for name, r in zip(("cov", "est"),
                           ratio(cuda_nmf.ratio_rowsums_colsharded_cuda)[0]):
            arrays[f"2cw_p{p}.{name}"] = r.cpu().numpy()
        out[f"4cw_p{p}"] = cs.time_ms(
            lambda: nmf(cuda_stream.nmf_masked_colsharded_cuda), 2)
        out[f"2cw_p{p}"] = cs.time_ms(
            lambda: ratio(cuda_nmf.ratio_rowsums_colsharded_cuda), 5)
        if prof is not None:
            prof[f"4cw_p{p}"] = by_kernel(
                lambda: nmf(cuda_stream.nmf_masked_colsharded_cuda))
            prof[f"2cw_p{p}"] = by_kernel(
                lambda: ratio(cuda_nmf.ratio_rowsums_colsharded_cuda))
        if plain:
            out[f"4cw_plain_p{p}"] = cs.time_ms(
                lambda: nmf(cuda_stream.nmf_masked_colsharded_plain), 1,
                warm=False)
            out[f"2cw_plain_p{p}"] = cs.time_ms(
                lambda: ratio(cuda_nmf.ratio_rowsums_colsharded_plain), 1,
                warm=False)
        del raw, shards
        torch.cuda.empty_cache()


def output_bits(a_path, b_path):
    """Per array of two runs' output files: the same bits, or the largest
    difference relative to max(|value|, 1) and how many values differ."""
    a, b = np.load(a_path), np.load(b_path)
    out = {}
    for k in a.files:
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        if x.shape == y.shape and np.array_equal(x, y):
            out[k] = True
            continue
        d = np.abs(x - y) / np.maximum(np.abs(y), 1.0)
        out[k] = {"max_rel": float(d.max()), "differing": int((x != y).sum())}
    return out


def time_core(cs, dev, nmf_cfg, eng, out):
    """Kernel 4 at 256 x p x 16,384 and kernels 1 and 3 with their branches
    on 1,024 narrow genes (the ``core`` part)."""
    import torch
    from degnorm_tpu_torch import EngineConfig
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream, cuda_trim
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


def one(tree, plain=False, parts=PARTS, save=None, profile=False):
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
               if r["spill_bytes"] and ("wide" in r["kernel"]
                                         or "_res_" in r["kernel"]
                                         or "cols" in r["kernel"])}
    dev = torch.device("cuda")
    nmf_cfg = NMFConfig(nmf_iter=cs.NMF_ITER)
    eng = EngineConfig(bucket_widths=cs.BUCKET_WIDTHS)
    out, arrays = {}, {}
    prof = {} if profile else None
    if "ratio" in parts:
        time_ratio(cs, dev, plain, out, arrays)
    if "cols" in parts:
        time_cols(cs, dev, plain, out, arrays, prof)
    if save is not None:
        np.savez(save, **arrays)
    if "core" in parts:
        time_core(cs, dev, nmf_cfg, eng, out)
    out = {k: round(v, 3) for k, v in out.items()}
    rec = {"tree": tree, "ms": out, "wide_spills": spilled,
           "smi": cs.smi_line()}
    if prof:
        rec["by_kernel"] = prof
    print(json.dumps(rec), flush=True)


def main(args):
    parts = PARTS
    if args[:1] == ["--parts"]:
        parts, args = tuple(args[1].split(",")), args[2:]
        if not set(parts) <= set(PARTS):
            sys.exit(__doc__)
    profile = args[:1] == ["--profile"]
    args = args[profile:]
    turns = args[:1] == ["--turns"]
    others = [os.path.abspath(t) for t in args[turns:]]
    trees = [REPO] + others + (others + [REPO] if turns else [])
    with tempfile.TemporaryDirectory() as tmp:
        saves = [os.path.join(tmp, f"out_{i}.npz")
                 for i in range(len(trees))]
        for i, tree in enumerate(trees):
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--one", tree, str(int(tree == REPO)),
                                ",".join(parts), saves[i],
                                str(int(profile))],
                               capture_output=True, text=True)
            line = (r.stdout.strip().splitlines() or [""])[-1]
            rec = {"tree": tree, "rc": r.returncode,
                   "result": json.loads(line) if r.returncode == 0
                   else r.stderr[-2000:]}
            if {"ratio", "cols"} & set(parts) and r.returncode == 0 and i > 0:
                rec["bits"] = output_bits(saves[i], saves[0])
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2], sys.argv[3] == "1", tuple(sys.argv[4].split(",")),
            sys.argv[5], sys.argv[6] == "1")
    else:
        main(sys.argv[1:])
