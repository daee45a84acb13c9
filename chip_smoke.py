"""GPU smoke test of the PyTorch/CUDA port (``degnorm_tpu_torch``).

Run ``python3 chip_smoke.py`` from the repository root on a machine with one
NVIDIA GPU (sm_90a) and the CUDA toolkit.  It builds the three CUDA kernels
from ``degnorm_tpu_torch/csrc/``, holds each against its plain PyTorch
version on the whole buckets the main path launches it at, drives the main
path (``DegNormEngine.run`` on 20,480 genes x 8 samples, bucket widths 1024 and
4096, ``nmf_iter=50``) and checks kernel-on against kernel-off fits.  Each
phase prints one JSON line; any failed phase raises (non-zero exit).  There
is no CPU fallback: without a CUDA device the script exits non-zero and
prints no result.

Options (none needed): ``--phases env,build,kernels,fit,parity`` runs a
subset (then no final result line is printed unless all ran);
``--ptxas`` prints the compiler's register/shared-memory report.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from collections import OrderedDict

import numpy as np

N_GENES = 20480
P_SAMPLES = 8
NMF_ITER = 50
DEGNORM_ITER = 5            # full depth of the bench workload; not cut
BUCKET_WIDTHS = (1024, 4096)
PARITY_GENES = 512
SEED = 7

# NVIDIA H100 SXM data-sheet peaks used for the bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

ALL_PHASES = ("env", "build", "kernels", "fit", "parity")


def synth_lengths(n, rng):
    """Power-law-ish gene lengths, 200..4000 bp (two bucket widths)."""
    return np.clip((rng.pareto(1.7, n) + 1) * 220, 200, 4000).astype(int)


def synth_dataset(n, p, seed=SEED, profile="dense"):
    """Synthetic pileup-like dataset (own copy of the bench workload's
    generator): "dense" degrades every gene, "sparse" about 20%."""
    rng = np.random.default_rng(seed)
    lengths = synth_lengths(n, rng)
    degraded = (np.ones(n, bool) if profile == "dense"
                else rng.random(n) < 0.2)
    base_scale = 2 + 10 * rng.random(n)
    amp = 0.5 + rng.random((n, p)) * 1.5
    decay = rng.random((n, p))
    mats = [None] * n
    odd = (np.arange(p) % 2 == 1)[None, :, None]
    order = np.argsort(lengths, kind="stable")
    for s in range(0, n, 512):
        idx = order[s:s + 512]
        Lk = lengths[idx][:, None].astype(np.float64)
        Lmax = int(lengths[idx].max())
        j = np.arange(Lmax, dtype=np.float64)[None, :]
        t = j / (Lk - 1)
        base = np.abs(np.sin(np.pi * t) + 0.2)
        m = (amp[idx][:, :, None] * base_scale[idx][:, None, None]
             * base[:, None, :])
        dec = np.exp(-2.0 * (1 - t)[:, None, :] * decay[idx][:, :, None])
        m = np.where(degraded[idx][:, None, None] & odd, m * dec, m)
        m = np.round(np.maximum(m, 0.0) * 20).astype(np.float32)
        for k, gi in enumerate(idx):
            mats[gi] = np.ascontiguousarray(m[k, :, :int(lengths[gi])])
    cov = OrderedDict((f"g{i}", mats[i]) for i in range(n))
    X = np.round(np.abs(rng.standard_normal((n, p))) * 300 + 30)
    return cov, X


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps, warm=True):
    """Mean milliseconds of ``fn`` over ``reps`` launches, by CUDA events,
    after one warm-up launch (``warm=False`` skips it: for a plain version
    that runs for seconds, after the same code has run on the card)."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def err_stats(got, want, sel=None):
    """(max abs error, max error relative to max(|want|, 1)) over ``sel``."""
    d = (got.double() - want.double()).abs()
    r = d / want.double().abs().clamp_min(1.0)
    if sel is not None:
        d, r = d[sel], r[sel]
    if d.numel() == 0:
        return 0.0, 0.0
    return float(d.max()), float(r.max())


def assert_close(got, want, rtol, atol, what, sel=None):
    import torch
    g, w = got.double(), want.double()
    if sel is not None:
        g, w = g[sel], w[sel]
    bad = (g - w).abs() > atol + rtol * w.abs()
    if bool(bad.any()) or not bool(torch.isfinite(g).all()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} values outside "
            f"rtol={rtol} atol={atol} (max abs err "
            f"{float((g - w).abs().max()):.3e})")


# ---- least-time bounds from this run's inputs ------------------------------

def nmf_ops_per_column(p, nmf_iter):
    """float32 operations per active column of one NMF loop: the Gram
    (p(p+1) per pass, nmf_iter + 1 passes), v = X^T u (2p), the multiplier
    update (6p) per iteration, and the final E (2p)."""
    return (nmf_iter + 1) * p * (p + 1) + nmf_iter * 8 * p + 2 * p


def bound(bytes_moved, ops):
    tb = bytes_moved / PEAK_BYTES_PER_S * 1e3
    to = ops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def bound_nmf(F, mask, act, nmf_iter):
    G, p, W = F.shape
    ga = int(act.sum())
    cols = int(mask[act].sum())
    byts = ga * (p * W * 4 + W) + G * (W * 4 + 2 * p * 4) + G
    return bound(byts, cols * nmf_ops_per_column(p, nmf_iter))


def bound_ratio(F, mask):
    G, p, W = F.shape
    cols = int(mask.sum())
    byts = G * (p * W * 4 + W + 2 * p * 4)
    return bound(byts, cols * (p * (p + 1) + 7 * p))


TRIM_BOUND_NOTE = (
    "columns counted from bin_count with every dropped bin taken as a full "
    "one: exact unless a gene's short last bin was dropped, then low by "
    "less than one bin's columns in each later round of that gene")


def bound_trim(ti, rounds_active, nmf_iter):
    """Work this run's data needs.  A gene active for R rounds scores its
    residuals R times (6p operations a column, round r on the columns left
    after r - 1 drops) and runs R NMF loops and DI refreshes (4p a column,
    on the columns left after r drops).  Each round drops one bin; every
    bin of a gene holds ``bin_count[:, 0]`` columns but its last, which may
    be shorter, and the loop does not report which bins it dropped, so a
    dropped bin is counted as a full one (TRIM_BOUND_NOTE)."""
    G, p, W = ti.Fm.shape
    B = ti.bin_count.shape[1]
    R = rounds_active.double()
    n_hi = ti.n_hi.double()
    csize = ti.bin_count[:, 0].double()
    # sum_{r=1..R} (n_hi - r csize)  and  sum_{r=1..R} (n_hi - (r-1) csize)
    after = (R * n_hi - csize * R * (R + 1) / 2).clamp_min(0)
    before = (R * n_hi - csize * R * (R - 1) / 2).clamp_min(0)
    ga = int((rounds_active > 0).sum())
    byts = (ga * (p * W * 4 + W * 4 + W * 4 + B * 4 + 3 * p * 4)
            + G * (2 * p * 4 + 1 + 4 + 1 + 8))
    ops = (float(after.sum()) * (nmf_ops_per_column(p, nmf_iter) + 4 * p)
           + float(before.sum()) * 6 * p)
    return bound(byts, ops)


# ---- phases ----------------------------------------------------------------

def phase_env():
    import torch
    from degnorm_tpu_torch.ops.build import find_nvcc
    nvcc = find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[-2:]
    line = smi_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], nvcc=" | ".join(ver),
         device=torch.cuda.get_device_name(0), smi=line)
    return line


def phase_build(ptxas):
    from degnorm_tpu_torch.ops import build
    t0 = time.perf_counter()
    build.get_lib(verbose=ptxas)
    secs = time.perf_counter() - t0
    if ptxas:
        for ln in str(build.build_info.get("log", "")).splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln.lower():
                print("[ptxas] " + ln.strip(), flush=True)
    emit("build", seconds=round(secs, 2),
         cached=bool(build.build_info.get("cached")),
         library=os.path.relpath(str(build.build_info.get("path"))))


def kernel_inputs(bucket, device):
    """One whole bucket as the engine hands it to the kernels, all-zero
    padding slots included (they must bail, never NaN): scale-adjusted
    float32 coverage and the length mask."""
    import torch
    F = torch.from_numpy(bucket.F).to(device).to(torch.float32)
    lm = torch.from_numpy(bucket.len_mask()).to(device)
    p = F.shape[1]
    scale = torch.linspace(0.8, 1.25, p, device=device)
    return (F / scale[None, :, None]).contiguous(), lm


def check_kernels_at(F_adj, lm, nmf_cfg, eng_cfg, timed=True):
    """All three kernels against their plain versions on one bucket slice;
    returns per-kernel measurements."""
    import torch
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_trim
    G, p, W = F_adj.shape
    out = {}
    reps = 3

    # kernel 2: ratio-SVD row sums (initialisation sees raw coverage)
    kw = dict(power_iters=eng_cfg.power_iters_cold)
    got = cuda_nmf.ratio_rowsums_cuda(F_adj, lm, **kw)
    want = cuda_nmf.ratio_rowsums_plain(F_adj, lm, **kw)
    torch.cuda.synchronize()
    errs = []
    for g_, w_, nm in zip(got, want, ("cov_sums", "est_sums")):
        assert_close(g_, w_, 1e-3, 1e-3, f"ratio_rowsums {nm} W={W}")
        errs.append(err_stats(g_, w_))
    b_ms, b_by = bound_ratio(F_adj, lm)
    out["ratio_rowsums"] = dict(
        max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
        bound_ms=b_ms, bound_by=b_by)
    if timed:
        out["ratio_rowsums"]["ms"] = time_ms(
            lambda: cuda_nmf.ratio_rowsums_cuda(F_adj, lm, **kw), reps)
        out["ratio_rowsums"]["plain_ms"] = time_ms(
            lambda: cuda_nmf.ratio_rowsums_plain(F_adj, lm, **kw), reps)

    # the trim loop's inputs, computed with the plain versions so that both
    # sides of every comparison below see identical inputs
    plain_cfg = dataclasses.replace(eng_cfg, use_kernels=False)
    ti = baseline.trim_inputs(F_adj, lm, nmf_cfg, plain_cfg)
    nkw = baseline._nmf_kwargs(nmf_cfg, eng_cfg)

    # kernel 1: cold start with inactive genes (every 7th, and the bailed)
    act = ~ti.bailed
    act[::7] = False
    got = cuda_nmf.nmf_masked_cuda(ti.Fm, ti.hi, gene_active=act, **nkw)
    want = cuda_nmf.nmf_masked_plain(ti.Fm, ti.hi, gene_active=act, **nkw)
    torch.cuda.synchronize()
    errs = []
    for g_, w_, nm in zip(got, want, ("K", "E", "u")):
        assert_close(g_, w_, 1e-3, 1e-3, f"nmf_masked {nm} W={W} (cold)")
        errs.append(err_stats(g_, w_))
        if bool((g_[~act] != 0).any()):
            raise AssertionError(f"nmf_masked {nm}: inactive gene not zero")
    # ... and the resume case of the trim rounds: u0 given, fewer cold steps
    rkw = dict(nkw, power_iters_cold=eng_cfg.power_iters_resume)
    got_r = cuda_nmf.nmf_masked_cuda(ti.Fm, ti.hi, gene_active=act,
                                     u0=want[2], **rkw)
    want_r = cuda_nmf.nmf_masked_plain(ti.Fm, ti.hi, gene_active=act,
                                       u0=want[2], **rkw)
    torch.cuda.synchronize()
    for g_, w_, nm in zip(got_r, want_r, ("K", "E", "u")):
        assert_close(g_, w_, 1e-3, 1e-3, f"nmf_masked {nm} W={W} (u0 resume)")
        errs.append(err_stats(g_, w_))
    b_ms, b_by = bound_nmf(ti.Fm, ti.hi, act, nmf_cfg.nmf_iter)
    out["nmf_masked"] = dict(
        max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
        inactive_genes=int((~act).sum()), bound_ms=b_ms, bound_by=b_by)
    if timed:
        out["nmf_masked"]["ms"] = time_ms(
            lambda: cuda_nmf.nmf_masked_cuda(ti.Fm, ti.hi, gene_active=act,
                                             **nkw), reps)
        out["nmf_masked"]["plain_ms"] = time_ms(
            lambda: cuda_nmf.nmf_masked_plain(ti.Fm, ti.hi, gene_active=act,
                                              **nkw), 1, warm=False)

    # kernel 3: the whole trim loop
    targs = (ti.Fm, ti.bin_id, ti.bin_count, ti.K0, ti.E0, ti.rho0, ti.u0,
             ti.n_hi, ti.n_bins0, ti.active0)
    tkw = baseline.trim_kwargs(nmf_cfg, eng_cfg)
    K_g, rho_g, ran_g, rounds_g = cuda_trim.trim_loop_cuda(*targs, **tkw)
    K_w, rho_w, ran_w, rounds_w = cuda_trim.trim_loop_plain(*targs, **tkw)
    torch.cuda.synchronize()
    same = (ran_g == ran_w) & (rounds_g == rounds_w)
    n_same = int(same.sum())
    # 99% of the genes that enter the loop: the rest of a whole bucket
    # (bailed genes, padding slots) agrees trivially
    n_ent = int(ti.active0.sum())
    if G - n_same > 0.01 * n_ent:
        raise AssertionError(
            f"trim_loop W={W}: ran_bs/rounds_active differ on {G - n_same} "
            f"genes, of {n_ent} that entered")
    if not bool(torch.isfinite(rho_g).all() & torch.isfinite(K_g).all()):
        raise AssertionError(f"trim_loop W={W}: non-finite output")
    rho_err = (rho_g.double() - rho_w.double()).abs().amax(dim=1)
    rho_ok = int(((rho_err <= 5e-4) & same).sum())
    # an arg-max near-tie can drop another bin at the same round count;
    # such genes are counted, and must stay as rare as round disagreements
    if G - rho_ok > 0.01 * n_ent:
        raise AssertionError(
            f"trim_loop W={W}: rho off by more than 5e-4 on {G - rho_ok} "
            f"genes, of {n_ent} that entered")
    inact = ~ti.active0
    if not (torch.equal(K_g[inact], ti.K0[inact])
            and torch.equal(rho_g[inact], ti.rho0[inact])
            and int(rounds_g[inact].sum()) == 0 and not bool(ran_g[inact].any())):
        raise AssertionError("trim_loop: inactive gene did not keep K0/rho0")
    b_ms, b_by = bound_trim(ti, rounds_g, nmf_cfg.nmf_iter)
    out["trim_loop"] = dict(
        max_abs_err=float(rho_err[same].max()) if n_same else 0.0,
        rho_within_5e4=rho_ok, K_max_abs_err=err_stats(K_g, K_w, same)[0],
        genes=G, entered=n_ent, rounds_agree=n_same,
        mean_rounds=float(rounds_g.double().mean()),
        bound_ms=b_ms, bound_by=b_by)
    if timed:
        out["trim_loop"]["ms"] = time_ms(
            lambda: cuda_trim.trim_loop_cuda(*targs, **tkw), 2)
        out["trim_loop"]["plain_ms"] = time_ms(
            lambda: cuda_trim.trim_loop_plain(*targs, **tkw), 1, warm=False)
    return out


def phase_kernels(cov):
    """Each kernel against its plain version at the shapes the main path
    launches it at: the two whole buckets the engine packs from this
    dataset (p=8; W=1024 and W=4096; every slot, with inactive genes and a
    u0-resume case), after two small odd shapes for the other template
    instances.  Tolerances: K, E, u and row sums rtol 1e-3 / atol 1e-3
    (float32 reduction order over W differs); trim loop ran_bs and
    rounds_active equal on >= 99% of genes, rho atol 5e-4 on >= 99%."""
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.data.buckets import pack_buckets
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_trim
    dev = torch.device("cuda")
    nmf_cfg = NMFConfig(nmf_iter=NMF_ITER)
    eng_cfg = EngineConfig(bucket_widths=BUCKET_WIDTHS)
    res = {}
    # other template instances (p <= 4 and p <= 16), correctness only
    rng = np.random.default_rng(SEED + 1)
    for p, W, G in ((3, 384, 48), (16, 512, 32)):
        small, _ = synth_dataset(G, p, seed=SEED + p)
        F = np.zeros((G, p, W), np.float32)
        lens = np.zeros(G, np.int64)
        for i, m in enumerate(small.values()):
            L = min(m.shape[1], W - int(rng.integers(0, 40)))
            F[i, :, :L] = m[:, :L]
            lens[i] = L
        lm = torch.from_numpy(np.arange(W)[None, :] < lens[:, None]).to(dev)
        r = check_kernels_at(torch.from_numpy(F).to(dev), lm,
                             NMFConfig(nmf_iter=20), eng_cfg, timed=False)
        res[f"p{p}_W{W}"] = {k: v["max_abs_err"] for k, v in r.items()}
    buckets = pack_buckets(list(cov.values()), bucket_widths=BUCKET_WIDTHS,
                           dtype=np.int16)
    assert sorted(b.width for b in buckets) == sorted(BUCKET_WIDTHS)
    for b in buckets:
        F_adj, lm = kernel_inputs(b, dev)
        res[b.width] = check_kernels_at(F_adj, lm, nmf_cfg, eng_cfg)
        res[b.width]["shape"] = list(F_adj.shape)
        del F_adj, lm
        torch.cuda.empty_cache()
    emit("kernels",
         kernels=["nmf_masked", "ratio_rowsums", "trim_loop"],
         tolerance="K,E,u,row sums rtol 1e-3 atol 1e-3; trim flags >= 99% "
                   "equal, rho atol 5e-4 on >= 99%",
         launches=dict(nmf_masked=cuda_nmf.nmf_launches,
                       ratio_rowsums=cuda_nmf.ratio_launches,
                       trim_loop=cuda_trim.trim_launches),
         results={str(k): v for k, v in res.items()})
    return res


def profile_fit(engine, cov, X, steady_wall_s):
    """One more steady fit under torch.profiler: device time by kernel and
    the device's idle share of the fit's wall time.  Returns "not measured"
    where the profiler shows no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(cov, X, reuse_device_data=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        # device-side rows only: a CPU-op row repeats its kernels' time
        if us > 0 and ev.device_type == DeviceType.CUDA:
            rows.append((ev.key, float(us), int(ev.count)))
    busy_us = sum(r[1] for r in rows)
    if busy_us <= 0:
        return "not measured"
    idle = 1 - busy_us / 1e6 / wall
    if idle < -0.02:
        raise AssertionError(
            f"profile: device time {busy_us / 1e3:.1f} ms exceeds the fit's "
            f"wall time {wall * 1e3:.1f} ms: device rows counted twice")
    rows.sort(key=lambda r: -r[1])
    ours = {}
    for tag in ("nmf_masked_kernel", "ratio_rowsums_kernel",
                "trim_loop_kernel"):
        sel = [r for r in rows if tag in r[0]]
        ours[tag] = {"device_ms": round(sum(r[1] for r in sel) / 1e3, 3),
                     "launches": sum(r[2] for r in sel)}
    return {
        "wall_s": round(wall, 4), "unprofiled_wall_s": round(steady_wall_s, 4),
        "device_busy_ms": round(busy_us / 1e3, 3),
        "device_idle_share": round(idle, 4),
        "port_kernels": ours,
        "port_kernels_share_of_busy": round(
            sum(v["device_ms"] for v in ours.values()) * 1e3 / busy_us, 4),
        "top": [[k[:60], round(us / 1e3, 3), c] for k, us, c in rows[:8]],
    }


def phase_fit(cov, X):
    """The full main path at full width through DegNormEngine.run."""
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.engine import DegNormEngine
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_trim
    nmf_cfg = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=DEGNORM_ITER)
    eng_cfg = EngineConfig(bucket_widths=BUCKET_WIDTHS)
    assert eng_cfg.fuse_trim and eng_cfg.use_kernels
    engine = DegNormEngine(nmf_cfg, eng_cfg)
    torch.cuda.reset_peak_memory_stats()
    # counts to 0 just before the main path, read just after
    cuda_nmf.nmf_launches = cuda_nmf.ratio_launches = 0
    cuda_trim.trim_launches = 0
    t0 = time.perf_counter()
    res = engine.run(cov, X)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(nmf_masked=cuda_nmf.nmf_launches,
                    ratio_rowsums=cuda_nmf.ratio_launches,
                    trim_loop=cuda_trim.trim_launches)
    for name, cnt in launches.items():
        if cnt < 1:
            raise AssertionError(f"main path never launched {name}")
    timings = dict(engine.timings)
    # a second, steady fit on the resident buckets
    t0 = time.perf_counter()
    res2 = engine.run(cov, X, reuse_device_data=True)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    prof = profile_fit(engine, cov, X, wall2)
    n, p = res.rho.shape
    assert (n, p) == (N_GENES, P_SAMPLES), res.rho.shape
    assert np.isfinite(res.rho).all() and res.rho.min() >= 0 and res.rho.max() <= 0.9
    assert np.isfinite(res.x_adj).all() and res.x_adj.shape == (n, p)
    n_ran = int(res.ran_baseline_selection.any(axis=1).sum())
    assert n_ran > 0, "no gene ran baseline selection"
    np.testing.assert_allclose(res2.rho, res.rho, rtol=0, atol=1e-6)
    t0 = time.perf_counter()
    ests = res.estimates()
    est_s = time.perf_counter() - t0
    for gi in range(0, n, max(1, n // 64)):
        m = list(cov.values())[gi]
        assert ests[gi].shape == m.shape and np.isfinite(ests[gi]).all()
    compute = timings["init"] + timings["iterations"]
    emit("fit", genes=n, samples=p, nmf_iter=NMF_ITER,
         degnorm_iter=DEGNORM_ITER, degnorm_iter_cut=False,
         bucket_widths=list(BUCKET_WIDTHS),
         buckets=[[b.width, int(b.F.shape[0]), b.n_real]
                  for b in engine._buckets],
         launches=launches, wall_s=round(wall, 3),
         steady_wall_s=round(wall2, 3),
         timings={k: round(v, 4) for k, v in timings.items()},
         steady_timings={k: round(v, 4) for k, v in engine.timings.items()},
         gene_iter_per_s=round(n * DEGNORM_ITER / compute, 1),
         steady_gene_iter_per_s=round(n * DEGNORM_ITER / wall2, 1),
         estimates_s=round(est_s, 2), genes_ran_bs=n_ran,
         rho_mean=float(res.rho.mean()),
         peak_mem_bytes=int(torch.cuda.max_memory_allocated()),
         profile=prof)
    return launches


def phase_parity(cov, X):
    """The first PARITY_GENES genes fitted twice on the card: kernels on and
    use_kernels=False.  rho atol 5e-3, x_adj rtol 5e-3, ran_bs equal, each on
    at least 99% of genes (a trim decision that flips on a float32 near-tie
    moves that gene's DI by more than the tolerance)."""
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.engine import DegNormEngine
    genes = list(cov.keys())[:PARITY_GENES]
    sub = OrderedDict((g, cov[g]) for g in genes)
    Xs = X[:PARITY_GENES]
    nmf_cfg = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=DEGNORM_ITER)
    fits = {}
    secs = {}
    for use in (True, False):
        t0 = time.perf_counter()
        fits[use] = DegNormEngine(nmf_cfg, EngineConfig(
            bucket_widths=BUCKET_WIDTHS, use_kernels=use)).run(sub, Xs)
        secs[use] = time.perf_counter() - t0
    a, b = fits[True], fits[False]
    n = len(genes)
    ran_same = (a.ran_baseline_selection == b.ran_baseline_selection).all(axis=1)
    rho_err = np.abs(a.rho - b.rho).max(axis=1)
    adj_err = np.abs(a.x_adj / b.x_adj - 1).max(axis=1)
    stats = dict(genes=n, ran_bs_equal=int(ran_same.sum()),
                 rho_within_5e3=int((rho_err <= 5e-3).sum()),
                 x_adj_within_5e3=int((adj_err <= 5e-3).sum()),
                 rho_err_max=float(rho_err.max()),
                 rho_err_median=float(np.median(rho_err)),
                 x_adj_rel_err_max=float(adj_err.max()),
                 kernels_s=round(secs[True], 2), plain_s=round(secs[False], 2))
    emit("parity", **stats)
    for key in ("ran_bs_equal", "rho_within_5e3", "x_adj_within_5e3"):
        if stats[key] < 0.99 * n:
            raise AssertionError(f"parity: {key} = {stats[key]} of {n}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)
    phases = [s for s in args.phases.split(",") if s]

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    import degnorm_tpu_torch  # noqa: F401  (fails where the port is absent)
    # the plain references multiply in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    smi = phase_env() if "env" in phases else smi_line()
    if "build" in phases:
        phase_build(args.ptxas)
    t0 = time.perf_counter()
    cov, X = synth_dataset(N_GENES, P_SAMPLES)
    emit("data", seconds=round(time.perf_counter() - t0, 2), genes=N_GENES,
         samples=P_SAMPLES, seed=SEED, profile="dense")
    kres = phase_kernels(cov) if "kernels" in phases else None
    launches = phase_fit(cov, X) if "fit" in phases else None
    if "parity" in phases:
        phase_parity(cov, X)
    if set(ALL_PHASES) - set(phases):
        print(json.dumps({"ok": False, "partial": phases}))
        return 0

    main_shape = kres[1024]
    replaces = {
        "nmf_masked": "degnorm_tpu/ops/pallas_nmf.py:687",
        "ratio_rowsums": "degnorm_tpu/ops/pallas_nmf.py:562",
        "trim_loop": "degnorm_tpu/ops/pallas_trim.py:324",
    }
    source = {
        "nmf_masked": "degnorm_tpu_torch/csrc/nmf.cu",
        "ratio_rowsums": "degnorm_tpu_torch/csrc/ratio.cu",
        "trim_loop": "degnorm_tpu_torch/csrc/trim.cu",
    }
    kernels = []
    for name in ("nmf_masked", "ratio_rowsums", "trim_loop"):
        m, wide = main_shape[name], kres[4096][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(m["max_abs_err"], wide["max_abs_err"]),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None,
            "shape": main_shape["shape"],
            **({"bound_note": TRIM_BOUND_NOTE} if name == "trim_loop" else {}),
            "wide": {"shape": kres[4096]["shape"], "ms": wide["ms"],
                     "plain_ms": wide["plain_ms"],
                     "bound_ms": wide["bound_ms"],
                     "bound_by": wide["bound_by"]},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"phase": "total",
                      "seconds": round(time.perf_counter() - t_start, 1)}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
