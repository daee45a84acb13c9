"""GPU smoke test of the PyTorch/CUDA port (``degnorm_tpu_torch``).

Run ``python3 chip_smoke.py`` from the repository root on a machine with one
NVIDIA GPU (sm_90a) and the CUDA toolkit.  It builds the four CUDA kernels
from ``degnorm_tpu_torch/csrc/``, holds each against its plain PyTorch
version on the whole buckets the fits launch it at, and drives two paths
through ``DegNormEngine.run`` at ``nmf_iter=50`` and 5 DegNorm iterations:
the narrow one (20,480 genes x 8 samples, bucket widths 1024 and 4096: the
resident NMF kernel and the fused trim kernel) and the wide one (2,048 long
genes x 8 samples of 8,193 to 60,000 bases, default bucket widths 16384 and
65536: the streamed NMF kernel on raw int16 coverage, once per round of the
unfused trim loop).  It then checks kernels-on against kernels-off fits and
the unfused against the fused loop, and runs the ``degnorm-tpu-torch``
command (phase ``pipeline``): cold, ``python3 -m degnorm_tpu_torch`` in
a subprocess on simulated .bam files and a .gtf (ETL, fit, outputs, report),
then on .cram files of the same reads, whose outputs must equal the .bam
run's bit for bit with no CRAM slice declined by the vectorized decoder;
and warm, ``cli.main`` on a warm-start directory of both fits' genes, whose
DI and adjusted counts must be bit-equal to a direct ``DegNormEngine.run``,
whose buckets (native scan and pack) must be byte-equal to the numpy pack,
whose fit must launch all four kernels and agree with a ``use_kernels=False``
fit, and at whose narrow buckets of the default widths kernels 1-3 are held
against their plain versions.  The opt-in modes: phase ``kernels`` also
holds the nmf_tol branch of kernel 1 and the trim_fast and nmf_tol branches
of kernel 3 against their plain versions; phase ``modes`` drives the narrow
fit under trim_fast and under nmf_tol (each launching its branches),
rank1_method="eigh" and keyed downsample offsets; phase ``oracle`` holds the
engine on the card against the package's float64 oracle on the host.  The
gene-sharded engine (``parallel/``): phase ``mesh`` runs both fits on two
gene shards of the card in one process, bit-equal to phases ``fit`` and
``fit_wide``, and ``dryrun_multichip(2)``; phase ``multihost`` runs the
narrow fit in two processes sharing the card over gloo and in a one-process
NCCL group, and the ``--multihost`` command in two processes on phase
``pipeline``'s .bam samples, whose outputs must equal that phase's.  The
column-sharded buckets (``parallel/seqpar.py``, kernels 4c and 2c): phase
``mesh``'s long tail column-shards its W=65536 bucket and is held to the
parity gate of ``fit_wide``'s; phase ``seqpar`` holds 4c and 2c against
their plain versions on that bucket cut in two (p = 3, 8, 16, 32), on one
110,000-base outlier and on a TTN-like bucket of one gene in 64 slots (the
last two with 4c's nmf_tol instances too; each run twice for the same bits,
with its picked
geometry, the host microseconds a sweep and the times before the kernels'
redesign beside this run's), reports the long tail's sharded fit, and fits three
TTN-like genes column-sharded and gene-sharded, each against one device;
phase ``multihost`` also column-shards the long tail in two gloo processes.
Each phase prints one JSON line; any failed phase raises (non-zero exit).  There
is no CPU fallback: without a CUDA device the script exits non-zero and
prints no result.

Options (none needed): ``--phases env,build,kernels,fit,fit_wide,parity,
pipeline,mesh,seqpar,multihost,modes,oracle,wide_p`` runs a subset (then no
final result line is printed unless all ran; ``modes`` reads the default fit of
``fit`` for its drift, ``mesh`` the fits of ``fit`` and ``fit_wide``,
``multihost`` those of ``fit``, ``fit_wide`` and ``pipeline``: ``NEEDS``;
``seqpar`` fits the long tail on one device itself where ``fit_wide`` did
not run, and on the mesh where ``mesh`` did not);
phase ``upload``, run only when ``--phases`` names it, times the direct int16
upload against a 4-bit delta-encoded one (host encode, upload, decode on
the card) on the buckets of three fits, the A/B behind the engine's direct
upload;
``--ptxas`` prints the compiler's register/shared-memory report (and keeps
its raw output in ``degnorm_tpu_torch/_build/ptxas.log``) and fails on a
kernel instance that spills outside ``SPILL_ALLOWED``;
``--sweep`` times kernel 4c over blocks a gene (``sweep_colsharded``),
kernel 4 over launch geometries, kernel 3 over threads a block, kernel 1
over its launches (a block or a warp a gene) and kernel 2 over blocks a
gene (the measurements behind the rules in ``ops/cuda_stream.py::
pick_cols_geometry``, ``pick_geometry`` and ``ops/cuda_nmf.py::
pick_loop_threads``, ``pick_nmf_geometry``, ``pick_ratio_geometry``) and
prints no result line.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_GENES = 20480
P_SAMPLES = 8
NMF_ITER = 50
DEGNORM_ITER = 5            # full depth of the bench workload; not cut
BUCKET_WIDTHS = (1024, 4096)
P32_GENES = 1024            # phase kernels' timed p > 16 buckets (W = 1024)
TIMED_WIDE_P = (32, 24)
PARITY_GENES = 512
SEED = 7
SYNTH_THREADS = 4         # synth_dataset's chunks made at once
DEVICE = "cuda"             # the script runs nowhere else
# the long tail of a human-scale annotation: genes past the resident gate
WIDE_GENES = 2048
WIDE_MIN_LEN, WIDE_MAX_LEN = 8193, 60000
WIDE_WIDTHS = (16384, 65536)       # where the default bucket_widths put them
PARITY_WIDE_GENES = (96, 32)       # of either width

# NVIDIA H100 SXM data-sheet peaks used for the bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12   # dense, the tensor cores' TF32 rate

ALL_PHASES = ("env", "build", "kernels", "fit", "fit_wide", "parity",
              "pipeline", "mesh", "seqpar", "multihost", "modes", "oracle",
              "wide_p", "panels")
# what a phase reads from earlier ones
NEEDS = {"modes": ("fit",), "mesh": ("fit", "fit_wide"),
         "multihost": ("fit", "fit_wide", "pipeline")}
# run only when named in --phases: the encoded upload's A/B (PERF.md, PR 7)
OPT_IN_PHASES = ("upload",)

# phase pipeline: the degnorm-tpu-torch command on simulated .bam files (cold)
# and on a warm-start directory of both fits' genes (warm)
PIPE_CHROMS = 4
PIPE_GENES_PER_CHROM = 512
PIPE_DEGRADATION = (0.0, 0.0, 0.5, 0.5)      # one sample each
PIPE_READS_PER_GENE = 150
PIPE_READ_LEN = 50
# the warm genes a kernels-on / kernels-off parity pair of phase pipeline
# fits (their first ones; cut from every warm gene for the script's time
# limit)
PIPE_PARITY_GENES = 2048
REPO = os.path.dirname(os.path.abspath(__file__))
PIPE_DIR = os.path.join(REPO, "degnorm_tpu_torch", "_build", "smoke_pipeline")


def synth_lengths(n, rng):
    """Power-law-ish gene lengths, 200..4000 bp (two bucket widths)."""
    return np.clip((rng.pareto(1.7, n) + 1) * 220, 200, 4000).astype(int)


def synth_long_lengths(n, rng):
    """Lengths of the long genes of an annotation: a heavy head just past
    8,192 bases (about 85% fit a 16,384 bucket), a tail to 60,000."""
    return np.clip(WIDE_MIN_LEN * (1 + rng.pareto(2.7, n)), WIDE_MIN_LEN,
                   WIDE_MAX_LEN).astype(int)


def synth_dataset(n, p, seed=SEED, profile="dense", lengths_fn=synth_lengths):
    """Synthetic pileup-like dataset (own copy of the bench workload's
    generator): "dense" degrades every gene, "sparse" about 20%.  Values
    are integral, so the engine uploads them as int16."""
    rng = np.random.default_rng(seed)
    lengths = lengths_fn(n, rng)
    degraded = (np.ones(n, bool) if profile == "dense"
                else rng.random(n) < 0.2)
    base_scale = 2 + 10 * rng.random(n)
    amp = 0.5 + rng.random((n, p)) * 1.5
    decay = rng.random((n, p))
    mats = [None] * n
    order = np.argsort(lengths, kind="stable")
    chunks = []
    s = 0
    while s < n:
        # genes sorted by length, at most 512 a step and about 17M values
        # (2M columns of 8 samples)
        k = 512
        while (k > 1 and k * lengths[order[min(s + k, n) - 1]] * p
               > 8 * 2_100_000):
            k //= 2
        chunks.append(order[s:s + k])
        s += k

    def make(idx):
        Lk = lengths[idx][:, None].astype(np.float64)
        Lmax = int(lengths[idx].max())
        j = np.arange(Lmax, dtype=np.float64)[None, :]
        t = j / (Lk - 1)
        base = np.abs(np.sin(np.pi * t) + 0.2)
        m = (amp[idx][:, :, None] * base_scale[idx][:, None, None]
             * base[:, None, :])
        # the odd samples of a degraded gene decay toward its 5' end
        deg = np.flatnonzero(degraded[idx])
        if deg.size:
            m[deg, 1::2] *= np.exp(-2.0 * (1 - t[deg])[:, None, :]
                                   * decay[idx[deg]][:, 1::2, None])
        m = np.round(np.maximum(m, 0.0) * 20).astype(np.float32)
        for k, gi in enumerate(idx):
            mats[gi] = np.ascontiguousarray(m[k, :, :int(lengths[gi])])

    # numpy's loops release the GIL; each chunk is made alone, so the data
    # are the same at any number of threads
    with ThreadPoolExecutor(SYNTH_THREADS) as pool:
        list(pool.map(make, chunks))
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
    after one warm-up launch (``warm=False`` skips it: after the same call
    has run on the card)."""
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


def timed_once(fn):
    """``fn()`` once, and its milliseconds by CUDA events from an idle card:
    a plain version's checking call (it runs for up to seconds) is its
    timing too, with no warm-up."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


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

def nmf_ops_per_column(p, nmf_iter, tc=False):
    """float32 operations per active column of one NMF loop: the Gram
    (p(p+1) per pass, nmf_iter + 1 passes), v = X^T u (2p), the multiplier
    update (6p) per iteration, and the final E (2p).  ``tc``: the bound of
    the resident core's design (csrc/wide_res.cuh), the Gram's operations
    run three times (3xTF32) at the tensor cores' PEAK_TF32_FLOPS, counted
    here as the float32 operations that take as long at PEAK_F32_FLOPS, and
    added to the others' time."""
    gram = (nmf_iter + 1) * p * (p + 1)
    if tc:
        gram *= 3 * PEAK_F32_FLOPS / PEAK_TF32_FLOPS
    return gram + nmf_iter * 8 * p + 2 * p


def bound(bytes_moved, ops):
    tb = bytes_moved / PEAK_BYTES_PER_S * 1e3
    to = ops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def bound_nmf(F, mask, act, nmf_iter, iters=None, tc=False):
    """Kernel 1; ``iters``: the Lagrangian iterations each gene ran (the
    nmf_tol branch reports them), else ``nmf_iter`` for every gene; ``tc``:
    the tensor-core bound (``nmf_ops_per_column``)."""
    G, p, W = F.shape
    ga = int(act.sum())
    cols_g = mask.double().sum(dim=1) * act.double()
    byts = ga * (p * W * 4 + W) + G * (W * 4 + 2 * p * 4) + G
    if iters is None:
        return bound(byts, float(cols_g.sum())
                     * nmf_ops_per_column(p, nmf_iter, tc))
    # nmf_ops_per_column is affine in the iterations
    fixed = nmf_ops_per_column(p, 0, tc)
    per_it = nmf_ops_per_column(p, 1, tc) - fixed
    return bound(byts, float(cols_g.sum()) * fixed
                 + float((cols_g * iters.double()).sum()) * per_it)


def bound_stream(F, mask, act, nmf_iter, tc=False):
    """Kernel 4: kernel 1's operations on the active columns; each active
    gene's coverage read once in the type it arrives in (2 bytes an element
    for int16) with its mask row, E and the two p-vectors written; ``tc``:
    the Gram by 3xTF32 on the tensor cores (``nmf_ops_per_column``)."""
    G, p, W = F.shape
    ga = int(act.sum())
    cols = int(mask[act].sum())
    byts = (ga * (p * W * F.element_size() + W)
            + G * (W * 4 + 2 * p * 4) + G)
    return bound(byts, cols * nmf_ops_per_column(p, nmf_iter, tc))


def floor_cols_sweeps(F, mask, act, nmf_iter):
    """Kernel 4c's floor as a launch a sweep (csrc/stream_cols_wide.cuh):
    every active column's X through device memory each sweep, as the
    design makes it go, with A0 read again (2 bytes an int16 element):
    launch (a) reads A0 and writes X, each of the ``nmf_iter`` sweeps reads
    and writes X and reads A0, the finish reads X; ms at PEAK_BYTES_PER_S,
    beside ``bound_stream``'s ideal bound (each input read once)."""
    p = F.shape[1]
    cols = int(mask[act].sum())
    a = F.element_size()
    byts = cols * p * ((a + 4) + nmf_iter * (8 + a) + 4)
    return byts / PEAK_BYTES_PER_S * 1e3


def bound_ratio(F, mask, full=False):
    """Kernel 2: the coverage of the active columns read once in the type it
    arrives in (2 bytes an int16 element), the whole mask, two p-vectors a
    gene written; ``full``: every element of the coverage read (the bound
    of a kernel that reads padding too)."""
    G, p, W = F.shape
    cols = int(mask.sum())
    byts = (G * p * W if full else cols * p) * F.element_size() + G * (
        W + 2 * p * 4)
    return bound(byts, cols * (p * (p + 1) + 7 * p))


TRIM_BOUND_NOTE = (
    "columns counted from bin_count with every dropped bin taken as a full "
    "one: exact unless a gene's short last bin was dropped, then low by "
    "less than one bin's columns in each later round of that gene")


def bound_trim(ti, rounds_active, nmf_iter, iters=None, tc=False):
    """Work this run's data needs.  A gene active for R rounds scores its
    residuals R times (6p operations a column, round r on the columns left
    after r - 1 drops) and runs R NMF loops and DI refreshes (4p a column,
    on the columns left after r drops).  Each round drops one bin; every
    bin of a gene holds ``bin_count[:, 0]`` columns but its last, which may
    be shorter, and the loop does not report which bins it dropped, so a
    dropped bin is counted as a full one (TRIM_BOUND_NOTE).  ``iters``: the
    Lagrangian iterations each gene ran over its rounds, as the kernel
    reports them (trim_fast, nmf_tol), spread over its rounds' columns in
    proportion to the rounds (exact where every round runs as many).
    ``tc``: the tensor-core bound (``nmf_ops_per_column``)."""
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
    if iters is None:
        nmf_ops = float(after.sum()) * (nmf_ops_per_column(p, nmf_iter, tc)
                                        + 4 * p)
    else:
        fixed = nmf_ops_per_column(p, 0, tc) + 4 * p
        per_it = nmf_ops_per_column(p, 1, tc) - nmf_ops_per_column(p, 0, tc)
        nmf_ops = (float(after.sum()) * fixed + float(
            (after / R.clamp_min(1) * iters.double()).sum()) * per_it)
    ops = nmf_ops + float(before.sum()) * 6 * p
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


def ptxas_report(log):
    """One record a compiled kernel from ``nvcc -Xptxas -v``'s output: name
    with its template arguments, registers, shared memory, stack frame and
    spill bytes (stores + loads)."""
    import re
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            t = re.match(r"_Z\d+([a-z_0-9]+?)I((?:L[ib]\d+E)+)", name)
            plain = re.match(r"_Z(\d+)", name)
            if t:
                name = "%s<%s>" % (t.group(1), ",".join(
                    re.findall(r"L[ib](\d+)E", t.group(2))))
            elif plain:   # a kernel that is no template: its name alone
                name = name[plain.end():plain.end() + int(plain.group(1))]
            cur = dict(kernel=name, registers=None, smem_bytes=0,
                       stack_bytes=0, spill_bytes=0)
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            # the entry's own line and one a function it calls: keep the most
            cur["stack_bytes"] = max(cur["stack_bytes"], int(m.group(1)))
            cur["spill_bytes"] = max(cur["spill_bytes"],
                                     int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    return rows


# Compiled instances that may spill registers: the trim loop at PMAX = 32
# (p > 16 inside the resident gate means W <= 2048, off both fits' paths),
# 180 and 276 bytes that five rewrites moved by under 100, in each of its
# modes (the last template argument: default, trim_fast, nmf_tol), and the
# nmf_tol instance of kernel 1's block launch at PMAX = 32 for 16 < p < 32
# (676 bytes; phase kernels times it at p = 24).  Any other instance of the
# kernels (4c and 2c included: none spills) that spills fails ``--ptxas``.
SPILL_ALLOWED = tuple(f"trim_loop_kernel<32,{f},{m}>" for m in range(3)
                      for f in range(2)) + ("nmf_masked_kernel<32,0,1>",)
SPILL_GATED = ("nmf_masked_kernel", "nmf_masked_warp_kernel",
               "trim_loop_kernel", "nmf_streamed_kernel",
               "ratio_rowsums_kernel", "cols_gram_kernel", "cols_sweep_kernel",
               "cols_finish_kernel", "ratio_cols_sums_kernel", "wcols_",
               "wratio_cols_sums_kernel",
               "nmf_wide_kernel", "trim_wide_kernel", "nmf_stream_wide_kernel",
               "ratio_wide_", "nmf_panel_kernel", "ratio_panel_kernel",
               "nmf_stream_panel_kernel", "trim_panel_kernel", "trim_ph_",
               "nmf_res_kernel", "trim_res_kernel", "phase_gram_kernel",
               "phase_power_kernel", "phase_cols_kernel", "phase_est_kernel",
               "phase_prep_kernel")


def phase_build(ptxas):
    from degnorm_tpu_torch.ops import build
    t0 = time.perf_counter()
    build.get_lib(verbose=ptxas)
    secs = time.perf_counter() - t0
    if ptxas:
        log = str(build.build_info.get("log", ""))
        with open(os.path.join(build.BUILD_DIR, "ptxas.log"), "w") as f:
            f.write(log)
        report = ptxas_report(log)
        for row in report:
            print("[ptxas] " + json.dumps(row), flush=True)
        spilled = [r["kernel"] for r in report if r["spill_bytes"]]
        refused = [k for k in spilled if k.startswith(SPILL_GATED)
                   and k not in SPILL_ALLOWED]
        emit("ptxas", kernels=len(report), spilled=spilled,
             spill_allowed=list(SPILL_ALLOWED), refused=refused)
        if refused or not any(r["kernel"].startswith(SPILL_GATED)
                              for r in report):
            raise AssertionError(
                f"ptxas: kernel instances spill registers: {refused}"
                if refused else "ptxas: no gated kernel found in the report")
    emit("build", seconds=round(secs, 2),
         cached=bool(build.build_info.get("cached")),
         source_seconds=build.build_info.get("source_seconds"),
         library=os.path.relpath(str(build.build_info.get("path"))))


def kernel_inputs(bucket, device):
    """One whole bucket as the engine hands it to the kernels, all-zero
    padding slots included (they must bail, never NaN): scale-adjusted
    float32 coverage, the length mask and the raw int16 upload."""
    import torch
    raw = torch.from_numpy(bucket.F).to(device)
    lm = torch.from_numpy(bucket.len_mask()).to(device)
    p = raw.shape[1]
    scale = torch.linspace(0.8, 1.25, p, device=device)
    return (raw.to(torch.float32) / scale[None, :, None]).contiguous(), lm, raw


RATIO_REPS = 20


def check_ratio_at(raw, lm, eng_cfg, timed=True):
    """Kernel 2 on one bucket as the engine's initialisation hands it over:
    the raw int16 upload and the length mask.  Equal bit for bit to the
    kernel on the float32 cast, and within rtol/atol 1e-3 of the plain
    version; both inputs timed over RATIO_REPS launches, beside the plain
    version and ``torch.sum`` over the same int16 tensor (one call that reads
    the same bytes once: a yardstick of the read, not the function)."""
    import torch
    from degnorm_tpu_torch.ops import cuda_nmf
    assert raw.dtype == torch.int16
    G, p, W = raw.shape
    kw = dict(power_iters=eng_cfg.power_iters_cold)
    Ff = raw.to(torch.float32)
    got = cuda_nmf.ratio_rowsums_cuda(raw, lm, **kw)
    got_f = cuda_nmf.ratio_rowsums_cuda(Ff, lm, **kw)
    want = cuda_nmf.ratio_rowsums_plain(Ff, lm, **kw)
    torch.cuda.synchronize()
    errs = []
    for g_, f_, w_, nm in zip(got, got_f, want, ("cov_sums", "est_sums")):
        if not torch.equal(g_, f_):
            raise AssertionError(
                f"ratio_rowsums {nm} p={p} W={W}: int16 input differs from "
                f"its float32 cast on {int((g_ != f_).sum())} values")
        assert_close(g_, w_, 1e-3, 1e-3, f"ratio_rowsums {nm} p={p} W={W}")
        errs.append(err_stats(g_, w_))
    b_ms, b_by = bound_ratio(raw, lm)
    out = dict(shape=[G, p, W], input="raw int16",
               max_abs_err=max(e[0] for e in errs),
               max_rel_err=max(e[1] for e in errs), int16_equals_f32=True,
               geometry=list(cuda_nmf.pick_ratio_geometry(p, W, G)),
               bound_ms=b_ms, bound_by=b_by,
               bound_full_ms=bound_ratio(raw, lm, full=True)[0],
               f32_bound_ms=bound_ratio(Ff, lm)[0])
    if timed:
        out["ms"] = time_ms(lambda: cuda_nmf.ratio_rowsums_cuda(raw, lm, **kw),
                            RATIO_REPS)
        out["f32_input_ms"] = time_ms(
            lambda: cuda_nmf.ratio_rowsums_cuda(Ff, lm, **kw), RATIO_REPS)
        out["torch_sum_i16_ms"] = time_ms(lambda: torch.sum(raw, dim=2),
                                          RATIO_REPS)
        out["plain_ms"] = time_ms(
            lambda: cuda_nmf.ratio_rowsums_plain(Ff, lm, **kw), 3)
    return out


def nmf_geometries(p, W, G):
    """Kernel 1's launch as its rule picks it, and the other one (a block or
    a warp a gene; None where p is past a warp a gene's limit)."""
    from degnorm_tpu_torch.ops import cuda_nmf
    geo = cuda_nmf.pick_nmf_geometry(p, W, G)
    other = (("block", cuda_nmf.pick_loop_threads(p, W)) if geo[0] == "warp"
             else ("warp", 32 * cuda_nmf.GENE_WARPS)
             if p <= cuda_nmf.GENE_WARP_MAX_P else None)
    return geo, other


def check_kernels_at(F_adj, lm, nmf_cfg, eng_cfg, raw, timed=True,
                     freeze=False, branches=True, keep=None):
    """Kernels 1-3 against their plain versions on one bucket (kernel 2 on
    its raw int16 form ``raw``), the opt-in branches too where ``branches``
    (``freeze``: also where most genes freeze, ``check_branches_at``);
    returns per-kernel measurements.  ``keep``: a dict that receives the
    kernels' inputs (``ti``, ``act``, ``nkw``, ``targs``, ``tkw``)."""
    import torch
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_trim
    G, p, W = F_adj.shape
    out = {}
    reps = 3

    # kernel 2: ratio-SVD row sums (initialisation sees raw coverage)
    out["ratio_rowsums"] = check_ratio_at(raw, lm, eng_cfg, timed)

    # the trim loop's inputs, computed with the plain versions so that both
    # sides of every comparison below see identical inputs
    plain_cfg = dataclasses.replace(eng_cfg, use_kernels=False)
    ti = baseline.trim_inputs(F_adj, lm, nmf_cfg, plain_cfg)
    nkw = baseline._nmf_kwargs(nmf_cfg, eng_cfg)

    # kernel 1: cold start with inactive genes (every 7th, and the bailed),
    # on the launch the rule picks and on the other one
    act = ~ti.bailed
    act[::7] = False
    geo, other = nmf_geometries(p, W, G)
    want, want_ms = timed_once(lambda: cuda_nmf.nmf_masked_plain(
        ti.Fm, ti.hi, gene_active=act, **nkw))
    errs = []
    for g in (geo, other)[:2 if other else 1]:
        got = cuda_nmf.nmf_masked_cuda(ti.Fm, ti.hi, gene_active=act,
                                       _geometry=g, **nkw)
        torch.cuda.synchronize()
        for g_, w_, nm in zip(got, want, ("K", "E", "u")):
            assert_close(g_, w_, 1e-3, 1e-3,
                         f"nmf_masked {nm} p={p} W={W} {g} (cold)")
            errs.append(err_stats(g_, w_))
            if bool((g_[~act] != 0).any()):
                raise AssertionError(f"nmf_masked {nm} {g}: inactive gene "
                                     "not zero")
    # ... and the resume case of the trim rounds: u0 given, fewer cold steps
    rkw = dict(nkw, power_iters_cold=eng_cfg.power_iters_resume)
    got_r = cuda_nmf.nmf_masked_cuda(ti.Fm, ti.hi, gene_active=act,
                                     u0=want[2], **rkw)
    want_r = cuda_nmf.nmf_masked_plain(ti.Fm, ti.hi, gene_active=act,
                                       u0=want[2], **rkw)
    torch.cuda.synchronize()
    for g_, w_, nm in zip(got_r, want_r, ("K", "E", "u")):
        assert_close(g_, w_, 1e-3, 1e-3,
                     f"nmf_masked {nm} p={p} W={W} {geo} (u0 resume)")
        errs.append(err_stats(g_, w_))
        if bool((g_[~act] != 0).any()):
            raise AssertionError(f"nmf_masked {nm}: inactive gene not zero")
    b_ms, b_by = bound_nmf(ti.Fm, ti.hi, act, nmf_cfg.nmf_iter)
    out["nmf_masked"] = dict(
        max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
        inactive_genes=int((~act).sum()), geometry=list(geo),
        other_geometry=list(other) if other else None, bound_ms=b_ms,
        bound_by=b_by)
    if cuda_nmf.res_core(p):
        out["nmf_masked"].update(
            bound_tc_ms=bound_nmf(ti.Fm, ti.hi, act, nmf_cfg.nmf_iter,
                                  tc=True)[0],
            res_geometry=list(cuda_nmf.res_geometry(p, W)))
    if timed:
        out["nmf_masked"]["ms"] = time_ms(
            lambda: cuda_nmf.nmf_masked_cuda(ti.Fm, ti.hi, gene_active=act,
                                             **nkw), reps)
        out["nmf_masked"]["plain_ms"] = want_ms

    # kernel 3: the whole trim loop
    targs = (ti.Fm, ti.bin_id, ti.bin_count, ti.K0, ti.E0, ti.rho0, ti.u0,
             ti.n_hi, ti.n_bins0, ti.active0)
    tkw = baseline.trim_kwargs(nmf_cfg, eng_cfg)
    out["trim_loop"] = check_trim_at(ti, targs, tkw, nmf_cfg, timed)

    # the opt-in branches of kernels 1 and 3, on the same inputs
    if branches:
        out.update(check_branches_at(
            ti, act, nkw, targs, tkw, nmf_cfg, timed,
            out["trim_loop"]["lagrangian_iters"], freeze))
    if keep is not None:
        keep.update(ti=ti, act=act, nkw=nkw, targs=targs, tkw=tkw)
    return out


def check_trim_at(ti, targs, tkw, nmf_cfg, timed, default_iters=None,
                  time_reps=2, **mode):
    """Kernel 3 (in the branch ``mode`` selects: trim_fast or nmf_tol)
    against its plain version on one bucket's trim inputs: ran_bs and
    rounds_active equal on >= 99% of the genes that enter, rho within 5e-4
    on >= 99%, a gene that never enters keeps K0 and rho0.  Lagrangian
    iterations: on the genes whose rounds agree, the kernel's count equals
    the plain version's on >= 99% of the genes that enter, give or take one
    iteration a round under nmf_tol (a freeze test that float32 summation
    order tips one iteration early or late).  ``default_iters``: the default
    mode's Lagrangian iterations on the same inputs; given, the rounds must
    freeze, at most 90% of them.  The kernel's iterations go into the
    bound.  ``time_reps``: the launches timed (1: one, with no warm-up,
    the check's own having run)."""
    import torch
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_trim
    G, p, W = ti.Fm.shape
    what = "trim_loop" + "".join(f"[{k}]" if v is True else f"[{k}={v:g}]"
                                 for k, v in mode.items())
    it_g = torch.zeros(G, dtype=torch.int32, device=ti.Fm.device)
    it_w = torch.zeros_like(it_g)
    K_g, rho_g, ran_g, rounds_g = cuda_trim.trim_loop_cuda(
        *targs, iters_out=it_g, **tkw, **mode)
    (K_w, rho_w, ran_w, rounds_w), plain_ms = timed_once(
        lambda: cuda_trim.trim_loop_plain(*targs, iters_out=it_w, **tkw,
                                          **mode))
    same = (ran_g == ran_w) & (rounds_g == rounds_w)
    n_same = int(same.sum())
    # 99% of the genes that enter the loop: the rest of a whole bucket
    # (bailed genes, padding slots) agrees trivially
    n_ent = int(ti.active0.sum())
    if G - n_same > 0.01 * n_ent:
        raise AssertionError(
            f"{what} W={W}: ran_bs/rounds_active differ on {G - n_same} "
            f"genes, of {n_ent} that entered")
    if not bool(torch.isfinite(rho_g).all() & torch.isfinite(K_g).all()):
        raise AssertionError(f"{what} W={W}: non-finite output")
    rho_err = (rho_g.double() - rho_w.double()).abs().amax(dim=1)
    rho_ok = int(((rho_err <= 5e-4) & same).sum())
    # an arg-max near-tie can drop another bin at the same round count;
    # such genes are counted, and must stay as rare as round disagreements
    if G - rho_ok > 0.01 * n_ent:
        raise AssertionError(
            f"{what} W={W}: rho off by more than 5e-4 on {G - rho_ok} "
            f"genes, of {n_ent} that entered")
    slack = rounds_w if "nmf_tol" in mode else torch.zeros_like(rounds_w)
    it_off = int(((it_g - it_w).abs() > slack)[same].sum())
    if it_off > 0.01 * n_ent:
        raise AssertionError(
            f"{what} W={W}: Lagrangian iterations differ on {it_off} genes "
            f"(more than one a round under nmf_tol), of {n_ent} that entered")
    if default_iters is not None and not int(it_g.sum()) <= 0.9 * default_iters:
        raise AssertionError(
            f"{what} W={W}: rounds did not freeze: {int(it_g.sum())} "
            f"Lagrangian iterations against {default_iters} by default")
    inact = ~ti.active0
    if not (torch.equal(K_g[inact], ti.K0[inact])
            and torch.equal(rho_g[inact], ti.rho0[inact])
            and int(rounds_g[inact].sum()) == 0 and not bool(ran_g[inact].any())
            and int(it_g[inact].abs().sum()) == 0):
        raise AssertionError(f"{what}: inactive gene did not keep K0/rho0")
    b_ms, b_by = bound_trim(ti, rounds_g, nmf_cfg.nmf_iter,
                            iters=it_g if mode else None)
    rec = dict(
        max_abs_err=float(rho_err[same].max()) if n_same else 0.0,
        rho_within_5e4=rho_ok, K_max_abs_err=err_stats(K_g, K_w, same)[0],
        genes=G, entered=n_ent, rounds_agree=n_same,
        iters_agree=int((it_g == it_w).sum()), iters_off=it_off,
        iters_max_diff=int((it_g - it_w).abs().max()) if G else 0,
        most_bins=int(ti.n_bins0[ti.active0].max()) if n_ent else 0,
        mean_rounds=float(rounds_g.double().mean()),
        lagrangian_iters=int(it_g.sum()),
        bound_ms=b_ms, bound_by=b_by)
    if cuda_nmf.res_core(p):
        rec["bound_tc_ms"] = bound_trim(ti, rounds_g, nmf_cfg.nmf_iter,
                                        iters=it_g if mode else None,
                                        tc=True)[0]
    if timed:
        rec["ms"] = time_ms(
            lambda: cuda_trim.trim_loop_cuda(*targs, **tkw, **mode),
            time_reps, warm=time_reps > 1)
        rec["plain_ms"] = plain_ms
    return rec


# the opt-in modes as chip_smoke.py drives them, and the kernel branches
# they run: name -> (kernel, mode, source, the TPU kernel's branch)
MODE_TOL = 1e-4
# a tolerance at which most genes and trim rounds freeze at nmf_iter 50
# (about 32 iterations a gene on the narrow workload): phase kernels holds
# the nmf_tol branches there too, so that their checks see the freeze
FREEZE_TOL = 1e-3
NEVER_TOL = 1e-30     # no gene meets it: the adaptive instances, no freeze
BRANCHES = {
    "nmf_masked[nmf_tol]": (
        "nmf_masked", dict(nmf_tol=MODE_TOL), "degnorm_tpu_torch/csrc/nmf_tol.cu",
        "degnorm_tpu/ops/pallas_nmf.py:440"),
    "trim_loop[trim_fast]": (
        "trim_loop", dict(trim_fast=True), "degnorm_tpu_torch/csrc/trim_fast.cu",
        "degnorm_tpu/ops/pallas_trim.py:135"),
    "trim_loop[nmf_tol]": (
        "trim_loop", dict(nmf_tol=MODE_TOL), "degnorm_tpu_torch/csrc/trim_tol.cu",
        "degnorm_tpu/ops/pallas_trim.py:177"),
}


def check_nmf_tol_at(ti, act, nkw, nmf_cfg, tol, timed, need_freeze=False,
                     cap_active=True):
    """Kernel 1's nmf_tol branch at ``tol`` against its plain version (cold
    start, inactive genes, on the launch the rule picks and on the other
    one).  Each gene reports the iterations it ran: the kernel's count must
    equal the plain version's on all but max(2, 1%) of the genes that froze
    early in the plain version, and on >= 99% of the active genes (float32
    summation order can tip a freeze test one iteration), so a kernel that
    never freezes, or freezes on another test, fails; K, E, u rtol 1e-3 /
    atol 1e-3 on the genes whose counts agree.  ``need_freeze``: at least half the active genes must
    freeze early, or the check would not see the freeze.  ``cap_active``
    False drops the cap of 1% of the active genes (the counts may differ on
    max(2, 1%) of the early-frozen genes): buckets of 64 columns past 640
    samples hold too few active genes for that cap to allow any."""
    import torch
    from degnorm_tpu_torch.ops import cuda_nmf
    G, p, W = ti.Fm.shape
    kw = dict(nkw, nmf_tol=tol)
    it_w = torch.zeros(G, dtype=torch.int32, device=ti.Fm.device)
    want, want_ms = timed_once(lambda: cuda_nmf.nmf_masked_plain(
        ti.Fm, ti.hi, gene_active=act, iters_out=it_w, **kw))
    frozen = int((act & (it_w < nmf_cfg.nmf_iter)).sum())
    n_act = int(act.sum())
    what = f"nmf_masked[nmf_tol={tol:g}] p={p} W={W}"
    if need_freeze and frozen < 0.5 * n_act:
        raise AssertionError(f"{what}: only {frozen} of {n_act} active genes "
                             "froze early in the plain version")
    geo, other = nmf_geometries(p, W, G)
    errs, agree, max_diff = [], [], 0
    for g in (geo, other)[:2 if other else 1]:
        it_g = torch.zeros_like(it_w)
        got = cuda_nmf.nmf_masked_cuda(ti.Fm, ti.hi, gene_active=act,
                                       iters_out=it_g, _geometry=g, **kw)
        torch.cuda.synchronize()
        same = it_g == it_w
        n_off = int((~same).sum())
        agree.append(G - n_off)
        max_diff = max(max_diff, int((it_g - it_w).abs().max()))
        allowed = max(2, 0.01 * frozen)
        if cap_active:
            allowed = min(allowed, 0.01 * n_act)
        if n_off > allowed:
            raise AssertionError(
                f"{what} {g}: iterations differ on {n_off} genes, of {frozen} "
                f"that froze early in the plain version ({n_act} active)")
        for g_, w_, nm in zip(got, want, ("K", "E", "u")):
            assert_close(g_, w_, 1e-3, 1e-3, f"{what} {nm} {g}", sel=same)
            errs.append(err_stats(g_, w_, same))
            if bool((g_[~act] != 0).any()):
                raise AssertionError(f"{what} {nm} {g}: inactive gene not "
                                     "zero")
        if g == geo:
            it_rule = it_g
    b_ms, b_by = bound_nmf(ti.Fm, ti.hi, act, nmf_cfg.nmf_iter, iters=it_rule)
    ran = it_rule[act].double()
    rec = dict(
        max_abs_err=max(e[0] for e in errs),
        max_rel_err=max(e[1] for e in errs), nmf_tol=tol,
        iters_agree=agree, iters_max_diff=max_diff, active=n_act,
        mean_iters=float(ran.mean()) if ran.numel() else 0.0,
        genes_frozen_early=int((ran < nmf_cfg.nmf_iter).sum()),
        plain_genes_frozen_early=frozen,
        nmf_iter=nmf_cfg.nmf_iter, geometry=list(geo),
        bound_ms=b_ms, bound_by=b_by)
    if cuda_nmf.res_core(ti.Fm.shape[1]):
        rec["bound_tc_ms"] = bound_nmf(ti.Fm, ti.hi, act, nmf_cfg.nmf_iter,
                                       iters=it_rule, tc=True)[0]
    if timed:
        rec["ms"] = time_ms(
            lambda: cuda_nmf.nmf_masked_cuda(ti.Fm, ti.hi, gene_active=act,
                                             **kw), 3)
        rec["plain_ms"] = want_ms
    return rec


def check_branches_at(ti, act, nkw, targs, tkw, nmf_cfg, timed,
                      default_iters, freeze=False):
    """The opt-in branches against their plain versions on one bucket, on
    the inputs of the default checks: kernel 1's nmf_tol branch
    (``check_nmf_tol_at``), kernel 3's trim_fast and nmf_tol branches
    (``check_trim_at``), at MODE_TOL.  ``freeze``: the two nmf_tol branches
    again at FREEZE_TOL, where most genes and trim rounds freeze, recorded
    under ``freeze``.  The bound of each counts the work of its own
    iterations: those the kernel reports for nmf_tol, n_it a round for
    trim_fast."""
    out = {"nmf_masked[nmf_tol]": check_nmf_tol_at(ti, act, nkw, nmf_cfg,
                                                   MODE_TOL, timed)}
    out["trim_loop[trim_fast]"] = check_trim_at(ti, targs, tkw, nmf_cfg,
                                                timed, trim_fast=True)
    out["trim_loop[nmf_tol]"] = check_trim_at(ti, targs, tkw, nmf_cfg, timed,
                                              nmf_tol=MODE_TOL)
    out["trim_loop[trim_fast]"]["n_it"] = max(nmf_cfg.nmf_iter // 4, 8)
    if freeze:
        out["nmf_masked[nmf_tol]"]["freeze"] = check_nmf_tol_at(
            ti, act, nkw, nmf_cfg, FREEZE_TOL, timed, need_freeze=True)
        out["trim_loop[nmf_tol]"]["freeze"] = dict(
            check_trim_at(ti, targs, tkw, nmf_cfg, timed,
                          default_iters=default_iters, nmf_tol=FREEZE_TOL),
            nmf_tol=FREEZE_TOL, default_lagrangian_iters=default_iters)
    return out


STREAM_RTOL = 1e-5


def assert_rel(got, want, what, sel=None):
    """|got - want| <= STREAM_RTOL * max(|want|, 1): the float32
    reduction-order level (the Gram is summed over threads, warps and the
    cluster's blocks in another order than the plain version's einsum)."""
    abs_err, rel_err = err_stats(got, want, sel)
    if not rel_err <= STREAM_RTOL:
        raise AssertionError(f"{what}: relative error {rel_err:.3e} exceeds "
                             f"{STREAM_RTOL} (max abs err {abs_err:.3e})")
    return abs_err, rel_err


def check_quotients(scale):
    """All 65,536 int16 numerators over each scale, as the int16 + scale
    sweeps of kernel 4 compute the quotient (a hoisted reciprocal and two
    corrections), against the IEEE divide ``raw.float() / scale``: equal
    bit for bit.  Returns the count of quotients compared."""
    import torch
    from degnorm_tpu_torch.ops import cuda_stream
    raw = torch.arange(-32768, 32768, device=scale.device).to(torch.int16)
    got = cuda_stream.scaled_quotients_cuda(raw, scale)
    want = raw.to(torch.float32)[None, :] / scale.to(torch.float32)[:, None]
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = got != want
        raise AssertionError(
            f"scaled quotient differs from the IEEE divide on "
            f"{int(bad.sum())} of {bad.numel()} (numerator, scale) pairs")
    return int(got.numel())


def check_stream_at(raw, lm, nmf_cfg, eng_cfg, reps=2, with_ratio=True,
                    time_f32=True):
    """Kernel 4 against its plain version on one wide bucket as the engine
    holds it: ``raw`` the int16 upload, the mask the high-coverage columns
    the initial NMF of a bucket step sees.  (a) float32 pre-adjusted input;
    (b) raw int16 + scale, equal to (a) bit for bit; (c) every 7th gene and
    the bailed ones inactive (zeros out), then a u0 resume at the resume
    count; (d) a second launch geometry (none past 128 samples: the panel
    instance has one); (e) the exhaustive quotient check.  Timed over
    ``reps`` launches on raw int16, and on float32 input where
    ``time_f32``.  Also kernel 2 on the same bucket (``check_ratio_at``).
    Returns measurements."""
    import torch
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream
    G, p, W = raw.shape
    assert raw.dtype == torch.int16
    scale = torch.linspace(0.8, 1.25, p, device=raw.device)
    F_adj = (raw.to(torch.float32) / scale[None, :, None]).contiguous()
    colmax = (F_adj * lm[:, None, :]).amax(dim=1)
    hi = (colmax > 0.1 * colmax.amax(dim=1, keepdim=True)) & lm
    del colmax
    bailed = hi.sum(dim=1) < nmf_cfg.effective_min_high_coverage
    nkw = baseline._nmf_kwargs(nmf_cfg, eng_cfg)
    names = ("K", "E", "u")
    errs = []

    # (a) float32 input, every gene
    got_a = cuda_stream.nmf_masked_streamed_cuda(F_adj, hi, **nkw)
    want, want_ms = timed_once(
        lambda: cuda_stream.nmf_masked_streamed_plain(F_adj, hi, **nkw))
    for g_, w_, nm in zip(got_a, want, names):
        errs.append(assert_rel(g_, w_, f"nmf_streamed {nm} p={p} W={W} (f32)"))
    # (b) raw int16 + scale: the same bits, and the same bits again
    got_b = cuda_stream.nmf_masked_streamed_cuda(raw, hi, scale=scale, **nkw)
    again = cuda_stream.nmf_masked_streamed_cuda(raw, hi, scale=scale, **nkw)
    torch.cuda.synchronize()
    for a_, b_, c_, nm in zip(got_a, got_b, again, names):
        if not (torch.equal(a_, b_) and torch.equal(b_, c_)):
            raise AssertionError(
                f"nmf_streamed {nm} p={p} W={W}: raw int16 + scale differs "
                f"from the float32 input ({int((a_ != b_).sum())} values) or "
                f"between two runs ({int((b_ != c_).sum())})")
    # (c) inactive genes return zeros, active ones are untouched by them
    act = ~bailed
    act[::7] = False
    got_c = cuda_stream.nmf_masked_streamed_cuda(raw, hi, scale=scale,
                                                 gene_active=act, **nkw)
    torch.cuda.synchronize()
    for b_, c_, nm in zip(got_b, got_c, names):
        if bool((c_[~act] != 0).any()):
            raise AssertionError(f"nmf_streamed {nm}: inactive gene not zero")
        if not torch.equal(b_[act], c_[act]):
            raise AssertionError(f"nmf_streamed {nm}: gene_active changed an "
                                 "active gene's result")
    # ... and the resume case of the trim rounds, on fewer columns
    rkw = dict(nkw, power_iters_cold=eng_cfg.power_iters_resume)
    hi2 = hi.clone()
    hi2[:, : W // 16] = False
    got_r = cuda_stream.nmf_masked_streamed_cuda(
        raw, hi2, scale=scale, gene_active=act, u0=want[2], **rkw)
    want_r = cuda_stream.nmf_masked_streamed_plain(
        raw, hi2, scale=scale, gene_active=act, u0=want[2], **rkw)
    torch.cuda.synchronize()
    for g_, w_, nm in zip(got_r, want_r, names):
        errs.append(assert_rel(g_, w_, f"nmf_streamed {nm} p={p} W={W} "
                                        "(u0 resume)"))
    # (d) another launch geometry: the same function within the tolerance,
    # and the same bits from two runs of one geometry (the panel instance,
    # p > 128, has one: a block a gene)
    auto = cuda_stream.pick_geometry(W, p)
    other = (None if p > cuda_nmf.WIDE_MAX_P
             else (1, cuda_nmf.max_loop_threads(p)) if auto[0] > 1
             else (8, 128) if p <= cuda_nmf.NARROW_MAX_P
             else (8, cuda_nmf.WIDE_THREADS))
    geo_err = 0.0
    if other is not None:
        got_g = cuda_stream.nmf_masked_streamed_cuda(raw, hi, scale=scale,
                                                     _geometry=other, **nkw)
        got_g2 = cuda_stream.nmf_masked_streamed_cuda(raw, hi, scale=scale,
                                                      _geometry=other, **nkw)
        torch.cuda.synchronize()
        for g_, g2_, w_, nm in zip(got_g, got_g2, want, names):
            if not torch.equal(g_, g2_):
                raise AssertionError(f"nmf_streamed {nm} p={p} W={W}: two "
                                     f"runs at geometry {other} differ")
            geo_err = max(geo_err, assert_rel(
                g_, w_, f"nmf_streamed {nm} p={p} W={W} (geometry {other})"
            )[1])
        del got_g, got_g2
    # (e) the quotient of the int16 + scale form against the IEEE divide,
    # for every int16 numerator and this launch's scales
    n_quot = check_quotients(scale)
    del got_a, got_b, again, got_c, got_r, want_r, hi2
    all_on = torch.ones_like(act)
    b_ms, b_by = bound_stream(raw, hi, all_on, nmf_cfg.nmf_iter)

    def run_raw():
        return cuda_stream.nmf_masked_streamed_cuda(raw, hi, scale=scale,
                                                    **nkw)

    out = dict(
        shape=[G, p, W], max_abs_err=max(e[0] for e in errs),
        max_rel_err=max(e[1] for e in errs), raw_equals_f32=True,
        inactive_genes=int((~act).sum()), active_columns=int(hi.sum()),
        bound_ms=b_ms, bound_by=b_by, geometry=list(auto),
        other_geometry=list(other) if other else None,
        other_geometry_rel_err=geo_err,
        quotients_equal_ieee=n_quot,
        # (no warm-up launch: (b) and (c) ran these inputs)
        ms=time_ms(run_raw, reps, warm=False), plain_ms=want_ms)
    if time_f32:
        out["f32_input_ms"] = time_ms(
            lambda: cuda_stream.nmf_masked_streamed_cuda(F_adj, hi, **nkw),
            reps)
    if with_ratio:
        out["ratio_rowsums"] = check_ratio_at(raw, lm, eng_cfg)
    return out


def resident_bucket(G, p, W, device, rng, mats=None):
    """G genes of the narrow workload's lengths at p samples (seed SEED + p;
    ``mats``: the first p rows of these genes' coverage instead), each cut
    to at most W less 0-39 columns (``rng``): float32 coverage, its length
    mask and its int16 form."""
    import torch
    if mats is None:
        mats = list(synth_dataset(G, p, seed=SEED + p)[0].values())
    F = np.zeros((G, p, W), np.float32)
    lens = np.zeros(G, np.int64)
    for i, m in enumerate(mats[:G]):
        L = min(m.shape[1], W - int(rng.integers(0, 40)))
        F[i, :, :L] = m[:p, :L]
        lens[i] = L
    lm = torch.from_numpy(np.arange(W)[None, :] < lens[:, None]).to(device)
    return (torch.from_numpy(F).to(device), lm,
            torch.from_numpy(F.astype(np.int16)).to(device))


def small_wide_bucket(G, p, W, seed, device):
    """A few dozen genes of a shape where a larger study leaves the resident
    gate (p = 16 or 32): int16 coverage and its length mask."""
    import torch
    rng = np.random.default_rng(seed)

    def lengths(n, r):
        return r.integers(W // 2, W + 1, n)

    small, _ = synth_dataset(G, p, seed=seed, lengths_fn=lengths)
    F = np.zeros((G, p, W), np.int16)
    lens = np.zeros(G, np.int64)
    for i, m in enumerate(small.values()):
        lens[i] = m.shape[1]
        F[i, :, :lens[i]] = m
    lens[int(rng.integers(G))] = 1               # a slot that must bail
    lm = torch.from_numpy(np.arange(W)[None, :] < lens[:, None]).to(device)
    return torch.from_numpy(F).to(device), lm


def phase_kernels(cov, cov_wide):
    """Each kernel against its plain version at the shapes the fits launch
    it at.  Kernels 1-3: the two whole buckets the engine packs from the
    narrow dataset (p=8; W=1024 and W=4096; every slot, with inactive genes
    and a u0-resume case), after three small odd shapes: two for the other
    template instances (p=3, W=384; p=16, W=512), one with 48 trim bins on
    32-thread blocks, and p=32, W=2048.  Kernel 1 runs on the launch the
    rule picks and on the other one (a block or a warp a gene), kernel 2 on
    the raw int16 form, bit-equal to its float32 cast.  Kernel 4 (and kernel
    2 again): the two whole buckets of the long genes (p=8; W=16384 and
    W=65536), after p=32, W=4096 and p=16, W=8192 at 48 genes and p=2,
    W=40000 at 12.
    Kernels 1 and 3 also in their opt-in branches (``check_branches_at``),
    at the two whole buckets also where most genes freeze (FREEZE_TOL), and
    all of kernels 1-3 timed at p=32 and p=24, W=1024 (P32_GENES genes).
    Tolerances: kernels 1-3 K, E, u and row sums rtol 1e-3 / atol 1e-3
    (float32 reduction order over W differs); trim loop ran_bs and
    rounds_active equal on >= 99% of genes, rho atol 5e-4 on >= 99%;
    kernel 4 K, E, u within 1e-5 of max(|value|, 1), raw int16 input equal
    to float32 input bit for bit."""
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.data.buckets import pack_buckets
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream, cuda_trim
    dev = torch.device(DEVICE)
    nmf_cfg = NMFConfig(nmf_iter=NMF_ITER)
    eng_cfg = EngineConfig(bucket_widths=BUCKET_WIDTHS)
    res = {}
    # other template instances (p <= 4, p <= 16, p = 32) and more trim bins
    # than a block of the trim kernel has threads (48 against 32),
    # correctness only
    rng = np.random.default_rng(SEED + 1)

    def odd_bucket(G, p, W):
        return resident_bucket(G, p, W, dev, rng)

    for p, W, G, bins in ((3, 384, 48, 20), (16, 512, 32, 20),
                          (8, 512, 48, 48), (32, 2048, 32, 20)):
        F, lm, raw = odd_bucket(G, p, W)
        assert bins <= 32 or cuda_nmf.pick_loop_threads(p, W) == 32
        r = check_kernels_at(F, lm, NMFConfig(nmf_iter=20, bins=bins),
                             eng_cfg, raw, timed=False)
        res[f"p{p}_W{W}_bins{bins}"] = dict(
            {k: v["max_abs_err"] for k, v in r.items()},
            trim_entered=r["trim_loop"]["entered"],
            trim_most_bins=r["trim_loop"]["most_bins"])
        if bins > 32 and not r["trim_loop"]["most_bins"] > 32:
            raise AssertionError("no gene of the many-bins case has more "
                                 "bins than the block has threads")
    # p = 32 and p = 24 at W = 1024, timed: the PMAX = 32 block instances of
    # kernels 1 and 3 in every mode, p == PMAX and not (the nmf_tol branch
    # of kernel 1 at p < 32 and kernel 3 spill, SPILL_ALLOWED), where a fit
    # of 17-32 samples runs them
    for p in TIMED_WIDE_P:
        F, lm, raw = odd_bucket(P32_GENES, p, 1024)
        res[f"p{p}_W1024"] = check_kernels_at(F, lm, nmf_cfg, eng_cfg, raw)
        res[f"p{p}_W1024"]["shape"] = list(F.shape)
        del F, lm, raw
    buckets = pack_buckets(list(cov.values()), bucket_widths=BUCKET_WIDTHS,
                           dtype=np.int16)
    assert sorted(b.width for b in buckets) == sorted(BUCKET_WIDTHS)
    for b in buckets:
        F_adj, lm, raw = kernel_inputs(b, dev)
        res[b.width] = check_kernels_at(F_adj, lm, nmf_cfg, eng_cfg, raw,
                                        freeze=True)
        res[b.width]["shape"] = list(F_adj.shape)
        del F_adj, lm, raw
        torch.cuda.empty_cache()
    # kernel 4: the shapes where p = 32 and p = 16 leave the resident gate,
    # and a width that is no multiple of the column chunk (p <= 4 instance)
    wide_cfg = EngineConfig()
    for G, p, W in ((48, 32, 4096), (48, 16, 8192), (12, 2, 40000)):
        raw, lm = small_wide_bucket(G, p, W, SEED + p, dev)
        assert not cuda_nmf.kernels_supported(raw.shape, torch.float32)
        res[f"stream_p{p}_W{W}"] = check_stream_at(
            raw, lm, nmf_cfg, wide_cfg, with_ratio=False)
    # ... and the two whole buckets of the long genes
    buckets = pack_buckets(list(cov_wide.values()),
                           bucket_widths=wide_cfg.bucket_widths,
                           dtype=np.int16)
    assert sorted(b.width for b in buckets) == sorted(WIDE_WIDTHS)
    for b in buckets:
        raw = torch.from_numpy(b.F).to(dev)
        lm = torch.from_numpy(b.len_mask()).to(dev)
        res[f"stream_{b.width}"] = check_stream_at(raw, lm, nmf_cfg, wide_cfg)
        res[f"stream_{b.width}"]["genes"] = b.n_real
        del raw, lm
        torch.cuda.empty_cache()
    emit("kernels",
         kernels=["nmf_masked", "ratio_rowsums", "trim_loop", "nmf_streamed",
                  *BRANCHES],
         tolerance="kernels 1-3: K,E,u,row sums rtol 1e-3 atol 1e-3 (kernel "
                   "1 on both launches); trim flags >= 99% equal, rho atol "
                   "5e-4 on >= 99%; kernel 2 and kernel 4: raw int16 input "
                   "bit-equal to float32 input; kernel 4: K,E,u within 1e-5 "
                   "of max(|value|, 1); the branches as their kernel, "
                   "kernel 1's nmf_tol on the genes whose iteration counts "
                   "agree, which must be all but max(2, 1%) of those that "
                   "froze early in the plain version and >= 99% of the "
                   "active ones; kernel 3's "
                   "iterations equal on >= 99% of the genes whose rounds "
                   "agree (nmf_tol: within one a round); at the two "
                   "buckets also at nmf_tol=1e-3, where >= 50% of the "
                   "active genes and >= 10% of the trim iterations must "
                   "freeze",
         launches=dict(nmf_masked=cuda_nmf.nmf_launches,
                       ratio_rowsums=cuda_nmf.ratio_launches,
                       trim_loop=cuda_trim.trim_launches,
                       nmf_streamed=cuda_stream.stream_launches),
         results={str(k): v for k, v in res.items()})
    return res


def profile_fit(engine, cov, X, steady_wall_s, per_launch=None):
    """One more steady fit under torch.profiler: device time by kernel and
    the device's idle share of the fit's wall time.  Returns "not measured"
    where the profiler shows no device time.  ``per_launch``: a kernel-name
    tag; the device time of each of its launches, in launch order, is
    returned under "per_launch_ms"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # a kernel and a sync before the fit: its first launches (kernel 2's)
        # are recorded once the device's tracing is under way
        torch.ones(1, device=DEVICE).add_(1)
        torch.cuda.synchronize()
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
    each = None
    if per_launch is not None:
        evs = [ev for ev in prof.events()
               if ev.device_type == DeviceType.CUDA and per_launch in ev.name]
        evs.sort(key=lambda ev: ev.time_range.start)
        each = [round(float(getattr(ev, "self_device_time_total", getattr(
            ev, "self_cuda_time_total", 0.0))) / 1e3, 4) for ev in evs]
    ours = {}
    for tag in ("nmf_masked_kernel", "nmf_masked_warp_kernel",
                "ratio_rowsums_kernel", "trim_loop_kernel",
                "nmf_streamed_kernel", "nmf_wide_kernel", "ratio_wide_",
                "trim_wide_kernel", "nmf_stream_wide_kernel",
                "nmf_panel_kernel", "ratio_panel_kernel", "trim_panel_kernel",
                "nmf_stream_panel_kernel", "trim_ph_", "phase_",
                "nmf_res_kernel", "trim_res_kernel", "void cols_",
                "void ratio_cols_", "wcols_", "wratio_cols_"):
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
        **({"per_launch_ms": each} if each is not None else {}),
    }


def phase_fit(cov, X):
    """The full main path at full width through DegNormEngine.run."""
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.engine import DegNormEngine
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream, cuda_trim
    nmf_cfg = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=DEGNORM_ITER)
    eng_cfg = EngineConfig(bucket_widths=BUCKET_WIDTHS)
    assert eng_cfg.fuse_trim and eng_cfg.use_kernels
    engine = DegNormEngine(nmf_cfg, eng_cfg)
    torch.cuda.reset_peak_memory_stats()
    # counts to 0 just before the main path, read just after
    cuda_nmf.nmf_launches = cuda_nmf.ratio_launches = 0
    cuda_trim.trim_launches = cuda_stream.stream_launches = 0
    t0 = time.perf_counter()
    res = engine.run(cov, X)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(nmf_masked=cuda_nmf.nmf_launches,
                    ratio_rowsums=cuda_nmf.ratio_launches,
                    trim_loop=cuda_trim.trim_launches,
                    nmf_streamed=cuda_stream.stream_launches)
    for name, cnt in launches.items():
        # the narrow buckets are inside the resident gate: kernels 1-3 only
        if (cnt < 1) != (name == "nmf_streamed"):
            raise AssertionError(f"narrow path launched {name} {cnt} times")
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
    return launches, res, wall2, timings


def phase_fit_wide(cov, X):
    """The wide path at real size through DegNormEngine.run with the default
    bucket widths: every NMF is a launch of the streamed kernel on the raw
    int16 upload, one for the initial fit and one per round of the unfused
    trim loop, per bucket and DegNorm iteration.  Nothing is cut."""
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.engine import DegNormEngine
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream, cuda_trim
    nmf_cfg = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=DEGNORM_ITER)
    eng_cfg = EngineConfig()
    assert eng_cfg.fuse_trim and eng_cfg.use_kernels
    engine = DegNormEngine(nmf_cfg, eng_cfg)
    torch.cuda.reset_peak_memory_stats()
    # counts to 0 just before this path, read just after
    cuda_nmf.nmf_launches = cuda_nmf.ratio_launches = 0
    cuda_trim.trim_launches = cuda_stream.stream_launches = 0
    t0 = time.perf_counter()
    res = engine.run(cov, X)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(nmf_masked=cuda_nmf.nmf_launches,
                    ratio_rowsums=cuda_nmf.ratio_launches,
                    trim_loop=cuda_trim.trim_launches,
                    nmf_streamed=cuda_stream.stream_launches)
    n_buckets = len(engine._buckets)
    if sorted(b.width for b in engine._buckets) != sorted(WIDE_WIDTHS):
        raise AssertionError("long genes did not pack into the wide buckets")
    # rounds the unfused loop ran, per DegNorm iteration and bucket: every
    # launch of the streamed kernel is a bucket step's initial NMF or one
    # of these rounds
    trim_rounds = [list(r) for r in engine.trim_rounds]
    rounds_total = sum(sum(r) for r in trim_rounds)
    if rounds_total < 1 or launches["nmf_streamed"] != (
            n_buckets * DEGNORM_ITER + rounds_total):
        raise AssertionError(
            f"wide path launched the streamed kernel "
            f"{launches['nmf_streamed']} times for {n_buckets} buckets x "
            f"{DEGNORM_ITER} iterations and {rounds_total} trim rounds")
    if launches["ratio_rowsums"] != n_buckets:
        raise AssertionError("wide path: ratio kernel launches "
                             f"{launches['ratio_rowsums']} != {n_buckets}")
    if launches["trim_loop"] or launches["nmf_masked"]:
        raise AssertionError(f"wide buckets reached a resident kernel: "
                             f"{launches}")
    upload = sorted({str(F.dtype) for F in engine._device_F})
    if upload != ["torch.int16"]:
        raise AssertionError(f"upload is {upload}, expected int16")
    timings = dict(engine.timings)
    entered = [int(r.ran_bs.sum()) for r in engine._last_results]
    t0 = time.perf_counter()
    res2 = engine.run(cov, X, reuse_device_data=True)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    peak_mem = int(torch.cuda.max_memory_allocated())
    # the profiled fit: every launch of kernel 4 with its round, the count of
    # active genes it ran on, its geometry and its device time; the states of
    # the W=16384 bucket's rounds are kept to time a late round alone
    # afterwards
    log, states = [], []
    wrapped = cuda_stream.nmf_masked_streamed_cuda

    def keep_state(Fin, m, **kw):
        act = kw.get("gene_active")
        # the count stays on the device until the fit is over: no extra sync
        log.append((Fin.shape, Fin.shape[0] if act is None else act.sum(),
                    kw.get("u0") is not None))
        if Fin.shape[2] == WIDE_WIDTHS[0]:
            if kw.get("u0") is None:
                states.clear()          # a new bucket step: its rounds only
            else:
                states.append((Fin, m, kw))
        return wrapped(Fin, m, **kw)

    cuda_stream.nmf_masked_streamed_cuda = keep_state
    try:
        prof = profile_fit(engine, cov, X, wall2,
                           per_launch="nmf_streamed_kernel")
    finally:
        cuda_stream.nmf_masked_streamed_cuda = wrapped
    per_launch = "not measured"
    if isinstance(prof, dict) and len(prof.get("per_launch_ms", ())) == len(log):
        per_launch, rnd = [], {}
        for ((_, p_, W_), n_act, resumed), ms in zip(
                log, prof.pop("per_launch_ms")):
            rnd[W_] = rnd[W_] + 1 if resumed else 0   # 0 = a step's initial fit
            per_launch.append([W_, rnd[W_], int(n_act),
                               *cuda_stream.pick_geometry(W_, p_), ms])
    # a late round alone: the last DegNorm iteration's middle and last rounds
    # of the W=16384 bucket (few active genes, bins dropped)
    late = []
    last_iter = list(states)
    for Fin, m, kw in (last_iter[len(last_iter) // 2], last_iter[-1]):
        late.append(dict(
            runs_on=int(kw["gene_active"].sum()),
            active_columns=int(m[kw["gene_active"]].sum()),
            geometry=list(cuda_stream.pick_geometry(Fin.shape[2],
                                                    Fin.shape[1])),
            bound_ms=bound_stream(Fin, m, kw["gene_active"], NMF_ITER)[0],
            ms=time_ms(lambda: wrapped(Fin, m, **kw), 3)))
    LATE_STATES[:] = [last_iter[len(last_iter) // 2], last_iter[-1]]
    del states, last_iter
    n, p = res.rho.shape
    assert (n, p) == (WIDE_GENES, P_SAMPLES), res.rho.shape
    assert np.isfinite(res.rho).all() and res.rho.min() >= 0 and res.rho.max() <= 0.9
    assert np.isfinite(res.x_adj).all() and res.x_adj.shape == (n, p)
    n_ran = int(res.ran_baseline_selection.any(axis=1).sum())
    assert n_ran > 0, "no gene ran baseline selection"
    np.testing.assert_allclose(res2.rho, res.rho, rtol=0, atol=1e-6)
    compute = timings["init"] + timings["iterations"]
    emit("fit_wide", genes=n, samples=p, nmf_iter=NMF_ITER,
         degnorm_iter=DEGNORM_ITER, degnorm_iter_cut=False,
         bucket_widths=list(eng_cfg.bucket_widths),
         buckets=[[b.width, int(b.F.shape[0]), b.n_real]
                  for b in engine._buckets],
         upload_dtype=upload[0], launches=launches,
         trim_rounds=trim_rounds, trim_rounds_total=rounds_total,
         last_iteration=dict(genes_in_trim_loop=entered),
         wall_s=round(wall, 3), steady_wall_s=round(wall2, 3),
         timings={k: round(v, 4) for k, v in timings.items()},
         steady_timings={k: round(v, 4) for k, v in engine.timings.items()},
         gene_iter_per_s=round(n * DEGNORM_ITER / compute, 1),
         steady_gene_iter_per_s=round(n * DEGNORM_ITER / wall2, 1),
         genes_ran_bs=n_ran, rho_mean=float(res.rho.mean()),
         peak_mem_bytes=peak_mem,
         profile=prof, late_round=late,
         per_launch_columns=["W", "round (0 = initial fit)", "active genes",
                             "blocks a gene", "threads", "device ms"],
         per_launch=per_launch)
    return launches, res, wall2


# states of kernel 4's late trim rounds kept by phase_fit_wide for the sweep
LATE_STATES = []


def sweep_times(run, configs, reps=2):
    """ms of ``run(config)`` for every config, timed in two passes, the
    second in reverse order, so that drift over the sweep shows as a spread
    between a config's two numbers."""
    first = [time_ms(lambda: run(c), reps) for c in configs]
    second = [time_ms(lambda: run(c), reps) for c in reversed(configs)][::-1]
    return [[list(c), round(a, 4), round(b, 4)]
            for c, a, b in zip(configs, first, second)]


COLS_SWEEP_NB = (1, 8, 33, 66, 132, 264, 430)


def sweep_colsharded(cov_wide):
    """Times only (correctness is phase ``seqpar``): kernel 4c over blocks a
    gene x threads, on two column shards of the card, at the outlier (one
    gene of OUTLIER_LEN bases), a TTN-like bucket as the engine packs it (one
    gene of TTN_LENGTHS[1] bases in 64 slots, the group told of one gene)
    and the long tail's W=65536 bucket, each line beside the choice of
    ``pick_cols_geometry``."""
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.data.buckets import pack_buckets
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream
    from degnorm_tpu_torch.ops.cuda_trim import run_steps
    from degnorm_tpu_torch.parallel import make_mesh
    from degnorm_tpu_torch.parallel.seqpar import ColumnGroup
    dev = torch.device(DEVICE, torch.cuda.current_device())
    mesh = make_mesh([dev] * MESH_SHARDS)
    nkw = baseline._nmf_kwargs(NMFConfig(nmf_iter=NMF_ITER), EngineConfig())

    def sweep(tag, raw, lm, genes, nbs):
        G, p, W = raw.shape
        group = ColumnGroup(mesh, W, genes=genes)
        cols = group.columns()
        shards = cut_columns(raw, lm, len(cols))
        kw = dict(nkw, scale=torch.linspace(0.8, 1.25, p, device=dev))
        rule = cuda_stream.pick_cols_geometry(genes, p, group.width)
        top = cuda_nmf.max_loop_threads(p)
        configs = sorted({(nb, t) for nb in nbs for t in (32, 64, 128, 256, 512)
                          if t <= top} | {rule})

        def run(c):
            return run_steps(cuda_stream.nmf_masked_colsharded_cuda(
                Fs, ms, cc, _geometry=c, **kw)
                for (Fs, ms), cc in zip(shards, cols))

        emit("sweep_colsharded", case=tag, shape=[G, p, W], shards=len(cols),
             genes=genes, rule=list(rule),
             columns=["(blocks a gene, threads)", "ms", "ms (reverse pass)"],
             times=sweep_times(run, configs))

    W = -(-OUTLIER_LEN // 128) * 128
    raw, lm = synth_wide_bucket([OUTLIER_LEN], P_SAMPLES, W, SEED + 9, dev)
    sweep("outlier", raw, lm, 1, COLS_SWEEP_NB)
    L = TTN_LENGTHS[1]
    raw, lm = synth_wide_bucket([L] + [0] * 63, P_SAMPLES, -(-L // 128) * 128,
                                SEED + 10, dev)
    sweep("TTN-like bucket of 64 slots", raw, lm, 1, COLS_SWEEP_NB)
    del raw, lm
    (b,) = [b for b in pack_buckets(list(cov_wide.values()),
                                    bucket_widths=EngineConfig().bucket_widths,
                                    dtype=np.int16)
            if b.width == WIDE_WIDTHS[1]]
    sweep("long tail W=65536", torch.from_numpy(b.F).to(dev),
          torch.from_numpy(b.len_mask()).to(dev), b.n_real, (1, 2, 4))
    torch.cuda.empty_cache()


# the wide kernel 4's cluster sweep: (W, genes) of the long tail's two
# buckets (its W=65536 bucket cut to the genes that fit one card at p = 128)
WIDE_SWEEP_BUCKETS = ((16384, 256), (65536, 96))
WIDE_SWEEP_P = (48, 64, 128)


def sweep_wide_clusters():
    """Kernel 4's wide instances over blocks a gene (1, 2, 4, 8: the
    cluster rule's WIDE_BLOCK_COLS) at p = 48, 64 and 128 on buckets of the
    long tail's two widths, raw int16 + scale, every p the first p samples
    of one bucket made at p = 128; each line names the rule's choice."""
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream
    dev = torch.device(DEVICE)
    nkw = baseline._nmf_kwargs(NMFConfig(nmf_iter=NMF_ITER), EngineConfig())
    for W, G in WIDE_SWEEP_BUCKETS:
        raw_top, lm = small_wide_bucket(G, max(WIDE_SWEEP_P), W, SEED + W, dev)
        for p in WIDE_SWEEP_P:
            raw = raw_top[:, :p].contiguous()
            scale = torch.linspace(0.8, 1.25, p, device=dev)
            res = sweep_times(
                lambda c: cuda_stream.nmf_masked_streamed_cuda(
                    raw, lm, scale=scale, _geometry=c, **nkw),
                [(cl, cuda_nmf.WIDE_THREADS) for cl in cuda_stream.CLUSTERS])
            emit("sweep_wide_clusters", shape=[G, p, W],
                 rule=list(cuda_stream.pick_geometry(W, p)),
                 block_cols=cuda_stream.WIDE_BLOCK_COLS,
                 columns=["(blocks a gene, threads)", "ms",
                          "ms (reverse pass)"], times=res)
            del raw
        del raw_top, lm
        torch.cuda.empty_cache()


def phase_sweep(cov, cov_wide):
    """Times only (correctness is phase ``kernels``): kernel 4 over launch
    geometries (blocks a gene x threads) at the two whole wide buckets, the
    p=16 and p=32 shapes and two late trim rounds kept by ``fit_wide``;
    kernel 3 over threads a block and kernel 1 over its launches (a block a
    gene over threads, a warp a gene over warps a block) at the two whole
    narrow
    buckets; kernel 2 over blocks a gene and threads at all four buckets.
    Each line names the choice of the wrappers' rules beside the timings,
    so the rule can be read against the sweep."""
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.data.buckets import pack_buckets
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream, cuda_trim
    dev = torch.device(DEVICE)
    nmf_cfg = NMFConfig(nmf_iter=NMF_ITER)
    wide_cfg = EngineConfig()
    nkw = baseline._nmf_kwargs(nmf_cfg, wide_cfg)

    def geometries(p):
        top = cuda_nmf.max_loop_threads(p)
        return [(cl, t) for cl in cuda_stream.CLUSTERS
                for t in (128, 256, 512) if t <= top]

    def sweep_stream(tag, Fin, m, kw, n_active):
        G, p, W = Fin.shape
        res = sweep_times(
            lambda c: cuda_stream.nmf_masked_streamed_cuda(
                Fin, m, **dict(kw, _geometry=c)), geometries(p))
        emit("sweep_stream", case=tag, shape=[G, p, W], n_active=n_active,
             rule=list(cuda_stream.pick_geometry(W, p)),
             columns=["(blocks a gene, threads)", "ms", "ms (reverse pass)"],
             times=res)

    def sweep_ratio(tag, raw, lm):
        G, p, W = raw.shape
        kw = dict(power_iters=wide_cfg.power_iters_cold)
        res = sweep_times(
            lambda c: cuda_nmf.ratio_rowsums_cuda(raw, lm, _geometry=c, **kw),
            [(cl, t, kb) for cl in (1, 2, 4, 8) for t in (64, 128, 256)
             for kb in (0, 24, 48, 96)], reps=RATIO_REPS)
        emit("sweep_ratio", case=tag, shape=[G, p, W], input="raw int16",
             rule=list(cuda_nmf.pick_ratio_geometry(p, W, G)),
             columns=["(blocks a gene, threads, KB copied)", "ms",
                      "ms (reverse pass)"],
             times=res)

    sweep_wide_clusters()
    sweep_colsharded(cov_wide)
    for G, p, W in ((48, 32, 4096), (48, 16, 8192)):
        raw, lm = small_wide_bucket(G, p, W, SEED + p, dev)
        scale = torch.linspace(0.8, 1.25, p, device=dev)
        sweep_stream(f"p{p}", raw, lm, dict(nkw, scale=scale), G)
    buckets = pack_buckets(list(cov_wide.values()),
                           bucket_widths=wide_cfg.bucket_widths,
                           dtype=np.int16)
    for b in buckets:
        raw = torch.from_numpy(b.F).to(dev)
        lm = torch.from_numpy(b.len_mask()).to(dev)
        scale = torch.linspace(0.8, 1.25, raw.shape[1], device=dev)
        sweep_stream(f"whole bucket W={b.width}", raw, lm,
                     dict(nkw, scale=scale), raw.shape[0])
        sweep_ratio(f"whole bucket W={b.width}", raw, lm)
        del raw, lm
        torch.cuda.empty_cache()
    for Fin, m, kw in LATE_STATES:
        n_act = int(kw["gene_active"].sum())
        sweep_stream(f"late round W={Fin.shape[2]}", Fin, m, kw, n_act)

    eng_cfg = EngineConfig(bucket_widths=BUCKET_WIDTHS)
    plain_cfg = dataclasses.replace(eng_cfg, use_kernels=False)
    buckets = pack_buckets(list(cov.values()), bucket_widths=BUCKET_WIDTHS,
                           dtype=np.int16)
    for b in buckets:
        F_adj, lm, raw = kernel_inputs(b, dev)
        G, p, W = F_adj.shape
        sweep_ratio(f"whole bucket W={W}", raw, lm)
        ti = baseline.trim_inputs(F_adj, lm, nmf_cfg, plain_cfg)
        targs = (ti.Fm, ti.bin_id, ti.bin_count, ti.K0, ti.E0, ti.rho0, ti.u0,
                 ti.n_hi, ti.n_bins0, ti.active0)
        tkw = baseline.trim_kwargs(nmf_cfg, eng_cfg)
        act = ~ti.bailed
        choices = [t for t in (32, 64, 128, 256, 512) if W <= 64 * t]

        def run_trim(t):
            return cuda_trim.trim_loop_cuda(*targs, _threads=t[0], **tkw)

        emit("sweep_resident", kernel="trim_loop", shape=[G, p, W],
             rule=[cuda_nmf.pick_loop_threads(p, W)],
             columns=["(threads)", "ms", "ms (reverse pass)"],
             times=sweep_times(run_trim, [(t,) for t in choices]))

        # kernel 1: a block a gene over threads; a warp a gene over warps a
        # block
        def run_nmf(c):
            return cuda_nmf.nmf_masked_cuda(
                ti.Fm, ti.hi, gene_active=act, _geometry=c,
                **baseline._nmf_kwargs(nmf_cfg, eng_cfg))

        configs = [("block", t) for t in choices] + [
            ("warp", 32 * w) for w in (2, 4, 8)
            if p <= cuda_nmf.GENE_WARP_MAX_P]
        emit("sweep_resident", kernel="nmf_masked", shape=[G, p, W],
             rule=list(cuda_nmf.pick_nmf_geometry(p, W, G)),
             columns=["(launch, threads)", "ms", "ms (reverse pass)"],
             times=sweep_times(run_nmf, configs))
        del F_adj, lm, raw, ti, targs
        torch.cuda.empty_cache()


def compare_fits(name, a, b, secs, **extra):
    """Two fits of the same genes: ran_bs equal, rho atol 5e-3, x_adj rtol
    5e-3, each on at least 99% of genes (a trim decision that flips on a
    float32 near-tie moves that gene's DI by more than the tolerance)."""
    n = a.rho.shape[0]
    ran_same = (a.ran_baseline_selection == b.ran_baseline_selection).all(axis=1)
    rho_err = np.abs(a.rho - b.rho).max(axis=1)
    adj_err = np.abs(a.x_adj / b.x_adj - 1).max(axis=1)
    stats = dict(genes=n, ran_bs_equal=int(ran_same.sum()),
                 rho_within_5e3=int((rho_err <= 5e-3).sum()),
                 x_adj_within_5e3=int((adj_err <= 5e-3).sum()),
                 rho_err_max=float(rho_err.max()),
                 rho_err_median=float(np.median(rho_err)),
                 x_adj_rel_err_max=float(adj_err.max()),
                 genes_ran_bs=int(a.ran_baseline_selection.any(axis=1).sum()),
                 seconds=[round(t, 2) for t in secs], **extra)
    emit(name, **stats)
    for key in ("ran_bs_equal", "rho_within_5e3", "x_adj_within_5e3"):
        if stats[key] < 0.99 * n:
            raise AssertionError(f"{name}: {key} = {stats[key]} of {n}")


def phase_parity(cov, X, cov_wide, X_wide):
    """Pairs of fits on the card, each held to ``compare_fits``:
    (narrow) the first PARITY_GENES genes, kernels on against
    use_kernels=False; (wide) 128 long genes of both wide widths, the same
    pair, so the streamed kernel in the unfused loop against the plain loop;
    (unfused) the narrow genes with fuse_trim=False and the kernels on (the
    resident NMF kernel once per round of the same Python loop) against the
    fused fit."""
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.engine import DegNormEngine
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream, cuda_trim
    nmf_cfg = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=DEGNORM_ITER)

    def fit(sub, Xs, **eng_kw):
        t0 = time.perf_counter()
        res = DegNormEngine(nmf_cfg, EngineConfig(**eng_kw)).run(sub, Xs)
        return res, time.perf_counter() - t0

    genes = list(cov.keys())[:PARITY_GENES]
    sub = OrderedDict((g, cov[g]) for g in genes)
    Xs = X[:PARITY_GENES]
    fused, t_fused = fit(sub, Xs, bucket_widths=BUCKET_WIDTHS)
    plain, t_plain = fit(sub, Xs, bucket_widths=BUCKET_WIDTHS,
                         use_kernels=False)
    compare_fits("parity", fused, plain, (t_fused, t_plain),
                 pair="kernels on (fused) vs use_kernels=False")

    before = (cuda_nmf.nmf_launches, cuda_trim.trim_launches)
    unfused, t_unfused = fit(sub, Xs, bucket_widths=BUCKET_WIDTHS,
                             fuse_trim=False)
    nmf_per_round = cuda_nmf.nmf_launches - before[0]
    if cuda_trim.trim_launches != before[1] or nmf_per_round < 1:
        raise AssertionError("fuse_trim=False reached the fused kernel or "
                             "launched no NMF kernel")
    compare_fits("parity_unfused", unfused, fused, (t_unfused, t_fused),
                 pair="fuse_trim=False (kernels on) vs fused",
                 nmf_masked_launches=nmf_per_round)

    names = list(cov_wide.keys())
    short = [i for i, g in enumerate(names)
             if cov_wide[g].shape[1] <= WIDE_WIDTHS[0]][:PARITY_WIDE_GENES[0]]
    long_ = [i for i, g in enumerate(names)
             if cov_wide[g].shape[1] > WIDE_WIDTHS[0]][:PARITY_WIDE_GENES[1]]
    pick = sorted(short + long_)
    sub = OrderedDict((names[i], cov_wide[names[i]]) for i in pick)
    Xs = X_wide[pick]
    before = cuda_stream.stream_launches
    on, t_on = fit(sub, Xs)
    streamed = cuda_stream.stream_launches - before
    off, t_off = fit(sub, Xs, use_kernels=False)
    if streamed < 1:
        raise AssertionError("wide parity fit launched no streamed kernel")
    compare_fits("parity_wide", on, off, (t_on, t_off),
                 pair="kernels on (streamed, unfused) vs use_kernels=False",
                 widths=[len(short), len(long_)],
                 nmf_streamed_launches=streamed)


# phase modes: the opt-in modes on the narrow workload
MODES = (("trim_fast", dict(trim_fast=True)), ("nmf_tol", dict(nmf_tol=MODE_TOL)))
MODES_PARITY_GENES = 1024      # cut from 2,048 for the time limit
EIGH_GENES = 1024
KEYED_GENES = 1024
KEYED_RATE = 3


def branch_launches():
    """Launch counts of every kernel and of each opt-in branch."""
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream, cuda_trim
    return {"nmf_masked": cuda_nmf.nmf_launches,
            "ratio_rowsums": cuda_nmf.ratio_launches,
            "trim_loop": cuda_trim.trim_launches,
            "nmf_streamed": cuda_stream.stream_launches,
            "nmf_colsharded": cuda_stream.colsharded_launches,
            "ratio_colsharded": cuda_nmf.ratio_cols_launches,
            "nmf_colsharded[nmf_tol]": cuda_stream.colsharded_tol_launches,
            "nmf_masked[nmf_tol]": cuda_nmf.nmf_tol_launches,
            "trim_loop[trim_fast]": cuda_trim.trim_fast_launches,
            "trim_loop[nmf_tol]": cuda_trim.trim_tol_launches,
            **wide_launches(), **wide_launches("panel")}


def wide_launches(tag="wide"):
    """Launch counts of the wide instances (33 <= p <= 128), or with
    ``tag="panel"`` of the panel instances (p > 128), by instance."""
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream, cuda_trim
    return {f"nmf_masked[{tag}]": getattr(cuda_nmf, f"nmf_{tag}_launches"),
            f"nmf_masked[{tag},nmf_tol]": getattr(
                cuda_nmf, f"nmf_{tag}_tol_launches"),
            f"ratio_rowsums[{tag}]": getattr(cuda_nmf,
                                             f"ratio_{tag}_launches"),
            f"trim_loop[{tag}]": getattr(cuda_trim, f"trim_{tag}_launches"),
            f"trim_loop[{tag},trim_fast]": getattr(
                cuda_trim, f"trim_{tag}_fast_launches"),
            f"trim_loop[{tag},nmf_tol]": getattr(
                cuda_trim, f"trim_{tag}_tol_launches"),
            f"nmf_streamed[{tag}]": getattr(cuda_stream,
                                            f"stream_{tag}_launches"),
            **({"nmf_masked[panel,phase]": cuda_nmf.nmf_panel_phase_launches,
                "ratio_rowsums[panel,cluster]":
                cuda_nmf.ratio_panel_cluster_launches,
                "nmf_streamed[panel,cluster]":
                cuda_stream.stream_panel_cluster_launches,
                "ratio_rowsums[panel,phase]":
                cuda_nmf.ratio_panel_phase_launches,
                "nmf_streamed[panel,phase]":
                cuda_stream.stream_panel_phase_launches,
                "trim_loop[panel,phase]": cuda_trim.trim_panel_phase_launches}
               if tag == "panel" else {
                   "nmf_colsharded[wide]": cuda_stream.colsharded_wide_launches,
                   "ratio_colsharded[wide]":
                   cuda_nmf.ratio_cols_wide_launches})}


def zero_launches():
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream, cuda_trim
    cuda_nmf.nmf_launches = cuda_nmf.nmf_tol_launches = 0
    cuda_nmf.ratio_launches = cuda_stream.stream_launches = 0
    cuda_trim.trim_launches = cuda_trim.trim_fast_launches = 0
    cuda_trim.trim_tol_launches = 0
    cuda_stream.colsharded_launches = cuda_nmf.ratio_cols_launches = 0
    cuda_stream.colsharded_tol_launches = 0
    cuda_nmf.nmf_wide_launches = cuda_nmf.nmf_wide_tol_launches = 0
    cuda_nmf.ratio_wide_launches = cuda_stream.stream_wide_launches = 0
    cuda_trim.trim_wide_launches = cuda_trim.trim_wide_fast_launches = 0
    cuda_trim.trim_wide_tol_launches = 0
    cuda_nmf.nmf_panel_launches = cuda_nmf.nmf_panel_tol_launches = 0
    cuda_nmf.nmf_panel_phase_launches = 0
    cuda_nmf.ratio_panel_launches = cuda_stream.stream_panel_launches = 0
    cuda_nmf.ratio_panel_cluster_launches = 0
    cuda_stream.stream_panel_cluster_launches = 0
    cuda_nmf.ratio_panel_phase_launches = 0
    cuda_stream.stream_panel_phase_launches = 0
    cuda_trim.trim_panel_launches = cuda_trim.trim_panel_fast_launches = 0
    cuda_trim.trim_panel_tol_launches = cuda_trim.trim_panel_phase_launches = 0
    cuda_stream.colsharded_wide_launches = cuda_nmf.ratio_cols_wide_launches = 0


def drift(a, b):
    """DI drift of fit ``a`` from fit ``b`` of the same genes and the
    baseline-selection decisions that flip (PARITY.md §known deviations)."""
    d = np.abs(a.rho - b.rho)
    return dict(di_drift_max=float(d.max()), di_drift_mean=float(d.mean()),
                decision_flips=int((a.ran_baseline_selection
                                    != b.ran_baseline_selection).sum()),
                genes_with_flips=int((a.ran_baseline_selection
                                      != b.ran_baseline_selection)
                                     .any(axis=1).sum()))


def phase_modes(cov, X, base_fit, base_steady_s):
    """The opt-in modes through DegNormEngine.run.  Each of trim_fast and
    nmf_tol=1e-4 drives the narrow workload at full width on the kernels
    (counts set to 0 just before the fit, read just after: the mode's
    kernel branches must have launched), then a steady refit; its DI drift
    and decision flips against the default fit of phase ``fit`` are
    reported beside PARITY.md §known-deviations items 6 and 7 (not gated).
    Parity: a kernel fit and a use_kernels=False fit of the mode on the
    first MODES_PARITY_GENES genes (``compare_fits``).  Then
    rank1_method="eigh" on EIGH_GENES genes (the plain versions, no kernel
    launched; held against the default kernel fit of the same genes), and
    a keyed downsample_rate=3 fit on the kernels against its plain fit."""
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.engine import DegNormEngine
    nmf_cfg = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=DEGNORM_ITER)
    launches = {}
    out = {}
    genes = list(cov.keys())

    def subset(k):
        return OrderedDict((g, cov[g]) for g in genes[:k]), X[:k]

    def fit(data, Xs, nmf=nmf_cfg, **eng_kw):
        t0 = time.perf_counter()
        res = DegNormEngine(nmf, EngineConfig(bucket_widths=BUCKET_WIDTHS,
                                              **eng_kw)).run(data, Xs)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    for name, mode in MODES:
        engine = DegNormEngine(nmf_cfg, EngineConfig(bucket_widths=BUCKET_WIDTHS,
                                                     **mode))
        zero_launches()
        t0 = time.perf_counter()
        res = engine.run(cov, X)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = branch_launches()
        launches[name] = got
        branches = [b for b, (_, m, _, _) in BRANCHES.items() if m == mode]
        if any(got[b] < 1 for b in branches) or got["nmf_streamed"]:
            raise AssertionError(f"mode {name}: launches {got}")
        timings = dict(engine.timings)
        t0 = time.perf_counter()
        res2 = engine.run(cov, X, reuse_device_data=True)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        n, p = res.rho.shape
        assert (n, p) == (N_GENES, P_SAMPLES), res.rho.shape
        assert np.isfinite(res.rho).all() and np.isfinite(res.x_adj).all()
        assert res.ran_baseline_selection.any(), "no gene ran baseline selection"
        np.testing.assert_allclose(res2.rho, res.rho, rtol=0, atol=1e-6)
        compute = timings["init"] + timings["iterations"]
        rec = dict(wall_s=round(wall, 3), steady_wall_s=round(wall2, 4),
                   timings={k: round(v, 4) for k, v in timings.items()},
                   gene_iter_per_s=round(n * DEGNORM_ITER / compute, 1),
                   steady_gene_iter_per_s=round(n * DEGNORM_ITER / wall2, 1),
                   trim_rounds=engine.trim_rounds, launches=got)
        if base_fit is not None:
            rec.update(drift(res, base_fit),
                       default_steady_wall_s=round(base_steady_s, 4),
                       default_steady_gene_iter_per_s=round(
                           n * DEGNORM_ITER / base_steady_s, 1))
        out[name] = rec
        del engine, res, res2
        torch.cuda.empty_cache()
        sub, Xs = subset(MODES_PARITY_GENES)
        on, t_on = fit(sub, Xs, **mode)
        off, t_off = fit(sub, Xs, use_kernels=False, **mode)
        compare_fits(f"modes_parity_{name}", on, off, (t_on, t_off),
                     pair=f"{name}: kernels on vs use_kernels=False")
    # eigh: every fit through the plain versions, no kernel launched
    sub, Xs = subset(EIGH_GENES)
    zero_launches()
    eigh, t_eigh = fit(sub, Xs, rank1_method="eigh")
    if any(branch_launches().values()):
        raise AssertionError(f"eigh launched kernels: {branch_launches()}")
    power, t_power = fit(sub, Xs)
    assert np.isfinite(eigh.rho).all() and np.isfinite(eigh.x_adj).all()
    compare_fits("modes_eigh", eigh, power, (t_eigh, t_power),
                 pair="rank1_method=eigh (plain versions) vs power (kernels)")
    # keyed downsample offsets, on the kernels and plain
    sub, Xs = subset(KEYED_GENES)
    ds_cfg = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=DEGNORM_ITER,
                       downsample_rate=KEYED_RATE)
    assert ds_cfg.ds_compat == "keyed"
    on, t_on = fit(sub, Xs, nmf=ds_cfg)
    off, t_off = fit(sub, Xs, nmf=ds_cfg, use_kernels=False)
    compare_fits("modes_keyed_downsample", on, off, (t_on, t_off),
                 pair=f"keyed downsample_rate={KEYED_RATE}: kernels on vs "
                      "use_kernels=False")
    emit("modes", genes=N_GENES, samples=P_SAMPLES, nmf_iter=NMF_ITER,
         degnorm_iter=DEGNORM_ITER, nmf_tol=MODE_TOL, modes=out,
         known_deviations="PARITY.md: trim_fast DI drift <= 0.02 max, 5e-4 "
                          "mean; nmf_tol 1e-4 zero decision flips",
         smi=smi_line())
    return launches


# phase oracle: the port's engine on the card against its float64 oracle
ORACLE_SYNTH_GENES = 8      # (ARPACK on the host: about a second a gene)
ORACLE_SYNTH_ITER = 2       # DegNorm iterations: keeps ARPACK under a minute
GOLDEN = os.path.join(REPO, "tests", "data", "golden_nmfoa.npz")


def golden_dataset():
    """The golden corpus (this script's copy of tools/make_golden.py's
    generator, checked against the fixture's read counts): 24 genes x 4."""
    rng = np.random.default_rng(20260817)
    cov = OrderedDict()
    lengths = rng.integers(250, 1800, 24)
    for i in range(24):
        L = int(lengths[i])
        t = np.linspace(0, 1, L)
        base = np.abs(np.sin(np.pi * t) + 0.2) * (3 + 10 * rng.random())
        rows = []
        for j in range(4):
            row = (0.5 + rng.random() * 1.5) * base
            if (i + j) % 2 == 1:
                row = row * np.exp(-2.5 * (1 - t) * rng.random())
            rows.append(np.round(np.maximum(row, 0.0) * 15))
        cov[f"g{i:03d}"] = np.vstack(rows).astype(np.float64)
    X = np.round(np.abs(rng.standard_normal((24, 4))) * 250 + 40)
    return cov, X


def phase_oracle():
    """The port's engine on the card (kernels on, default EngineConfig)
    against the port's float64 oracle (oracle/nmfoa.py, ARPACK on the
    host): on the golden corpus, gated at tests/test_golden.py's tolerance
    (ran_baseline_selection equal, rho rtol 3e-4 / atol 3e-6, adjusted
    counts rtol 3e-4), and on ORACLE_SYNTH_GENES genes x 8 of the narrow
    generator at ORACLE_SYNTH_ITER DegNorm iterations, held to
    ``compare_fits``.  The engine's kernels compute in float32."""
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.engine import DegNormEngine
    from degnorm_tpu_torch.oracle.nmfoa import degnorm_fit
    g = np.load(GOLDEN)
    cov, X = golden_dataset()
    np.testing.assert_array_equal(X, g["x"])
    cfg = NMFConfig(nmf_iter=int(g["nmf_iter"]), degnorm_iter=int(g["degnorm_iter"]))
    zero_launches()
    t0 = time.perf_counter()
    card = DegNormEngine(cfg, EngineConfig()).run(cov, X)
    t_card = time.perf_counter() - t0
    if not all(v > 0 for k, v in branch_launches().items()
               if k in ("nmf_masked", "ratio_rowsums", "trim_loop")):
        raise AssertionError(f"oracle phase: launches {branch_launches()}")
    t0 = time.perf_counter()
    host = degnorm_fit(list(cov.values()), X, cfg)
    t_host = time.perf_counter() - t0
    rho_err = np.abs(card.rho - host.rho)
    adj_rel = np.abs(card.x_adj / host.x_adj - 1)
    golden = dict(
        genes=len(cov), samples=4, nmf_iter=cfg.nmf_iter,
        degnorm_iter=cfg.degnorm_iter, engine_s=round(t_card, 3),
        oracle_s=round(t_host, 3),
        ran_bs_equal=bool((card.ran_baseline_selection
                           == host.ran_baseline_selection).all()),
        rho_err_max=float(rho_err.max()),
        rho_err_over_tolerance=float((rho_err / (3e-6 + 3e-4 * np.abs(
            host.rho))).max()),
        x_adj_rel_err_max=float(adj_rel.max()),
        oracle_vs_fixture_rho_err_max=float(np.abs(host.rho - g["rho"]).max()),
        engine_vs_fixture_rho_err_max=float(np.abs(card.rho - g["rho"]).max()))
    emit("oracle_golden", **golden,
         tolerance="tests/test_golden.py:65-66: ran_bs equal, rho rtol 3e-4 "
                   "atol 3e-6, x_adj rtol 3e-4")
    np.testing.assert_array_equal(card.ran_baseline_selection,
                                  host.ran_baseline_selection)
    np.testing.assert_allclose(card.rho, host.rho, rtol=3e-4, atol=3e-6)
    np.testing.assert_allclose(card.x_adj, host.x_adj, rtol=3e-4)
    cov2, X2 = synth_dataset(ORACLE_SYNTH_GENES, P_SAMPLES, seed=SEED + 2)
    cfg2 = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=ORACLE_SYNTH_ITER)
    t0 = time.perf_counter()
    card2 = DegNormEngine(cfg2, EngineConfig()).run(cov2, X2)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    host2 = degnorm_fit(list(cov2.values()), X2, cfg2)
    t_host = time.perf_counter() - t0
    compare_fits("oracle_synth", card2, host2, (t_card, t_host),
                 pair="engine on the card (kernels, float32) vs float64 "
                      "oracle on the host",
                 nmf_iter=NMF_ITER, degnorm_iter=ORACLE_SYNTH_ITER,
                 rho_err_over_golden_tolerance=float(
                     (np.abs(card2.rho - host2.rho)
                      / (3e-6 + 3e-4 * np.abs(host2.rho))).max()))


def _one_run_dir(base):
    runs = [d for d in os.listdir(base) if d.startswith("degnorm_")]
    if len(runs) != 1:
        raise AssertionError(f"{base}: expected one run directory, got {runs}")
    return os.path.join(base, runs[0])


def _report_libraries():
    """(True, "") where the report's libraries import, else (False, why)."""
    import importlib.util
    missing = [m for m in ("matplotlib", "seaborn", "jinja2")
               if importlib.util.find_spec(m) is None]
    return (not missing, "missing: " + ", ".join(missing) if missing else "")


def _check_run_dir(run, chroms, n_samples, degnorm_iter, expect_device):
    """The output contract of one run directory; returns (DI frame, log
    text, timings from the log, report reason or "")."""
    import ast
    import pandas as pd
    for name in ("degradation_index_scores.csv", "adjusted_read_counts.csv",
                 "ran_baseline_selection.csv", "read_counts.csv",
                 "gene_exon_metadata.csv", "degnorm.log",
                 "degnorm_checkpoint.npz"):
        if not os.path.isfile(os.path.join(run, name)):
            raise AssertionError(f"{run}: {name} missing")
    for c in chroms:
        for prefix in ("coverage_matrices", "estimated_coverage_matrices"):
            f = os.path.join(run, c, f"{prefix}_{c}.pkl")
            if not os.path.isfile(f):
                raise AssertionError(f"{f} missing")
    with np.load(os.path.join(run, "degnorm_checkpoint.npz"),
                 allow_pickle=True) as z:
        if int(z["iteration"]) != degnorm_iter - 1:
            raise AssertionError(f"checkpoint at iteration {z['iteration']}")
    di = pd.read_csv(os.path.join(run, "degradation_index_scores.csv"),
                     float_precision="round_trip")
    vals = di.iloc[:, 2:].to_numpy()
    if vals.shape[1] != n_samples or not np.isfinite(vals).all() \
            or vals.min() < 0 or vals.max() > 0.9:
        raise AssertionError(f"{run}: DI out of [0, 0.9] or not finite")
    with open(os.path.join(run, "degnorm.log")) as f:
        log = f.read()
    if f"fit device: {expect_device}" not in log:
        raise AssertionError(f"{run}: the log does not name {expect_device}")
    line = [ln for ln in log.splitlines() if "pipeline phase timings" in ln]
    timings = ast.literal_eval(line[-1].split("(s): ", 1)[1])
    have, why = _report_libraries()
    report = os.path.isfile(os.path.join(run, "report",
                                         "degnorm_summary.html"))
    if have and not report:
        raise AssertionError(f"{run}: the report libraries exist, no report")
    if not have:
        failed = [ln for ln in log.splitlines()
                  if "report rendering failed" in ln]
        why = f"{why} ({failed[-1].split('---- ', 1)[-1]})" if failed else why
    return di, log, timings, ("" if report else why)


def write_simulated_samples(out_dir, seed=SEED):
    """The cold runs' input: PIPE_CHROMS chromosomes of PIPE_GENES_PER_CHROM
    genes (a .gtf) and one single-end sample a PIPE_DEGRADATION entry,
    written by the port's io/simulate.py twice: as a .bam (io/bam.py) and
    as a .cram of the same records (io/cram.py, rANS blocks; pure Python,
    so one process a sample, started as each sample's records are made).
    Returns (gtf, bams, crams, reads a sample, seconds until the last .cram
    was written)."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context
    from degnorm_tpu_torch.io import bam as bamio
    from degnorm_tpu_torch.io import cram as cramio
    from degnorm_tpu_torch.io.simulate import (make_genes, simulate_sample,
                                               write_gtf)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    by_chrom = OrderedDict()
    for c in range(PIPE_CHROMS):
        name = f"chr{c + 1}"
        by_chrom[name] = make_genes(rng, chrom=name,
                                    n_genes=PIPE_GENES_PER_CHROM,
                                    name_prefix=f"{name}.")
    lens = {c: g[-1].exons[-1][1] + 5000 for c, g in by_chrom.items()}
    gtf = os.path.join(out_dir, "sim.gtf")
    write_gtf(gtf, [g for genes in by_chrom.values() for g in genes])
    names, lengths = list(by_chrom), [lens[c] for c in by_chrom]
    bams, crams, n_reads, writes = [], [], [], []
    with ProcessPoolExecutor(len(PIPE_DEGRADATION),
                             mp_context=get_context("spawn")) as pool:
        for i, deg in enumerate(PIPE_DEGRADATION):
            rs = np.random.default_rng(seed + 100 + i)
            recs = []
            for tid, (c, genes) in enumerate(by_chrom.items()):
                recs += [(r[0], tid, *r[2:]) for r in simulate_sample(
                    rs, genes, lens[c],
                    mean_reads_per_gene=PIPE_READS_PER_GENE,
                    read_len=PIPE_READ_LEN, degradation=deg)]
            path = os.path.join(out_dir, f"sample{i}")
            writes.append(pool.submit(cramio.write_cram, path + ".cram",
                                      names, lengths, recs,
                                      compression="rans"))
            bamio.write_bam(path + ".bam", names, lengths, recs)
            bams.append(path + ".bam")
            crams.append(path + ".cram")
            n_reads.append(len(recs))
        for w in writes:
            w.result()
    return gtf, bams, crams, n_reads, time.perf_counter() - t0


def write_warm_dir(out_dir, cov_parts, X_parts, seed=SEED):
    """A run directory holding ``cov_parts`` (gene dicts) as a finished run
    leaves them, written with the port's outputs writers: one single-exon
    gene a matrix, the short and long genes interleaved over chromosomes in
    an order drawn from ``seed``, with their gene_exon_metadata.csv,
    read_counts.csv and per-chromosome coverage pickles."""
    import pandas as pd
    from degnorm_tpu_torch.pipeline import outputs
    mats, counts = [], []
    for cov, X in zip(cov_parts, X_parts):
        mats += list(cov.values())
        counts.append(np.asarray(X))
    counts = np.concatenate(counts).astype(np.int64)
    n, p = len(mats), mats[0].shape[0]
    order = np.random.default_rng(seed).permutation(n)
    genes = [f"w{i}" for i in range(n)]
    rows, cursor, gene_chrom = [], {}, {}
    for k, gi in enumerate(order):
        chrom = f"chr{1 + k % PIPE_CHROMS}"
        start = cursor.get(chrom, 1000)
        end = start + mats[gi].shape[1] - 1
        cursor[chrom] = end + 1000
        rows.append((chrom, start, end, genes[gi], start, end))
        gene_chrom[genes[gi]] = chrom
    exon_df = pd.DataFrame(rows, columns=["chr", "start", "end", "gene",
                                          "gene_start", "gene_end"])
    exon_df.to_csv(os.path.join(out_dir, "gene_exon_metadata.csv"),
                   index=False)
    sids = [f"s{j}" for j in range(p)]
    rc = pd.DataFrame(counts[order], columns=sids)
    rc.insert(0, "chr", exon_df.chr.values)
    rc.insert(0, "gene", exon_df.gene.values)
    rc.to_csv(os.path.join(out_dir, "read_counts.csv"), index=False)
    outputs.save_coverage_matrices(
        out_dir, gene_chrom,
        OrderedDict((genes[gi], mats[gi]) for gi in order))
    return n, p


def phase_pipeline(cov, X, cov_wide, X_wide, keep_cold=False):
    """The degnorm-tpu-torch command, three times.  Cold: ``python3 -m
    degnorm_tpu_torch`` in a subprocess with no --device (so on the card) on
    simulated .bam files and a .gtf: the ETL, the fit, the outputs and the
    report; then the same on .cram files of the same reads, whose output
    files must equal the .bam run's (the fit is deterministic) and whose
    log must show no slice declined by the vectorized CRAM decoder.  Warm:
    ``cli.main`` in this process on a warm-start directory of the narrow
    and the wide dataset (22,528 genes x 8), whose DI and adjusted counts
    must be bit-equal to a direct DegNormEngine.run of the same loaded
    genes, whose buckets must be byte-equal to a pack of the same genes on
    the numpy paths, and whose fit must launch all four kernels.  The
    default bucket widths give the warm fit narrow buckets that phase
    kernels does not see (W=256, 512, 2048): kernels 1-3 are held against
    their plain versions on each of them (``check_kernels_at``), and a fit
    of the first PIPE_PARITY_GENES warm genes against a use_kernels=False
    fit of them (``compare_fits``).
    The host library is built before the cold command, so that its etl
    timing holds the ETL alone.  Returns the warm command's launches and the
    cold .bam run (``keep_cold``: its inputs and run directory are left for
    phase ``multihost``, which removes them)."""
    import pickle
    import shutil
    import pandas as pd
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch import cli
    from degnorm_tpu_torch.engine import DegNormEngine
    from degnorm_tpu_torch.io.native.build import native_disabled
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream, cuda_trim
    from degnorm_tpu_torch.pipeline import run as prun
    from degnorm_tpu_torch.pipeline.warm_start import load_from_previous
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    os.makedirs(PIPE_DIR)
    device_flag = [] if DEVICE == "cuda" else ["--device", DEVICE]
    expect_device = "cuda:0" if DEVICE == "cuda" else DEVICE
    fit_flags = ["--nmf-iter", str(NMF_ITER), "--iter", str(DEGNORM_ITER)]
    try:
        # ---- cold: .bam + .gtf, then .cram + .gtf, through the console
        # entry point ----
        data_dir = os.path.join(PIPE_DIR, "data")
        os.makedirs(data_dir)
        gtf, bams, crams, n_reads, data_s = write_simulated_samples(data_dir)
        # the host library's g++ build first, where the command would run it
        # inside its ETL, so that the command's etl times the ETL alone
        from degnorm_tpu_torch.io.native import build as native_build
        built_before = os.path.isfile(os.path.join(native_build.BUILD_DIR,
                                                   native_build._so_name()))
        t0 = time.perf_counter()
        native_build.open_library(native_build.BUILD_DIR)
        host_build_s = time.perf_counter() - t0
        chroms = [f"chr{c + 1}" for c in range(PIPE_CHROMS)]

        def cold_command(kind, files):
            base = os.path.join(PIPE_DIR, f"cold_{kind}")
            os.makedirs(base)
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "degnorm_tpu_torch", "--bam-files",
                 *files, "-g", gtf, "-o", base, *fit_flags, "-p", "4",
                 *device_flag], cwd=REPO, capture_output=True, text=True,
                timeout=900)
            wall = time.perf_counter() - t0
            if r.returncode != 0:
                raise AssertionError(f"cold {kind} command rc={r.returncode}"
                                     f"\n{r.stdout[-3000:]}\n"
                                     f"{r.stderr[-3000:]}")
            run = _one_run_dir(base)
            di, log, timings, report_why = _check_run_dir(
                run, chroms, len(files), DEGNORM_ITER, expect_device)
            declined = [ln for ln in log.splitlines()
                        if "CRAM slices decoded record by record" in ln]
            return run, di, timings, report_why, wall, dict(
                input=kind, wall_s=round(wall, 3), etl_s=timings["etl"],
                etl_reads_per_s=round(sum(n_reads) / timings["etl"], 1),
                fit_s=timings["fit"],
                declined_slices=(int(declined[-1].rsplit(" ", 1)[1])
                                 if declined else None))

        cold_run, di, cold_timings, cold_report_why, cold_s, bam_rec = \
            cold_command("bam", bams)
        cram_run, _, _, _, _, cram_rec = cold_command("cram", crams)
        if cram_rec["declined_slices"] != 0:
            raise AssertionError("the vectorized CRAM decoder declined "
                                 f"{cram_rec['declined_slices']} slices of "
                                 "the writer's files")
        # the .cram run leaves the .bam run's outputs, bit for bit
        import filecmp
        for name in ("read_counts.csv", "gene_exon_metadata.csv",
                     "degradation_index_scores.csv",
                     "adjusted_read_counts.csv",
                     "ran_baseline_selection.csv"):
            if not filecmp.cmp(os.path.join(cold_run, name),
                               os.path.join(cram_run, name), shallow=False):
                raise AssertionError(f"cold .cram run's {name} differs "
                                     "from the .bam run's")
        cold_host_bytes = 0
        for c in chroms:
            for prefix in ("coverage_matrices", "estimated_coverage_matrices"):
                f = os.path.join(c, f"{prefix}_{c}.pkl")
                with open(os.path.join(cold_run, f), "rb") as a, \
                        open(os.path.join(cram_run, f), "rb") as b:
                    ma, mb = pickle.load(a), pickle.load(b)
                if list(ma) != list(mb) or not all(
                        np.array_equal(ma[g], mb[g]) for g in ma):
                    raise AssertionError(f"cold .cram run's {f} differs")
                if prefix == "coverage_matrices":
                    cold_host_bytes += sum(m.nbytes for m in ma.values())
        cold = dict(
            command="python3 -m degnorm_tpu_torch (no --device)",
            samples=len(bams), degradation=list(PIPE_DEGRADATION),
            chroms=PIPE_CHROMS, genes_annotated=PIPE_CHROMS
            * PIPE_GENES_PER_CHROM, genes_fit=int(len(di)),
            reads_per_sample=n_reads, read_len=PIPE_READ_LEN,
            data_write_s=round(data_s, 3), wall_s=round(cold_s, 3),
            timings=cold_timings,
            fit_share_of_wall=round(cold_timings["fit"] / cold_s, 4),
            host_library_build_s=round(host_build_s, 3),
            host_library_built_before=built_before,
            etl_reads_per_s=round(sum(n_reads) / cold_timings["etl"], 1),
            host_bytes_coverage=cold_host_bytes,
            report=not cold_report_why,
            **({"report_reason": cold_report_why} if cold_report_why
               else {}),
            di_mean=float(di.iloc[:, 2:].to_numpy().mean()),
            inputs=[bam_rec, cram_rec], cram_equals_bam=True)

        # ---- warm: both fits' genes through cli.main in this process ----
        warm_src = os.path.join(PIPE_DIR, "warm_src")
        os.makedirs(warm_src)
        t0 = time.perf_counter()
        n_warm, p_warm = write_warm_dir(warm_src, (cov, cov_wide),
                                        (X, X_wide))
        warm_write_s = time.perf_counter() - t0
        warm_base = os.path.join(PIPE_DIR, "warm")
        os.makedirs(warm_base)
        captured = {}
        original = prun.run_pipeline

        def capture(cfg, output_dir=None, **kw):
            captured.update(original(cfg, output_dir=output_dir, **kw))
            return captured

        prun.run_pipeline = capture
        # counts to 0 just before the command, read just after
        cuda_nmf.nmf_launches = cuda_nmf.ratio_launches = 0
        cuda_trim.trim_launches = cuda_stream.stream_launches = 0
        try:
            t0 = time.perf_counter()
            rc = cli.main(["-w", warm_src, "-o", warm_base, *fit_flags,
                           *device_flag])
            warm_s = time.perf_counter() - t0
        finally:
            prun.run_pipeline = original
        launches = dict(nmf_masked=cuda_nmf.nmf_launches,
                        ratio_rowsums=cuda_nmf.ratio_launches,
                        trim_loop=cuda_trim.trim_launches,
                        nmf_streamed=cuda_stream.stream_launches)
        if rc != 0:
            raise AssertionError(f"warm command rc={rc}")
        if DEVICE == "cuda" and min(launches.values()) < 1:
            raise AssertionError(f"warm command launches: {launches}")
        warm_run = _one_run_dir(warm_base)
        _, _, _, warm_report_why = _check_run_dir(
            warm_run, chroms, p_warm, DEGNORM_ITER, expect_device)
        res = captured["result"]
        # the same loaded genes, fitted directly
        direct_dir = os.path.join(PIPE_DIR, "direct")
        os.makedirs(direct_dir)
        loaded = load_from_previous(warm_src, direct_dir)
        counts = loaded["read_count_df"][loaded["sample_ids"]].values.astype(
            np.float64)
        t0 = time.perf_counter()
        direct = DegNormEngine(
            NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=DEGNORM_ITER),
            EngineConfig(device=DEVICE)).run(loaded["gene_cov_dict"], counts)
        direct_s = time.perf_counter() - t0
        if direct.genes != res.genes or len(res.genes) != n_warm:
            raise AssertionError("warm command and direct fit differ in genes")
        for what in ("rho", "x_adj", "ran_baseline_selection"):
            if not np.array_equal(getattr(res, what), getattr(direct, what)):
                raise AssertionError(f"warm command {what} is not bit-equal "
                                     "to the direct fit")
        # the native scan and pack made the numpy paths' buckets, byte for
        # byte (the same genes packed again under DEGNORM_TPU_TORCH_NO_NATIVE)
        if native_disabled():
            raise AssertionError("DEGNORM_TPU_TORCH_NO_NATIVE is set: the "
                                 "warm buckets were not packed natively")
        saved = os.environ.get("DEGNORM_TPU_TORCH_NO_NATIVE")
        os.environ["DEGNORM_TPU_TORCH_NO_NATIVE"] = "1"
        try:
            numpy_buckets, numpy_scan_s, numpy_pack_s = engine_buckets(
                list(loaded["gene_cov_dict"].values()),
                EngineConfig().bucket_widths)
        finally:
            if saved is None:
                del os.environ["DEGNORM_TPU_TORCH_NO_NATIVE"]
            else:
                os.environ["DEGNORM_TPU_TORCH_NO_NATIVE"] = saved
        packed = direct._engine._buckets
        if len(packed) != len(numpy_buckets) or not all(
                a.F.dtype == b.F.dtype == np.int16
                and a.F.tobytes() == b.F.tobytes()
                and np.array_equal(a.gene_indices, b.gene_indices)
                and np.array_equal(a.lengths, b.lengths)
                for a, b in zip(packed, numpy_buckets)):
            raise AssertionError("warm buckets differ from the numpy pack")
        del numpy_buckets
        # kernels 1-3 against their plain versions at the narrow buckets the
        # default widths give the command and phase kernels does not check
        bucket_checks = {}
        for b in direct._engine._buckets:
            if b.width in BUCKET_WIDTHS or not cuda_nmf.kernels_supported(
                    b.F.shape, torch.float32):
                continue
            F_adj, lm, raw = kernel_inputs(b, torch.device(DEVICE))
            r = check_kernels_at(F_adj, lm, NMFConfig(nmf_iter=NMF_ITER),
                                 EngineConfig(device=DEVICE), raw,
                                 timed=False)
            bucket_checks[b.width] = dict(
                {k: v["max_abs_err"] for k, v in r.items()},
                shape=list(F_adj.shape),
                trim_entered=r["trim_loop"]["entered"],
                trim_rounds_agree=r["trim_loop"]["rounds_agree"])
            del F_adj, lm, raw
        # ... and a kernels-on fit against the plain versions' fit, on the
        # warm genes' first PIPE_PARITY_GENES
        keys = list(loaded["gene_cov_dict"])[:PIPE_PARITY_GENES]
        sub = OrderedDict((k, loaded["gene_cov_dict"][k]) for k in keys)
        fits = {}
        for tag, on in (("on", True), ("off", False)):
            t0 = time.perf_counter()
            fits[tag] = DegNormEngine(
                NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=DEGNORM_ITER),
                EngineConfig(device=DEVICE, use_kernels=on)).run(
                    sub, counts[:len(keys)])
            fits[tag + "_s"] = time.perf_counter() - t0
        plain_s = fits["off_s"]
        compare_fits("pipeline_plain", fits["on"], fits["off"],
                     (fits["on_s"], plain_s),
                     pair=f"the warm genes' first {len(keys)}: kernels on "
                          "vs use_kernels=False")
        del fits, sub
        # the files hold the same bits
        saved = pd.read_csv(
            os.path.join(warm_run, "degradation_index_scores.csv"),
            float_precision="round_trip")
        if not np.array_equal(saved.iloc[:, 2:].to_numpy(), res.rho):
            raise AssertionError("degradation_index_scores.csv differs from "
                                 "the fit's DI")
        widths = sorted({b.width for b in direct._engine._buckets})
        warm = dict(
            command="degnorm_tpu_torch.cli.main(['-w', ...])",
            genes=n_warm, samples=p_warm, wall_s=round(warm_s, 3),
            warm_dir_write_s=round(warm_write_s, 3),
            timings={k: round(v, 4) for k, v in captured["timings"].items()},
            fit_share_of_wall=round(captured["timings"]["fit"] / warm_s, 4),
            host_bytes_coverage=int(sum(
                m.nbytes for m in loaded["gene_cov_dict"].values())),
            bucket_widths=widths, launches=launches,
            bit_equal_to_direct_fit=True, direct_fit_s=round(direct_s, 3),
            buckets_equal_numpy_pack=True,
            numpy_pack_scan_s=numpy_scan_s, numpy_pack_host_s=numpy_pack_s,
            plain_fit_s=round(plain_s, 3), parity_genes=PIPE_PARITY_GENES,
            kernels_vs_plain_at={str(k): v for k, v in bucket_checks.items()},
            report=not warm_report_why,
            **({"report_reason": warm_report_why} if warm_report_why
               else {}))
        del loaded, direct, res, captured
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        emit("pipeline", cold=cold, warm=warm, smi=smi_line())
        kept = dict(run=cold_run, bams=bams, gtf=gtf, wall_s=bam_rec["wall_s"],
                    fit_s=bam_rec["fit_s"], etl_s=bam_rec["etl_s"])
        return launches, kept
    finally:
        if keep_cold:
            for d in os.listdir(PIPE_DIR):
                if d not in ("data", "cold_bam"):
                    shutil.rmtree(os.path.join(PIPE_DIR, d),
                                  ignore_errors=True)
        else:
            shutil.rmtree(PIPE_DIR, ignore_errors=True)


def engine_buckets(mats, widths):
    """The buckets DegNormEngine packs of ``mats`` on this device at the
    default float32 (its own scan, pack and bucket cap), with its two host
    timings."""
    from degnorm_tpu_torch.config import EngineConfig
    from degnorm_tpu_torch.engine import DegNormEngine
    eng = DegNormEngine(eng_cfg=EngineConfig(device=DEVICE,
                                             bucket_widths=widths))
    eng._pack_host(mats)
    if any(b.F.dtype != np.int16 for b in eng._buckets):
        raise AssertionError("the packed workload is not int16")
    return (eng._buckets, eng.timings["pack_scan"],
            eng.timings["pack_host"])


def nib_encode(F, n_real):
    """The host library's 4-bit delta encoder (io/native/pack_kernel.cpp
    ``dn_nib_encode``) on one int16 (G, p, W) bucket, 4 threads: column 0,
    two clipped position deltas a byte (low nibble the even one), and the
    deltas outside [-8, 7] as (flat index, remainder) pairs.  The encoded
    upload's measurement only: the engine uploads int16 directly."""
    import ctypes
    from degnorm_tpu_torch.io.native.build import get_fn
    G, p, W = F.shape
    cap = max(1024, n_real * p * (W - 1) // 100)
    first = np.zeros((G, p), np.int16)
    nib = np.zeros((G, p, W // 2), np.uint8)
    exc_idx = np.empty(cap, np.int64)
    exc_val = np.empty(cap, np.int32)
    ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))  # noqa: E731
    n = int(get_fn("dn_nib_encode")(
        ptr(np.ascontiguousarray(F), ctypes.c_int16), n_real, p, W,
        ptr(first, ctypes.c_int16), ptr(nib, ctypes.c_uint8),
        ptr(exc_idx, ctypes.c_int64), ptr(exc_val, ctypes.c_int32), cap, 4))
    if n < 0:
        raise AssertionError("4-bit exceptions over 1% of the deltas")
    return first, nib, exc_idx[:n].copy(), exc_val[:n].copy()


def nib_decode(first, nib, exc_idx, exc_val, W):
    """The exact int16 (G, p, W) bucket from nib_encode's fields, on their
    device: unpack (arithmetic shifts of int8 sign-extend each nibble),
    add the exceptions, sum along positions in int32."""
    import torch
    G, p, nb = nib.shape
    full = torch.empty((G, p, W), dtype=torch.int32, device=nib.device)
    full[:, :, 0] = first
    d8 = torch.stack([(nib << 4).view(torch.int8) >> 4,
                      nib.view(torch.int8) >> 4], dim=-1).reshape(G, p, -1)
    full[:, :, 1:] = d8[:, :, :W - 1]
    full.view(-1).index_add_(0, exc_idx // (W - 1) * W + exc_idx % (W - 1)
                             + 1, exc_val)
    return torch.cumsum(full, dim=2, dtype=torch.int32).to(torch.int16)


def phase_upload(cov, cov_wide):
    """The encoded upload against the direct one (ROADMAP item 5b), on the
    int16 buckets of three fits: the narrow one, the long tail, and the
    warm command's (both, at the default widths).  Direct: each bucket
    through ``torch.from_numpy(F).to(device)``, as DegNormEngine._upload
    uploads it.  Encoded: the host library's 4-bit delta encoder
    (nib_encode, 4 threads), the encoded fields uploaded, then decoded on
    the card (nib_decode; CUDA events).  Forms in turns (direct, encoded,
    encoded, direct); the decoded tensor must be torch.equal to the direct
    upload.  The engine keeps the direct upload: encoding alone took
    longer than it in this phase's first run (PERF.md, PR 7).  Opt-in:
    runs only when ``--phases`` names it."""
    import torch
    from degnorm_tpu_torch.config import EngineConfig
    dev = torch.device(DEVICE)
    workloads = (
        ("narrow", list(cov.values()), BUCKET_WIDTHS),
        ("long_tail", list(cov_wide.values()), EngineConfig().bucket_widths),
        ("warm", list(cov.values()) + list(cov_wide.values()),
         EngineConfig().bucket_widths))
    out = {}
    for name, mats, widths in workloads:
        buckets, scan_s, pack_s = engine_buckets(mats, widths)

        def direct():
            t0 = time.perf_counter()
            ts = [torch.from_numpy(b.F).to(dev) for b in buckets]
            torch.cuda.synchronize()
            return ts, time.perf_counter() - t0

        def encoded():
            t0 = time.perf_counter()
            encs = [nib_encode(b.F, b.n_real) for b in buckets]
            enc_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            on_dev = [[torch.from_numpy(f).to(dev) for f in e] for e in encs]
            torch.cuda.synchronize()
            up_s = time.perf_counter() - t0
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            ts = [nib_decode(*e, b.width) for e, b in zip(on_dev, buckets)]
            stop.record()
            torch.cuda.synchronize()
            return ts, dict(
                bytes=sum(f.nbytes for e in encs for f in e),
                exceptions=sum(len(e[2]) for e in encs), encode_s=enc_s,
                upload_s=up_s, decode_ms=start.elapsed_time(stop))

        runs = {"direct": [], "encoded": []}
        ref = None
        for form in ("direct", "encoded", "encoded", "direct"):
            if form == "direct":
                ts, up_s = direct()
                runs["direct"].append(up_s)
                if ref is None:
                    ref = [t.cpu() for t in ts]
            else:
                ts, rec = encoded()
                runs["encoded"].append(rec)
                for t, r in zip(ts, ref):
                    if not torch.equal(t.cpu(), r):
                        raise AssertionError(
                            f"{name}: decoded upload differs from the "
                            "direct upload")
            del ts
        del ref
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        enc = runs["encoded"]
        direct_s = min(runs["direct"])
        enc_s = min(r["encode_s"] + r["upload_s"] + r["decode_ms"] / 1e3
                    for r in enc)
        out[name] = dict(
            genes=len(mats), buckets=[[b.width, int(b.F.shape[0])]
                                      for b in buckets],
            pack_scan_s=scan_s, pack_host_s=pack_s,
            direct=dict(bytes=int(sum(b.F.nbytes for b in buckets)),
                        upload_s=runs["direct"]),
            encoded=dict(bytes=enc[0]["bytes"],
                         exceptions=enc[0]["exceptions"],
                         encode_s=[r["encode_s"] for r in enc],
                         upload_s=[r["upload_s"] for r in enc],
                         decode_ms=[r["decode_ms"] for r in enc]),
            direct_best_s=direct_s, encoded_best_s=enc_s,
            encoded_wins=enc_s < direct_s, decoded_equal=True)
        del buckets
    emit("upload", host_threads=os.cpu_count(), smi=smi_line(), **out)
    return out


# ---- phases mesh and multihost: the gene-sharded fit (parallel/) ----------

MESH_SHARDS = 2            # both on the card: the script needs one


def compare_or_gate(name, got, want, secs, **extra):
    """A sharded fit against the one-device fit of the same genes: DI,
    adjusted counts and baseline-selection flags bit-equal, else the max
    difference and the reason are printed and the pair is held to the
    parity gate (``compare_fits``).  Returns the bit-equality record."""
    same = {f: bool(np.array_equal(getattr(got, f), getattr(want, f)))
            for f in ("rho", "x_adj", "ran_baseline_selection")}
    if all(same.values()):
        return {"bit_equal": True}
    rec = {"bit_equal": False, "equal": same,
           "rho_max_abs_diff": float(np.abs(got.rho - want.rho).max()),
           "x_adj_max_rel_diff": float(np.abs(got.x_adj / want.x_adj
                                              - 1).max()),
           "reason": "a shard's kernel launches or reduction order differ "
                     "from the whole bucket's (float32 summation order)"}
    compare_fits(name + "_gate", got, want, secs, **extra, **rec)
    return rec


def batch_invariance(engine):
    """Which computations of a wide bucket step give a gene the same bits
    in a half-size batch: the first half of each of the one-device engine's
    buckets run alone, against its rows of the whole bucket, through kernel
    4, kernel 2 (with the whole bucket's gene count), the batched einsum of
    ``core/linalg.py::masked_rowsum`` (cuBLAS), and PyTorch's ``sum`` over
    the columns of a (G, p, W) and of a (G, W) tensor (the unfused loop's
    per-bin sums, ``ops/cuda_trim.py::_per_bin_sums``).  The measured
    reason when a sharded wide fit is not bit-equal."""
    import torch
    from degnorm_tpu_torch.core.linalg import masked_rowsum
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream
    out = []
    for F, m in zip(engine._device_F, engine._device_mask):
        G, p, W = F.shape
        h = G // 2
        Fh, mh = F[:h].contiguous(), m[:h].contiguous()
        ones = torch.ones(p, dtype=torch.float32, device=F.device)
        kw = dict(nmf_iter=NMF_ITER, power_iters_cold=128,
                  power_iters_warm=24, power_warm_plain=1, scale=ones)
        whole = cuda_stream.nmf_masked_streamed_cuda(F, m, **kw)
        half = cuda_stream.nmf_masked_streamed_cuda(Fh, mh, **kw)
        rec = {"bucket": [G, p, W], "half": h,
               "kernel4_K_E": all(torch.equal(a[:h], b)
                                  for a, b in zip(whole[:2], half[:2]))}
        whole = cuda_nmf.ratio_rowsums_cuda(F, m, bucket_genes=G)
        half = cuda_nmf.ratio_rowsums_cuda(Fh, mh, bucket_genes=G)
        rec["kernel2"] = all(torch.equal(a[:h], b)
                             for a, b in zip(whole, half))
        Ff, mf = F.float(), m.float()
        rec["einsum_masked_rowsum"] = torch.equal(
            masked_rowsum(Ff, mf)[:h], masked_rowsum(Ff[:h], mf[:h]))
        rec["sum_gpw_over_w"] = torch.equal(
            (Ff * mf[:, None, :]).sum(dim=2)[:h],
            (Ff[:h] * mf[:h, None, :]).sum(dim=2))
        col = Ff.amax(dim=1) * mf
        rec["sum_gw_over_w"] = torch.equal(col.sum(dim=1)[:h],
                                           col[:h].sum(dim=1))
        out.append(rec)
        del Ff, mf, col, whole, half
    return out


def phase_mesh(cov, X, cov_wide, X_wide, fits):
    """The sharded engine in one process on ``make_mesh([cuda:0] *
    MESH_SHARDS)``.  The narrow workload, gene-sharded (counts to 0 just
    before the fit, read just after: every kernel launched once a shard,
    twice the one-device count), held bit-equal to phase ``fit``'s
    (``compare_or_gate``), a steady refit timed beside the one-device one,
    the gather seconds and the peak memory; the long tail, whose W=65536
    bucket is column-sharded (``long_tail_mesh_fit``), held to the parity
    gate of phase ``fit_wide``'s with its difference printed; then
    ``dryrun_multichip(2)`` (its outlier column-sharded) on the card.
    Returns the long tail's record for phase ``seqpar``."""
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.engine import DegNormEngine
    from degnorm_tpu_torch.parallel import make_mesh
    from degnorm_tpu_torch.parallel.dryrun import dryrun_multichip
    dev = torch.device(DEVICE, torch.cuda.current_device()) \
        if DEVICE == "cuda" else torch.device(DEVICE)
    mesh = make_mesh([dev] * MESH_SHARDS)
    nmf_cfg = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=DEGNORM_ITER)
    out = {}
    for name, c, x, widths in (("narrow", cov, X, BUCKET_WIDTHS),):
        one, one_steady_s, one_launches = fits[name]
        eng_cfg = EngineConfig(bucket_widths=widths)
        engine = DegNormEngine(nmf_cfg, eng_cfg, mesh=mesh)
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        res = engine.run(c, x)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in branch_launches().items()
                    if "[" not in k}
        timings = dict(engine.timings)
        t0 = time.perf_counter()
        engine.run(c, x, reuse_device_data=True)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        steady = time.perf_counter() - t0
        n_shards = len(engine._shards)
        if n_shards != MESH_SHARDS * len(engine._buckets):
            raise AssertionError(f"mesh {name}: {n_shards} shards for "
                                 f"{len(engine._buckets)} buckets")
        for k in ("nmf_masked", "ratio_rowsums", "trim_loop"):
            if launches[k] != MESH_SHARDS * one_launches[k]:
                raise AssertionError(
                    f"mesh {name}: {k} launched {launches[k]} times, not "
                    f"{MESH_SHARDS} x {one_launches[k]} (one a shard)")
        unused = [k for k, v in launches.items()
                  if (v > 0) != (one_launches.get(k, 0) > 0)]
        if unused:
            raise AssertionError(f"mesh {name}: kernels {unused} launched "
                                 "on one path and not the other")
        check = compare_or_gate(f"mesh_{name}", res, one, (steady,
                                                           one_steady_s))
        if not check["bit_equal"] and DEVICE == "cuda":
            check["batch_invariant"] = batch_invariance(one._engine)
        n = res.rho.shape[0]
        out[name] = dict(
            genes=n, shards=MESH_SHARDS, devices=[str(d) for d in
                                                  mesh.devices],
            launches=launches, launches_one_device=one_launches,
            wall_s=round(wall, 4), steady_wall_s=round(steady, 4),
            one_device_steady_wall_s=round(one_steady_s, 4),
            steady_gene_iter_per_s=round(n * DEGNORM_ITER / steady, 1),
            one_device_steady_gene_iter_per_s=round(
                n * DEGNORM_ITER / one_steady_s, 1),
            steady_vs_one_device=round(steady / one_steady_s - 1, 4),
            gather_s=round(timings["gather"], 4),
            steady_gather_s=round(engine.timings["gather"], 4),
            timings={k: round(v, 4) for k, v in timings.items()},
            peak_mem_bytes=(int(torch.cuda.max_memory_allocated())
                            if DEVICE == "cuda" else None),
            **check)
        del engine, res
    one, one_steady_s, one_launches = fits["long_tail"]
    out["long_tail"] = long_tail_mesh_fit(cov_wide, X_wide, one,
                                          one_steady_s, one_launches)
    t0 = time.perf_counter()
    dry = dryrun_multichip(MESH_SHARDS, devices=[dev])
    dry["seconds"] = round(time.perf_counter() - t0, 3)
    emit("mesh", **out, dryrun_multichip=dry, smi=smi_line())
    return out["long_tail"]


def long_tail_mesh_fit(cov_wide, X_wide, one, one_steady_s, one_launches):
    """The long tail through ``DegNormEngine.run`` on ``make_mesh([cuda:0]
    * MESH_SHARDS)`` with the default config: its W=16384 bucket gene-
    sharded, its W=65536 bucket column-sharded (kernels 4c and 2c, a
    reduction across the shards at each reduction point).  Counts to 0 just
    before the fit, read just after: kernels 4 and 2 launched on the gene-
    sharded bucket alone (2 a shard), 4c and 2c on the column-sharded one
    (2c twice a shard), nothing resident.  Held to the parity gate of the
    one-device fit ``one`` (``compare_or_gate``: the difference printed);
    a steady refit, the reduce seconds and count, the peak memory."""
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.engine import DegNormEngine
    from degnorm_tpu_torch.parallel import make_mesh
    dev = torch.device(DEVICE, torch.cuda.current_device()) \
        if DEVICE == "cuda" else torch.device(DEVICE)
    mesh = make_mesh([dev] * MESH_SHARDS)
    nmf_cfg = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=DEGNORM_ITER)
    engine = DegNormEngine(nmf_cfg, EngineConfig(), mesh=mesh)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    res = engine.run(cov_wide, X_wide)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in branch_launches().items() if "[" not in k}
    timings = dict(engine.timings)
    reductions, gathers = engine.reductions, engine.gathers
    col = [b.width for b, g in zip(engine._buckets, engine._col_groups)
           if g is not None]
    gene = [b.width for b, g in zip(engine._buckets, engine._col_groups)
            if g is None]
    if col != [WIDE_WIDTHS[1]] or gene != [WIDE_WIDTHS[0]]:
        raise AssertionError(f"mesh long tail: column-sharded {col}, "
                             f"gene-sharded {gene}")
    want = dict(ratio_rowsums=MESH_SHARDS * len(gene),
                ratio_colsharded=2 * MESH_SHARDS, nmf_masked=0, trim_loop=0)
    bad = {k: launches[k] for k, v in want.items() if launches[k] != v}
    if DEVICE == "cuda" and (bad or not (
            launches["nmf_streamed"] >= MESH_SHARDS * DEGNORM_ITER
                   and launches["nmf_colsharded"]
                   >= MESH_SHARDS * DEGNORM_ITER * (NMF_ITER + 2))):
        raise AssertionError(f"mesh long tail: launches {launches}, "
                             f"expected {want}")
    t0 = time.perf_counter()
    engine.run(cov_wide, X_wide, reuse_device_data=True)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    check = compare_or_gate("mesh_long_tail", res, one, (steady, one_steady_s))
    n = res.rho.shape[0]
    rec = dict(
        genes=n, shards=MESH_SHARDS, devices=[str(d) for d in mesh.devices],
        column_sharded_widths=col, gene_sharded_widths=gene,
        launches=launches, launches_one_device=one_launches,
        wall_s=round(wall, 4), steady_wall_s=round(steady, 4),
        one_device_steady_wall_s=round(one_steady_s, 4),
        steady_gene_iter_per_s=round(n * DEGNORM_ITER / steady, 1),
        steady_vs_one_device=round(steady / one_steady_s - 1, 4),
        reductions=reductions, reduce_s=round(timings["reduce"], 4),
        steady_reduce_s=round(engine.timings["reduce"], 4),
        gathers=gathers, gram_gather_s=round(timings["gram_gather"], 4),
        gather_s=round(timings["gather"], 4),
        timings={k: round(v, 4) for k, v in timings.items()},
        peak_mem_bytes=(int(torch.cuda.max_memory_allocated())
                        if DEVICE == "cuda" else None),
        rho_max_abs_diff=float(np.abs(res.rho - one.rho).max()),
        x_adj_max_rel_diff=float(np.abs(res.x_adj / one.x_adj - 1).max()))
    rec.update(check)
    del engine, res
    return rec


# phase seqpar: kernels 4c and 2c at the long tail's W=65536 bucket cut in
# two at these p, and at one outlier gene; three TTN-like genes (the longest
# human exonic lengths) fitted column-sharded and gene-sharded
SEQPAR_P = (3, 8, 16, 32)
OUTLIER_LEN = 110_000
TTN_GENES = 3
TTN_LENGTHS = (100_000, 120_000)
# kernels 4c and 2c's wide instances (csrc/stream_cols_wide.cuh): every
# PMAX on COLS_WIDE_GENES genes x p x COLS_WIDE_W (one dataset made at the
# largest p), and the TTN-like genes at TTN_WIDE_P samples (their fits at
# TTN_WIDE_ITER DegNorm iterations, cut from 5)
COLS_WIDE_P = (33, 48, 64, 96, 128)
COLS_WIDE_GENES = 64
COLS_WIDE_W = 65536
TTN_WIDE_P = 128
TTN_WIDE_ITER = 1
# ... and at the edges of their layout at every PMAX, on COLS_EDGE_GENES
# genes x p x COLS_EDGE_W cut at COLS_EDGE_CUT: a shard of odd width (rows
# not 16-byte aligned, which the producer warp loads itself) beside one
# whose rows are, and half the genes with no active column on the second
COLS_EDGE_P = (41, 64, 96, 128)
# ... and timed at COLS_ODD_P on COLS_WIDE_GENES x p x COLS_WIDE_W cut into
# shards of odd widths, beside the engine's cut (multiples of CHUNK)
COLS_ODD_P = (48, 128)
COLS_EDGE_GENES = 16
COLS_EDGE_W = 20001
COLS_EDGE_CUT = 10001


def cut_columns(raw, lm, n):
    """A (G, p, W) device bucket cut along its columns as the engine cuts it
    (``parallel/seqpar.py::column_slots``): ``n`` (coverage, mask) shards,
    padded to one width and masked off past W."""
    from degnorm_tpu_torch.parallel.seqpar import column_slots
    G, p, W = raw.shape
    slots, width = column_slots(W, n)
    out = []
    for a, b in slots:
        Fs = raw.new_zeros((G, p, width))
        ms = lm.new_zeros((G, width))
        Fs[:, :, :b - a] = raw[:, :, a:b]
        ms[:, :b - a] = lm[:, a:b]
        out.append((Fs, ms))
    return out


def synth_wide_bucket(lengths, p, W, seed, device):
    """An int16 (G, p, W) coverage bucket made on the card from ``seed``
    (a smooth envelope, a degradation ramp and noise a sample) and its
    length mask, for genes of ``lengths``."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    G = len(lengths)
    t = torch.linspace(0, 1, W, device=device)
    lm = (torch.arange(W, device=device)[None, :]
          < torch.as_tensor(lengths, device=device)[:, None])
    F = torch.empty((G, p, W), dtype=torch.int16, device=device)
    for i in range(G):                # a gene at a time: small temporaries
        amp = torch.rand((p, 1), generator=g, device=device) * 40 + 5
        ramp = torch.exp(-2 * (1 - t)[None, :]
                         * torch.rand((p, 1), generator=g, device=device))
        noise = torch.rand((p, W), generator=g, device=device)
        v = amp * (torch.sin(torch.pi * t).abs() + 0.2) * ramp * (0.8 + 0.4 * noise)
        F[i] = (v.round() * lm[i]).to(torch.int16)
    return F, lm


# Times of kernels 4c and 2c a call before their redesign (one block a gene,
# the sum across the shards through PyTorch between launches), taken by this
# script on an NVIDIA H100 80GB HBM3 at 700 W; kept beside this run's in each
# record as `earlier_ms`
EARLIER_MS = {"p3": (14.382, 0.478), "p8": (22.663, 0.6784),
              "p16": (45.636, 1.5759), "p32": (95.465, 3.6461),
              "outlier": (13.548, 0.645)}
# ... and of their wide instances on their first design (a block's tiles
# staged in lockstep, the power step in every block), the same card and
# limit, the shapes of phase seqpar (none kept for 2c on the TTN-like genes)
EARLIER_MS.update({"wide33": (66.72, 1.68), "wide48": (69.51, 1.655),
                   "wide64": (98.07, 2.89), "wide96": (228.57, 4.24),
                   "wide128": (455.80, 12.93), "ttn128": (79.05, None)})


def host_us_a_sweep(run, sweeps):
    """Host microseconds a sweep of one call of ``run`` (its launches, the
    asks and their answers, no wait for the card), after the card is idle."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return round(secs / sweeps * 1e6, 2)


def check_colsharded_at(raw, lm, mesh, tag, genes, reps=2, tol_check=False,
                        i16_vs_f32=False, tol_tip=0, ref64=False, cut=None,
                        need_freeze=False, odd_cut=None):
    """Kernels 4c and 2c on a bucket of ``genes`` real genes (the rest of
    its slots padding, as the engine packs it) cut along its columns into
    one shard a ``mesh`` device (both on the card), each against its plain
    version on the same shards: 4c on the raw int16 + scale form with every
    7th slot from the 7th on inactive (zeros out), K, E, u within
    STREAM_RTOL of max(|value|, 1), K and u bit-equal on every shard (K =
    u s: so s too); 2c on the raw int16 upload, the row sums bit-equal on
    every shard and within STREAM_RTOL.  Each kernel runs
    twice and must give the same bits.  Beside them kernel 4 and kernel 2
    on the whole bucket.  Times: one column-sharded call over all shards
    (its launches and reductions, CUDA events) beside the time before the
    kernels' redesign (``EARLIER_MS[tag]``, None where there was no such
    time), the plain version's, the bound of the function on the whole
    bucket; launches, gather asks and reductions a call; the picked
    geometry (blocks a gene, threads); the host microseconds a sweep of a
    call and of the answers to its gather asks (``ColumnGroup.combine``).
    ``tol_check``: 4c's nmf_tol instances too, at FREEZE_TOL, against the
    plain adaptive loop on the same shards: K, E, u within 1e-4 of
    max(|value|, 1) on >= 99% of the genes (a gene whose freeze falls on
    another iteration in float32 differs more; ``tol_tip``: at least that
    many genes may, as check_nmf_phase_at allows max(2, 1%) of a bucket of
    a few dozen active genes); the genes the kernel froze (its outputs
    differ from those of the same instances at NEVER_TOL, which no gene
    meets) must be the plain loop's (found the same way), bar as many, and
    with ``need_freeze`` some gene must freeze.  ``i16_vs_f32``: 4c on
    the float32 coverage the engine's order gives (raw / scale) and 2c on
    the float32 cast of the raw coverage must give the raw int16 form's
    bits on every shard.  ``ref64``: 2c is held against its plain version
    in float64 (at 33-128 samples the float32 plain version's own est_sums
    drift up to 1.4e-5 from float64, over the 1e-5 the check holds, while
    the kernel's stay under 5e-7), the float32 plain version's gap to it
    recorded beside.  ``cut``: the two shards are columns [0, cut) and
    [cut, W) of the bucket as they are, of widths that need not be
    multiples of 8 (the wide instances' rows not 16-byte aligned), not
    ``cut_columns``'s.  Beside the bound, the floor of a launch a sweep
    (``floor_cols_sweeps``).  Launches and gather asks a call must be
    ``cuda_stream.cols_calls`` / ``ratio_cols_calls`` a shard.
    ``odd_cut``: both kernels timed also on the bucket cut at that column
    into two shards of odd widths (the wide instances' producer warp fills
    their stages by its own loads), beside ``ms``."""
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream
    from degnorm_tpu_torch.ops.cuda_trim import run_steps
    from degnorm_tpu_torch.parallel.seqpar import ColumnGroup
    G, p, W = raw.shape
    group = ColumnGroup(mesh, W, genes=genes)
    cols = group.columns()
    if cut is None:
        shards = cut_columns(raw, lm, len(cols))
    elif len(cols) == 2:
        shards = [(raw[:, :, :cut].contiguous(), lm[:, :cut].contiguous()),
                  (raw[:, :, cut:].contiguous(), lm[:, cut:].contiguous())]
    else:
        raise ValueError("check_colsharded_at: cut takes two shards")
    geometry = list(cuda_stream.pick_cols_geometry(genes, p,
                                                   shards[0][0].shape[2]))
    earlier = EARLIER_MS.get(tag, (None, None))
    scale = torch.linspace(0.8, 1.25, p, device=raw.device)
    act = torch.ones(G, dtype=torch.bool, device=raw.device)
    act[6::7] = False          # the first gene stays active (the outlier's)
    nmf_cfg = NMFConfig(nmf_iter=NMF_ITER)
    nkw = dict(baseline._nmf_kwargs(nmf_cfg, EngineConfig()),
               gene_active=act, scale=scale)
    power = EngineConfig().power_iters_cold

    def nmf(fn):
        return run_steps(fn(Fs, ms, c, **nkw)
                         for (Fs, ms), c in zip(shards, cols))

    def ratio(fn):
        return run_steps(fn(Fs, ms, c, power_iters=power)
                         for (Fs, ms), c in zip(shards, cols))

    def same_bits(a, b, what):
        for k, (x, y) in enumerate(zip(a, b)):
            if not all(torch.equal(u, v) for u, v in zip(x, y)):
                raise AssertionError(f"{what} p={p} W={W}: shard {k} gave "
                                     "other bits on a second run")

    l0, r0, q0 = (cuda_stream.colsharded_launches, group.reductions,
                  group.gathers)
    got = nmf(cuda_stream.nmf_masked_colsharded_cuda)
    launches, reductions, gathers = (cuda_stream.colsharded_launches - l0,
                                     group.reductions - r0,
                                     group.gathers - q0)
    calls = cuda_stream.cols_calls(p, NMF_ITER)
    if (launches, gathers) != (len(cols) * calls[0], calls[1]):
        raise AssertionError(f"nmf_colsharded p={p}: {launches} launches and "
                             f"{gathers} gathers, not {calls} a shard")
    same_bits(got, nmf(cuda_stream.nmf_masked_colsharded_cuda),
              "nmf_colsharded")
    if i16_vs_f32:
        fkw = {k: v for k, v in nkw.items() if k != "scale"}
        same_bits(got, run_steps(
            cuda_stream.nmf_masked_colsharded_cuda(
                Fs.to(torch.float32) / scale[None, :, None], ms, c, **fkw)
            for (Fs, ms), c in zip(shards, cols)), "nmf_colsharded[float32]")
    want = nmf(cuda_stream.nmf_masked_colsharded_plain)
    whole = cuda_stream.nmf_masked_streamed_cuda(raw, lm, **nkw)
    torch.cuda.synchronize()
    errs = []
    for k, (g_, w_) in enumerate(zip(got, want)):
        for a, b, nm in zip(g_, w_, "KEu"):
            errs.append(assert_rel(a, b, f"nmf_colsharded {nm} p={p} W={W} "
                                         f"shard {k}"))
            if bool((a[~act] != 0).any()):
                raise AssertionError(f"nmf_colsharded {nm}: inactive gene "
                                     "not zero")
        if not (torch.equal(g_[0], got[0][0]) and torch.equal(g_[2], got[0][2])):
            raise AssertionError(f"nmf_colsharded p={p} W={W}: K or u differ "
                                 f"between shards 0 and {k}")
    E = torch.cat([g_[1] for g_ in got], dim=1)[:, :W]
    vs4 = max(err_stats(a, b)[1] for a, b in zip((got[0][0], E, got[0][2]),
                                                 whole))
    del got, want, whole, E
    tol_rec = None
    if tol_check:
        tkw = dict(nkw, nmf_tol=FREEZE_TOL)
        l0 = cuda_stream.colsharded_tol_launches
        got = run_steps(cuda_stream.nmf_masked_colsharded_cuda(Fs, ms, c, **tkw)
                        for (Fs, ms), c in zip(shards, cols))
        tol_launches = cuda_stream.colsharded_tol_launches - l0
        same_bits(got, run_steps(
            cuda_stream.nmf_masked_colsharded_cuda(Fs, ms, c, **tkw)
            for (Fs, ms), c in zip(shards, cols)), "nmf_colsharded[nmf_tol]")
        want = run_steps(cuda_stream.nmf_masked_colsharded_plain(Fs, ms, c, **tkw)
                         for (Fs, ms), c in zip(shards, cols))
        torch.cuda.synchronize()
        bad = torch.zeros(G, dtype=torch.bool, device=raw.device)
        for g_, w_ in zip(got, want):
            for a, b in zip(g_, w_):
                r = ((a.double() - b.double()).abs()
                     / b.double().abs().clamp_min(1.0)).amax(dim=1)
                bad |= r > 1e-4
        n_act = int(act.sum())
        if int(bad.sum()) > max(tol_tip, 0.01 * n_act):
            raise AssertionError(f"nmf_colsharded[nmf_tol] p={p} W={W}: "
                                 f"{int(bad.sum())} of {n_act} genes differ")

        def froze(a, fn):
            # the genes whose outputs differ from a loop that freezes none
            b = run_steps(fn(Fs, ms, c, **dict(tkw, nmf_tol=NEVER_TOL))
                          for (Fs, ms), c in zip(shards, cols))
            out = torch.zeros(G, dtype=torch.bool, device=raw.device)
            for x, y in zip(a, b):
                for u, v in zip(x, y):
                    out |= (u != v).flatten(1).any(dim=1)
            return out
        fk = froze(got, cuda_stream.nmf_masked_colsharded_cuda)
        fp = froze(want, cuda_stream.nmf_masked_colsharded_plain)
        n_fk, n_diff = int(fk.sum()), int((fk ^ fp).sum())
        if (need_freeze and n_fk == 0) or n_diff > max(tol_tip,
                                                          0.01 * n_act):
            raise AssertionError(
                f"nmf_colsharded[nmf_tol] p={p} W={W}: {n_fk} genes froze "
                f"(the plain loop: {int(fp.sum())}), {n_diff} differ")
        tol_rec = dict(tol=FREEZE_TOL, launches_per_nmf=tol_launches,
                       genes_off=int(bad.sum()), active_genes=n_act,
                       genes_off_allowed=max(tol_tip, int(0.01 * n_act)),
                       frozen=n_fk, frozen_plain=int(fp.sum()),
                       frozen_differ=n_diff)
        del got, want
    b_ms, b_by = bound_stream(raw, lm, act, NMF_ITER)
    # the wide instances' Gram runs by 3xTF32 on the tensor cores
    b_tc = (bound_stream(raw, lm, act, NMF_ITER, tc=True)[0]
            if p > cuda_nmf.NARROW_MAX_P else None)
    floor = floor_cols_sweeps(raw, lm, act, NMF_ITER)
    s0, q0 = group.gather_seconds, group.gathers
    host4 = host_us_a_sweep(
        lambda: nmf(cuda_stream.nmf_masked_colsharded_cuda), NMF_ITER + 1)
    answer4 = round((group.gather_seconds - s0) / (group.gathers - q0) * 1e6,
                    2)
    rec4 = dict(
        shape=[G, p, W], shards=len(cols),
        shard_width=[int(Fs.shape[2]) for Fs, _ in shards],
        geometry=geometry, i16_bits_of_f32=i16_vs_f32 or None,
        launches_per_nmf=launches,
        gathers_per_nmf=gathers, reductions_per_nmf=reductions,
        max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
        kernel4_whole_rel_err=vs4, bound_ms=b_ms, bound_by=b_by,
        bound_tc_ms=b_tc, floor_ms=floor,
        ms=time_ms(lambda: nmf(cuda_stream.nmf_masked_colsharded_cuda), reps),
        earlier_ms=earlier[0], host_us_a_sweep=host4,
        host_us_an_answer=answer4,
        kernel4_whole_ms=time_ms(
            lambda: cuda_stream.nmf_masked_streamed_cuda(raw, lm, **nkw), reps),
        plain_ms=time_ms(lambda: nmf(cuda_stream.nmf_masked_colsharded_plain),
                         1, warm=False), nmf_tol=tol_rec)
    l0, r0, q0 = cuda_nmf.ratio_cols_launches, group.reductions, group.gathers
    got = ratio(cuda_nmf.ratio_rowsums_colsharded_cuda)
    launches, reductions, gathers = (cuda_nmf.ratio_cols_launches - l0,
                                     group.reductions - r0,
                                     group.gathers - q0)
    calls = cuda_stream.ratio_cols_calls(p)
    if (launches, gathers) != (len(cols) * calls[0], calls[1]):
        raise AssertionError(f"ratio_colsharded p={p}: {launches} launches "
                             f"and {gathers} gathers, not {calls} a shard")
    same_bits(got, ratio(cuda_nmf.ratio_rowsums_colsharded_cuda),
              "ratio_colsharded")
    if i16_vs_f32:
        same_bits(got, run_steps(
            cuda_nmf.ratio_rowsums_colsharded_cuda(
                Fs.to(torch.float32), ms, c, power_iters=power)
            for (Fs, ms), c in zip(shards, cols)), "ratio_colsharded[float32]")
    want = ratio(cuda_nmf.ratio_rowsums_colsharded_plain)
    plain32_err = None
    if ref64:
        want64 = run_steps(
            cuda_nmf.ratio_rowsums_colsharded_plain(
                Fs.to(torch.float64), ms, c, power_iters=power)
            for (Fs, ms), c in zip(shards, cols))
        plain32_err = max(err_stats(a, b)[1]
                          for a, b in zip(want[0], want64[0]))
        want = want64
    whole = cuda_nmf.ratio_rowsums_cuda(raw, lm, bucket_genes=G)
    torch.cuda.synchronize()
    errs = []
    for k, g_ in enumerate(got):
        if not all(torch.equal(a, b) for a, b in zip(g_, got[0])):
            raise AssertionError(f"ratio_colsharded p={p} W={W}: shards 0 "
                                 f"and {k} differ")
    for a, b, nm in zip(got[0], want[0], ("cov_sums", "est_sums")):
        errs.append(assert_rel(a, b, f"ratio_colsharded {nm} p={p} W={W}"))
    vs2 = max(err_stats(a, b)[1] for a, b in zip(got[0], whole))
    b2_ms, b2_by = bound_ratio(raw, lm)
    rec2 = dict(
        shape=[G, p, W], geometry=geometry, launches_per_init=launches,
        gathers_per_init=gathers, reductions_per_init=reductions,
        max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
        reference="plain float64" if ref64 else "plain float32",
        plain32_vs_64_rel_err=plain32_err,
        kernel2_whole_rel_err=vs2, bound_ms=b2_ms, bound_by=b2_by,
        ms=time_ms(lambda: ratio(cuda_nmf.ratio_rowsums_colsharded_cuda),
                   RATIO_REPS),
        earlier_ms=earlier[1],
        host_us_a_launch=host_us_a_sweep(
            lambda: ratio(cuda_nmf.ratio_rowsums_colsharded_cuda), 2),
        kernel2_whole_ms=time_ms(
            lambda: cuda_nmf.ratio_rowsums_cuda(raw, lm, bucket_genes=G),
            RATIO_REPS),
        plain_ms=time_ms(lambda: ratio(cuda_nmf.ratio_rowsums_colsharded_plain),
                         1, warm=False))
    if odd_cut is not None:
        shards = [(raw[:, :, :odd_cut].contiguous(),
                   lm[:, :odd_cut].contiguous()),
                  (raw[:, :, odd_cut:].contiguous(),
                   lm[:, odd_cut:].contiguous())]
        widths = [int(Fs.shape[2]) for Fs, _ in shards]
        if not all(w % 2 for w in widths):
            raise ValueError("check_colsharded_at: odd_cut must leave two "
                             "shards of odd width")
        rec4["odd_cut"] = dict(
            shard_width=widths,
            ms=time_ms(lambda: nmf(cuda_stream.nmf_masked_colsharded_cuda),
                       reps))
        rec2["odd_cut"] = dict(
            shard_width=widths,
            ms=time_ms(lambda: ratio(cuda_nmf.ratio_rowsums_colsharded_cuda),
                       RATIO_REPS))
    del shards
    return {"nmf_colsharded": rec4, "ratio_colsharded": rec2}


def timed_fit(nmf_cfg, eng_cfg, cov, X, mesh=None):
    """A cold fit with counts set to 0 just before it and read just after,
    then a steady refit: (result, launches, cold s, steady s, engine)."""
    import torch
    from degnorm_tpu_torch.engine import DegNormEngine
    engine = DegNormEngine(nmf_cfg, eng_cfg, mesh=mesh)
    zero_launches()
    t0 = time.perf_counter()
    res = engine.run(cov, X)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {k: v for k, v in branch_launches().items()
                if "[" not in k or k in COLS_WIDE_INSTANCES}
    t0 = time.perf_counter()
    engine.run(cov, X, reuse_device_data=True)
    torch.cuda.synchronize()
    return res, launches, cold, time.perf_counter() - t0, engine


def phase_seqpar(cov_wide, X_wide, wide, long_tail):
    """Column-sharded buckets on ``make_mesh([cuda:0] * MESH_SHARDS)``.
    (1) Kernels 4c and 2c against their plain versions
    (``check_colsharded_at``) at the long tail's W=65536 bucket cut in two,
    at p = 8 (the fit's own bucket) and p = 3, 16, 32 (made on the card at
    its gene lengths), at one outlier of OUTLIER_LEN bases and at a
    TTN-like bucket as the engine packs it (one gene of TTN_LENGTHS[1]
    bases in 64 slots): the last two spread a gene over many blocks, and
    run 4c's nmf_tol instances too; their wide instances at every PMAX on
    COLS_WIDE_GENES x p x COLS_WIDE_W for p in COLS_WIDE_P and on the
    TTN-like genes at TTN_WIDE_P samples, the nmf_tol instances too, raw
    int16 + scale bit-equal to float32.  (2) The
    long tail on the mesh (``long_tail_mesh_fit``, phase ``mesh``'s record
    where it ran), against the one-device fit of phase ``fit_wide`` (``wide``;
    fitted here where that phase did not run).  (3) TTN_GENES genes of
    TTN_LENGTHS bases x P_SAMPLES, and x TTN_WIDE_P (``ttn_fits``), on one
    device, column-sharded on the mesh and gene-sharded on it
    (``seqpar_width`` above W), each held to the parity gate of the
    one-device fit, each with its launches and steady seconds.  Returns the
    kernel records and the long tail's."""
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.data.buckets import pack_buckets
    from degnorm_tpu_torch.parallel import make_mesh
    dev = torch.device(DEVICE, torch.cuda.current_device()) \
        if DEVICE == "cuda" else torch.device(DEVICE)
    mesh = make_mesh([dev] * MESH_SHARDS)
    kres = {}
    (b,) = [b for b in pack_buckets(list(cov_wide.values()),
                                    bucket_widths=EngineConfig().bucket_widths,
                                    dtype=np.int16)
            if b.width == WIDE_WIDTHS[1]]
    for p in SEQPAR_P:
        if p == P_SAMPLES:
            raw = torch.from_numpy(b.F).to(dev)
            lm = torch.from_numpy(b.len_mask()).to(dev)
        else:
            raw, lm = synth_wide_bucket(b.lengths, p, b.width, SEED + p, dev)
        kres[f"p{p}"] = check_colsharded_at(raw, lm, mesh, f"p{p}",
                                            b.n_real,
                                            tol_check=p == P_SAMPLES)
        del raw, lm
        torch.cuda.empty_cache()
    W = -(-OUTLIER_LEN // 128) * 128
    raw, lm = synth_wide_bucket([OUTLIER_LEN], P_SAMPLES, W, SEED + 9, dev)
    kres["outlier"] = check_colsharded_at(raw, lm, mesh, "outlier", 1,
                                          tol_check=True)
    L = TTN_LENGTHS[1]
    raw, lm = synth_wide_bucket([L] + [0] * 63, P_SAMPLES, -(-L // 128) * 128,
                                SEED + 10, dev)
    kres["ttn_bucket"] = check_colsharded_at(raw, lm, mesh, "ttn_bucket", 1,
                                             tol_check=True)
    del raw, lm
    # the wide instances at every PMAX, the nmf_tol ones too, raw int16 +
    # scale against float32
    lengths = np.random.default_rng(SEED + 11).integers(
        COLS_WIDE_W // 2, COLS_WIDE_W + 1, COLS_WIDE_GENES)
    raw_w, lm_w = synth_wide_bucket(lengths, max(COLS_WIDE_P), COLS_WIDE_W,
                                    SEED + 11, dev)
    for p in COLS_WIDE_P:
        kres[f"wide{p}"] = check_colsharded_at(
            raw_w[:, :p].contiguous(), lm_w, mesh, f"wide{p}",
            COLS_WIDE_GENES, reps=1, tol_check=True, i16_vs_f32=True,
            tol_tip=2, ref64=True, need_freeze=True,
            odd_cut=COLS_WIDE_W // 2 + 1 if p in COLS_ODD_P else None)
        torch.cuda.empty_cache()
    del raw_w, lm_w
    # ... at the edges of their layout
    rng = np.random.default_rng(SEED + 12)
    half = COLS_EDGE_GENES // 2
    lengths = np.concatenate([
        rng.integers(COLS_EDGE_CUT // 5, COLS_EDGE_CUT + 1, half),
        rng.integers(COLS_EDGE_CUT + 1, COLS_EDGE_W + 1,
                     COLS_EDGE_GENES - half)])
    raw_e, lm_e = synth_wide_bucket(lengths, max(COLS_EDGE_P), COLS_EDGE_W,
                                    SEED + 12, dev)
    if not bool((~lm_e[:, COLS_EDGE_CUT:].any(dim=1)).any()):
        raise AssertionError("seqpar: no gene without a column on shard 1")
    for p in COLS_EDGE_P:
        kres[f"edge{p}"] = check_colsharded_at(
            raw_e[:, :p].contiguous(), lm_e, mesh, f"edge{p}",
            COLS_EDGE_GENES, reps=1, tol_check=True, i16_vs_f32=True,
            tol_tip=2, ref64=True, cut=COLS_EDGE_CUT, need_freeze=True)
    del raw_e, lm_e
    torch.cuda.empty_cache()
    # ... and the TTN-like genes at TTN_WIDE_P samples, a bucket of three
    cov_t, _ = ttn_dataset(TTN_WIDE_P)
    W = -(-max(m.shape[1] for m in cov_t.values()) // 128) * 128
    F = np.zeros((TTN_GENES, TTN_WIDE_P, W), np.int16)
    lens = np.zeros(TTN_GENES, np.int64)
    for i, m in enumerate(cov_t.values()):
        F[i, :, :m.shape[1]] = np.round(m)
        lens[i] = m.shape[1]
    raw = torch.from_numpy(F).to(dev)
    lm = torch.from_numpy(np.arange(W)[None, :] < lens[:, None]).to(dev)
    kres[f"ttn{TTN_WIDE_P}"] = check_colsharded_at(
        raw, lm, mesh, f"ttn{TTN_WIDE_P}", TTN_GENES, reps=1, tol_check=True,
        i16_vs_f32=True, ref64=True)
    del cov_t, F, raw, lm
    torch.cuda.empty_cache()
    nmf_cfg = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=DEGNORM_ITER)
    if wide is None:
        one, one_launches, _, one_steady, _ = timed_fit(
            nmf_cfg, EngineConfig(), cov_wide, X_wide)
        wide = (one, one_steady, one_launches)
    if long_tail is None:
        long_tail = long_tail_mesh_fit(cov_wide, X_wide, *wide)
    # TTN-like genes: the longest human exonic lengths, a bucket each, at
    # P_SAMPLES and at TTN_WIDE_P samples (4c and 2c's wide instances)
    ttn = ttn_fits(mesh, P_SAMPLES, nmf_cfg)
    ttn[f"p{TTN_WIDE_P}"] = ttn_fits(mesh, TTN_WIDE_P, dataclasses.replace(
        nmf_cfg, degnorm_iter=TTN_WIDE_ITER))
    emit("seqpar", kernels={str(k): v for k, v in kres.items()},
         tolerance="4c: K,E,u within 1e-5 of max(|value|, 1) of the plain "
                   "version on the same shards, K and u bit-equal on every "
                   "shard; 2c: row sums within 1e-5, bit-equal on every "
                   "shard; fits: the parity gate (DI atol 5e-3, adjusted "
                   "rtol 5e-3, flags equal on >= 99% of genes)",
         long_tail=long_tail, ttn=ttn, smi=smi_line())
    return kres, long_tail


def ttn_dataset(p):
    """TTN_GENES genes of TTN_LENGTHS bases (seed SEED + 3) at p samples."""
    return synth_dataset(
        TTN_GENES, p, seed=SEED + 3,
        lengths_fn=lambda n, rng: rng.integers(*TTN_LENGTHS, n, endpoint=True))


def ttn_fits(mesh, p, nmf_cfg):
    """The TTN-like genes at p samples on one device, column-sharded on the
    mesh and gene-sharded on it (``seqpar_width`` above W), each held to
    the parity gate of the one-device fit, each with its launches, steady
    seconds, reductions and gathers (above NARROW_MAX_P: the wide
    instances of 4c and 2c must launch)."""
    import torch
    from degnorm_tpu_torch import EngineConfig
    from degnorm_tpu_torch.ops import cuda_nmf
    cov_t, X_t = ttn_dataset(p)
    one, l_one, c_one, s_one, _ = timed_fit(nmf_cfg, EngineConfig(), cov_t,
                                            X_t)
    ttn = dict(genes=TTN_GENES, samples=p,
               degnorm_iter=nmf_cfg.degnorm_iter,
               lengths=[m.shape[1] for m in cov_t.values()],
               one_device=dict(launches=l_one, wall_s=round(c_one, 4),
                               steady_wall_s=round(s_one, 4)))
    wide = p > cuda_nmf.NARROW_MAX_P
    for form, kw in (("column_sharded", {}),
                     ("gene_sharded", dict(seqpar_width=1 << 20))):
        res, launches, cold, steady, engine = timed_fit(
            nmf_cfg, EngineConfig(**kw), cov_t, X_t, mesh=mesh)
        n_col = sum(g is not None for g in engine._col_groups)
        want_col = len(engine._buckets) if form == "column_sharded" else 0
        k4, k4c = launches["nmf_streamed"], launches["nmf_colsharded"]
        k4cw = launches.get("nmf_colsharded[wide]", 0)
        if n_col != want_col or engine.colshard_declined or (
                DEVICE == "cuda" and (
                    (k4c > 0) != (want_col > 0) or (k4 > 0) == (want_col > 0)
                    or wide and (k4cw > 0) != (want_col > 0))):
            raise AssertionError(f"TTN p={p} {form}: {n_col} column-sharded "
                                 f"buckets, {engine.colshard_declined} "
                                 f"declined, launches {launches}")
        check = compare_or_gate(f"seqpar_ttn_p{p}_{form}", res, one,
                                (steady, s_one), samples=p)
        ttn[form] = dict(
            launches=launches, wall_s=round(cold, 4),
            steady_wall_s=round(steady, 4),
            steady_vs_one_device=round(steady / s_one - 1, 4),
            reductions=engine.reductions,
            reduce_s=round(engine.timings.get("reduce", 0.0), 4),
            gathers=engine.gathers,
            gram_gather_s=round(engine.timings.get("gram_gather", 0.0), 4),
            rho_max_abs_diff=float(np.abs(res.rho - one.rho).max()),
            x_adj_max_rel_diff=float(np.abs(res.x_adj / one.x_adj - 1).max()),
            **{k: v for k, v in check.items()
               if k not in ("rho_max_abs_diff", "x_adj_max_rel_diff")})
        del engine, res
        torch.cuda.empty_cache()
    return ttn


_ENGINE_RANK = r"""
import json, sys, time
from collections import OrderedDict
import numpy as np, torch
from degnorm_tpu_torch import EngineConfig, NMFConfig
from degnorm_tpu_torch.engine import DegNormEngine
from degnorm_tpu_torch.parallel import distributed
data, out, device = sys.argv[1], sys.argv[2], sys.argv[3]
t_start = time.perf_counter()
distributed.initialize_multihost(device=device)
rank = distributed.process_index()
backend = torch.distributed.get_backend()
with np.load(data) as d:
    names, lens, flat, X = ([str(g) for g in d["genes"]], d["lengths"],
                            d["flat"], d["X"])
p = X.shape[1]
ends = np.cumsum(lens.astype(np.int64) * p)
cov = OrderedDict((g, flat[e - L * p:e].reshape(p, L))
                  for g, L, e in zip(names, lens.tolist(), ends.tolist()))
nmf_iter, degnorm_iter = (int(v) for v in sys.argv[4:6])
widths = tuple(int(w) for w in sys.argv[6].split(","))
mesh = distributed.global_mesh(device)
eng = DegNormEngine(NMFConfig(nmf_iter=nmf_iter, degnorm_iter=degnorm_iter),
                    EngineConfig(device=device, bucket_widths=widths),
                    mesh=mesh)
t0 = time.perf_counter()
res = eng.run(cov, X)
if device == "cuda":
    torch.cuda.synchronize()
fit_s = time.perf_counter() - t0
timings = dict(eng.timings)
steady_s = None
if sys.argv[7:] != ["cold"]:
    t0 = time.perf_counter()
    eng.run(cov, X, reuse_device_data=True)
    if device == "cuda":
        torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
# the collectives themselves, on this group's backend: a gather of CUDA
# rows, a broadcast string and a barrier
rows = torch.full((rank + 1, 3), float(rank), device=mesh.devices[0])
got = distributed.gather_rows(rows)
want = torch.cat([torch.full((r + 1, 3), float(r))
                  for r in range(distributed.process_count())])
assert torch.equal(got.cpu(), want) and got.device == rows.device
s = distributed.broadcast_string("run/å-π" if rank == 0 else "")
assert s == "run/å-π", s
distributed.barrier("smoke")
np.save(out + "/rho_%d.npy" % rank, res.rho)
distributed.shutdown()
print(json.dumps({"rank": rank, "backend": backend,
                  "device": str(mesh.devices[0]),
                  "shards": [[sh.bucket, sh.start, sh.stop]
                             for sh in eng._shards],
                  "column_shards": [[sh.bucket, sh.cols.offset]
                                    for sh in eng._shards if sh.cols.sharded],
                  "reductions": eng.reductions,
                  "reduce_s": timings.get("reduce", 0.0),
                  "gathers": eng.gathers,
                  "gram_gather_s": timings.get("gram_gather", 0.0),
                  "fit_s": fit_s, "steady_s": steady_s,
                  "gather_s": timings["gather"],
                  "wall_s": time.perf_counter() - t_start,
                  "peak_mem_bytes": (int(torch.cuda.max_memory_allocated())
                                     if device == "cuda" else None)}),
      flush=True)
"""


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(argv, n, env_extra=(), timeout=600):
    """``argv`` in ``n`` processes as one torch.distributed job on a free
    localhost port; returns (outputs, wall seconds); raises with every
    rank's output when one fails.  Every process is waited for or
    killed."""
    env = dict(os.environ, DEGNORM_TPU_COORDINATOR=f"localhost:{_free_port()}",
               DEGNORM_TPU_NUM_PROCESSES=str(n), **dict(env_extra))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=dict(env, DEGNORM_TPU_PROCESS_ID=str(r)))
             for r in range(n)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=timeout)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    wall = time.perf_counter() - t0
    if any(pr.returncode != 0 for pr in procs):
        raise AssertionError("\n".join(
            f"rank {r} rc={pr.returncode}:\n{out[-3000:]}"
            for r, (pr, out) in enumerate(zip(procs, outs))))
    return outs, wall


def write_npz(path, cov, X):
    """A fit's genes for the rank processes: names, lengths, the matrices
    flattened, and X."""
    names = list(cov.keys())
    np.savez(path, genes=np.array(names), X=X,
             lengths=np.array([cov[g].shape[1] for g in names]),
             flat=np.concatenate([cov[g].ravel() for g in names]))


def phase_multihost(cov, X, base_fit, base_steady_s, base_timings, cold,
                    cov_wide, X_wide, wide_fit):
    """Several processes on the one card.  (a) Two processes share it over
    gloo (``DEGNORM_TPU_TORCH_DIST_BACKEND=gloo``: NCCL refuses two ranks
    on one card) and fit the narrow workload, its inputs handed over as an
    .npz; (b) a one-process NCCL group runs the same fit through
    ``initialize_multihost``; each rank's DI is held bit-equal to phase
    ``fit``'s (``compare_or_gate``), and each rank also runs a gather, a
    broadcast and a barrier.  (a') Two gloo processes fit the long tail,
    its W=65536 bucket column-sharded across them (one column shard a
    process, every reduction gathered over the group): both ranks' DI
    bit-equal, within the parity gate of phase ``fit_wide``'s.  (c) ``python -m degnorm_tpu_torch
    --multihost`` in two processes (gloo) on phase ``pipeline``'s four .bam
    samples: one run directory, no file the single-process run lacks (the
    worker writes none), no .etl_shared left, DI and adjusted-count CSVs
    byte-equal to phase ``pipeline``'s .bam run, --plot-genes split over
    the ranks.  Wall and fit seconds beside the single-process ones."""
    import filecmp
    import shutil
    import pandas as pd
    work = os.path.join(PIPE_DIR, "multihost")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    device = DEVICE
    data = os.path.join(work, "narrow.npz")
    write_npz(data, cov, X)
    argv = [sys.executable, "-c", _ENGINE_RANK, data, work, device,
            str(NMF_ITER), str(DEGNORM_ITER),
            ",".join(str(w) for w in BUCKET_WIDTHS)]
    fits = {}
    for tag, n, extra in (("gloo_2_processes", 2,
                           {"DEGNORM_TPU_TORCH_DIST_BACKEND": "gloo"}),
                          ("nccl_1_process", 1, {})):
        if device != "cuda" and tag.startswith("nccl"):
            continue
        outs, wall = run_ranks(argv, n, extra)
        ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
        want = "gloo" if tag.startswith("gloo") else "nccl"
        if device == "cuda" and any(r["backend"] != want for r in ranks):
            raise AssertionError(f"{tag}: backends {ranks}")
        checks = []
        for r in range(n):
            rho = np.load(os.path.join(work, f"rho_{r}.npy"))
            same = bool(np.array_equal(rho, base_fit.rho))
            checks.append(same)
            if not same:
                d = float(np.abs(rho - base_fit.rho).max())
                emit(f"multihost_{tag}_rank{r}_differs", rho_max_abs_diff=d,
                     reason="float32 summation order of another launch")
                if d > 5e-3:       # the parity gate's DI tolerance
                    raise AssertionError(f"{tag} rank {r}: DI differs from "
                                         f"phase fit's by {d}")
        fits[tag] = dict(
            processes=n, wall_s=round(wall, 3), rho_bit_equal=checks,
            ranks=ranks, one_process_fit_s=round(
                base_timings["init"] + base_timings["iterations"]
                + base_timings["pack"], 4),
            one_process_steady_s=round(base_steady_s, 4))
    # (a') the long tail, its widest bucket column-sharded over two processes
    from degnorm_tpu_torch import EngineConfig
    data = os.path.join(work, "long_tail.npz")
    write_npz(data, cov_wide, X_wide)
    outs, wall = run_ranks(
        [sys.executable, "-c", _ENGINE_RANK, data, work, device,
         str(NMF_ITER), str(DEGNORM_ITER),
         ",".join(str(w) for w in EngineConfig().bucket_widths), "cold"], 2,
        {"DEGNORM_TPU_TORCH_DIST_BACKEND": "gloo"})
    os.remove(data)
    ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    rhos = [np.load(os.path.join(work, f"rho_{r}.npy")) for r in range(2)]
    if [len(r["column_shards"]) for r in ranks] != [1, 1] or \
            ranks[0]["column_shards"][0][1] != 0:
        raise AssertionError(f"long tail over two processes: column shards "
                             f"{[r['column_shards'] for r in ranks]}")
    if not np.array_equal(rhos[0], rhos[1]):
        raise AssertionError("long tail over two processes: the ranks' DI "
                             "differ")
    d = float(np.abs(rhos[0] - wide_fit.rho).max())
    if not d <= 5e-3:          # the parity gate's DI tolerance
        raise AssertionError(f"long tail over two processes: DI differs from "
                             f"phase fit_wide's by {d}")
    fits["gloo_2_processes_long_tail_column_sharded"] = dict(
        processes=2, wall_s=round(wall, 3), ranks_bit_equal=True,
        rho_max_abs_diff_one_device=d, ranks=ranks)
    # (c) the command
    base = os.path.join(work, "command")
    os.makedirs(base)
    di_one = pd.read_csv(os.path.join(cold["run"],
                                      "degradation_index_scores.csv"))
    plot = sorted(di_one.gene.astype(str))[:2]
    device_flag = [] if device == "cuda" else ["--device", device]
    outs, wall = run_ranks(
        [sys.executable, "-m", "degnorm_tpu_torch", "--bam-files",
         *cold["bams"], "-g", cold["gtf"], "-o", base, "--nmf-iter",
         str(NMF_ITER), "--iter", str(DEGNORM_ITER), "-p", "4",
         "--multihost", "--plot-genes", *plot, *device_flag], 2,
        {"DEGNORM_TPU_TORCH_DIST_BACKEND": "gloo"})
    run = _one_run_dir(base)
    if any(f.startswith(".etl") for f in os.listdir(run)):
        raise AssertionError("multihost command left .etl_shared behind")

    def files(d):
        return {os.path.relpath(os.path.join(r, f), d)
                for r, _, fs in os.walk(d) for f in fs
                if not f.endswith("_coverage.png")}
    extra = files(run) - files(cold["run"])
    missing = files(cold["run"]) - files(run)
    if extra or missing:
        raise AssertionError(f"multihost run files differ: extra {extra}, "
                             f"missing {missing}")
    for name in ("ran_baseline_selection.csv", "read_counts.csv",
                 "gene_exon_metadata.csv"):
        if not filecmp.cmp(os.path.join(run, name),
                           os.path.join(cold["run"], name), shallow=False):
            raise AssertionError(f"multihost command's {name} differs from "
                                 "the single-process .bam run's")
    byte_equal = {}
    for name, rel in (("degradation_index_scores.csv", False),
                      ("adjusted_read_counts.csv", True)):
        byte_equal[name] = filecmp.cmp(os.path.join(run, name),
                                       os.path.join(cold["run"], name),
                                       shallow=False)
        if not byte_equal[name]:
            a, b = (pd.read_csv(os.path.join(d, name),
                                float_precision="round_trip")
                    for d in (run, cold["run"]))
            va, vb = (t.select_dtypes("number").to_numpy(np.float64)
                      for t in (a, b))
            d = float((np.abs(va - vb) / (np.maximum(np.abs(vb), 1.0)
                                          if rel else 1.0)).max())
            byte_equal[name + " max diff"] = d
            if not d <= 5e-3:        # the parity gate
                raise AssertionError(f"multihost command's {name} differs "
                                     f"from the single-process run's by {d}")
    for r, (out, gene) in enumerate(zip(outs, plot)):
        if f"plotting coverage for 1 gene(s): {gene}" not in out:
            raise AssertionError(f"rank {r} did not plot {gene}")
        if "multi-process ETL: this process owns 2/4 sample(s)" not in out:
            raise AssertionError(f"rank {r} did not own two samples")
    with open(os.path.join(run, "degnorm.log")) as f:
        log = f.read()
    if "[rank 1]" in log:
        raise AssertionError("the worker wrote into the run's degnorm.log")
    line = [ln for ln in log.splitlines() if "pipeline phase timings" in ln]
    import ast
    timings = ast.literal_eval(line[-1].split("(s): ", 1)[1])
    command = dict(processes=2, backend="gloo", wall_s=round(wall, 3),
                   fit_s=timings["fit"], etl_s=timings["etl"],
                   one_process_wall_s=cold["wall_s"],
                   one_process_fit_s=cold["fit_s"],
                   one_process_etl_s=cold["etl_s"],
                   plot_genes=plot, byte_equal_one_process=byte_equal)
    emit("multihost", fits=fits, command=command, smi=smi_line())
    shutil.rmtree(work, ignore_errors=True)


# ---- phase wide_p: studies of 33 to 128 samples -----------------------------
# the wide instances of kernels 1-4 (csrc/wide.cuh, csrc/*_wide.cuh)
WIDE_P = (33, 48, 64, 96, 128)
# (a) the resident buckets of kernels 1-3 (and 2): p -> (W, with the opt-in
# branches), so that every instance (PMAX 48, 64, 96, 128) meets its plain
# version in every branch, each at a shape where the engine runs it: the
# modes apply (trim_fast_applies) at 48 x 1024, 64 x 512, 96 x 512 and
# 128 x 256, not at 128 x 512
WIDE_P_RESIDENT = {33: ((1024, False),), 48: ((1024, True),),
                   64: ((1024, False), (512, True)), 96: ((512, True),),
                   128: ((512, False), (256, True))}
# the resident core's layout (csrc/wide_res.cuh) at its edges, at each PMAX:
# a bucket of the widest W the gate admits (its genes on clusters of two),
# one of the widest W whose genes a block holds alone, and clusters of three
# (p = 65 and 97 at the gate's widest W); every gene fills its W but every
# RES_EDGE_FEW-th, which holds a few columns (one block)
WIDE_P_RES_EDGE_GENES = 128
RES_EDGE_FEW = 16
RES_EDGE_THREE = ((65, 1008), (97, 675))
WIDE_P_GENES = 1024              # (a) kernels 1-3 and 2 at G x p x W
WIDE_P_STREAM = (256, 16384)     # (a) kernel 4 (and 2) at 256 x p x 16384
WIDE_P_BRANCH_P = 48             # the opt-in branches' main shape: 48 x 1024
WIDE_P_MODE_P = (48, 64, 96, 128)   # the fits under each mode
WIDE_P_MODE_GENES = 512
WIDE_P_FIT_P = 64                # (b) the narrow fit
WIDE_P_TAIL_P = 48               # (c) the long tail
WIDE_P_STREAM_P = 128            # (d) the default bucket widths at p = 128
WIDE_P_STREAM_GENES = 4096
WIDE_P_MESH_P = 40               # (e) the long tail on a two-shard mesh
WIDE_PMAX = (48, 64, 96, 128)    # the instances of csrc/wide.cuh
# DegNorm iterations of the fits (b)-(e) and the modes' fits, and (c)'s
# genes, cut to keep the script within its time limit (PERF.md §4)
WIDE_P_ITER = dict(b=3, c=1, d=1, e=1, modes=1)
WIDE_P_TAIL_GENES = 1024   # (c); (e) takes those of its W=65536 bucket
# the new instances: name -> (source, the TPU kernel, where its launches
# are read: the phase's fit that runs it)
WIDE_INSTANCES = OrderedDict([
    ("nmf_masked[wide]", ("degnorm_tpu_torch/csrc/nmf_wide.cu",
                          "degnorm_tpu/ops/pallas_nmf.py:687", "b")),
    ("nmf_masked[wide,nmf_tol]", ("degnorm_tpu_torch/csrc/nmf_wide_tol.cu",
                                  "degnorm_tpu/ops/pallas_nmf.py:440",
                                  "nmf_tol_p48")),
    ("ratio_rowsums[wide]", ("degnorm_tpu_torch/csrc/ratio_wide.cuh",
                             "degnorm_tpu/ops/pallas_nmf.py:562", "b")),
    ("trim_loop[wide]", ("degnorm_tpu_torch/csrc/trim_wide.cu",
                         "degnorm_tpu/ops/pallas_trim.py:324", "b")),
    ("trim_loop[wide,trim_fast]", ("degnorm_tpu_torch/csrc/trim_wide_fast.cu",
                                   "degnorm_tpu/ops/pallas_trim.py:135",
                                   "trim_fast_p48")),
    ("trim_loop[wide,nmf_tol]", ("degnorm_tpu_torch/csrc/trim_wide_tol.cu",
                                 "degnorm_tpu/ops/pallas_trim.py:177",
                                 "nmf_tol_p48")),
    ("nmf_streamed[wide]", ("degnorm_tpu_torch/csrc/stream_wide.cuh",
                            "degnorm_tpu/ops/pallas_stream.py:266", "b")),
])


def res_edges():
    """(p, W, what) of the resident core's edge buckets (RES_EDGE_THREE and,
    at each PMAX, the gate's widest W and the widest W of a cluster of
    one)."""
    from degnorm_tpu_torch.ops import cuda_nmf
    out = []
    for pm in WIDE_PMAX:
        if pm not in cuda_nmf.RES_PMAX:
            continue
        w_max = min(cuda_nmf.MAX_W, cuda_nmf.MAX_PW // pm)
        w_one = max(W for W in range(8, w_max + 1, 8)
                    if cuda_nmf.res_gene_cluster(
                        W, cuda_nmf.res_geometry(pm, W)[0]) == 1)
        out += [(pm, w_max, "widest"), (pm, w_one, "one block")]
    out += [(p, W, "cluster of three") for p, W in RES_EDGE_THREE
            if cuda_nmf.pmax_of(p) in cuda_nmf.RES_PMAX]
    return out


def check_res_geometry():
    """The resident core's geometry as its launcher computes it
    (``dn_res_geometry``) against its mirror ``cuda_nmf.res_geometry``, at
    every p of the wide instances and every seventh W the gate admits (and
    the widest).  Returns the shapes checked."""
    import ctypes
    from degnorm_tpu_torch.ops import build, cuda_nmf
    lib = build.get_lib()
    out = (ctypes.c_int * (2 + cuda_nmf.RES_MAX_CLUSTER))()
    n = 0
    for p in range(cuda_nmf.NARROW_MAX_P + 1, cuda_nmf.WIDE_MAX_P + 1):
        w_max = min(cuda_nmf.MAX_W, cuda_nmf.MAX_PW // p)
        for W in [*range(1, w_max + 1, 7), w_max]:
            lib.dn_res_geometry(p, W, out)
            capmax, launches = cuda_nmf.res_geometry(p, W)
            want = [capmax, len(launches), *[x[2] for x in launches]]
            want += [0] * (len(out) - len(want))
            if list(out) != want:
                raise AssertionError(f"res_geometry p={p} W={W}: the "
                                     f"launcher's {list(out)}, the mirror's "
                                     f"{want}")
            n += 1
    return n


def res_edge_bucket(G, p, W, seed, device):
    """G genes of exactly W positions at p samples (seed ``seed``), every
    RES_EDGE_FEW-th cut to 1-8 columns: float32 coverage, its length mask
    and its int16 form."""
    import torch
    rng = np.random.default_rng(seed)
    mats, _ = synth_dataset(G, p, seed=seed,
                            lengths_fn=lambda n, r: np.full(n, W))
    F = np.zeros((G, p, W), np.float32)
    lens = np.full(G, W)
    for i, m in enumerate(mats.values()):
        if i % RES_EDGE_FEW == RES_EDGE_FEW - 1:
            lens[i] = int(rng.integers(1, 9))
        F[i, :, :lens[i]] = m[:, :lens[i]]
    lm = torch.from_numpy(np.arange(W)[None, :] < lens[:, None]).to(device)
    return (torch.from_numpy(F).to(device), lm,
            torch.from_numpy(F.astype(np.int16)).to(device))


def wide_same_bits(keep, raw, lm, eng_cfg, branches, tag="wide"):
    """Each wide (or, ``tag="panel"``, panel) instance run twice on the
    inputs of its check: the same bits.  Returns the instances checked."""
    import torch
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_trim
    ti, act, nkw = keep["ti"], keep["act"], keep["nkw"]
    targs, tkw = keep["targs"], keep["tkw"]
    runs = {
        f"ratio_rowsums[{tag}]": lambda: cuda_nmf.ratio_rowsums_cuda(
            raw, lm, power_iters=eng_cfg.power_iters_cold),
        f"nmf_masked[{tag}]": lambda: cuda_nmf.nmf_masked_cuda(
            ti.Fm, ti.hi, gene_active=act, **nkw),
        f"trim_loop[{tag}]": lambda: cuda_trim.trim_loop_cuda(*targs, **tkw)}
    if branches:
        runs.update({
            f"nmf_masked[{tag},nmf_tol]": lambda: cuda_nmf.nmf_masked_cuda(
                ti.Fm, ti.hi, gene_active=act, **dict(nkw, nmf_tol=MODE_TOL)),
            f"trim_loop[{tag},trim_fast]": lambda: cuda_trim.trim_loop_cuda(
                *targs, **tkw, trim_fast=True),
            f"trim_loop[{tag},nmf_tol]": lambda: cuda_trim.trim_loop_cuda(
                *targs, **tkw, nmf_tol=MODE_TOL)})
    for name, fn in runs.items():
        a, b = fn(), fn()
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            if not torch.equal(x, y):
                raise AssertionError(f"{name} p={ti.Fm.shape[1]}: two runs "
                                     f"differ on {int((x != y).sum())} values")
    return list(runs)


def wide_fit(tag, cov, X, nmf_cfg, eng_cfg, mesh=None, steady=True,
             profile=False, need_bs=True):
    """A fit of phase wide_p through DegNormEngine.run: counts set to 0 just
    before it and read just after, peak device memory; a steady refit and a
    profiled one where asked (without the steady refit, the profiled fit is
    reported beside the cold fit's wall).  ``need_bs``: some gene must run
    baseline selection (genes shorter than min_gene_len never do).  Returns
    (result, record, engine)."""
    import torch
    from degnorm_tpu_torch.engine import DegNormEngine
    engine = DegNormEngine(nmf_cfg, eng_cfg, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    res = engine.run(cov, X)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {k: v for k, v in branch_launches().items() if v}
    n, p = res.rho.shape
    if not (np.isfinite(res.rho).all() and res.rho.min() >= 0
            and res.rho.max() <= 0.9 and np.isfinite(res.x_adj).all()):
        raise AssertionError(f"wide_p {tag}: non-finite or out-of-range DI")
    if need_bs and not res.ran_baseline_selection.any():
        raise AssertionError(f"wide_p {tag}: no gene ran baseline selection")
    iters = nmf_cfg.degnorm_iter
    compute = engine.timings["init"] + engine.timings["iterations"]
    rec = dict(genes=n, samples=p, degnorm_iter=iters,
               buckets=[[b.width, int(b.F.shape[0]), b.n_real]
                        for b in engine._buckets],
               launches=launches, wall_s=round(cold, 3),
               timings={k: round(v, 4) for k, v in engine.timings.items()},
               gene_iter_per_s=round(n * iters / compute, 1),
               genes_ran_bs=int(res.ran_baseline_selection.any(axis=1).sum()),
               trim_rounds=[list(r) for r in engine.trim_rounds])
    if steady:
        t0 = time.perf_counter()
        res2 = engine.run(cov, X, reuse_device_data=True)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        np.testing.assert_allclose(res2.rho, res.rho, rtol=0, atol=1e-6)
        rec.update(steady_wall_s=round(wall2, 3),
                   steady_gene_iter_per_s=round(n * iters / wall2, 1))
        if profile:
            rec["profile"] = profile_fit(engine, cov, X, wall2)
    rec["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated())
    if profile and not steady:
        rec["profile"] = profile_fit(engine, cov, X, cold)
    return res, rec, engine


def phase_wide_p():
    """Studies of 33 to 128 samples (the wide instances of kernels 1-4,
    csrc/wide.cuh).  (a) each new instance against its plain version at
    p = 33, 48, 64, 96, 128: kernels 1-3 (and 2) on WIDE_P_GENES genes at
    the resident widths of WIDE_P_RESIDENT (every PMAX instance, the opt-in
    branches at 48, 64, 96 and 128), kernel 4 (and 2) at 256 x p x 16384,
    raw int16 + scale bit-equal to float32, each at phase kernels'
    tolerances and run twice for the same bits, every p on the first p
    samples of one dataset made at p = 128; then the narrow genes at each p
    of WIDE_P_MODE_P (the first p samples of one dataset) under each opt-in
    mode, with the default bucket widths (the launches of every instance in
    each branch).  (b) the narrow
    fit at p = 64 (the bench gene set, seed 7: kernels 2, 1 and 3 at
    W = 1024, kernel 4 with the unfused loop at W = 4096), cold and a
    profiled steady refit, held to ``compare_fits`` against use_kernels=False on its
    first PARITY_GENES genes.  (c) the long tail at p = 48 (phase
    fit_wide's genes, seed 8, all through kernel 4), held the same way on
    PARITY_WIDE_GENES of its genes.  (d) p = 128 on WIDE_P_STREAM_GENES
    narrow genes with the default bucket widths: W <= 512 resident
    (kernels 1 and 3), W >= 1024 streamed (kernel 4).  (e) the slice's main
    path: the long tail's genes of its W = 65536 bucket at p = 40 (the
    first 40 samples of (c)'s data) on two column shards of the card
    (kernels 4c and 2c's wide instances; nothing declined), cold and
    steady, against one device's fit at the seqpar gate, with its
    reductions, gathers and peak memory.
    DegNorm iterations: WIDE_P_ITER.  Every instance must launch at every
    PMAX in the phase's fits.  Returns the kernels' records, the launches of
    each instance on its fit and its launches by PMAX."""
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.config import trim_fast_applies
    from degnorm_tpu_torch.ops import cuda_nmf
    from degnorm_tpu_torch.parallel.sharded import make_mesh
    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    nmf_cfg = NMFConfig(nmf_iter=NMF_ITER)
    eng_cfg = EngineConfig(bucket_widths=BUCKET_WIDTHS)
    rng = np.random.default_rng(SEED + 11)
    kres = {"resident": OrderedDict(), "stream": OrderedDict()}
    secs = {}

    # (a) every instance against its plain version, each p on the first p
    # samples of one dataset at the largest p
    t0 = time.perf_counter()
    top = max(WIDE_P)
    base = list(synth_dataset(WIDE_P_GENES, top, seed=SEED + top)[0].values())
    raw_top, lm_top = small_wide_bucket(WIDE_P_STREAM[0], top,
                                        WIDE_P_STREAM[1], SEED + top, dev)
    secs["a_data"] = time.perf_counter() - t0
    for p in WIDE_P:
        t1 = time.perf_counter()
        for W, branches in WIDE_P_RESIDENT[p]:
            F, lm, raw = resident_bucket(WIDE_P_GENES, p, W, dev, rng,
                                         mats=base)
            assert cuda_nmf.kernels_supported(F.shape, torch.float32)
            assert not branches or trim_fast_applies(F.shape)
            keep = {}
            rec = check_kernels_at(F, lm, nmf_cfg, eng_cfg, raw,
                                   branches=branches, keep=keep)
            rec["same_bits"] = wide_same_bits(keep, raw, lm, eng_cfg,
                                              branches)
            kres["resident"][f"p{p}_W{W}"] = rec
            del F, lm, raw, keep, rec
        t2 = time.perf_counter()
        secs[f"a_resident_p{p}"] = t2 - t1
        raw = raw_top[:, :p].contiguous()
        assert not cuda_nmf.kernels_supported(raw.shape, torch.float32)
        kres["stream"][f"p{p}_W{WIDE_P_STREAM[1]}"] = check_stream_at(
            raw, lm_top, nmf_cfg, EngineConfig())
        del raw
        torch.cuda.empty_cache()
        secs[f"a_stream_p{p}"] = time.perf_counter() - t2
    del base, raw_top, lm_top
    secs["a"] = time.perf_counter() - t0

    # the resident core's edges: every branch of kernels 1 and 3 (and 2)
    # against its plain version, twice for the same bits
    t0 = time.perf_counter()
    kres["res_edges"] = OrderedDict()
    for p, W, what in res_edges():
        F, lm, raw = res_edge_bucket(WIDE_P_RES_EDGE_GENES, p, W,
                                     SEED + 3 * p + W, dev)
        keep = {}
        rec = check_kernels_at(F, lm, nmf_cfg, eng_cfg, raw, timed=False,
                               branches=True, keep=keep)
        rec["same_bits"] = wide_same_bits(keep, raw, lm, eng_cfg, True)
        rec.update(edge=what, res_geometry=list(cuda_nmf.res_geometry(p, W)))
        if rec["trim_loop"]["entered"] < WIDE_P_RES_EDGE_GENES // 2:
            raise AssertionError(f"wide_p res edge p={p} W={W}: "
                                 f"{rec['trim_loop']['entered']} genes in "
                                 "the trim loop")
        kres["res_edges"][f"p{p}_W{W}"] = rec
        del F, lm, raw, keep, rec
    torch.cuda.empty_cache()
    secs["res_edges"] = time.perf_counter() - t0
    kres["res_geometry_checked"] = check_res_geometry()

    # the narrow genes under each opt-in mode at every PMAX, with the
    # default bucket widths: the branches' instances on a fit's path
    t0 = time.perf_counter()
    modes = {}
    cov_top, X_top = synth_dataset(WIDE_P_MODE_GENES, max(WIDE_P_MODE_P))
    for p in WIDE_P_MODE_P:
        cov_m = OrderedDict((k, np.ascontiguousarray(m[:p]))
                            for k, m in cov_top.items())
        X_m = np.ascontiguousarray(X_top[:, :p])
        for mode, kw in MODES:
            _, rec, _ = wide_fit(
                f"{mode}_p{p}", cov_m, X_m,
                NMFConfig(nmf_iter=NMF_ITER,
                          degnorm_iter=WIDE_P_ITER["modes"]),
                EngineConfig(**kw), steady=False)
            modes[f"{mode}_p{p}"] = rec
        del cov_m, X_m
    del cov_top, X_top
    secs["modes"] = time.perf_counter() - t0

    # (b) the narrow fit at p = 64
    t0 = time.perf_counter()
    cov_b, X_b = synth_dataset(N_GENES, WIDE_P_FIT_P)
    secs["b_data"] = time.perf_counter() - t0
    nmf_b = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=WIDE_P_ITER["b"])
    # the steady refit is the profiled one (the profiler cost 0.1% of it)
    fit_b, rec_b, eng_b = wide_fit("b", cov_b, X_b, nmf_b, eng_cfg,
                                   steady=False, profile=True)
    if isinstance(rec_b["profile"], dict):
        rec_b["steady_profiled_wall_s"] = rec_b["profile"]["wall_s"]
    widths = sorted(b.width for b in eng_b._buckets)
    if widths != sorted(BUCKET_WIDTHS):
        raise AssertionError(f"wide_p (b): buckets {widths}")
    need = ("ratio_rowsums[wide]", "nmf_masked[wide]", "trim_loop[wide]",
            "nmf_streamed[wide]")
    if any(rec_b["launches"].get(k, 0) < 1 for k in need):
        raise AssertionError(f"wide_p (b): launches {rec_b['launches']}")
    del eng_b
    torch.cuda.empty_cache()
    secs["b_fit"] = time.perf_counter() - t0 - secs["b_data"]
    keys = list(cov_b)[:PARITY_GENES]
    sub = OrderedDict((k, cov_b[k]) for k in keys)
    Xs = X_b[:PARITY_GENES]
    t1 = time.perf_counter()
    on, _, _ = wide_fit("b_parity_on", sub, Xs, nmf_b, eng_cfg, steady=False)
    t2 = time.perf_counter()
    off, _, _ = wide_fit("b_parity_off", sub, Xs, nmf_b,
                         dataclasses.replace(eng_cfg, use_kernels=False),
                         steady=False)
    compare_fits("wide_p_parity_b", on, off,
                 (t2 - t1, time.perf_counter() - t2), samples=WIDE_P_FIT_P)
    del cov_b, X_b, fit_b, sub, on, off
    secs["b"] = time.perf_counter() - t0

    # (c) the long tail at p = 48
    t0 = time.perf_counter()
    cov_c, X_c = synth_dataset(WIDE_P_TAIL_GENES, WIDE_P_TAIL_P,
                               seed=SEED + 1, lengths_fn=synth_long_lengths)
    secs["c_data"] = time.perf_counter() - t0
    nmf_c = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=WIDE_P_ITER["c"])
    wide_cfg = EngineConfig()
    fit_c, rec_c, eng_c = wide_fit("c", cov_c, X_c, nmf_c, wide_cfg,
                                   steady=False)
    if sorted(b.width for b in eng_c._buckets) != sorted(WIDE_WIDTHS):
        raise AssertionError("wide_p (c): long genes did not pack into the "
                             "wide buckets")
    if (rec_c["launches"].get("nmf_streamed[wide]", 0) < 1
            or rec_c["launches"].get("trim_loop", 0)
            or rec_c["launches"].get("nmf_masked", 0)):
        raise AssertionError(f"wide_p (c): launches {rec_c['launches']}")
    del eng_c
    torch.cuda.empty_cache()
    secs["c_fit"] = time.perf_counter() - t0 - secs["c_data"]
    lens = np.array([m.shape[1] for m in cov_c.values()])
    pick = np.concatenate([
        np.flatnonzero(lens <= WIDE_WIDTHS[0])[:PARITY_WIDE_GENES[0]],
        np.flatnonzero(lens > WIDE_WIDTHS[0])[:PARITY_WIDE_GENES[1]]])
    keys = list(cov_c)
    sub = OrderedDict((keys[i], cov_c[keys[i]]) for i in pick)
    t1 = time.perf_counter()
    on, _, _ = wide_fit("c_parity_on", sub, X_c[pick], nmf_c, wide_cfg,
                        steady=False)
    t2 = time.perf_counter()
    off, _, _ = wide_fit("c_parity_off", sub, X_c[pick], nmf_c,
                         dataclasses.replace(wide_cfg, use_kernels=False),
                         steady=False)
    compare_fits("wide_p_parity_c", on, off,
                 (t2 - t1, time.perf_counter() - t2), samples=WIDE_P_TAIL_P)
    del fit_c, sub, on, off
    secs["c"] = time.perf_counter() - t0

    # (d) p = 128 with the default bucket widths: W <= 512 resident, the
    # rest streamed
    t0 = time.perf_counter()
    cov_d, X_d = synth_dataset(WIDE_P_STREAM_GENES, WIDE_P_STREAM_P)
    _, rec_d, eng_d = wide_fit(
        "d", cov_d, X_d,
        NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=WIDE_P_ITER["d"]),
        EngineConfig(), steady=False)
    resident = sorted(b.width for b in eng_d._buckets
                      if cuda_nmf.kernels_supported(b.F.shape, torch.float32))
    if (resident != [256, 512]
            or set(rec_d["launches"]) - {"ratio_rowsums", "nmf_masked",
                                         "trim_loop", "nmf_streamed",
                                         *(k + "[wide]" for k in (
                                             "ratio_rowsums", "nmf_masked",
                                             "trim_loop", "nmf_streamed"))}
            or any(rec_d["launches"].get(k + "[wide]", 0) < 1 for k in (
                "nmf_masked", "trim_loop", "nmf_streamed"))):
        raise AssertionError(f"wide_p (d): resident widths {resident}, "
                             f"launches {rec_d['launches']}")
    del cov_d, X_d, eng_d
    torch.cuda.empty_cache()
    secs["d"] = time.perf_counter() - t0

    # (e) the slice's main path: the long tail at p = 40 on two column
    # shards of the card, its genes of the W=65536 bucket (kernels 4c and
    # 2c's wide instances), against one device's fit
    t0 = time.perf_counter()
    rows = [i for i, m in enumerate(cov_c.values())
            if m.shape[1] > WIDE_WIDTHS[0]]
    keys = list(cov_c)
    cov_e = OrderedDict(
        (keys[i], np.ascontiguousarray(cov_c[keys[i]][:WIDE_P_MESH_P]))
        for i in rows)
    X_e = np.ascontiguousarray(X_c[rows, :WIDE_P_MESH_P])
    del cov_c, X_c
    nmf_e = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=WIDE_P_ITER["e"])
    one, rec_one, _ = wide_fit("e_one", cov_e, X_e, nmf_e, wide_cfg)
    torch.cuda.empty_cache()
    mesh = make_mesh([DEVICE] * MESH_SHARDS)
    two, rec_two, eng_two = wide_fit("e_mesh", cov_e, X_e, nmf_e, wide_cfg,
                                     mesh=mesh)
    declined = eng_two.colshard_declined
    n_col = sum(g is not None for g in eng_two._col_groups)
    counts = rec_two["launches"]
    if (declined or n_col != 1
            or not 0 < counts.get("nmf_colsharded[wide]", 0)
            == counts.get("nmf_colsharded", 0)
            or not 0 < counts.get("ratio_colsharded[wide]", 0)
            == counts.get("ratio_colsharded", 0)):
        raise AssertionError(
            f"wide_p (e): {declined} buckets declined, {n_col} "
            f"column-sharded, launches {counts}")
    gap = compare_or_gate("wide_p_mesh", two, one,
                          (rec_two["steady_wall_s"], rec_one["steady_wall_s"]),
                          samples=WIDE_P_MESH_P)
    # the steady refits' own counts (the engine's are its last fit's)
    mesh_rec = dict(gap)
    mesh_rec.update(
        shards=MESH_SHARDS, colshard_declined=declined,
        column_sharded_buckets=n_col, bucket_genes=len(cov_e),
        steady_s=rec_two["steady_wall_s"],
        one_device_steady_s=rec_one["steady_wall_s"],
        cold_s=rec_two["wall_s"], one_device_cold_s=rec_one["wall_s"],
        steady_vs_one_device=round(rec_two["steady_wall_s"]
                                   / rec_one["steady_wall_s"] - 1, 4),
        reductions=eng_two.reductions,
        reduce_s=round(eng_two.timings.get("reduce", 0.0), 4),
        gathers=eng_two.gathers,
        gram_gather_s=round(eng_two.timings.get("gram_gather", 0.0), 4),
        peak_mem_bytes=rec_two["peak_mem_bytes"],
        one_device_peak_mem_bytes=rec_one["peak_mem_bytes"],
        rho_max_abs_diff=float(np.abs(two.rho - one.rho).max()),
        x_adj_max_rel_diff=float(np.abs(two.x_adj / one.x_adj - 1).max()),
        rho_within_1e5=bool(np.abs(two.rho - one.rho).max() <= 1e-5))
    print(f"wide_p (e) p={WIDE_P_MESH_P}: column-sharded against one device: "
          f"DI max |diff| {mesh_rec['rho_max_abs_diff']:.3e}, adjusted "
          f"{mesh_rec['x_adj_max_rel_diff']:.3e} (relative); steady "
          f"{mesh_rec['steady_s']} s (one device "
          f"{mesh_rec['one_device_steady_s']}), cold {mesh_rec['cold_s']} s "
          f"(one device {mesh_rec['one_device_cold_s']})", flush=True)
    del cov_e, X_e, one, two, eng_two
    torch.cuda.empty_cache()
    secs["e"] = time.perf_counter() - t0

    runs = {"b": rec_b, "c": rec_c, "d": rec_d, "e_one": rec_one,
            "e_mesh": rec_two, **modes}
    launches = {name: runs[where]["launches"].get(name, 0)
                for name, (_, _, where) in WIDE_INSTANCES.items()}
    # kernels 4c and 2c's wide instances: on the main path (e) alone
    launches.update((name, rec_two["launches"].get(name, 0))
                    for name in COLS_WIDE_INSTANCES)
    by_pmax = {name: {pm: sum(r["launches"].get(name, 0)
                              for r in runs.values()
                              if cuda_nmf.pmax_of(r["samples"]) == pm)
                      for pm in WIDE_PMAX}
               for name in WIDE_INSTANCES}
    if not all(n for v in by_pmax.values() for n in v.values()):
        raise AssertionError(f"wide_p: an instance never launched at some "
                             f"PMAX: {by_pmax}")
    emit("wide_p", samples=list(WIDE_P), nmf_iter=NMF_ITER,
         degnorm_iter=WIDE_P_ITER,
         degnorm_iter_cut={k: v < DEGNORM_ITER
                           for k, v in WIDE_P_ITER.items()},
         tolerance="as phase kernels; each instance run twice: the same bits",
         kernels=kres, fits=runs,
         mesh=mesh_rec,
         instance_launches=launches, launches_by_pmax=by_pmax,
         seconds={k: round(v, 2) for k, v in secs.items()},
         phase_seconds=round(time.perf_counter() - t_phase, 1))
    return kres, launches, by_pmax


# kernels 4c and 2c's wide instances (phase seqpar's checks, phase wide_p's
# main path): name -> (their records' key, source)
COLS_WIDE_INSTANCES = OrderedDict([
    ("nmf_colsharded[wide]", ("nmf_colsharded",
                              "degnorm_tpu_torch/csrc/stream_cols_wide.cuh")),
    ("ratio_colsharded[wide]", ("ratio_colsharded",
                                "degnorm_tpu_torch/csrc/ratio_cols_wide.cu")),
])


def cols_wide_records(seqpar, wide):
    """The result line's records of kernels 4c and 2c's wide instances: at
    the main path's PMAX (64 genes x 48 x 65,536 on two column shards), with
    every PMAX and the TTN-like genes beside it (``by_shape``), their
    launches on phase wide_p's main path (e)."""
    from degnorm_tpu_torch.ops import cuda_nmf
    col_kres, _ = seqpar
    _, launches, _ = wide
    keys = ("shape", "shard_width", "geometry", "ms",
            "plain_ms", "bound_ms", "bound_by", "bound_tc_ms", "floor_ms",
            "max_abs_err", "nmf_tol")
    main = f"wide{cuda_nmf.pmax_of(WIDE_P_MESH_P)}"
    out = []
    for name, (key, src) in COLS_WIDE_INSTANCES.items():
        recs = {k: v[key] for k, v in col_kres.items()
                if k.startswith(("wide", "edge")) or k == f"ttn{TTN_WIDE_P}"}
        m = recs[main]
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": "degnorm_tpu/engine.py:75-84 (none: XLA under GSPMD)",
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "shape": m["shape"], "shards": MESH_SHARDS,
            "by_shape": {k: {f: r[f] for f in keys if f in r}
                         for k, r in recs.items()}})
    return out


# where each wide instance's records sit in a resident bucket's checks
WIDE_CHECK_KEY = {"nmf_masked[wide]": "nmf_masked",
                  "nmf_masked[wide,nmf_tol]": "nmf_masked[nmf_tol]",
                  "ratio_rowsums[wide]": "ratio_rowsums",
                  "trim_loop[wide]": "trim_loop",
                  "trim_loop[wide,trim_fast]": "trim_loop[trim_fast]",
                  "trim_loop[wide,nmf_tol]": "trim_loop[nmf_tol]"}


def wide_kernel_records(wide):
    """The result line's records of the wide instances: each at its main
    shape (kernels 1-3 and 2 at WIDE_P_GENES x 64 x 1024, kernel 4 at 256 x
    64 x 16384, the branches at 48 x 1024), with every shape it was held at
    beside it (``by_shape``, keyed p{p}_W{W}) and its launches in the phase's
    fits by PMAX."""
    kres, launches, by_pmax = wide
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_tc_ms",
            "max_abs_err")
    out = []
    for name, (src, repl, _) in WIDE_INSTANCES.items():
        if name == "nmf_streamed[wide]":
            recs = dict(kres["stream"])
        else:
            key = WIDE_CHECK_KEY[name]
            recs = {k: r[key] for k, r in kres["resident"].items()
                    if key in r}
            if key == "ratio_rowsums":   # also at kernel 4's shape
                recs.update((k, r["ratio_rowsums"])
                            for k, r in kres["stream"].items())
        main = (f"p{WIDE_P_BRANCH_P}_W1024" if name in (
            "nmf_masked[wide,nmf_tol]", "trim_loop[wide,trim_fast]",
            "trim_loop[wide,nmf_tol]")
            else f"p{WIDE_P_FIT_P}_W{WIDE_P_STREAM[1]}"
            if name == "nmf_streamed[wide]" else f"p{WIDE_P_FIT_P}_W1024")
        m = recs[main]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            **({"bound_tc_ms": m["bound_tc_ms"]} if "bound_tc_ms" in m
               else {}),
            "library_ms": None, "shape": main,
            "launches_by_pmax": by_pmax[name],
            "by_shape": {k: {f: r[f] for f in keys if f in r}
                         for k, r in recs.items()}})
    return out


# ---- phase panels: studies of more than 128 samples --------------------------
# the panel instances of kernels 1-4 (csrc/panel.cuh, csrc/*_panel.cu)
# kernels 1-3 (and 2) resident on PANEL_GENES genes: (p, W, the opt-in
# branches where the engine's mode gate lets them run: 129 x 256 only)
PANEL_RESIDENT = ((129, 256, True), (256, 256, False), (512, 128, False))
PANEL_GENES = 256
# kernels 4 and 2 at G x p x 16384, one dataset made at the largest p
PANEL_STREAM = ((32, 129), (32, 192), (32, 256), (16, 512))
PANEL_STREAM_W = 16384
# the edges of the cluster layout, on data of their own: kernels 1-3 and 2
# resident on PANEL_GENES genes at (p, W) at their largest p (5 blocks of
# three pairs) and past it (their phased layout; kernel 2 on a cluster of
# 6), kernels 4 and 2 on G x p x W at three panels (a cluster of 3 blocks of
# two pairs), at kernels 1 and 3's largest p, past it (clusters of 6 and
# 8 blocks: 32 x 768 x 16384 half a bucket; 8 the largest portable
# cluster), at their own largest p (a cluster of 9, not portable); their
# sizes cut to keep the script within its time limit (PERF.md §4)
PANEL_EDGE = ((640, 64), (704, 64))
PANEL_BIG_MAIN = (32, 768, 16384)   # kernels 4 and 2's shape in the result
PANEL_EDGE_STREAM = ((8, 384, 4096), (8, 640, 4096), (4, 700, 2048),
                     (8, 768, 16384), PANEL_BIG_MAIN, (4, 1024, 2048),
                     (4, 1152, 2048))
# kernels 4 and 2 past their cluster layout, on its phased layout
# (csrc/phase.cuh): just past the cut, a full bucket at the main path's p
# (the result line's shape) and 8 of its genes, and 32 panels (past any
# cluster the card can hold)
PANEL_PHASE_MAIN = (64, 1222, 16384)
PANEL_PHASE_STREAM = ((4, 1153, 2048), (8, 1222, 16384), PANEL_PHASE_MAIN,
                      (2, 4096, 1024))
# ... and kernels 1-3 at (p, W) where a block holds several pairs and genes
# enter the trim loop (a gene of min_gene_len = 200 columns fits p * W <=
# MAX_PW up to p = 327), with the opt-in branches on the kernels' wrappers:
# their mode gates (W a multiple of 128) admit them past p = 208 only at W =
# 128, where no gene has the columns to enter the loop
PANEL_MULTI = (288, 224)
PANEL_MODE_P = 160               # the narrow genes under each opt-in mode
PANEL_MODE_GENES = 512           # (the first genes and samples of the fit's)
PANEL_FIT_P = 256                # the narrow genes at the default widths
PANEL_FIT_GENES = 1024
PANEL_PARITY_GENES = 128
PANEL_ITER = 1                   # DegNorm iterations of its fits (cut from 5)
# the fit past 640 samples: narrow genes at p = PANEL_BIG_P with the
# default bucket widths (every bucket streams: kernels 2 and 4 on clusters
# of 6 blocks, the unfused trim loop), a kernels-off parity pair on its
# first PANEL_BIG_PARITY genes
PANEL_BIG_P = 768
PANEL_BIG_GENES = 256
PANEL_BIG_PARITY = 32
# the slice's main path past 1,152 samples: the same genes at p =
# PANEL_PHASE_P (every bucket streams: kernels 2 and 4 on the phased
# layout), profiled, a kernels-off parity pair on its first
# PANEL_PHASE_PARITY genes
PANEL_PHASE_P = 1222
PANEL_PHASE_GENES = 256
PANEL_PHASE_PARITY = 32
# kernel 1 past its cluster layout, on the phased layout (csrc/phase.cuh):
# resident on PANEL_GENES genes at (p, W) just past the cut (PANEL_EDGE's),
# at the main path's p, at four panels and just past kernels 2 and 4's cut
# (at the widest W the resident gate admits), in both branches
PANEL_NMF_PHASE = ((704, 64), (768, 64), (1024, 64), (1153, 56))
# the slice's main path for kernel 1 past 640 samples: narrow genes of
# 50-64 bases at p = PANEL_RES_P with widths that keep a W = 64 bucket
# resident (the default widths start at 256, where no bucket past 256
# samples is resident), kernels 2 on its cluster layout, 1 and 3 on the
# phased layout (kernel 3: its light path, no gene enters); a kernels-off
# parity pair on its first PANEL_RES_PARITY genes
PANEL_RES_P = 768
PANEL_RES_GENES = 1024
PANEL_RES_PARITY = 64
PANEL_RES_WIDTHS = (64, 256, 512, 1024, 2048, 4096, 8192, 16384, 65536)
# name -> (source, the TPU kernel, the phase's fit that runs it)
PANEL_INSTANCES = OrderedDict([
    ("nmf_masked[panel]", ("degnorm_tpu_torch/csrc/nmf_panel.cu",
                           "degnorm_tpu/ops/pallas_nmf.py:687", "fit")),
    ("nmf_masked[panel,nmf_tol]", ("degnorm_tpu_torch/csrc/nmf_panel.cu",
                                   "degnorm_tpu/ops/pallas_nmf.py:440",
                                   "nmf_tol")),
    ("ratio_rowsums[panel]", ("degnorm_tpu_torch/csrc/ratio_panel.cu",
                              "degnorm_tpu/ops/pallas_nmf.py:562", "big")),
    ("trim_loop[panel]", ("degnorm_tpu_torch/csrc/trim_panel.cu",
                          "degnorm_tpu/ops/pallas_trim.py:324", "fit")),
    ("trim_loop[panel,trim_fast]", ("degnorm_tpu_torch/csrc/trim_panel.cu",
                                    "degnorm_tpu/ops/pallas_trim.py:135",
                                    "trim_fast")),
    ("trim_loop[panel,nmf_tol]", ("degnorm_tpu_torch/csrc/trim_panel.cu",
                                  "degnorm_tpu/ops/pallas_trim.py:177",
                                  "nmf_tol")),
    ("nmf_streamed[panel]", ("degnorm_tpu_torch/csrc/stream_panel.cu",
                             "degnorm_tpu/ops/pallas_stream.py:266", "big")),
    ("ratio_rowsums[panel,phase]", ("degnorm_tpu_torch/csrc/ratio_phase.cu",
                                    "degnorm_tpu/ops/pallas_nmf.py:562",
                                    "phase")),
    ("nmf_streamed[panel,phase]", ("degnorm_tpu_torch/csrc/stream_phase.cu",
                                   "degnorm_tpu/ops/pallas_stream.py:266",
                                   "phase")),
    ("nmf_masked[panel,phase]", ("degnorm_tpu_torch/csrc/phase.cuh",
                                 "degnorm_tpu/ops/pallas_nmf.py:687",
                                 "resident768")),
    ("trim_loop[panel,phase]", ("degnorm_tpu_torch/csrc/trim_panel.cu",
                                "degnorm_tpu/ops/pallas_trim.py:324",
                                "resident768")),
])


def check_nmf_phase_at(F, lm, nmf_cfg, eng_cfg, timed=True,
                       all_active=False):
    """Kernel 1 past PCL_MAX_P on its phased layout (csrc/phase.cuh through
    csrc/nmf_panel.cu) against its plain version on one resident bucket, in
    both branches: the default one cold (every 7th gene and the bailed ones
    inactive: zeros; ``all_active``: only the bailed ones, and the active
    genes must fill at least two groups of the layout, so that slots are
    reused by later groups) and resumed from u0 at rtol/atol 1e-3, its
    nmf_tol branch by ``check_nmf_tol_at`` at MODE_TOL and at FREEZE_TOL
    (the iterations each gene ran against the plain version's, without the
    cap by active genes); each run twice for the same bits (the nmf_tol
    branch with its iterations), every launch counted as a phased one.
    Returns the measurements."""
    import torch
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.ops import cuda_nmf
    G, p, W = F.shape
    assert cuda_nmf.panel_phase(p, "nmf") and cuda_nmf.kernels_supported(
        F.shape, torch.float32)
    plain_cfg = dataclasses.replace(eng_cfg, use_kernels=False)
    ti = baseline.trim_inputs(F, lm, nmf_cfg, plain_cfg)
    nkw = baseline._nmf_kwargs(nmf_cfg, eng_cfg)
    act = ~ti.bailed
    if not all_active:
        act[::7] = False
    slots = cuda_nmf.panel_slots(G, F.device)
    groups = -(-int(act.sum()) // slots)
    if all_active and groups < 2:
        raise AssertionError(f"nmf_masked[panel,phase] p={p} W={W}: "
                             f"{int(act.sum())} active genes fill {groups} "
                             f"group of {slots}")
    n0 = cuda_nmf.nmf_panel_phase_launches
    want, want_ms = timed_once(lambda: cuda_nmf.nmf_masked_plain(
        ti.Fm, ti.hi, gene_active=act, **nkw))
    rkw = dict(nkw, power_iters_cold=eng_cfg.power_iters_resume)
    runs = {"cold": (lambda: cuda_nmf.nmf_masked_cuda(
                ti.Fm, ti.hi, gene_active=act, **nkw), want),
            "u0_resume": (lambda: cuda_nmf.nmf_masked_cuda(
                ti.Fm, ti.hi, gene_active=act, u0=want[2], **rkw),
                cuda_nmf.nmf_masked_plain(ti.Fm, ti.hi, gene_active=act,
                                          u0=want[2], **rkw))}
    errs = []
    for tag, (fn, ref) in runs.items():
        a, b = fn(), fn()
        torch.cuda.synchronize()
        for g_, h_, w_, nm in zip(a, b, ref, ("K", "E", "u")):
            if not torch.equal(g_, h_):
                raise AssertionError(f"nmf_masked[panel,phase] {nm} p={p} "
                                     f"W={W} ({tag}): two runs differ on "
                                     f"{int((g_ != h_).sum())} values")
            assert_close(g_, w_, 1e-3, 1e-3,
                         f"nmf_masked[panel,phase] {nm} p={p} W={W} ({tag})")
            errs.append(err_stats(g_, w_))
            if bool((g_[~act] != 0).any()):
                raise AssertionError(f"nmf_masked[panel,phase] {nm} p={p}: "
                                     "inactive gene not zero")
    b_ms, b_by = bound_nmf(ti.Fm, ti.hi, act, nmf_cfg.nmf_iter)
    rec = dict(shape=[G, p, W], max_abs_err=max(e[0] for e in errs),
               max_rel_err=max(e[1] for e in errs),
               inactive_genes=int((~act).sum()), bound_ms=b_ms, bound_by=b_by,
               slots=slots, groups=groups)
    tol = {}
    for t in (MODE_TOL, FREEZE_TOL):
        tol[f"{t:g}"] = check_nmf_tol_at(ti, act, nkw, nmf_cfg, t, timed,
                                         cap_active=False)
        kw = dict(nkw, nmf_tol=t)
        its = [torch.zeros(G, dtype=torch.int32, device=F.device)
               for _ in range(2)]
        a, b = (cuda_nmf.nmf_masked_cuda(ti.Fm, ti.hi, gene_active=act,
                                         iters_out=i, **kw) for i in its)
        torch.cuda.synchronize()
        if not (all(torch.equal(x, y) for x, y in zip(a, b))
                and torch.equal(*its)):
            raise AssertionError(f"nmf_masked[panel,phase,nmf_tol={t:g}] "
                                 f"p={p} W={W}: two runs differ")
    rec["nmf_tol"] = tol
    if timed:
        rec["ms"] = time_ms(runs["cold"][0], 2)
        rec["plain_ms"] = want_ms
    launched = cuda_nmf.nmf_panel_phase_launches - n0
    if launched < 1:
        raise AssertionError(f"nmf_masked p={p}: no launch on the phased "
                             "layout")
    rec["launches"] = launched
    return rec


# kernel 3 past PCL_MAX_P, on the phased layout (csrc/trim_panel.cu):
# (G, p, W, floors lowered) on PANEL_GENES-style genes of 200-299 bases cut
# to W; at the resident widths past 640 samples no gene has the 200 columns
# the default min_gene_len asks, so the kernel's own floors are lowered to
# TRIM_PHASE_FLOORS (min_gene_len, min_bins) and its rounds capped at
# TRIM_PHASE_ROUNDS for the shapes where rounds are to run
TRIM_PHASE = ((512, 704, 64, False), (256, 768, 64, True),
              (256, 1024, 64, True))
TRIM_PHASE_FLOORS = (8, 2)
TRIM_PHASE_ROUNDS = 4
# the block layout's bucket step with no round at 512 x 704 x 64 (PERF.md
# §6, row 3p-b), beside which the phased layout's light path is timed over
# TRIM_LIGHT_REPS calls (a call is host-bound: its wrapper and one read of
# a count on the card)
TRIM_LIGHT_MS = 0.149
TRIM_LIGHT_REPS = 50
TRIM_MODES = (("default", {}), ("trim_fast", dict(trim_fast=True)),
              ("nmf_tol", dict(nmf_tol=MODE_TOL)))


def check_trim_phase_at(F, lm, nmf_cfg, eng_cfg, lowered, modes=TRIM_MODES,
                        all_active=False, timed=True):
    """Kernel 3 past PCL_MAX_P on its phased layout against its plain
    version (``check_trim_at``) in each of ``modes``, each run twice more
    for the same bits (K, rho, ran_bs, rounds and iterations), every launch
    counted as a phased one.  ``lowered``: the kernel's own min_gene_len
    and min_bins at TRIM_PHASE_FLOORS and its rounds capped at
    TRIM_PHASE_ROUNDS, active0 recomputed with that min_gene_len (the
    loop's entry rule; ``all_active``: every gene that does not bail) and
    rounds must run; else no gene may enter, and the default mode's bucket
    step is timed over TRIM_LIGHT_REPS calls beside TRIM_LIGHT_MS (a
    light path that launched a round would take milliseconds: over ten
    times the limit fails).  Returns the records by mode."""
    import torch
    from degnorm_tpu_torch.core import baseline
    from degnorm_tpu_torch.ops import cuda_nmf, cuda_trim
    G, p, W = F.shape
    assert cuda_nmf.panel_phase(p, "loop") and cuda_nmf.kernels_supported(
        F.shape, torch.float32)
    plain_cfg = dataclasses.replace(eng_cfg, use_kernels=False)
    ti = baseline.trim_inputs(F, lm, nmf_cfg, plain_cfg)
    tkw = baseline.trim_kwargs(nmf_cfg, eng_cfg)
    if lowered:
        mgl, mb = TRIM_PHASE_FLOORS
        act = ~ti.bailed
        if not all_active:
            act &= ((ti.n_hi >= mgl) & (ti.rho0.amin(dim=1) <= 0.2)
                    & (ti.rho0.amax(dim=1) > 0.1))
        ti = ti._replace(active0=act)
        tkw = dict(tkw, min_gene_len=mgl, min_bins=mb,
                   max_rounds=TRIM_PHASE_ROUNDS)
    targs = (ti.Fm, ti.bin_id, ti.bin_count, ti.K0, ti.E0, ti.rho0, ti.u0,
             ti.n_hi, ti.n_bins0, ti.active0)
    n_ent = int(ti.active0.sum())
    what = f"trim_loop[panel,phase] {G}x{p}x{W}"
    if lowered and n_ent < max(1, G // 16):
        raise AssertionError(f"{what}: {n_ent} genes enter the rounds")
    if not lowered and n_ent:
        raise AssertionError(f"{what}: {n_ent} genes enter at the default "
                             "floors")
    slots = cuda_nmf.panel_slots(G, F.device)
    n0 = cuda_trim.trim_panel_phase_launches
    out = OrderedDict(entered=n_ent, slots=slots,
                      groups=-(-n_ent // slots), floors=(
                          list(TRIM_PHASE_FLOORS) if lowered else None),
                      max_rounds=tkw["max_rounds"])
    for name, mode in modes:
        rec = check_trim_at(ti, targs, tkw, nmf_cfg, timed and name ==
                            "default", time_reps=1 if lowered else 2, **mode)
        its = [torch.zeros(G, dtype=torch.int32, device=F.device)
               for _ in range(2)]
        a, b = (cuda_trim.trim_loop_cuda(*targs, iters_out=i, **tkw, **mode)
                for i in its)
        torch.cuda.synchronize()
        if not (all(torch.equal(x, y) for x, y in zip(a, b))
                and torch.equal(*its)):
            raise AssertionError(f"{what} ({name}): two runs differ")
        if lowered and not rec["mean_rounds"] > 0:
            raise AssertionError(f"{what} ({name}): no round ran: {rec}")
        rec["rounds_max"] = int(a[3].max())
        out[name] = rec
    if not lowered and timed:
        ms = time_ms(lambda: cuda_trim.trim_loop_cuda(*targs, **tkw),
                     TRIM_LIGHT_REPS)
        out["default"]["ms"] = ms
        out.update(light_ms=ms, light_reps=TRIM_LIGHT_REPS,
                   light_ms_limit=TRIM_LIGHT_MS,
                   light_within_limit=ms <= TRIM_LIGHT_MS)
        if ms > 10 * TRIM_LIGHT_MS:
            raise AssertionError(f"{what}: the bucket step with no round "
                                 f"took {ms:.4f} ms")
    launched = cuda_trim.trim_panel_phase_launches - n0
    if launched < 3 * len(modes):
        raise AssertionError(f"{what}: {launched} launches on the phased "
                             "layout")
    out["launches"] = launched
    return out


def short_lengths(n, rng):
    """Genes of 200-299 bases: cut to a resident width of 256 or 128."""
    return rng.integers(200, 300, n)


def resident_lengths(n, rng):
    """Genes of 50-64 bases: a bucket of W = 64 under PANEL_RES_WIDTHS."""
    return rng.integers(50, 65, n)


def stream_shapes(shapes, nmf_cfg):
    """Kernels 4 and 2 (``check_stream_at``) at each (G, p, W) of
    ``shapes``, on ``small_wide_bucket``'s data: each (p, W) one dataset made
    at its largest G, a smaller G its first genes.  Returns the records by
    shape, keyed GxpxW."""
    import torch
    from degnorm_tpu_torch import EngineConfig
    top_g, out, made = {}, OrderedDict(), {}
    for G_s, p_s, W_s in shapes:
        top_g[p_s, W_s] = max(G_s, top_g.get((p_s, W_s), 0))
    for G_s, p_s, W_s in shapes:
        if (p_s, W_s) not in made:
            made = {(p_s, W_s): small_wide_bucket(top_g[p_s, W_s], p_s, W_s,
                                                  SEED + p_s,
                                                  torch.device(DEVICE))}
        raw_t, lm_t = made[p_s, W_s]
        raw, lm = raw_t[:G_s].contiguous(), lm_t[:G_s].contiguous()
        out[f"{G_s}x{p_s}x{W_s}"] = check_stream_at(
            raw, lm, nmf_cfg, EngineConfig(), reps=1, time_f32=False)
        del raw, lm, raw_t, lm_t
        torch.cuda.empty_cache()
    return out


def phase_panels():
    """Studies of more than 128 samples (the panel instance of kernels 1-4,
    csrc/panel.cuh).  Each panel instance against its plain version at phase
    kernels' tolerances, run twice for the same bits: kernels 1-3 and 2
    resident on PANEL_GENES genes at the shapes of PANEL_RESIDENT (the
    opt-in branches at 129 x 256, where the engine's gate lets them run),
    kernels 4 and 2 at G x p x 16384 for PANEL_STREAM (raw int16 + scale
    bit-equal to float32), every p on the first p samples of one dataset
    made at the largest; the edges of the cluster layout (PANEL_EDGE,
    PANEL_EDGE_STREAM) and PANEL_MULTI, with the branches and genes that
    run trim rounds on blocks of several pairs, on data of their own.  Then the narrow genes at p =
    PANEL_FIT_P with the default bucket widths (W = 256 resident, the rest
    streamed) held to ``compare_fits`` against use_kernels=False on its
    first PARITY genes, and their first genes and samples (p =
    PANEL_MODE_P) under each opt-in mode (the branches on a fit's path);
    then PANEL_BIG_GENES narrow genes at p = PANEL_BIG_P with the default
    widths (every bucket streams: kernels 2 and 4 on their cluster layout,
    every launch counted there), with a kernels-off parity pair on its
    first PANEL_BIG_PARITY genes; and the clusters the card holds at
    once by blocks a cluster.  Past the cluster layout, kernels 4 and 2 on
    their phased layout at PANEL_PHASE_STREAM, and PANEL_PHASE_GENES narrow
    genes at p = PANEL_PHASE_P (every launch of kernels 2 and 4 on the
    phased layout, counted apart), profiled, with a kernels-off parity pair
    on its first PANEL_PHASE_PARITY genes.  Past its own cut, kernel 1 on
    the phased layout at PANEL_NMF_PHASE in both branches
    (``check_nmf_phase_at``), kernel 3 on it at TRIM_PHASE in every mode
    (``check_trim_phase_at``: its light path where no gene enters, rounds
    with its floors lowered), both on the main path's own bucket, and the
    slice's main path: PANEL_RES_GENES
    genes of 50-64 bases at p = PANEL_RES_P, resident at W = 64 (kernel 1
    phased, counted apart), profiled, with a kernels-off parity pair on its
    first PANEL_RES_PARITY genes (``panel_resident_fit``).  No p > 128 may
    reach a plain version: every fit must launch the panel instances.
    Returns the kernels' records and the launches of each instance on its
    fit."""
    import torch
    from degnorm_tpu_torch import EngineConfig, NMFConfig
    from degnorm_tpu_torch.config import trim_fast_applies
    from degnorm_tpu_torch.ops import cuda_nmf
    from degnorm_tpu_torch.ops.build import get_lib
    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    nmf_cfg = NMFConfig(nmf_iter=NMF_ITER)
    eng_cfg = EngineConfig(bucket_widths=BUCKET_WIDTHS)
    rng = np.random.default_rng(SEED + 13)
    kres = {"resident": OrderedDict(), "stream": OrderedDict()}
    secs = {}

    t0 = time.perf_counter()
    top = max(p for p, _, _ in PANEL_RESIDENT)
    base = list(synth_dataset(PANEL_GENES, top, seed=SEED + top,
                              lengths_fn=short_lengths)[0].values())
    for p, W, branches in PANEL_RESIDENT:
        F, lm, raw = resident_bucket(PANEL_GENES, p, W, dev, rng, mats=base)
        assert cuda_nmf.kernels_supported(F.shape, torch.float32)
        assert cuda_nmf.instance_of(p) == "panel"
        assert branches == trim_fast_applies(F.shape)
        keep = {}
        rec = check_kernels_at(F, lm, nmf_cfg, eng_cfg, raw,
                               branches=branches, keep=keep)
        rec["same_bits"] = wide_same_bits(keep, raw, lm, eng_cfg, branches,
                                          tag="panel")
        kres["resident"][f"p{p}_W{W}"] = rec
        del F, lm, raw, keep, rec
        torch.cuda.empty_cache()
    del base
    secs["resident"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    G_top = max(g for g, _ in PANEL_STREAM)
    p_top = max(p for _, p in PANEL_STREAM)
    raw_top, lm_top = small_wide_bucket(G_top, p_top, PANEL_STREAM_W,
                                        SEED + p_top, dev)
    for G, p in PANEL_STREAM:
        raw = raw_top[:G, :p].contiguous()
        # (one timed launch, no float32 timing: a launch is 0.6-2.4 s)
        kres["stream"][f"p{p}_W{PANEL_STREAM_W}"] = check_stream_at(
            raw, lm_top[:G], nmf_cfg, EngineConfig(), reps=1, time_f32=False)
        del raw
        torch.cuda.empty_cache()
    del raw_top, lm_top
    secs["stream"] = time.perf_counter() - t0

    # the cluster layout's edges
    t0 = time.perf_counter()
    assert [cuda_nmf.panel_cluster(p, "loop")
            for p, _ in PANEL_EDGE] == [True, False]
    p_top = max(p for p, _ in PANEL_EDGE)
    edge = list(synth_dataset(PANEL_GENES, p_top, seed=SEED + p_top,
                              lengths_fn=short_lengths)[0].values())
    for p_e, W_e in PANEL_EDGE:
        F, lm, raw = resident_bucket(PANEL_GENES, p_e, W_e, dev, rng,
                                     mats=edge)
        keep = {}
        rec = check_kernels_at(F, lm, nmf_cfg, eng_cfg, raw, branches=False,
                               keep=keep)
        rec["same_bits"] = wide_same_bits(keep, raw, lm, eng_cfg, False,
                                          tag="panel")
        kres["resident"][f"p{p_e}_W{W_e}"] = rec
        del F, lm, raw, keep, rec
    p_b, W_b = PANEL_MULTI
    assert (cuda_nmf.panel_cluster(p_b, "loop") and cuda_nmf.pcl_held(p_b) > 1
            and p_b * W_b <= cuda_nmf.MAX_PW)
    F, lm, raw = resident_bucket(PANEL_GENES, p_b, W_b, dev, rng, mats=edge)
    keep = {}
    rec = check_kernels_at(F, lm, nmf_cfg, eng_cfg, raw, branches=True,
                           keep=keep)
    rec["same_bits"] = wide_same_bits(keep, raw, lm, eng_cfg, True,
                                      tag="panel")
    # the check is not vacuous: genes ran trim rounds in every mode
    for k in ("trim_loop", "trim_loop[trim_fast]", "trim_loop[nmf_tol]"):
        if not (rec[k]["entered"] > 0 and rec[k]["mean_rounds"] > 0):
            raise AssertionError(f"panels p{p_b}_W{W_b} {k}: no gene ran a "
                                 f"trim round: {rec[k]}")
    kres["resident"][f"p{p_b}_W{W_b}"] = rec
    del edge, F, lm, raw, keep, rec
    assert all(cuda_nmf.panel_cluster(p, "stream")
               for _, p, _ in PANEL_EDGE_STREAM)
    kres["stream"].update(stream_shapes(PANEL_EDGE_STREAM, nmf_cfg))
    # the clusters the card holds at once, by blocks a cluster
    lib = get_lib()
    kres["clusters"] = {
        str(p): {"blocks": cuda_nmf.pcl_size(p),
                 "nmf_streamed": lib.dn_stream_panel_clusters(p, 1),
                 "ratio_rowsums": lib.dn_ratio_panel_clusters(p, 1)}
        for p in (256, 384, 640, 768, 896, 1024, 1152)}
    secs["edge"] = time.perf_counter() - t0

    # past the cluster layout: the phased layout
    t0 = time.perf_counter()
    assert all(cuda_nmf.panel_phase(p) for _, p, _ in PANEL_PHASE_STREAM)
    kres["phase"] = stream_shapes(PANEL_PHASE_STREAM, nmf_cfg)
    secs["phase_shapes"] = time.perf_counter() - t0
    # ... and kernel 1 past its own, both branches
    t0 = time.perf_counter()
    p_top = max(p for p, _ in PANEL_NMF_PHASE)
    mats = list(synth_dataset(PANEL_GENES, p_top, seed=SEED + p_top,
                              lengths_fn=short_lengths)[0].values())
    kres["nmf_phase"] = OrderedDict()
    for p_e, W_e in PANEL_NMF_PHASE:
        F, lm, _ = resident_bucket(PANEL_GENES, p_e, W_e, dev, rng, mats=mats)
        kres["nmf_phase"][f"{PANEL_GENES}x{p_e}x{W_e}"] = check_nmf_phase_at(
            F, lm, nmf_cfg, eng_cfg)
        del F, lm
        torch.cuda.empty_cache()
    secs["nmf_phase_shapes"] = time.perf_counter() - t0
    del mats
    # ... and kernel 3 past its own, every mode, with and without rounds
    # (one dataset made at the largest p and G)
    t0 = time.perf_counter()
    kres["trim_phase"] = OrderedDict()
    p_top = max(p for _, p, _, _ in TRIM_PHASE)
    mats = list(synth_dataset(max(g for g, _, _, _ in TRIM_PHASE), p_top,
                              seed=SEED + p_top,
                              lengths_fn=short_lengths)[0].values())
    for G_e, p_e, W_e, lowered in TRIM_PHASE:
        F, lm, _ = resident_bucket(G_e, p_e, W_e, dev, rng, mats=mats)
        kres["trim_phase"][f"{G_e}x{p_e}x{W_e}"] = check_trim_phase_at(
            F, lm, nmf_cfg, eng_cfg, lowered)
        del F, lm
        torch.cuda.empty_cache()
    del mats
    secs["trim_phase_shapes"] = time.perf_counter() - t0

    # the narrow genes at p = PANEL_FIT_P with the default bucket widths
    t0 = time.perf_counter()
    runs = {}
    cov_f, X_f = synth_dataset(PANEL_FIT_GENES, PANEL_FIT_P)
    secs["fit_data"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nmf_f = NMFConfig(nmf_iter=NMF_ITER, degnorm_iter=PANEL_ITER)
    _, runs["fit"], eng_f = wide_fit("panel_fit", cov_f, X_f, nmf_f,
                                     EngineConfig(), steady=False)
    resident = sorted(b.width for b in eng_f._buckets
                      if cuda_nmf.kernels_supported(b.F.shape, torch.float32))
    need = ("ratio_rowsums[panel]", "nmf_masked[panel]", "trim_loop[panel]",
            "nmf_streamed[panel]")
    if resident != [256] or any(runs["fit"]["launches"].get(k, 0) < 1
                                for k in need):
        raise AssertionError(f"panels fit: resident widths {resident}, "
                             f"launches {runs['fit']['launches']}")
    del eng_f
    torch.cuda.empty_cache()
    keys = list(cov_f)[:PANEL_PARITY_GENES]
    sub = OrderedDict((k, cov_f[k]) for k in keys)
    Xs = X_f[:PANEL_PARITY_GENES]
    # (its device time by kernel: one more run of it under the profiler)
    on, runs["parity_on"], _ = wide_fit("panel_parity_on", sub, Xs, nmf_f,
                                        EngineConfig(), steady=False,
                                        profile=True)
    t2 = time.perf_counter()
    off, _, _ = wide_fit("panel_parity_off", sub, Xs, nmf_f,
                         EngineConfig(use_kernels=False), steady=False)
    compare_fits("panels_parity", on, off,
                 (runs["parity_on"]["wall_s"], time.perf_counter() - t2),
                 samples=PANEL_FIT_P)
    del sub, on, off
    secs["fit"] = time.perf_counter() - t0

    # the narrow genes at p = PANEL_BIG_P, where every bucket streams
    # (kernels 2 and 4 on clusters of six blocks), and a kernels-off parity
    # pair on its first genes
    t0 = time.perf_counter()
    assert (cuda_nmf.panel_cluster(PANEL_BIG_P, "stream")
            and not cuda_nmf.panel_cluster(PANEL_BIG_P, "loop"))
    cov_b, X_b = synth_dataset(PANEL_BIG_GENES, PANEL_BIG_P)
    secs["big_data"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, runs["big"], eng_b = wide_fit("panel_big", cov_b, X_b, nmf_f,
                                     EngineConfig(), steady=False)
    counts = runs["big"]["launches"]
    resident = [b.width for b in eng_b._buckets
                if cuda_nmf.kernels_supported(b.F.shape, torch.float32)]
    if (resident or counts.get("nmf_masked", 0) or counts.get("trim_loop", 0)
            or not 0 < counts.get("ratio_rowsums[panel]", 0)
            == counts.get("ratio_rowsums[panel,cluster]", 0)
            or not 0 < counts.get("nmf_streamed[panel]", 0)
            == counts.get("nmf_streamed[panel,cluster]", 0)):
        raise AssertionError(f"panels big fit: resident widths {resident}, "
                             f"launches {counts}")
    del eng_b
    torch.cuda.empty_cache()
    secs["big"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    keys = list(cov_b)[:PANEL_BIG_PARITY]
    sub = OrderedDict((k, cov_b[k]) for k in keys)
    Xs = X_b[:PANEL_BIG_PARITY]
    on, runs["big_parity_on"], _ = wide_fit(
        "panel_big_parity_on", sub, Xs, nmf_f, EngineConfig(), steady=False)
    t2 = time.perf_counter()
    off, _, _ = wide_fit("panel_big_parity_off", sub, Xs, nmf_f,
                         EngineConfig(use_kernels=False), steady=False)
    compare_fits("panels_big_parity", on, off,
                 (runs["big_parity_on"]["wall_s"], time.perf_counter() - t2),
                 samples=PANEL_BIG_P)
    del cov_b, X_b, sub, on, off
    secs["big_parity"] = time.perf_counter() - t0

    # their first genes and samples under each opt-in mode: the branches on
    # a fit's path
    t0 = time.perf_counter()
    cov_m = OrderedDict((k, cov_f[k][:PANEL_MODE_P])
                        for k in list(cov_f)[:PANEL_MODE_GENES])
    X_m = X_f[:PANEL_MODE_GENES, :PANEL_MODE_P]
    for mode, kw in MODES:
        _, runs[mode], _ = wide_fit(
            f"panel_{mode}", cov_m, X_m, nmf_f, EngineConfig(**kw),
            steady=False)
    del cov_f, X_f, cov_m, X_m
    secs["modes"] = time.perf_counter() - t0

    # the main path past 1,152 samples, and kernel 1's past 640
    panel_phase_fit(nmf_f, runs, secs)
    bucket = panel_resident_fit(nmf_f, runs, secs, nmf_cfg, eng_cfg)
    kres["trim_phase"][f"{PANEL_RES_GENES}x{PANEL_RES_P}x64"] = bucket.pop(
        "trim_phase")
    kres["nmf_phase"][f"{PANEL_RES_GENES}x{PANEL_RES_P}x64"] = bucket

    # every launch at p > 128 went to a panel instance, and each instance
    # ran on its fit
    for tag, r in runs.items():
        counts = r["launches"]
        for k in ("nmf_masked", "ratio_rowsums", "trim_loop", "nmf_streamed"):
            if counts.get(k, 0) != counts.get(f"{k}[panel]", 0):
                raise AssertionError(f"panels {tag}: {k} launched outside "
                                     f"the panel instance: {counts}")
    launches = {name: runs[where]["launches"].get(name, 0)
                for name, (_, _, where) in PANEL_INSTANCES.items()}
    if not all(launches.values()):
        raise AssertionError(f"panels: an instance never launched on its "
                             f"fit: {launches}")
    emit("panels", nmf_iter=NMF_ITER, degnorm_iter=PANEL_ITER,
         degnorm_iter_cut=PANEL_ITER < DEGNORM_ITER,
         tolerance="as phase kernels; each instance run twice: the same bits",
         kernels=kres, fits=runs, instance_launches=launches,
         seconds={k: round(v, 2) for k, v in secs.items()},
         phase_seconds=round(time.perf_counter() - t_phase, 1))
    return kres, launches


def panel_phase_fit(nmf_f, runs, secs):
    """The slice's main path past 1,152 samples: PANEL_PHASE_GENES narrow
    genes at p = PANEL_PHASE_P with the default widths (every bucket
    streams: every launch of kernels 2 and 4 on the phased layout, counted
    apart), profiled, and a kernels-off parity pair on its first
    PANEL_PHASE_PARITY genes.  Adds its records to ``runs`` and its
    seconds to ``secs``."""
    import torch
    from degnorm_tpu_torch import EngineConfig
    from degnorm_tpu_torch.ops import cuda_nmf
    t0 = time.perf_counter()
    assert cuda_nmf.panel_phase(PANEL_PHASE_P)
    cov_p, X_p = synth_dataset(PANEL_PHASE_GENES, PANEL_PHASE_P)
    secs["phase_data"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, runs["phase"], eng_p = wide_fit("panel_phase", cov_p, X_p, nmf_f,
                                       EngineConfig(), steady=False,
                                       profile=True)
    counts = runs["phase"]["launches"]
    resident = [b.width for b in eng_p._buckets
                if cuda_nmf.kernels_supported(b.F.shape, torch.float32)]
    if (resident or counts.get("nmf_masked", 0) or counts.get("trim_loop", 0)
            or not 0 < counts.get("ratio_rowsums[panel]", 0)
            == counts.get("ratio_rowsums[panel,phase]", 0)
            or not 0 < counts.get("nmf_streamed[panel]", 0)
            == counts.get("nmf_streamed[panel,phase]", 0)):
        raise AssertionError(f"panels phase fit: resident widths {resident}, "
                             f"launches {counts}")
    del eng_p
    torch.cuda.empty_cache()
    secs["phase"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    keys = list(cov_p)[:PANEL_PHASE_PARITY]
    sub = OrderedDict((k, cov_p[k]) for k in keys)
    Xs = X_p[:PANEL_PHASE_PARITY]
    on, runs["phase_parity_on"], _ = wide_fit(
        "panel_phase_parity_on", sub, Xs, nmf_f, EngineConfig(), steady=False)
    t2 = time.perf_counter()
    off, _, _ = wide_fit("panel_phase_parity_off", sub, Xs, nmf_f,
                         EngineConfig(use_kernels=False), steady=False)
    compare_fits("panels_phase_parity", on, off,
                 (runs["phase_parity_on"]["wall_s"],
                  time.perf_counter() - t2), samples=PANEL_PHASE_P)
    del cov_p, X_p, sub, on, off
    secs["phase_parity"] = time.perf_counter() - t0


def panel_resident_fit(nmf_f, runs, secs, nmf_cfg, eng_cfg):
    """The slice's main path for kernel 1 past 640 samples:
    PANEL_RES_GENES genes of 50-64 bases at p = PANEL_RES_P with
    PANEL_RES_WIDTHS (one bucket, W = 64, resident: kernel 2 on its cluster
    layout, kernels 1 and 3 on the phased layout, counted apart; with the
    default min_gene_len no gene enters the trim rounds), profiled, and a
    kernels-off parity pair on its first PANEL_RES_PARITY genes.  First,
    kernels 1 and 3 on the fit's bucket (these genes at W = 64, every gene
    that does not bail active: groups of the phased layout one after
    another; kernel 3 with its floors lowered, so that rounds run) by
    ``check_nmf_phase_at`` and ``check_trim_phase_at`` under ``nmf_cfg``
    and ``eng_cfg``.  Adds its records to ``runs`` and its seconds to
    ``secs``; returns the bucket's record (kernel 3's under
    "trim_phase")."""
    import torch
    from degnorm_tpu_torch import EngineConfig
    from degnorm_tpu_torch.ops import cuda_nmf
    t0 = time.perf_counter()
    assert (cuda_nmf.panel_phase(PANEL_RES_P, "nmf")
            and cuda_nmf.panel_cluster(PANEL_RES_P, "stream"))
    cov_r, X_r = synth_dataset(PANEL_RES_GENES, PANEL_RES_P,
                               lengths_fn=resident_lengths)
    secs["resident768_data"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    F = np.zeros((PANEL_RES_GENES, PANEL_RES_P, 64), np.float32)
    lens = np.zeros(PANEL_RES_GENES, np.int64)
    for i, m in enumerate(cov_r.values()):
        F[i, :, :m.shape[1]] = m
        lens[i] = m.shape[1]
    dev = torch.device(DEVICE)
    lm = torch.from_numpy(np.arange(64)[None, :] < lens[:, None]).to(dev)
    F = torch.from_numpy(F).to(dev)
    bucket = check_nmf_phase_at(F, lm, nmf_cfg, eng_cfg, all_active=True)
    # ... and kernel 3 on it, its floors lowered, every gene that does not
    # bail active: rounds run in groups one after another on reused slots
    bucket["trim_phase"] = check_trim_phase_at(
        F, lm, nmf_cfg, eng_cfg, True, modes=TRIM_MODES[:1], all_active=True)
    del F, lm
    torch.cuda.empty_cache()
    secs["resident768_bucket"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng_r = EngineConfig(bucket_widths=PANEL_RES_WIDTHS)
    _, runs["resident768"], eng = wide_fit(
        "panel_resident768", cov_r, X_r, nmf_f, eng_r, steady=False,
        profile=True, need_bs=False)
    counts = runs["resident768"]["launches"]
    resident = sorted(b.width for b in eng._buckets
                      if cuda_nmf.kernels_supported(b.F.shape, torch.float32))
    if (resident != [64] or counts.get("nmf_streamed", 0)
            or not 0 < counts.get("nmf_masked[panel,phase]", 0)
            == counts.get("nmf_masked", 0)
            or not 0 < counts.get("ratio_rowsums[panel,cluster]", 0)
            == counts.get("ratio_rowsums", 0)
            or not 0 < counts.get("trim_loop[panel,phase]", 0)
            == counts.get("trim_loop", 0)):
        raise AssertionError(f"panels resident768 fit: resident widths "
                             f"{resident}, launches {counts}")
    del eng
    torch.cuda.empty_cache()
    secs["resident768"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    keys = list(cov_r)[:PANEL_RES_PARITY]
    sub = OrderedDict((k, cov_r[k]) for k in keys)
    Xs = X_r[:PANEL_RES_PARITY]
    on, runs["resident768_parity_on"], _ = wide_fit(
        "panel_resident768_parity_on", sub, Xs, nmf_f, eng_r, steady=False,
        need_bs=False)
    t2 = time.perf_counter()
    off, _, _ = wide_fit("panel_resident768_parity_off", sub, Xs, nmf_f,
                         dataclasses.replace(eng_r, use_kernels=False),
                         steady=False, need_bs=False)
    compare_fits("panels_resident768_parity", on, off,
                 (runs["resident768_parity_on"]["wall_s"],
                  time.perf_counter() - t2), samples=PANEL_RES_P)
    del cov_r, X_r, sub, on, off
    secs["resident768_parity"] = time.perf_counter() - t0
    return bucket


def panel_kernel_records(panels):
    """The result line's records of the panel instances: each at its main
    shape (kernels 1 and 3 at PANEL_GENES x 256 x 256, the branches at 129
    x 256, kernels 4 and 2 at PANEL_BIG_MAIN, a full bucket at the main
    path's p, and on their phased layout at PANEL_PHASE_MAIN), with every
    shape it was held at beside it and its launches on its fit (kernels 4
    and 2: the p = PANEL_BIG_P fit, and the p = PANEL_PHASE_P one for their
    phased layout)."""
    kres, launches = panels
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")
    big = "x".join(map(str, PANEL_BIG_MAIN))
    out = []
    for name, (src, repl, _) in PANEL_INSTANCES.items():
        if name == "nmf_masked[panel,phase]":
            recs = dict(kres["nmf_phase"])
            main = f"{PANEL_GENES}x{PANEL_RES_P}x64"
        elif name == "trim_loop[panel,phase]":
            # every mode at every shape; the main one the default mode's
            # bucket step where no gene enters (the p = 768 fit's case)
            recs = {f"{k}[{mode}]": r[mode]
                    for k, r in kres["trim_phase"].items()
                    for mode, _ in TRIM_MODES if mode in r}
            main = "x".join(map(str, TRIM_PHASE[0][:3])) + "[default]"
        elif name.endswith(",phase]"):
            recs = (dict(kres["phase"]) if name.startswith("nmf_streamed")
                    else {k: r["ratio_rowsums"]
                          for k, r in kres["phase"].items()})
            main = "x".join(map(str, PANEL_PHASE_MAIN))
        elif name == "nmf_streamed[panel]":
            recs = dict(kres["stream"])
            main = big
        else:
            key = WIDE_CHECK_KEY[name.replace("panel", "wide")]
            recs = {k: r[key] for k, r in kres["resident"].items()
                    if key in r}
            if key == "ratio_rowsums":   # also at kernel 4's shapes
                recs.update((k, r["ratio_rowsums"])
                            for k, r in kres["stream"].items())
            main = ("p129_W256" if "," in name
                    else big if key == "ratio_rowsums"
                    else f"p{PANEL_FIT_P}_W256")
        m = recs[main]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "shape": main,
            "by_shape": {k: {f: r[f] for f in keys if f in r}
                         for k, r in recs.items()}})
    return out


def kernels_line(kres, launches, launches_wide, launches_pipeline,
                 launches_modes, seqpar):
    """The per-kernel records of the result line: kernels 1-3 at the narrow
    fit's main shape (W=1024) with the W=4096 one beside it, kernel 4 at the
    wide fit's W=16384 bucket with its other shapes beside it, then the
    opt-in branches of kernels 1 and 3 at the narrow shapes, each beside its
    kernel's default-mode time, with its launches in its mode's fit (phase
    ``modes``), then kernels 4c and 2c at the long tail's W=65536 bucket cut
    in two (p=8) with their other shapes beside it, with their launches in
    the long tail's column-sharded fit (phase ``seqpar``)."""
    main_shape = kres[1024]
    replaces = {
        "nmf_masked": "degnorm_tpu/ops/pallas_nmf.py:687",
        "ratio_rowsums": "degnorm_tpu/ops/pallas_nmf.py:562",
        "trim_loop": "degnorm_tpu/ops/pallas_trim.py:324",
        "nmf_streamed": "degnorm_tpu/ops/pallas_stream.py:266",
    }
    source = {
        "nmf_masked": "degnorm_tpu_torch/csrc/nmf.cu",
        "ratio_rowsums": "degnorm_tpu_torch/csrc/ratio.cu",
        "trim_loop": "degnorm_tpu_torch/csrc/trim.cu",
        "nmf_streamed": "degnorm_tpu_torch/csrc/stream.cuh",
    }
    kernels = []
    extra_keys = {
        "nmf_masked": ("geometry",),
        "ratio_rowsums": ("input", "geometry", "f32_input_ms",
                          "torch_sum_i16_ms", "bound_full_ms", "f32_bound_ms"),
        "trim_loop": ()}
    for name in ("nmf_masked", "ratio_rowsums", "trim_loop"):
        m, wide = main_shape[name], kres[4096][name]
        extra = {k: m[k] for k in extra_keys[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(m["max_abs_err"], wide["max_abs_err"]),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None,
            "shape": main_shape["shape"], **extra,
            **({"bound_note": TRIM_BOUND_NOTE} if name == "trim_loop" else {}),
            "wide": {"shape": kres[4096]["shape"], "ms": wide["ms"],
                     "plain_ms": wide["plain_ms"],
                     "bound_ms": wide["bound_ms"],
                     "bound_by": wide["bound_by"],
                     **{k: wide[k] for k in extra_keys[name]}},
            **{f"p{q}": {k: kres[f"p{q}_W1024"][name][k]
                         for k in ("shape", "ms", "plain_ms", "bound_ms",
                                   "max_abs_err")
                         if k in kres[f"p{q}_W1024"][name]}
               for q in TIMED_WIDE_P},
            "launches_fit_wide": launches_wide[name],
            "launches_pipeline": launches_pipeline[name],
        })
    # kernel 2 also runs on the wide buckets (initialisation of fit_wide)
    kernels[1]["fit_wide_shapes"] = [kres[f"stream_{w}"]["ratio_rowsums"]
                                     for w in WIDE_WIDTHS]
    keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "f32_input_ms", "geometry")
    m = kres[f"stream_{WIDE_WIDTHS[0]}"]
    kernels.append({
        "name": "nmf_streamed", "route": "cuda",
        "source": source["nmf_streamed"], "replaces": replaces["nmf_streamed"],
        # its main path is fit_wide: counts set to 0 just before that fit
        "launches": launches_wide["nmf_streamed"],
        "launches_fit": launches.get("nmf_streamed", 0),
        "launches_pipeline": launches_pipeline["nmf_streamed"],
        "max_abs_err": max(v["max_abs_err"] for k, v in kres.items()
                           if str(k).startswith("stream_")),
        "max_rel_err": max(v["max_rel_err"] for k, v in kres.items()
                           if str(k).startswith("stream_")),
        "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": None, "shape": m["shape"],
        "input": "raw int16 + scale",
        "other_shapes": [{k: v[k] for k in keys} for name_, v in kres.items()
                         if str(name_).startswith("stream_")
                         and name_ != f"stream_{WIDE_WIDTHS[0]}"],
    })
    for name, (kernel, mode, src, repl) in BRANCHES.items():
        m, wide = main_shape[name], kres[4096][name]
        mode_name = next(k for k, v in MODES if any(v.get(x) == y
                                                      for x, y in mode.items()))
        extra = ("n_it",) if "trim_fast" in mode else (
            ("mean_iters", "genes_frozen_early") if kernel == "nmf_masked"
            else ("lagrangian_iters",))
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "mode": mode, "launches": launches_modes[mode_name][name],
            "max_abs_err": max(m["max_abs_err"], wide["max_abs_err"]),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            "shape": main_shape["shape"],
            "default_ms": main_shape[kernel]["ms"],
            "default_bound_ms": main_shape[kernel]["bound_ms"],
            **{k: m[k] for k in extra},
            **({"freeze": m["freeze"]} if "freeze" in m else {}),
            **{f"p{q}": {k: kres[f"p{q}_W1024"][name][k]
                         for k in ("ms", "plain_ms", "bound_ms",
                                   "max_abs_err")}
               for q in TIMED_WIDE_P},
            "wide": {"shape": kres[4096]["shape"], "ms": wide["ms"],
                     "plain_ms": wide["plain_ms"], "bound_ms": wide["bound_ms"],
                     "bound_by": wide["bound_by"],
                     "default_ms": kres[4096][kernel]["ms"],
                     **{k: wide[k] for k in extra}},
        })
    col_kres, long_tail = seqpar
    for name, src, whole in (
            ("nmf_colsharded", "degnorm_tpu_torch/csrc/stream_cols.cuh",
             "kernel4_whole_ms"),
            ("ratio_colsharded", "degnorm_tpu_torch/csrc/ratio_cols.cu",
             "kernel2_whole_ms")):
        m = col_kres[f"p{P_SAMPLES}"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": "degnorm_tpu/engine.py:75-84 (none: XLA under GSPMD)",
            # its main path is the long tail's column-sharded fit
            "launches": long_tail["launches"][name],
            "max_abs_err": max(v[name]["max_abs_err"]
                               for v in col_kres.values()),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            "shape": m["shape"], "shards": MESH_SHARDS,
            "geometry": m["geometry"], "whole_gene_kernel_ms": m[whole],
            **({"nmf_tol": m["nmf_tol"]} if m.get("nmf_tol") else {}),
            "other_shapes": [{"at": k, **{f: v[name][f] for f in (
                "shape", "geometry", "ms", "plain_ms", "bound_ms",
                "bound_by", "max_abs_err")}}
                for k, v in col_kres.items() if k != f"p{P_SAMPLES}"],
        })
    return kernels


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated phases; opt-in: "
                         + ",".join(OPT_IN_PHASES))
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="time kernels 1-4 and 4c over their launch "
                         "geometries, the wide kernel 4 over blocks a gene "
                         "(phases env, build, fit_wide, then the sweep; no "
                         "result line)")
    args = ap.parse_args(argv)
    phases = [s for s in args.phases.split(",") if s]
    if args.sweep:
        phases = ["env", "build", "fit_wide"]
    for ph, needs in NEEDS.items():
        if ph in phases and set(needs) - set(phases):
            ap.error(f"phase {ph} needs phases {', '.join(needs)}")

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
    walls = OrderedDict()       # seconds of each phase, for the total line
    t_last = [t_start]

    def lap(phase):
        now = time.perf_counter()
        if phase in phases or phase == "data":
            walls[phase] = round(now - t_last[0], 1)
        t_last[0] = now

    smi = phase_env() if "env" in phases else smi_line()
    if "build" in phases:
        phase_build(args.ptxas)
    lap("build")
    t0 = time.perf_counter()
    cov, X = synth_dataset(N_GENES, P_SAMPLES)
    emit("data", seconds=round(time.perf_counter() - t0, 2), genes=N_GENES,
         samples=P_SAMPLES, seed=SEED, profile="dense")
    cov_wide = X_wide = None
    if {"kernels", "fit_wide", "parity", "pipeline", "upload",
            "mesh", "seqpar", "multihost"} & set(phases):
        t0 = time.perf_counter()
        cov_wide, X_wide = synth_dataset(WIDE_GENES, P_SAMPLES, seed=SEED + 1,
                                         lengths_fn=synth_long_lengths)
        lens = np.array([m.shape[1] for m in cov_wide.values()])
        emit("data_wide", seconds=round(time.perf_counter() - t0, 2),
             genes=WIDE_GENES, samples=P_SAMPLES, seed=SEED + 1,
             profile="dense", min_len=int(lens.min()), max_len=int(lens.max()),
             per_width=[int((lens <= WIDE_WIDTHS[0]).sum()),
                        int((lens > WIDE_WIDTHS[0]).sum())],
             host_bytes=int(sum(m.nbytes for m in cov_wide.values())))
    lap("data")
    kres = phase_kernels(cov, cov_wide) if "kernels" in phases else None
    lap("kernels")
    launches, base_fit, base_steady_s, base_timings = (
        phase_fit(cov, X) if "fit" in phases else (None,) * 4)
    lap("fit")
    launches_wide, wide_fit, wide_steady_s = (
        phase_fit_wide(cov_wide, X_wide) if "fit_wide" in phases
        else (None,) * 3)
    lap("fit_wide")
    if "parity" in phases:
        phase_parity(cov, X, cov_wide, X_wide)
    lap("parity")
    keep_cold = "multihost" in phases
    launches_pipeline, cold = (
        phase_pipeline(cov, X, cov_wide, X_wide, keep_cold=keep_cold)
        if "pipeline" in phases else (None, None))
    lap("pipeline")
    mesh_long_tail = seqpar = None
    try:
        if "mesh" in phases:
            mesh_long_tail = phase_mesh(cov, X, cov_wide, X_wide, {
                "narrow": (base_fit, base_steady_s, launches),
                "long_tail": (wide_fit, wide_steady_s, launches_wide)})
        lap("mesh")
        if "seqpar" in phases:
            seqpar = phase_seqpar(
                cov_wide, X_wide,
                ((wide_fit, wide_steady_s, launches_wide)
                 if "fit_wide" in phases else None), mesh_long_tail)
        lap("seqpar")
        if "multihost" in phases:
            phase_multihost(cov, X, base_fit, base_steady_s, base_timings,
                            cold, cov_wide, X_wide, wide_fit)
        lap("multihost")
    finally:
        if keep_cold:
            import shutil
            shutil.rmtree(PIPE_DIR, ignore_errors=True)
    launches_modes = (phase_modes(cov, X, base_fit, base_steady_s)
                      if "modes" in phases else None)
    lap("modes")
    if "oracle" in phases:
        phase_oracle()
    lap("oracle")
    wide = phase_wide_p() if "wide_p" in phases else None
    lap("wide_p")
    panels = phase_panels() if "panels" in phases else None
    lap("panels")
    if "upload" in phases:
        phase_upload(cov, cov_wide)
    if args.sweep:
        phase_sweep(cov, cov_wide)
    if set(ALL_PHASES) - set(phases):
        print(json.dumps({"ok": False, "partial": phases}))
        return 0

    kernels = (kernels_line(kres, launches, launches_wide, launches_pipeline,
                            launches_modes, seqpar) + wide_kernel_records(wide)
               + cols_wide_records(seqpar, wide)
               + panel_kernel_records(panels))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"phase": "total",
                      "seconds": round(time.perf_counter() - t_start, 1),
                      "by_phase": walls}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
