"""PyTorch port, studies of more than 32 samples: the wide instances of
kernels 1-4 (csrc/wide.cuh, 33 to 128 samples), their panel instance
(csrc/panel.cuh, more than 128) and their dispatch, the route of wide
buckets through the engine, the port against the JAX engine at p = 40, 64
and 160, and ``EngineConfig.device_loop``.

On the CPU every wrapper takes its plain version, so what the kernels
compute is checked on the card (``chip_smoke.py`` phase ``wide_p``); here
the launch rules, the shared-memory sizing mirror, the limits, the route by
shape and the engine's results.  Tolerances: PARITY.md's all-up ones (DI
atol 5e-3, adjusted counts rtol 5e-3, ran_baseline_selection exact) where
the two engines run different warm schemes or a kernel's interpret path;
1e-9 where they run the same float64 arithmetic.
"""
import os
import re
from collections import OrderedDict

import numpy as np
import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets it)
import pytest
import torch

from degnorm_tpu import engine as jengine
from degnorm_tpu.config import EngineConfig as JEng, NMFConfig as JNmf
from degnorm_tpu.core import degnorm as jd
from degnorm_tpu_torch import EngineConfig, NMFConfig, convert
from degnorm_tpu_torch import engine as tengine
from degnorm_tpu_torch.core import degnorm as td
from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream, cuda_trim
from degnorm_tpu_torch.parallel import make_mesh
from tests.torch_port_util import random_coverage

torch.set_num_threads(1)
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "degnorm_tpu_torch", "csrc")
SMEM_PER_BLOCK = 232448        # the H100's opt-in shared memory a block
INSTANCES = (4, 8, 16, 32, 48, 64, 96, 128)
WIDTHS = (512, 1024)
# p above the wide instances: the panel instance, one for every p
PANEL_P = (129, 160, 192, 255, 256, 257, 384, 512, 1000)


WIDE_TC = 64                   # columns of a wide instance's tile


# the largest PMAX whose streamed genes take the pipelined sweep (with its
# copy stage; WideStreamSrc::PIPE of csrc/stream_wide.cuh), and whose copy
# stage has two slots (WideShape::NST of csrc/wide.cuh)
PIPE_MAX, NST2_MAX = 96, 48


def stage_slots(P):
    """Slots of a wide instance's copy stage (``WideShape::NST``)."""
    return 2 if P <= NST2_MAX else 1


def wide_work_bytes(p):
    """Shared memory of a wide instance's core (mirror of
    ``wide_work_floats`` in csrc/wide.cuh): the two tile buffers and the
    Gram B, rows of PMAX + 4 floats, the v partials, five p-vectors, 32
    floats, eight flags and the copy stage (a slot: PMAX x 64 floats of X
    and of A0)."""
    P = cuda_nmf.pmax_of(p)
    ld = P + 4
    return 4 * (2 * WIDE_TC * ld + P * ld + 4 * WIDE_TC + 5 * P + 32 + 8
                + 2 * stage_slots(P) * P * WIDE_TC)


def wide_sync_bytes(p):
    """The synchronous sweep's share of it (``wide_sync_floats``: kernels 1
    and 3): without the flags and the copy stage."""
    P = cuda_nmf.pmax_of(p)
    return wide_work_bytes(p) - 4 * (8 + 2 * stage_slots(P) * P * WIDE_TC)


def wide_core_bytes(p):
    """The core's share of it without the second buffer either
    (``wide_core_floats``)."""
    P = cuda_nmf.pmax_of(p)
    return wide_sync_bytes(p) - 4 * WIDE_TC * (P + 4)


def wide_smem_bytes(kernel, p, W):
    """Shared memory one block of a wide or panel instance takes, dynamic
    and static (mirror of the launches in csrc/*_wide.cuh and
    csrc/*_panel.cu): the core, kernel 3's W residual scores and per-bin
    state, and K, rho, two row sums of p (the panel instance: one float
    each, its vectors are in its workspace), kernel 4's scales (the panel
    instance: its last column alone); kernel 2's wide instance its largest
    launch (tests/test_torch_ratiowide.py::smem_bytes, float32 input),
    kernels 1 and 3's phased layout past their cluster layout its Gram
    launch's (``dn_phase_gram_floats``: two tiles of two panels, the tile
    list, 16 counters), the largest of kernel 3's launches there."""
    if kernel == "ratio" and cuda_nmf.NARROW_MAX_P < p <= cuda_nmf.WIDE_MAX_P:
        from tests.test_torch_ratiowide import smem_bytes
        return max(smem_bytes(p, 4).values())
    if kernel in ("nmf", "trim") and cuda_nmf.panel_phase(p, "loop"):
        return 4 * (4 * WIDE_TC * (cuda_nmf.PANEL_ROWS + 4) + 2048 + 16)
    panel = p > cuda_nmf.WIDE_MAX_P
    P = 1 if panel else cuda_nmf.pmax_of(p)
    static = {"nmf": 0, "ratio": 0, "stream": (0 if panel else 4 * 2 * P) + 4,
              "trim": 4 * 4 * P + 12 * cuda_trim.MAX_BINS + 12}[kernel]
    kind = "stream" if kernel in ("stream", "ratio") else "loop"
    if cuda_nmf.panel_cluster(p, kind):
        # the cluster layout (``dn_pcl_smem_floats``; kernels 1 and 3 up to
        # their cut, 2 and 4 up to theirs): the p-vectors are in the core's
        # shared memory
        static = {"nmf": 0, "stream": 4, "ratio": 0,
                  "trim": 12 * cuda_trim.MAX_BINS + 12}[kernel]
        return (cuda_nmf.pcl_smem_bytes(p) + (4 * W if kernel == "trim"
                                               else 0) + static)
    assert not panel, (kernel, p)
    core = (wide_work_bytes(p) if kernel == "stream" and P <= PIPE_MAX
            else wide_sync_bytes(p))
    return core + (4 * W if kernel == "trim" else 0) + static


def make_dataset(seed=21, n=6, p=40, lengths=None):
    """``tests/test_torch_engine.py``'s generator at p samples; ``lengths``
    fixes the genes' lengths."""
    rng = np.random.default_rng(seed)
    cov = OrderedDict()
    for i in range(n):
        L = int(lengths[i]) if lengths is not None else int(
            120 + rng.integers(0, 800))
        cov[f"gene{i}"] = random_coverage(
            rng, p, L, scale=3 + 6 * rng.random(), degraded=(i % 2 == 0))
    X = np.round(np.abs(rng.standard_normal((n, p))) * 300 + 30)
    return cov, X


def _gap(rt, rj):
    return dict(rho=float(np.abs(rt.rho - rj.rho).max()),
                x_adj=float(np.abs(rt.x_adj / rj.x_adj - 1).max()))


def _assert_parity(rt, rj, rho_atol=5e-3, rtol=5e-3):
    np.testing.assert_array_equal(rt.ran_baseline_selection,
                                  rj.ran_baseline_selection)
    np.testing.assert_allclose(rt.rho, rj.rho, rtol=0, atol=rho_atol)
    np.testing.assert_allclose(rt.x_adj, rj.x_adj, rtol=rtol)
    np.testing.assert_allclose(rt.scale_factors, rj.scale_factors, rtol=rtol)


# ---- dispatch and the shared-memory mirror ----------------------------------

@pytest.mark.parametrize("p", [*range(2, cuda_nmf.WIDE_MAX_P + 1), *PANEL_P])
def test_every_p_runs_in_an_instance_that_holds_it(p):
    """The instance chosen for p is the smallest that holds it (above 128
    the panel instance, whose rows are the whole panels that hold p); above
    32 every launch rule picks the wide instances' geometry (above 128 one
    block a gene for kernel 4 too), a block's shared memory (the mirror of
    the kernels' launches) stays within the card's per-block limit at every
    geometry the rules pick, and kernel 3's workspace past its cluster
    layout is the phased layout's, sized by the genes a group holds, and
    its trim state, sized by the bucket."""
    P = cuda_nmf.pmax_of(p)
    if p > cuda_nmf.WIDE_MAX_P:
        assert cuda_nmf.instance_of(p) == "panel"
        assert P % cuda_nmf.PANEL_ROWS == 0
        assert P - cuda_nmf.PANEL_ROWS < p <= P
        if cuda_nmf.panel_phase(p, "loop"):
            ws, slots = cuda_nmf.kernel_workspace(
                24576, p, torch.device("cpu"), "loop", 64, 8)
            G = 24576
            assert slots == cuda_nmf.SMS and ws.numel() == (
                cuda_nmf.phase_ws_floats(p, slots, G)
                + G * (p + 2 * 64 + cuda_nmf.TRIM_ST + 1) + 1
                + (G * 9 + 3) // 4)
        assert cuda_nmf.kernel_workspace(24576, 128, torch.device("cpu"),
                                         "loop") == (None, 0)
    else:
        assert P >= p and P in INSTANCES
        assert all(q < p for q in INSTANCES if q < P)
        assert cuda_stream.packed_gram_floats(p) == P * (P + 1) // 2
        assert cuda_nmf.instance_of(p).endswith(str(P))
    if p <= cuda_nmf.NARROW_MAX_P:
        return
    wt = cuda_nmf.WIDE_THREADS
    resident = [W for W in (256, 512, 1024, 1984, 2048)
                if cuda_nmf.kernels_supported((1, p, W), torch.float32)]
    for W in resident:
        assert cuda_nmf.pick_loop_threads(p, W) == wt
        for G in (1, 1536, 24576):
            assert cuda_nmf.pick_nmf_geometry(p, W, G) == ("block", wt)
        assert wide_smem_bytes("nmf", p, W) <= SMEM_PER_BLOCK
    # the trim kernel's widest bucket inside the gate
    W_trim = min(cuda_nmf.MAX_W, cuda_nmf.MAX_PW // p)
    assert wide_smem_bytes("trim", p, W_trim) <= SMEM_PER_BLOCK
    for W in (256, 1024, 4096, 16384, 65536, 120064):
        assert cuda_nmf.pick_ratio_geometry(p, W, 100) == (1, wt, 0)
        assert wide_smem_bytes("ratio", p, W) <= SMEM_PER_BLOCK
        cl, threads = cuda_stream.pick_geometry(W, p)
        assert threads == wt and cl in cuda_stream.CLUSTERS
        if p > cuda_nmf.WIDE_MAX_P:
            assert cl == 1
        else:
            assert (cuda_stream.block_share(W, cl)
                    <= cuda_stream.WIDE_BLOCK_COLS
                    or cl == cuda_stream.CLUSTERS[-1])
            assert cl == 1 or cuda_stream.block_share(
                W, cl // 2) > cuda_stream.WIDE_BLOCK_COLS
        assert wide_smem_bytes("stream", p, W) <= SMEM_PER_BLOCK


def _define(src, name):
    return int(re.search(rf"#define {name} (\d+)", src).group(1))


def test_wide_mirror_matches_the_sources():
    """The Python mirror of csrc/wide.cuh and csrc/panel.cuh: threads a
    block, columns a tile, the largest p of the wide instances and the
    first of the panel instance, the instances of DN_DISPATCH_WIDE_P, the
    core's shared memory (wide_work_floats) at every instance, the panel
    instance's rows and the phased layout's Gram launch's shared memory."""
    with open(os.path.join(CSRC, "wide.cuh")) as f:
        src = f.read()
    with open(os.path.join(CSRC, "panel.cuh")) as f:
        panel = f.read()
    assert _define(src, "DN_WIDE_THREADS") == cuda_nmf.WIDE_THREADS
    assert _define(src, "DN_WIDE_TC") == WIDE_TC
    assert _define(src, "DN_WIDE_MAX_P") == cuda_nmf.WIDE_MAX_P
    assert _define(src, "DN_WIDE_MIN_P") == cuda_nmf.NARROW_MAX_P + 1
    assert _define(panel, "DN_PANEL_MIN_P") == cuda_nmf.WIDE_MAX_P + 1
    assert _define(panel, "DN_PANEL_ROWS") == cuda_nmf.PANEL_ROWS
    with open(os.path.join(CSRC, "phase.cuh")) as f:
        phase = f.read()
    body = re.search(r"dn_phase_gram_floats\(\) \{\s*return (.*?);", phase,
                     re.S).group(1)
    expr = (body.replace("DN_PANEL_LD", f"({cuda_nmf.PANEL_ROWS} + 4)")
            .replace("DN_WIDE_TC", str(WIDE_TC))
            .replace("DN_PHASE_LIST", str(_define(phase, "DN_PHASE_LIST"))))
    assert 4 * eval(" ".join(expr.split()), {}) == wide_smem_bytes(
        "trim", cuda_nmf.PCL_MAX_P + 1, 64)
    disp = src[src.index("#define DN_DISPATCH_WIDE_P"):]
    assert [int(x) for x in re.findall(r"CALL\((\d+)\)", disp)[:4]] == \
        [48, 64, 96, 128]
    assert [int(x) for x in re.findall(r"\(p\) <= (\d+)", disp)[:3]] == \
        [48, 64, 96]
    def floats(name, P):
        body = re.search(name + r"\(\) \{\s*return (.*?);", src,
                         re.S).group(1)
        for inner in ("wide_core_floats", "wide_sync_floats"):
            if inner in body:
                body = body.replace(f"{inner}<PMAX>()",
                                    str(floats(inner, P)))
        expr = (body.replace("WideShape<PMAX>::LD", str(P + 4))
                .replace("WideShape<PMAX>::NST", str(stage_slots(P)))
                .replace("DN_WIDE_TC", str(WIDE_TC)).replace("PMAX", str(P)))
        return eval(" ".join(expr.split()), {})

    assert f"NST = PMAX <= {NST2_MAX} ? 2 : 1;" in src
    with open(os.path.join(CSRC, "stream_wide.cuh")) as f:
        assert f"PIPE = PMAX <= {PIPE_MAX};" in f.read()
    for P in (48, 64, 96, 128):
        assert 4 * floats("wide_work_floats", P) == wide_work_bytes(P)
        assert 4 * floats("wide_sync_floats", P) == wide_sync_bytes(P)
        assert 4 * floats("wide_core_floats", P) == wide_core_bytes(P)


@pytest.mark.parametrize("kind", ["ratio", "nmf", "stream", "trim",
                                  "cols_nmf", "cols_ratio"])
def test_each_kernel_names_its_own_limit(kind):
    """Kernels 1-4 have no limit on p: p = 129, 256 and 1,000 pass their
    input checks and reach the panel instance through the dispatch and
    launch rules, within the card's shared memory a block.  Kernels 4c and
    2c stop at ``COLS_MAX_P`` (128, their wide instances): p = 129 raises
    ValueError naming that limit before anything is launched (the engine
    gene-shards such a bucket instead).
    Meta tensors stand for the card's: they take the wrappers' CUDA
    branch."""
    if not kind.startswith("cols"):
        wt = cuda_nmf.WIDE_THREADS
        for p in (129, 256, 1000):
            W = 256 if p * 256 <= cuda_nmf.MAX_PW else 64
            F = torch.empty((2, p, W), dtype=torch.float32, device="meta")
            cuda_nmf.check_coverage_input(F, kind, int16_ok=True)
            assert cuda_nmf.kernels_supported(F.shape, torch.float32)
            cuda_nmf.check_kernel_input(F, kind)
            assert cuda_nmf.instance_of(p) == "panel"
            geometry = {
                "ratio": (cuda_nmf.pick_ratio_geometry(p, W, 2), (1, wt, 0)),
                "nmf": (cuda_nmf.pick_nmf_geometry(p, W, 2), ("block", wt)),
                "stream": (cuda_stream.pick_geometry(16384, p), (1, wt)),
                "trim": (cuda_nmf.pick_loop_threads(p, W), wt)}[kind]
            assert geometry[0] == geometry[1]
            assert wide_smem_bytes(kind, p, W) <= SMEM_PER_BLOCK
        assert not cuda_nmf.kernels_supported((2, 257, 256), torch.float32)
        return
    over = cuda_nmf.COLS_MAX_P + 1
    limit = over - 1
    F = torch.empty((2, over, 256), dtype=torch.float32, device="meta")
    m = torch.empty((2, 256), dtype=torch.bool, device="meta")
    calls = {
        "cols_nmf": lambda: next(cuda_stream.nmf_masked_colsharded_cuda(
            F, m, None, nmf_iter=2)),
        "cols_ratio": lambda: next(cuda_nmf.ratio_rowsums_colsharded_cuda(
            F, m, None)),
    }
    with pytest.raises(ValueError, match=rf"p={over} .*2\.\.{limit}\b"):
        calls[kind]()


# ---- the route of wide buckets -----------------------------------------------

def _record(monkeypatch):
    """Recorders on the CUDA entry points: (name, coverage shape) of every
    call, each then run as it is (the plain version on the CPU)."""
    calls = []
    for mod, name in ((cuda_nmf, "nmf_masked_cuda"),
                      (cuda_nmf, "ratio_rowsums_cuda"),
                      (cuda_nmf, "ratio_rowsums_colsharded_cuda"),
                      (cuda_trim, "trim_loop_cuda"),
                      (cuda_stream, "nmf_masked_streamed_cuda"),
                      (cuda_stream, "nmf_masked_colsharded_cuda")):
        def rec(F, *a, _orig=getattr(mod, name), _name=name, **k):
            calls.append((_name, tuple(F.shape[1:])))
            return _orig(F, *a, **k)
        monkeypatch.setattr(mod, name, rec)
    return calls


@pytest.mark.parametrize("p,widths", [(64, (1024, 4096)), (128, (1024, 4096)),
                                      (128, None)])
def test_wide_buckets_take_their_kernels(monkeypatch, p, widths):
    """At p = 64 the W = 1024 bucket stays resident (kernels 2, 1 and the
    fused trim kernel 3) and the W = 4096 bucket streams (kernel 4 with the
    unfused loop); at p = 128 the W = 1024 bucket streams too, and with the
    default bucket widths the W = 256 and W = 512 buckets stay resident
    (128 x 512 = 65,536 is inside the gate)."""
    calls = _record(monkeypatch)
    lengths = {64: (300, 900, 1100), 128: (300, 900)}[p]
    if widths is None:
        lengths = (200, 450, 900)
    cov, X = make_dataset(seed=3, n=len(lengths), p=p, lengths=lengths)
    cfg = (EngineConfig(device="cpu") if widths is None
           else EngineConfig(device="cpu", bucket_widths=widths))
    eng = tengine.DegNormEngine(
        NMFConfig(nmf_iter=2, degnorm_iter=1, bins=5), cfg)
    res = eng.run(cov, X)
    assert np.isfinite(res.rho).all() and res.rho.shape == (len(lengths), p)
    got = set(calls)
    if p == 64:
        assert {("nmf_masked_cuda", (64, 1024)),
                ("trim_loop_cuda", (64, 1024)),
                ("ratio_rowsums_cuda", (64, 1024)),
                ("ratio_rowsums_cuda", (64, 4096)),
                ("nmf_masked_streamed_cuda", (64, 4096))} <= got
        assert ("nmf_masked_cuda", (64, 4096)) not in got
        assert ("nmf_masked_streamed_cuda", (64, 1024)) not in got
    elif widths is not None:
        assert ("nmf_masked_streamed_cuda", (128, 1024)) in got
        assert not any(n in ("nmf_masked_cuda", "trim_loop_cuda")
                       for n, _ in calls)
    else:
        assert {("nmf_masked_cuda", (128, 256)),
                ("nmf_masked_cuda", (128, 512)),
                ("trim_loop_cuda", (128, 256)),
                ("trim_loop_cuda", (128, 512)),
                ("nmf_masked_streamed_cuda", (128, 1024))} <= got
        assert ("nmf_masked_streamed_cuda", (128, 512)) not in got
        assert ("nmf_masked_cuda", (128, 1024)) not in got


@pytest.mark.parametrize("p", [8, 40, 129])
def test_mesh_column_shards_buckets_up_to_the_column_kernels_limit(
        monkeypatch, p):
    """On a two-shard CPU mesh a bucket at least ``seqpar_width`` wide is
    column-sharded at p = 8 and p = 40 (kernels 4c and 2c, narrow and wide
    instances: ``COLS_MAX_P`` is 128), nothing declined; at p = 129, past
    their limit, the engine's shape rule gene-shards it, counts it in
    ``colshard_declined`` and never calls 4c or 2c."""
    calls = _record(monkeypatch)
    cov, X = make_dataset(seed=4, n=4, p=p, lengths=(700, 800, 900, 1000))
    eng = tengine.DegNormEngine(
        NMFConfig(nmf_iter=2, degnorm_iter=1, bins=5),
        EngineConfig(device="cpu", bucket_widths=(1024,), seqpar_width=1024),
        mesh=make_mesh(["cpu"] * 2))
    res = eng.run(cov, X)
    assert np.isfinite(res.rho).all()
    cols = {n for n, _ in calls if "colsharded" in n}
    assert cuda_nmf.COLS_MAX_P == cuda_nmf.WIDE_MAX_P == 128
    if p <= cuda_nmf.COLS_MAX_P:
        assert cols == {"nmf_masked_colsharded_cuda",
                        "ratio_rowsums_colsharded_cuda"}
        assert eng.colshard_declined == 0
        assert eng.column_sharded(eng._buckets[0])
        assert ("nmf_masked_colsharded_cuda", (p, 512)) in calls
    else:
        assert not cols and eng.colshard_declined == 1
        assert ("nmf_masked_streamed_cuda", (p, 1024)) in calls
        assert not eng.column_sharded(eng._buckets[0])


# ---- the port against the JAX engine -----------------------------------------

@pytest.mark.parametrize("p", [40, 64])
def test_run_matches_jax_engine_at_wide_p(p):
    """The port (its default warm scheme, the plain versions on the CPU)
    against the JAX engine's XLA twin with the host outer loop, at PARITY.md's
    tolerances; the gap is printed."""
    cov, X = make_dataset(p=p)
    nmf_kw = dict(nmf_iter=5, degnorm_iter=2)
    rj = jengine.DegNormEngine(
        JNmf(**nmf_kw), JEng(device_loop=False, use_pallas=False,
                             bucket_widths=WIDTHS)).run(cov, X)
    rt = tengine.DegNormEngine(
        NMFConfig(**nmf_kw),
        EngineConfig(device="cpu", bucket_widths=WIDTHS)).run(cov, X)
    print(f"p={p} gap to the JAX XLA twin:", _gap(rt, rj))
    assert rt.ran_baseline_selection.any()
    _assert_parity(rt, rj)


def test_run_matches_pallas_interpret_at_p40():
    """The port against the JAX engine's Pallas kernels in interpret mode
    (the fused kernels' warm scheme, one plain matvec) at p = 40."""
    cov, X = make_dataset(p=40, n=3)
    nmf_kw = dict(nmf_iter=4, degnorm_iter=2)
    rj = jengine.DegNormEngine(
        JNmf(**nmf_kw),
        JEng(device_loop=False, use_pallas=True, pallas_interpret=True,
             gram_mode="vpu", bucket_widths=WIDTHS)).run(cov, X)
    rt = tengine.DegNormEngine(
        NMFConfig(**nmf_kw),
        EngineConfig(device="cpu", bucket_widths=WIDTHS,
                     power_warm_plain=1)).run(cov, X)
    print("p=40 gap to the Pallas interpret path:", _gap(rt, rj))
    _assert_parity(rt, rj)


PANEL_WIDTHS = (256, 1024)     # at p = 160: W=256 resident, W=1024 streamed
PANEL_LENGTHS = (200, 240, 700, 900)


def test_run_matches_jax_engine_at_p160(monkeypatch):
    """Past 128 samples (the panel instances of kernels 1-4 on the card): at
    p = 160 the W = 256 bucket stays resident (kernels 2, 1 and the fused
    trim kernel 3) and the W = 1024 bucket streams (kernels 2 and 4 with the
    unfused loop); the port's fit against the JAX engine's XLA twin on the
    same numpy data at PARITY.md's gate (the gap is printed)."""
    calls = _record(monkeypatch)
    cov, X = make_dataset(seed=12, n=len(PANEL_LENGTHS), p=160,
                          lengths=PANEL_LENGTHS)
    # six bins keep the trim loop's rounds (and the plain versions' time at
    # p = 160) short
    nmf_kw = dict(nmf_iter=5, degnorm_iter=2, bins=6)
    rj = jengine.DegNormEngine(
        JNmf(**nmf_kw), JEng(device_loop=False, use_pallas=False,
                             bucket_widths=PANEL_WIDTHS)).run(cov, X)
    rt = tengine.DegNormEngine(
        NMFConfig(**nmf_kw),
        EngineConfig(device="cpu", bucket_widths=PANEL_WIDTHS)).run(cov, X)
    print("p=160 gap to the JAX XLA twin:", _gap(rt, rj))
    assert {("ratio_rowsums_cuda", (160, 256)),
            ("nmf_masked_cuda", (160, 256)),
            ("trim_loop_cuda", (160, 256)),
            ("ratio_rowsums_cuda", (160, 1024)),
            ("nmf_masked_streamed_cuda", (160, 1024))} <= set(calls)
    assert ("nmf_masked_cuda", (160, 1024)) not in calls
    assert rt.ran_baseline_selection.any()
    _assert_parity(rt, rj)


def test_run_matches_pallas_interpret_at_p160():
    """The port's plain versions at p = 160 against the JAX engine's Pallas
    kernels in interpret mode (the fused kernels' warm scheme, one plain
    matvec), three genes across a resident and a streamed bucket."""
    cov, X = make_dataset(seed=13, n=3, p=160, lengths=(220, 240, 600))
    nmf_kw = dict(nmf_iter=4, degnorm_iter=2, bins=6)
    rj = jengine.DegNormEngine(
        JNmf(**nmf_kw),
        JEng(device_loop=False, use_pallas=True, pallas_interpret=True,
             gram_mode="vpu", bucket_widths=PANEL_WIDTHS)).run(cov, X)
    rt = tengine.DegNormEngine(
        NMFConfig(**nmf_kw),
        EngineConfig(device="cpu", bucket_widths=PANEL_WIDTHS,
                     power_warm_plain=1)).run(cov, X)
    print("p=160 gap to the Pallas interpret path:", _gap(rt, rj))
    _assert_parity(rt, rj)


# ---- EngineConfig.device_loop ------------------------------------------------

def test_host_and_device_outer_updates_match_jax_on_identical_state():
    """One outer update from the same state (carried across by
    ``convert.global_state_from_numpy``): the port's host rule equals the
    JAX package's bit for bit, its device twin to 1e-12."""
    rng = np.random.default_rng(5)
    n, p = 30, 40
    X = np.round(rng.random((n, p)) * 400 + 20)
    st_j = jd.init_state(rng.random((n, p)) * 0.3, X)
    st_t = td.init_state(np.array(st_j.rho), X)
    for a, b in zip(st_t, st_j):
        np.testing.assert_array_equal(a, b)
    rho_raw = rng.random((n, p)) * 0.5
    rho_raw[3] = 0.0                                   # never ran the trim
    want = jd.iteration_update(st_j, rho_raw)
    host = td.iteration_update(st_t, rho_raw)
    for a, b in zip(host, want):
        np.testing.assert_array_equal(a, b)
    dev = convert.global_state_from_numpy(*st_j, device="cpu")
    got = td.device_iteration_math(torch.from_numpy(rho_raw),
                                   dev.x_weighted, dev.scale_factors)
    for a, b in zip(got, (want.rho, want.x_adj, want.x_weighted,
                          want.norm_factors, want.scale_factors)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-15)


@pytest.fixture(scope="module")
def loop_fits():
    cov, X = make_dataset(seed=9, n=10, p=4)
    nmf = NMFConfig(nmf_iter=5, degnorm_iter=3)
    out = {}
    for loop in (None, True, False):
        eng = tengine.DegNormEngine(nmf, EngineConfig(
            device="cpu", use_kernels=False, dtype="float64",
            power_warm_plain=0, bucket_widths=WIDTHS, device_loop=loop))
        out[loop] = (eng, eng.run(cov, X))
    return cov, X, nmf, out


def test_device_loop_false_runs_the_host_loop(loop_fits, monkeypatch):
    """None and True run the outer update on the device, False on the host
    (core/degnorm.py's numpy rules); the two agree at 1e-9 in float64, and
    the host loop agrees with the JAX engine's at 1e-9 (the same scheme)."""
    cov, X, nmf, out = loop_fits
    assert out[None][0].outer_on_device() and out[True][0].outer_on_device()
    assert not out[False][0].outer_on_device()
    for f in ("rho", "x_adj", "x_weighted", "scale_factors", "norm_factors"):
        np.testing.assert_allclose(getattr(out[False][1], f),
                                   getattr(out[True][1], f), rtol=1e-9,
                                   atol=1e-12)
    np.testing.assert_array_equal(out[False][1].ran_baseline_selection,
                                  out[None][1].ran_baseline_selection)
    rj = jengine.DegNormEngine(
        JNmf(nmf_iter=5, degnorm_iter=3),
        JEng(device_loop=False, use_pallas=False, dtype="float64",
             bucket_widths=WIDTHS)).run(cov, X)
    _assert_parity(out[False][1], rj, rho_atol=1e-9, rtol=1e-9)
    # the host loop calls the numpy rules, the device loop never does
    seen = []
    real = td.iteration_update
    monkeypatch.setattr(td, "iteration_update",
                        lambda *a: seen.append(1) or real(*a))
    out[True][0].run(cov, X, reuse_device_data=True)
    assert not seen
    out[False][0].run(cov, X, reuse_device_data=True)
    assert len(seen) == nmf.degnorm_iter


def test_device_loop_is_forced_across_processes(loop_fits):
    """A mesh that spans processes runs the device loop whatever the field
    says (the JAX engine's rule, its engine.py:674)."""
    eng = loop_fits[3][False][0]
    mesh = eng.mesh
    try:
        eng.mesh = type(mesh)(mesh.devices, process_index=0, process_count=2)
        assert eng.outer_on_device()
    finally:
        eng.mesh = mesh
    assert not eng.outer_on_device()


def test_host_loop_resumes_from_its_checkpoint(loop_fits, tmp_path):
    """device_loop=False saves its state after every iteration and resumes
    from it bit for bit."""
    cov, X, nmf, out = loop_fits
    cfg = out[False][0].eng_cfg
    short = NMFConfig(nmf_iter=5, degnorm_iter=2)
    tengine.DegNormEngine(short, cfg).run(cov, X, checkpoint_dir=str(tmp_path))
    resumed = tengine.DegNormEngine(nmf, cfg).run(
        cov, X, checkpoint_dir=str(tmp_path))
    whole = out[False][1]
    for f in ("rho", "x_adj", "x_weighted", "scale_factors", "norm_factors",
              "ran_baseline_selection"):
        np.testing.assert_array_equal(getattr(resumed, f), getattr(whole, f))
