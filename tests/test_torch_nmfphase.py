"""Kernel 1 past 640 samples on the phased layout (csrc/nmf_panel.cu
handing p past its cluster layout to csrc/stream_phase.cu's phase_loop,
csrc/phase.cuh): the dispatch rule by kernel (kernel 1 phased past 640,
kernels 2 and 4 past 1,152, kernel 3 on its block layout) in the sources
and in its Python mirror, the wrapper's workspace in both branches, the
engine's memory guard by the kinds of kernel a fit launches, and the
port's plain engine against the JAX engine at p = 768 with a resident
bucket of W = 64 (its XLA twin, and its Pallas kernels in interpret mode).

The kernel runs only on the card (``chip_smoke.py`` phase ``panels``,
which holds it against its plain version in both branches and twice for
the same bits, and ``tools/panel_ab.py --parts loop`` against the block
layout it replaces); here the geometry and the plain versions, at
PARITY.md's gate (DI atol 5e-3, adjusted counts rtol 5e-3,
ran_baseline_selection exact)."""
import os
import time
import types

import numpy as np
import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets it)
import pytest
import torch

from degnorm_tpu import engine as jengine
from degnorm_tpu.config import EngineConfig as JEng, NMFConfig as JNmf
from degnorm_tpu_torch import EngineConfig, NMFConfig
from degnorm_tpu_torch import engine as tengine
from degnorm_tpu_torch.ops import build, cuda_nmf
from tests.test_torch_panelcl import CSRC
from tests.test_torch_widep import (_assert_parity, _gap, _record,
                                    make_dataset)

KIND_P = (129, 640, 641, 700, 704, 768, 1024, 1152, 1153, 1222, 2048)


def _src(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("p", KIND_P)
def test_each_kernel_keeps_its_layout_past_its_cut(p):
    """Past its cluster layout kernel 1 ("nmf") takes the phased layout
    (its workspace: a slot a gene in flight and the list of active genes;
    X row by row), kernels 2 and 4 ("stream") keep their cluster layout to
    1,152 samples and take the phased layout past it, kernel 3 ("loop")
    takes it past its own cut with kernel 1, its trim state after the
    layout's workspace."""
    cpu = torch.device("cpu")
    G = 300
    slots = cuda_nmf.panel_slots(G, cpu)
    assert cuda_nmf.panel_phase(p, "nmf") == (p > cuda_nmf.PCL_MAX_P)
    assert cuda_nmf.panel_phase(p, "stream") == (p > cuda_nmf.PCL_MAX_P_STREAM)
    assert cuda_nmf.panel_phase(p) == cuda_nmf.panel_phase(p, "stream")
    assert cuda_nmf.panel_phase(p, "loop") == (p > cuda_nmf.PCL_MAX_P)
    assert cuda_nmf.panel_cluster(p, "nmf") == cuda_nmf.panel_cluster(
        p, "loop") == (p <= cuda_nmf.PCL_MAX_P)
    for kind in cuda_nmf.WORKSPACE_KINDS:
        Wt = min(64, cuda_nmf.MAX_PW // p)    # a resident width at p
        ws, n = cuda_nmf.kernel_workspace(G, p, cpu, kind, Wt,
                                          cuda_nmf.TRIM_MAX_BINS)
        floats = 0 if ws is None else ws.numel()
        trim = (cuda_nmf.trim_phase_floats(p, Wt, cuda_nmf.TRIM_MAX_BINS, G)
                if kind == "loop" else 0)
        if cuda_nmf.panel_phase(p, kind):
            assert (n, floats) == (slots, cuda_nmf.phase_ws_floats(p, slots,
                                                                   G) + trim)
        else:
            assert cuda_nmf.panel_cluster(p, kind)
            assert floats == n * cuda_nmf.pcl_ws_floats(p)
        assert floats == cuda_nmf.kind_workspace_floats(
            p, kind, slots, G, [Wt]) or cuda_nmf.panel_cluster(p, kind)
    assert cuda_nmf.loop_scratch_shape(G, p, 64) == (
        (G, 64, cuda_nmf.pcl_ldx(p)) if p <= cuda_nmf.PCL_MAX_P
        else (G, p, 64))


def test_kernel_1_hands_its_phased_layout_the_loop():
    """In the sources: kernel 1 past its cluster layout checks the phased
    layout's kind (DN_PCL_LOOP) and runs stream_phase.cu's phase_loop on
    float32 input, its nmf_tol branch through PhaseArgs::tol; kernels 2 and
    4 ask their own kind; kernel 3 runs each round's loop through the same
    phase_loop, on its round's list, keeping the outputs of the genes off
    it; the block kernels of kernels 1 and 3 are gone."""
    nmf = _src("nmf_panel.cu")
    assert "dn_phase_on(a.p, DN_PCL_LOOP)" in nmf
    assert "return phase_loop(pa, false, a.act, nullptr, a.ws_slots" in nmf
    assert "pa.tol = a.tol > 0.f ? a.tol : 0.f;" in nmf
    assert "pa.iters = a.iters;" in nmf
    assert "dn_phase_on(a.p, DN_PCL_STREAM)" in _src("stream_phase.cu")
    assert "dn_phase_on(a.p, DN_PCL_STREAM)" in _src("ratio_phase.cu")
    trim = _src("trim_panel.cu")
    assert "return dn_trim_phase(a, mode);" in trim
    assert "e = phase_loop(pa, false, t.in_round, nullptr, S, n_cold," in trim
    assert "pa.keep = 1;" in trim and "pa.listed = n;" in trim
    phase = _src("phase.cuh")
    # the freeze test of panel_core, and its carry's update
    stream = _src("stream_phase.cu")
    assert "if (delta <= __fmul_rn(a.tol, ref) && t == 0)" in stream
    assert "a.tol > 0.f ? __fmul_rn(s, v / (s + DN_EPS)) : v;" in phase
    for name in os.listdir(CSRC):
        for gone in ("nmf_panel_block_kernel", "trim_panel_block_kernel",
                     "launch_panel"):
            assert gone not in _src(name), (name, gone)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("p,tol", [(641, 0.0), (704, 1e-4), (1153, 0.0)])
def test_nmf_wrapper_passes_the_phased_workspace(monkeypatch, p, tol):
    """Past 640 samples ``nmf_masked_cuda`` hands kernel 1 the phased
    layout's workspace (``phase_ws_floats`` at ``panel_slots`` genes) and
    the (G, p, W) scratch, in both branches, and counts the launch as a
    phased one.  Meta tensors stand for the card's; the library is a
    stub."""
    seen = {}

    class Lib:
        def dn_nmf_masked(self, *args):
            seen["args"] = args
            return 0

    monkeypatch.setattr(build, "get_lib", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    sizes = {}
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes.setdefault("shapes", []).append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    G, W = 5, min(64, cuda_nmf.MAX_PW // p)
    F = real_empty((G, p, W), dtype=torch.float32, device="meta")
    m = real_empty((G, W), dtype=torch.bool, device="meta")
    before = (cuda_nmf.nmf_panel_launches, cuda_nmf.nmf_panel_phase_launches,
              cuda_nmf.nmf_panel_tol_launches)
    cuda_nmf.nmf_masked_cuda(F, m, nmf_iter=3, nmf_tol=tol)
    a = seen["args"]
    assert a[8:11] == (G, p, W)
    assert a[19] == G  # ws_slots: one a gene, at most one an SM
    assert (G, p, W) in sizes["shapes"]      # the X scratch, row by row
    assert (cuda_nmf.phase_ws_floats(p, G, G),) in sizes["shapes"]
    assert (cuda_nmf.nmf_panel_launches, cuda_nmf.nmf_panel_phase_launches,
            cuda_nmf.nmf_panel_tol_launches) == (
        before[0] + 1, before[1] + 1, before[2] + (tol > 0))


@pytest.fixture
def a_card(monkeypatch):
    """An H100's SM count and memory where there is no card."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(tengine, "_device_memory", lambda d: 80 << 30)
    return torch.device("cuda", 0)


def _guard_cap(monkeypatch, a_card, p, lengths, widths):
    seen = {}
    pack = tengine.pack_buckets

    def spy(*a, **kw):
        seen["cap"] = kw["max_bucket_bytes"]
        return pack(*a, **kw)

    monkeypatch.setattr(tengine, "pack_buckets", spy)
    eng = tengine.DegNormEngine(NMFConfig(nmf_iter=2),
                                EngineConfig(device="cpu",
                                             bucket_widths=widths))
    eng.mesh = types.SimpleNamespace(devices=(a_card,), process_count=1)
    rng = np.random.default_rng(p)
    eng._pack_host([rng.integers(0, 40, (p, L)).astype(np.float64)
                    for L in lengths])
    return seen["cap"]


RESIDENT_WIDTHS = (64, 256, 512, 1024, 2048, 4096, 8192, 16384, 65536)


@pytest.mark.parametrize("p", [768, 1222, 4096])
def test_memory_guard_sets_aside_only_launched_kinds(monkeypatch, a_card, p):
    """The engine's memory guard sets aside a kind's workspace only where a
    bucket of the fit launches that kind: a fit whose buckets all stream
    (genes of 300 bases) the workspace of kernels 2 and 4 alone (none on
    the cluster layout where a block holds one pair, the phased one past
    1,152 samples), one with a resident bucket (genes of 50-64 bases at
    W = 64, inside the gate up to p = 1,024) also kernel 1's, reckoned
    from ``phase_ws_floats``, and kernel 3's, that and its trim state at
    the W = 64 bucket."""
    sms = cuda_nmf.SMS
    streamed = _guard_cap(monkeypatch, a_card, p, (300, 300, 290),
                          RESIDENT_WIDTHS)
    ws_s = 4 * cuda_nmf.kind_workspace_floats(p, "stream", sms, 3)
    assert streamed == max(((80 << 30) - ws_s) // 12, 512 << 20)
    block = 4 * (cuda_nmf.phase_ws_floats(p, 3, 3)
                 + cuda_nmf.trim_phase_floats(p, 64, cuda_nmf.TRIM_MAX_BINS,
                                              3))
    if cuda_nmf.panel_phase(p):
        assert ws_s == 4 * cuda_nmf.phase_ws_floats(p, 3, 3) < block
    lengths = (50, 64, 57)
    resident = _guard_cap(monkeypatch, a_card, p, lengths, RESIDENT_WIDTHS)
    kinds = cuda_nmf.workspace_kinds(p, [64])
    if p * 64 <= cuda_nmf.MAX_PW:
        assert kinds == cuda_nmf.WORKSPACE_KINDS
        assert 4 * cuda_nmf.kind_workspace_floats(p, "nmf", sms, 3) == \
            4 * cuda_nmf.phase_ws_floats(p, 3, 3) < block
        assert resident == max(((80 << 30) - max(block, ws_s)) // 12,
                               512 << 20)
    else:
        assert kinds == ("stream",) and resident == streamed
    assert cuda_nmf.workspace_kinds(p, [64], use_kernels=False) == ()
    assert cuda_nmf.panel_workspace_bytes(p, a_card, ()) == 0


@pytest.mark.parametrize("p", [33, 64, 96, 128])
def test_memory_guard_sets_aside_kernel_2_wide_workspace(monkeypatch, a_card,
                                                         p):
    """At 33-128 samples every bucket launches kernel 2's wide instance,
    whose workspace (``ratio_wide_workspace``) the guard sets aside at the
    widths the packer gives the fit's genes: a slot a gene up to
    RW_WS_FLOATS floats, so a few long genes take a slot each and a bucket
    of many genes the cap; none at p <= 32 or with the kernels off."""
    W = 65536
    assert cuda_nmf.workspace_kinds(p, [64]) == cuda_nmf.WORKSPACE_KINDS
    for kinds in (cuda_nmf.WORKSPACE_KINDS, ("stream",)):
        assert cuda_nmf.panel_workspace_bytes(
            p, a_card, kinds, genes=3, widths=[64, W]) == \
            4 * 3 * cuda_nmf.ratio_wide_slot_floats(p, W)
    many = cuda_nmf.panel_workspace_bytes(p, a_card, genes=1 << 16,
                                          widths=[64])
    assert many == 4 * cuda_nmf.ratio_wide_slots(1 << 16, p, 64) * \
        cuda_nmf.ratio_wide_slot_floats(p, 64)
    assert 4 * cuda_nmf.RW_WS_FLOATS - many < \
        4 * cuda_nmf.ratio_wide_slot_floats(p, 64)
    ws, _ = cuda_nmf.ratio_wide_workspace(3, p, W, torch.device("cpu"))
    assert 4 * ws.numel() == cuda_nmf.panel_workspace_bytes(
        p, a_card, genes=3, widths=[W])
    assert cuda_nmf.panel_workspace_bytes(p, a_card, ("nmf", "loop"),
                                          widths=[W]) == 0
    assert cuda_nmf.panel_workspace_bytes(32, a_card, widths=[W]) == 0
    # the engine's guard: genes of 50-64 bases and one of 40,000 (a bucket
    # of W = 65,536 under RESIDENT_WIDTHS)
    cap = _guard_cap(monkeypatch, a_card, p, (50, 64, 40000),
                     RESIDENT_WIDTHS)
    ws_b = 4 * 3 * cuda_nmf.ratio_wide_slot_floats(p, W)
    assert cap == max(((80 << 30) - ws_b) // 12, 512 << 20)
    assert cuda_nmf.workspace_kinds(p, [64], use_kernels=False) == ()


RESIDENT_P = 768
RESIDENT_GENES = 16


def _resident_dataset(seed, n):
    """``make_dataset``'s genes at p = RESIDENT_P, of 50-64 bases: one
    bucket of W = 64 under RESIDENT_WIDTHS, inside the resident gate."""
    rng = np.random.default_rng(seed)
    return make_dataset(seed=seed, n=n, p=RESIDENT_P,
                        lengths=rng.integers(50, 65, n))


def test_run_matches_jax_engine_at_p768_resident(monkeypatch):
    """Past 640 samples with a resident bucket (kernels 2 on its cluster
    layout, 1 on the phased layout and 3 on its block layout on the card):
    the port's plain fit of RESIDENT_GENES genes of 50-64 bases at p = 768
    against the JAX engine's XLA twin on the same numpy data at PARITY.md's
    gate (the gap is printed).  With the default min_gene_len (200) no
    gene enters the trim rounds."""
    calls = _record(monkeypatch)
    cov, X = _resident_dataset(31, RESIDENT_GENES)
    nmf_kw = dict(nmf_iter=4, degnorm_iter=1, bins=6)
    t0 = time.perf_counter()
    rj = jengine.DegNormEngine(
        JNmf(**nmf_kw), JEng(device_loop=False, use_pallas=False,
                             bucket_widths=RESIDENT_WIDTHS)).run(cov, X)
    t1 = time.perf_counter()
    rt = tengine.DegNormEngine(
        NMFConfig(**nmf_kw),
        EngineConfig(device="cpu", bucket_widths=RESIDENT_WIDTHS)).run(cov, X)
    print(f"p={RESIDENT_P} resident gap to the JAX XLA twin:", _gap(rt, rj),
          f"(JAX {t1 - t0:.1f} s, port {time.perf_counter() - t1:.1f} s)")
    assert cuda_nmf.panel_phase(RESIDENT_P, "nmf")
    assert cuda_nmf.kernels_supported((1, RESIDENT_P, 64), torch.float32)
    assert {("ratio_rowsums_cuda", (RESIDENT_P, 64)),
            ("nmf_masked_cuda", (RESIDENT_P, 64)),
            ("trim_loop_cuda", (RESIDENT_P, 64))} <= set(calls)
    assert not {c for c in calls if c[0] == "nmf_masked_streamed_cuda"}
    _assert_parity(rt, rj)


def test_run_matches_pallas_interpret_at_p768_resident():
    """The port's plain versions at p = 768 with a resident bucket of W = 64
    against the JAX engine's Pallas kernels in interpret mode (the fused
    kernels' warm scheme, one plain matvec), on two genes."""
    cov, X = _resident_dataset(32, 2)
    nmf_kw = dict(nmf_iter=3, degnorm_iter=1, bins=6)
    rj = jengine.DegNormEngine(
        JNmf(**nmf_kw),
        JEng(device_loop=False, use_pallas=True, pallas_interpret=True,
             gram_mode="vpu", bucket_widths=RESIDENT_WIDTHS)).run(cov, X)
    rt = tengine.DegNormEngine(
        NMFConfig(**nmf_kw),
        EngineConfig(device="cpu", bucket_widths=RESIDENT_WIDTHS,
                     power_warm_plain=1)).run(cov, X)
    print(f"p={RESIDENT_P} resident gap to the Pallas interpret path:",
          _gap(rt, rj))
    _assert_parity(rt, rj)
