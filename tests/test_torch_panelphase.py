"""Studies of more than 1,152 samples: the phased layout of kernels 2 and 4
(csrc/phase.cuh, csrc/stream_phase.cu, csrc/ratio_phase.cu) against its
Python mirror (the workspace in ops/cuda_nmf.py, the launches' geometry
modelled here) at p = 1,153, 1,222, 1,280, 2,048 and 4,096, and the port's
plain versions against the JAX engine at p = 1,222, where every bucket
streams.

The kernels run only on the card (``chip_smoke.py`` phase ``panels``, which
holds them against their plain versions and ``tools/panel_ab.py --parts
past`` against the block layout they replace); here the geometry the
launches take and the arithmetic of the plain versions, at PARITY.md's gate
(DI atol 5e-3, adjusted counts rtol 5e-3, ran_baseline_selection exact)
against the JAX engine's XLA twin."""
import os
import re
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
from degnorm_tpu_torch.ops import cuda_nmf
from tests.test_torch_panelcl import CSRC, _c_eval
from tests.test_torch_widep import (_assert_parity, _gap, _record,
                                    make_dataset)

SMEM_PER_BLOCK = 232448        # the H100's opt-in shared memory a block
MAX_PORTABLE = 8               # the largest portable cluster
PHASE_P = (1153, 1222, 1280, 2048, 4096)
R = cuda_nmf.PANEL_ROWS
PHASE_C = 8                    # blocks of a gene's power step (DN_PHASE_C)
PHASE_LIST = 2048              # active tiles a Gram block lists at a time


def phase_rows(p):
    """The rows [r0, r1) of a matvec each block of a gene's power step
    computes (``PhaseMv``): ceil(p / PHASE_C) a block."""
    rb = -(-p // PHASE_C)
    return [(r * rb, min(p, r * rb + rb)) for r in range(PHASE_C)]


def phase_power_smem_bytes(p):
    """Shared memory of a block of the power step
    (``dn_phase_power_floats``): u and two matvec results, the published
    rows (two halves), 32 floats of scratch."""
    return 4 * (3 * cuda_nmf.pmax_of(p) + 2 * -(-p // PHASE_C) + 32)


def phase_gram_smem_bytes():
    """Shared memory of a block of the Gram launch
    (``dn_phase_gram_floats``): two tiles of two panels, the list of
    active tiles and 16 counters."""
    return 4 * (4 * 64 * (R + 4) + PHASE_LIST + 16)


def phase_pairs(p):
    """The panel pair of each block of a gene's Gram launch (blockIdx.x =
    pair e, ``dn_pcl_pair``)."""
    T = cuda_nmf.pcl_T(p)
    return [cuda_nmf.pcl_pair(T, e) for e in range(cuda_nmf.pcl_pairs(p))]


def phase_groups(lst, G, slots):
    """The genes each group of a call runs, slot by slot, from the list of
    active genes ``lst``: its entries base .. base + slots - 1 for base =
    0, slots, ... < G (a group past the active genes runs none)."""
    return [lst[b:b + slots] for b in range(0, G, slots)]


def _src(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _define(src, name):
    return int(re.search(rf"#define {name} (\d+)", src).group(1))


def _returned(src, fn):
    """The returned expression of a one-line C function of phase.cuh, as
    Python (casts dropped, panel.cuh's functions by their mirrors)."""
    body = re.search(fn + r"\([^)]*\) \{\s*return (.*?);\s*\}", src,
                     re.S).group(1)
    body = " ".join(body.replace("(size_t)", "").split())
    for c_name, py in (("dn_panel_np(p)", "np_"),
                       ("dn_phase_ldb(p)", "ldb"),
                       ("dn_phase_slot_floats(p)", "slot"),
                       ("dn_phase_rows(p)", "rows")):
        body = body.replace(c_name, py)
    return body


def _names(p):
    return dict(p=p, np_=cuda_nmf.pmax_of(p), ldb=cuda_nmf.phase_ldb(p),
                slot=cuda_nmf.phase_slot_floats(p),
                rows=-(-p // PHASE_C),
                DN_PHASE_C=PHASE_C, DN_PHASE_SCAL=cuda_nmf.PHASE_SCAL,
                DN_PHASE_LIST=PHASE_LIST, DN_WIDE_TC=64,
                DN_PANEL_LD=R + 4,
                DN_PCL_MAX_P_STREAM=cuda_nmf.PCL_MAX_P_STREAM)


def test_phase_mirror_matches_the_sources():
    """The constants and formulas of csrc/phase.cuh equal the mirror's
    (the cut, a slot's and a call's workspace, a block's rows of a matvec
    and both launches' shared memory, at every p of PHASE_P), the power
    step's clusters are portable, kernels 2 and 4 hand every p past their
    cluster layout to the phased layout, and the block layout they had
    there is gone from the sources."""
    src = _src("phase.cuh")
    assert _define(src, "DN_PHASE_C") == PHASE_C <= MAX_PORTABLE
    assert _define(src, "DN_PHASE_LIST") == PHASE_LIST
    assert _define(src, "DN_PHASE_SCAL") == cuda_nmf.PHASE_SCAL
    assert _returned(src, "dn_phase_on") == "p > dn_pcl_max_p(kind)"
    assert f"<= {SMEM_PER_BLOCK};" in src   # phase_fits
    for p in [*PHASE_P, cuda_nmf.PCL_MAX_P_STREAM]:
        n = _names(p)
        assert _c_eval(_returned(src, "dn_phase_on"), kind="stream",
                       dn_pcl_max_p=cuda_nmf.pcl_max_p, **n) == \
            cuda_nmf.panel_phase(p) == (p > 1152)
        assert _c_eval(_returned(src, "dn_phase_ldb"), **n) == \
            cuda_nmf.phase_ldb(p)
        assert _c_eval(_returned(src, "dn_phase_slot_floats"), **n) == \
            cuda_nmf.phase_slot_floats(p)
        for slots, G in ((1, 1), (64, 64), (132, 512)):
            assert _c_eval(_returned(src, "dn_phase_ws_floats"), slots=slots,
                           G=G, **n) == cuda_nmf.phase_ws_floats(p, slots, G)
        assert _c_eval(_returned(src, "dn_phase_rows"), **n) == \
            phase_rows(p)[0][1]
        assert 4 * _c_eval(_returned(src, "dn_phase_power_floats"), **n) \
            == phase_power_smem_bytes(p)
    assert 4 * _c_eval(_returned(src, "dn_phase_gram_floats"), **_names(1153)) \
        == phase_gram_smem_bytes()
    assert "return dn_stream_phase(a);" in _src("stream_panel.cu")
    assert "return dn_ratio_phase(a, f_is_i16);" in _src("ratio_panel.cu")
    assert "return phase_loop(pa, false, a.act" in _src("nmf_panel.cu")
    for name in os.listdir(CSRC):
        text = _src(name)
        assert "nmf_stream_panel_block_kernel" not in text, name
        assert "ratio_panel_block_kernel" not in text, name
        assert "nmf_panel_block_kernel" not in text, name


@pytest.mark.parametrize("p", PHASE_P)
def test_phase_pairs_cover_the_upper_triangle_once(p):
    """A gene's Gram launch has a block a panel pair, diagonal pairs
    included: the T(T+1)/2 pairs cover the upper triangle of the T panels
    once (each stored with its mirror), the diagonal pairs first; and the
    power step's PHASE_C blocks cover the p rows of each matvec once, each
    block's share within one published half."""
    assert cuda_nmf.panel_phase(p) and not cuda_nmf.panel_cluster(p, "stream")
    T = cuda_nmf.pcl_T(p)
    pairs = phase_pairs(p)
    assert len(pairs) == T * (T + 1) // 2
    assert sorted(pairs) == [(i, j) for i in range(T) for j in range(i, T)]
    assert pairs[:T] == [(i, i) for i in range(T)]
    covered = np.zeros((T * R, T * R), np.uint8)
    for i, j in pairs:
        covered[i * R:(i + 1) * R, j * R:(j + 1) * R] += 1
        if i != j:
            covered[j * R:(j + 1) * R, i * R:(i + 1) * R] += 1
    assert (covered[:p, :p] == 1).all()
    rows = phase_rows(p)
    assert len(rows) == PHASE_C
    assert [i for r0, r1 in rows for i in range(r0, r1)] == list(range(p))
    assert all(r1 - r0 <= -(-p // PHASE_C) for r0, r1 in rows)


def _ballot_list(active, width=256):
    """``phase_prep_kernel``'s (and ``phase_list_tiles``') compaction: 256
    entries a round, a warp's ballot, its popcount before each lane and the
    warps' counts before it, added to the rounds' total."""
    out = [None] * sum(map(bool, active))
    total = 0
    for b in range(0, len(active), width):
        on = [bool(a) for a in active[b:b + width]]
        on += [False] * (width - len(on))
        warps = [on[w:w + 32] for w in range(0, width, 32)]
        counts = [sum(w) for w in warps]
        for wi, w in enumerate(warps):
            for lane, a in enumerate(w):
                if a:
                    out[total + sum(counts[:wi]) + sum(w[:lane])] = \
                        b + wi * 32 + lane
        total += sum(counts)
    return out


@pytest.mark.parametrize("p", PHASE_P)
def test_phase_groups_hold_every_active_gene_once(p):
    """A call lists its active genes on the card (in order: the ballot
    compaction gives the plain filter) and runs them in groups of at most
    ``panel_slots`` genes, slot by slot: every active gene in exactly one
    group, no inactive one, the groups ceil(G / slots) in number (those
    past the active genes empty), each within its slots.  Both calls step
    through the groups as ``phase_groups`` does (kernel 3's rounds stop
    at the groups their list fills, ``PhaseArgs::listed``)."""
    assert ("for (int base = 0; e == 0 && base < a.G; base += S)"
            in _src("ratio_phase.cu"))
    assert ("const int listed = a.listed > 0 && a.listed < a.G ? a.listed "
            ": a.G;\n  for (int base = 0; e == 0 && base < listed; base += S)"
            in _src("stream_phase.cu"))
    rng = np.random.default_rng(p)
    cpu = torch.device("cpu")
    for G in (1, 4, 64, 132, 133, 300, 512):
        slots = cuda_nmf.panel_slots(G, cpu)
        assert slots == min(G, cuda_nmf.SMS)
        for frac in (1.0, 0.5, 0.02, 0.0):
            active = rng.random(G) < frac
            lst = _ballot_list(active)
            assert lst == list(np.flatnonzero(active))
            groups = phase_groups(lst, G, slots)
            assert len(groups) == -(-G // slots)
            assert all(len(g) <= slots for g in groups)
            flat = [g for grp in groups for g in grp]
            assert flat == lst and len(set(flat)) == len(flat)
            assert all(active[g] for g in flat)


@pytest.fixture
def a_card(monkeypatch):
    """An H100's SM count where there is no card: enough for the workspace
    rule and the engine's memory guard."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            multi_processor_count=132))
    return torch.device("cuda", 0)


@pytest.mark.parametrize("p", PHASE_P)
def test_phase_workspace_fits_the_guard(p, a_card):
    """The phased layout's workspace (a slot a gene in flight, one an SM at
    most, and the list of active genes) is no larger than what the
    engine's memory guard sets aside at p (``panel_workspace_bytes``:
    kernel 3's, the phased layout's with its trim state at the gate's
    widest resident bucket, the largest kind there) at any bucket up to
    the guard's 65,536 genes; every slot starts 16-byte aligned; the
    launches' shared memory fits a block; the X scratch keeps the (G, p, W)
    form; the wrapper's workspace is the mirror's size."""
    guard = cuda_nmf.panel_workspace_bytes(p, a_card)
    n = 1 << 16
    assert guard == 4 * (cuda_nmf.phase_ws_floats(p, cuda_nmf.SMS, n)
                         + cuda_nmf.trim_phase_floats(
                             p, cuda_nmf.MAX_PW // p, cuda_nmf.TRIM_MAX_BINS,
                             n))
    for G in (1, 4, 64, 132, 512, n):
        slots = cuda_nmf.panel_slots(G, a_card)
        assert 4 * cuda_nmf.phase_ws_floats(p, slots, G) <= guard
    assert cuda_nmf.phase_slot_floats(p) % 4 == 0
    assert cuda_nmf.phase_ldb(p) % 4 == 0 and cuda_nmf.phase_ldb(p) >= p
    assert phase_power_smem_bytes(p) <= SMEM_PER_BLOCK
    assert phase_gram_smem_bytes() <= SMEM_PER_BLOCK
    assert cuda_nmf.scratch_shape(5, p, 64, "stream") == (5, p, 64)
    ws, slots = cuda_nmf.kernel_workspace(2, p, torch.device("cpu"), "stream")
    assert slots == 2 and ws.numel() == cuda_nmf.phase_ws_floats(p, 2, 2)
    # kernel 3 is phased too, with its trim state after the layout's
    ws, slots = cuda_nmf.kernel_workspace(2, p, torch.device("cpu"), "loop",
                                          56, 8)
    assert slots == 2 and ws.numel() == (cuda_nmf.phase_ws_floats(p, 2, 2)
                                         + cuda_nmf.trim_phase_floats(
                                             p, 56, 8, 2))
    ws, slots = cuda_nmf.kernel_workspace(2, p, torch.device("cpu"), "nmf")
    assert slots == 2 and ws.numel() == cuda_nmf.phase_ws_floats(p, 2, 2)


PHASE_RUN_P = 1222
PHASE_WIDTHS = (1024,)        # one bucket, streamed at p = 1,222
PHASE_LENGTHS = (240, 600)


def test_run_matches_jax_engine_at_p1222(monkeypatch):
    """Past 1,152 samples (kernels 2 and 4 on the phased layout on the
    card, the unfused trim loop): at p = 1,222 every bucket streams; the
    port's fit of two genes against the JAX engine's XLA twin on the same
    numpy data at PARITY.md's gate (the gap is printed)."""
    calls = _record(monkeypatch)
    cov, X = make_dataset(seed=17, n=len(PHASE_LENGTHS), p=PHASE_RUN_P,
                          lengths=PHASE_LENGTHS)
    nmf_kw = dict(nmf_iter=4, degnorm_iter=1, bins=6)
    t0 = time.perf_counter()
    rj = jengine.DegNormEngine(
        JNmf(**nmf_kw), JEng(device_loop=False, use_pallas=False,
                             bucket_widths=PHASE_WIDTHS)).run(cov, X)
    t1 = time.perf_counter()
    rt = tengine.DegNormEngine(
        NMFConfig(**nmf_kw),
        EngineConfig(device="cpu", bucket_widths=PHASE_WIDTHS)).run(cov, X)
    print(f"p={PHASE_RUN_P} gap to the JAX XLA twin:", _gap(rt, rj),
          f"(JAX {t1 - t0:.1f} s, port {time.perf_counter() - t1:.1f} s)")
    assert cuda_nmf.panel_phase(PHASE_RUN_P)
    assert {("ratio_rowsums_cuda", (PHASE_RUN_P, 1024)),
            ("nmf_masked_streamed_cuda", (PHASE_RUN_P, 1024))} <= set(calls)
    assert not {c for c in calls
                if c[0] in ("nmf_masked_cuda", "trim_loop_cuda")}
    assert rt.ran_baseline_selection.any()
    _assert_parity(rt, rj)
