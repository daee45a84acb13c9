"""Studies of more than 640 samples: the cluster layout of kernels 2 and 4
past 640 samples (csrc/panel.cuh's ``pcl_*`` code with clusters of T
blocks, csrc/stream_panel.cu, csrc/ratio_panel.cu) against its Python
mirror in ops/cuda_nmf.py at every p from 129 to the cut of kernels 2 and
4, and the port's plain versions against the JAX engine at p = 704, where
every bucket streams (past the cut: tests/test_torch_panelphase.py).

The kernels run only on the card (``chip_smoke.py`` phase ``panels``);
here the geometry the launches take and the arithmetic of the plain
versions, at PARITY.md's gate (DI atol 5e-3, adjusted counts rtol 5e-3,
ran_baseline_selection exact) against the JAX engine's XLA twin."""
import time

import numpy as np
import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets it)
import pytest
import torch

from degnorm_tpu import engine as jengine
from degnorm_tpu.config import EngineConfig as JEng, NMFConfig as JNmf
from degnorm_tpu_torch import EngineConfig, NMFConfig
from degnorm_tpu_torch import engine as tengine
from degnorm_tpu_torch.ops import cuda_nmf
from tests.test_torch_widep import (_assert_parity, _gap, _record,
                                    make_dataset, wide_smem_bytes)

SMEM_PER_BLOCK = 232448        # the H100's opt-in shared memory a block
MAX_PORTABLE = 8               # the largest portable cluster
MAX_NONPORTABLE = 16           # the largest cluster an H100 takes at all
R = cuda_nmf.PANEL_ROWS
STREAM_T = range(2, cuda_nmf.pcl_T(cuda_nmf.PCL_MAX_P_STREAM) + 1)


def _p_of(T):
    """Every p of kernels 2 and 4's cluster layout with T panels."""
    return range(max(cuda_nmf.WIDE_MAX_P + 1, (T - 1) * R + 1),
                 min(T * R, cuda_nmf.PCL_MAX_P_STREAM) + 1)


def _blocks(p):
    """Each block's pairs of a gene's cluster at p, as the kernels deal
    them: block `rank` holds pairs rank, rank + C, ... (``PclWork::hold``)."""
    C, h, n = cuda_nmf.pcl_size(p), cuda_nmf.pcl_held(p), cuda_nmf.pcl_pairs(p)
    T = cuda_nmf.pcl_T(p)
    return [[cuda_nmf.pcl_pair(T, e) for e in range(r, n, C)][:h]
            for r in range(C)]


@pytest.mark.parametrize("T", STREAM_T)
def test_cluster_geometry_of_kernels_2_and_4(T):
    """At every p of kernels 2 and 4's cluster layout (by its panels T):
    each diagonal pair is the first pair of its own block (the pass that
    publishes v's partials and writes X back), past 1,024 samples a
    cluster of T blocks that is not portable (asked for as such) and at
    most 8 blocks below, the pairs cover the upper triangle once, each
    block's shared memory (the core's and the kernel's static state) fits
    the card's, the workspace is a cluster's slot where a block holds
    several pairs, and X is kept column by column."""
    assert T == 9 or _p_of(T)[-1] == T * R
    for p in _p_of(T):
        _check_geometry(p, T)


def _check_geometry(p, T):
    assert cuda_nmf.pcl_T(p) == T
    C, h = cuda_nmf.pcl_size(p), cuda_nmf.pcl_held(p)
    blocks = _blocks(p)
    assert T <= C
    for P in range(T):
        assert blocks[P][0] == (P, P)
    if T > cuda_nmf.PCL_MAX_C:
        assert C == T and h == -(-(T + 1) // 2)
        assert cuda_nmf.pcl_shared_power(p)
    else:
        assert C <= cuda_nmf.PCL_MAX_C and not cuda_nmf.pcl_shared_power(p)
    assert C <= MAX_PORTABLE or (MAX_PORTABLE < C == T <= MAX_NONPORTABLE
                                 and p > 1024)
    pairs = [e for b in blocks for e in b]
    assert sorted(pairs) == [(i, j) for i in range(T) for j in range(i, T)]
    assert max(len(b) for b in blocks) == h
    for kernel in ("stream", "ratio"):
        assert cuda_nmf.panel_cluster(p, "stream")
        smem = wide_smem_bytes(kernel, p, 16384)
        assert smem == cuda_nmf.pcl_smem_bytes(p) + (4 if kernel == "stream"
                                                     else 0)
        assert smem <= SMEM_PER_BLOCK, (p, kernel, smem)
    ws, slots = cuda_nmf.kernel_workspace(24576, p, torch.device("cpu"),
                                          "stream")
    if h == 1:
        assert (ws, slots) == (None, 0)
    else:
        assert slots == cuda_nmf.SMS // C
        assert ws.numel() == slots * cuda_nmf.pcl_ws_floats(p)
        assert cuda_nmf.pcl_ws_floats(p) == \
            cuda_nmf.pcl_pairs(p) * (2 * R * (R + 4) + 2 * R * R)
    assert cuda_nmf.scratch_shape(5, p, 64, "stream") == (5, 64, -(-p // 4) * 4)


@pytest.mark.parametrize("p", [129, 256, 384, 640, 641, 768, 1000, 1024,
                               1025, 1152])
def test_shared_power_step_rows_cover_p_once(p):
    """Where the blocks share the power step (kernel 2 at every p, kernel
    4 past 640 samples), block P < T publishes panel P's rows of a matvec
    (rows P * 128 .. min(p, P * 128 + 128) - 1, two threads a row over
    the first ceil(T / 2) panels of columns and the rest) and every block
    copies row i from block i // 128: every row of p comes from exactly one
    block, every entry of a row from exactly one of its two threads, and
    the blocks past T (a cluster larger than T at T <= 5) publish none."""
    T, C = cuda_nmf.pcl_T(p), cuda_nmf.pcl_size(p)
    assert cuda_nmf.pcl_shared_power(p) == (T > cuda_nmf.PCL_MAX_C)
    assert C >= T and (C == T or T <= cuda_nmf.PCL_MAX_C)
    rows = [list(range(P * R, min(p, P * R + R))) for P in range(T)]
    assert [i for r in rows for i in r] == list(range(p))
    assert all(rows) and all(i // R == P for P, r in enumerate(rows)
                             for i in r)
    Jm = (T + 1) // 2
    halves = [list(range(0, min(p, Jm * R))), list(range(Jm * R, p))]
    assert all(halves) and halves[0] + halves[1] == list(range(p))


BIG_P = 704
BIG_WIDTHS = (1024,)          # one bucket, streamed at p = 704
BIG_LENGTHS = (240, 600)


def test_run_matches_jax_engine_at_p704(monkeypatch):
    """Past 640 samples (kernels 2 and 4 on clusters of six blocks on the
    card, the unfused trim loop): at p = 704 every bucket streams; the
    port's fit of two genes against the JAX engine's XLA twin on the same
    numpy data at PARITY.md's gate (the gap is printed)."""
    calls = _record(monkeypatch)
    cov, X = make_dataset(seed=15, n=len(BIG_LENGTHS), p=BIG_P,
                          lengths=BIG_LENGTHS)
    nmf_kw = dict(nmf_iter=4, degnorm_iter=1, bins=6)
    t0 = time.perf_counter()
    rj = jengine.DegNormEngine(
        JNmf(**nmf_kw), JEng(device_loop=False, use_pallas=False,
                             bucket_widths=BIG_WIDTHS)).run(cov, X)
    t1 = time.perf_counter()
    rt = tengine.DegNormEngine(
        NMFConfig(**nmf_kw),
        EngineConfig(device="cpu", bucket_widths=BIG_WIDTHS)).run(cov, X)
    print(f"p={BIG_P} gap to the JAX XLA twin:", _gap(rt, rj),
          f"(JAX {t1 - t0:.1f} s, port {time.perf_counter() - t1:.1f} s)")
    assert {("ratio_rowsums_cuda", (BIG_P, 1024)),
            ("nmf_masked_streamed_cuda", (BIG_P, 1024))} <= set(calls)
    assert not {c for c in calls
                if c[0] in ("nmf_masked_cuda", "trim_loop_cuda")}
    assert rt.ran_baseline_selection.any()
    _assert_parity(rt, rj)


def test_run_matches_pallas_interpret_at_p704():
    """The port's plain versions at p = 704 against the JAX engine's Pallas
    kernels in interpret mode (the fused kernels' warm scheme, one plain
    matvec), two genes of a streamed bucket."""
    cov, X = make_dataset(seed=16, n=2, p=BIG_P, lengths=(220, 240))
    nmf_kw = dict(nmf_iter=3, degnorm_iter=1, bins=6)
    rj = jengine.DegNormEngine(
        JNmf(**nmf_kw),
        JEng(device_loop=False, use_pallas=True, pallas_interpret=True,
             gram_mode="vpu", bucket_widths=BIG_WIDTHS)).run(cov, X)
    rt = tengine.DegNormEngine(
        NMFConfig(**nmf_kw),
        EngineConfig(device="cpu", bucket_widths=BIG_WIDTHS,
                     power_warm_plain=1)).run(cov, X)
    print(f"p={BIG_P} gap to the Pallas interpret path:", _gap(rt, rj))
    _assert_parity(rt, rj)
