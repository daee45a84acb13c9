"""PyTorch port, the opt-in modes (``EngineConfig.nmf_tol``, ``trim_fast``,
``rank1_method="eigh"``) vs the JAX package.

The JAX package reaches its branches in three ways, and each test names the
one it matches:
  * the interpret-mode kernels (``use_pallas=True, pallas_interpret=True,
    gram_mode="vpu"``), against the port's plain versions at
    ``power_warm_plain=1``: float32, K/E/u rtol 1e-4 / atol 1e-4, rho
    rtol 5e-4 / atol 5e-5, flags exact (the tolerances of
    tests/test_pallas.py and tests/test_torch_baseline.py);
  * the XLA twin (``use_pallas=False``), against the port at
    ``power_warm_plain=0``: float64, rtol 1e-8 (same arithmetic, another
    summation order);
  * ``trim_fast`` only through the interpret-mode fused kernel: the XLA loop
    ignores it.
Where a mode applies is the JAX package's rule (``config.nmf_tol_applies``,
``config.trim_fast_applies``), pinned against its gates here.
"""
from collections import OrderedDict

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from degnorm_tpu import engine as jengine
from degnorm_tpu.config import EngineConfig as JEng, NMFConfig as JNmf
from degnorm_tpu.core import baseline as jb
from degnorm_tpu.core import nmf as jn
from degnorm_tpu.ops import pallas_nmf as jp
from degnorm_tpu.ops.pallas_trim import fused_trim_supported, trim_loop_pallas
from degnorm_tpu_torch import EngineConfig, NMFConfig
from degnorm_tpu_torch import config as tconfig
from degnorm_tpu_torch import engine as tengine
from degnorm_tpu_torch.core import baseline as tb
from degnorm_tpu_torch.core import nmf as tn
from degnorm_tpu_torch.ops import cuda_nmf, cuda_trim
from tests.torch_port_util import degraded_bucket, random_coverage, to_np

torch.set_num_threads(1)

KW = dict(nmf_iter=12, power_iters_cold=60, power_iters_warm=12)
LENGTHS = (150, 256, 90, 200, 231, 64)
TRIM_LENGTHS = (200, 256, 180, 230, 140, 250, 210, 160)
FLAGS = ("ran_bs", "est_kind", "bailed", "n_hi", "rounds_active")


def _t(x):
    return torch.from_numpy(np.array(x))


def trim_bucket(seed, p, lengths=TRIM_LENGTHS, W=256, dtype=np.float32):
    """Integral pileups whose odd samples decay toward the 5' end (the
    generator of chip_smoke.py's fits): genes that stay in the trim loop
    for several rounds."""
    rng = np.random.default_rng(seed)
    F = np.zeros((len(lengths), p, W), dtype)
    mask = np.zeros((len(lengths), W), bool)
    odd = np.arange(p) % 2 == 1
    for i, L in enumerate(lengths):
        t = np.arange(L) / (L - 1)
        m = ((0.5 + rng.random(p) * 1.5)[:, None]
             * (np.abs(np.sin(np.pi * t) + 0.2) * (2 + 10 * rng.random())))
        m[odd] *= np.exp(-2.0 * (1 - t)[None, :] * rng.random(p)[odd, None])
        F[i, :, :L] = np.round(m * 20)
        mask[i, :L] = True
    return F, mask


def _assert_flags_equal(rt, rj):
    for name in FLAGS:
        np.testing.assert_array_equal(to_np(getattr(rt, name)),
                                      np.asarray(getattr(rj, name)),
                                      err_msg=name)


# -- nmf_tol: kernel 1's adaptive branch ------------------------------------

@pytest.mark.parametrize("tol", [1e-4, 1e-3])
def test_nmf_tol_plain_matches_pallas_interpret(tol):
    F, mask = degraded_bucket(44, 4, LENGTHS, 256, np.float32)
    Kj, Ej, uj = jp.nmf_masked_pallas(
        jnp.asarray(F), jnp.asarray(mask), interpret=True, gram_mode="vpu",
        power_warm_plain=1, nmf_tol=tol, **KW)
    iters = torch.zeros(len(LENGTHS), dtype=torch.int32)
    Kt, Et, ut = tn.nmf_masked(_t(F), _t(mask), power_warm_plain=1,
                               use_kernels=False, nmf_tol=tol, **KW)
    cuda_nmf.nmf_masked_plain(_t(F), _t(mask), power_warm_plain=1,
                              nmf_tol=tol, iters_out=iters, **KW)
    for a, b in ((Kt, Kj), (Et, Ej), (ut, uj)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    # the freeze really cut loops short, and no gene ran past nmf_iter
    assert int(iters.min()) >= 1 and int(iters.max()) <= KW["nmf_iter"]
    assert int(iters.min()) < KW["nmf_iter"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nmf_tol_plain_matches_xla_twin(dtype):
    F, mask = degraded_bucket(45, 4, LENGTHS, 256, dtype)
    kw = dict(KW, nmf_iter=30)
    Kj, Ej, uj = jn.nmf_masked(jnp.asarray(F), jnp.asarray(mask),
                               nmf_tol=1e-4, **kw)
    Kt, Et, ut = tn.nmf_masked(_t(F), _t(mask), power_warm_plain=0,
                               use_kernels=False, nmf_tol=1e-4, **kw)
    tol = (dict(rtol=1e-8, atol=1e-10) if dtype == np.float64
           else dict(rtol=1e-4, atol=1e-4))
    for a, b in ((Kt, Kj), (Et, Ej), (ut, uj)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), **tol)


def test_nmf_tol_is_invariant_to_splitting_the_batch():
    """Each gene freezes on its own history (tests/test_pallas.py:141-167):
    two halves give the whole batch's result, and the reported iterations;
    an inactive gene returns zeros and 0 iterations."""
    F, mask = degraded_bucket(51, 4, LENGTHS, 256, np.float32)
    kw = dict(KW, nmf_iter=50, power_warm_plain=1, nmf_tol=1e-4)
    it_all = torch.zeros(6, dtype=torch.int32)
    K, E, u = cuda_nmf.nmf_masked_plain(_t(F), _t(mask), iters_out=it_all,
                                        **kw)
    parts = []
    for sl in (slice(0, 2), slice(2, 6)):
        it = torch.zeros(sl.stop - sl.start, dtype=torch.int32)
        parts.append(cuda_nmf.nmf_masked_plain(_t(F[sl]), _t(mask[sl]),
                                               iters_out=it, **kw) + (it,))
    for k, name in enumerate(("K", "E", "u", "iters")):
        np.testing.assert_allclose(
            np.concatenate([to_np(p[k]) for p in parts]),
            to_np((K, E, u, it_all)[k]), rtol=1e-6, atol=1e-7, err_msg=name)
    act = torch.tensor([True, False, True, True, True, False])
    it_act = torch.zeros(6, dtype=torch.int32)
    Ka, _, _ = cuda_nmf.nmf_masked_plain(_t(F), _t(mask), gene_active=act,
                                         iters_out=it_act, **kw)
    assert torch.equal(Ka[act], K[act]) and bool((Ka[~act] == 0).all())
    assert torch.equal(it_act[act], it_all[act])
    assert int(it_act[~act].abs().sum()) == 0


def test_nmf_tol_ignored_where_the_jax_package_streams():
    """p=8, W=8192 is inside the port's resident gate but past the JAX
    package's (p*W > 60,854): JAX streams it and its streamed kernel ignores
    nmf_tol, so the port ignores it there too, and matches the interpret-mode
    streamed kernel."""
    shape = (2, 8, 8192)
    assert cuda_nmf.kernels_supported(shape, torch.float32)
    assert not tconfig.nmf_tol_applies(shape)
    assert not jp.pallas_supported(shape, jnp.float32)
    F, mask = degraded_bucket(60, 8, (7000, 8192), 8192, np.float32)
    kw = dict(nmf_iter=6, power_iters_cold=40, power_iters_warm=12)
    Kt, Et, _ = tn.nmf_masked(_t(F), _t(mask), power_warm_plain=1,
                              use_kernels=True, nmf_tol=1e-2, **kw)
    K0, E0, _ = tn.nmf_masked(_t(F), _t(mask), power_warm_plain=1,
                              use_kernels=True, **kw)
    assert torch.equal(Kt, K0) and torch.equal(Et, E0)
    Kj, Ej, _ = jn.nmf_masked(jnp.asarray(F), jnp.asarray(mask),
                              use_pallas=True, pallas_interpret=True,
                              gram_mode="vpu", power_warm_plain=1,
                              nmf_tol=1e-2, **kw)
    np.testing.assert_allclose(to_np(Kt), np.asarray(Kj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(to_np(Et), np.asarray(Ej), rtol=1e-4,
                               atol=1e-4)


def test_nmf_tol_ignored_where_the_port_streams():
    """The deliberate difference (ROADMAP Queue 3): p <= 3 at W = 16384 is
    inside the JAX package's resident gate, so it applies nmf_tol there, but
    past the port's (W > 8192): the port streams it, and its streamed kernel
    has no adaptive branch."""
    shape = (2, 2, 16384)
    assert tconfig.nmf_tol_applies(shape)
    assert not cuda_nmf.kernels_supported(shape, torch.float32)
    F, mask = degraded_bucket(61, 2, (9000, 16384), 16384, np.float32)
    kw = dict(nmf_iter=4, power_iters_cold=20, power_iters_warm=12,
              power_warm_plain=1, use_kernels=True)
    a = tn.nmf_masked(_t(F), _t(mask), nmf_tol=1e-2, **kw)
    b = tn.nmf_masked(_t(F), _t(mask), **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# -- the trim loop: trim_fast and nmf_tol in kernel 3 ------------------------

def _jax_fused(F, mask, nmf_iter, **eng):
    return jb.baseline_select_bucket(
        jnp.asarray(F), jnp.asarray(mask), JNmf(nmf_iter=nmf_iter),
        JEng(use_pallas=True, pallas_interpret=True, fuse_trim=True,
             gram_mode="vpu", **eng))


def _port(F, mask, nmf_iter, **eng):
    return tb.baseline_select_bucket(
        _t(F), _t(mask), NMFConfig(nmf_iter=nmf_iter),
        EngineConfig(device="cpu", **eng))


@pytest.mark.parametrize("nmf_iter", [12, 40])
def test_trim_fast_matches_fused_interpret_kernel(nmf_iter):
    """The fused plain loop with trim_fast (n_it = max(nmf_iter // 4, 8):
    8 and 10 steps a round) against the JAX package's fused kernel in
    interpret mode, through baseline_select_bucket; with the kernels on or
    off the port takes the fused loop (its plain version on the CPU)."""
    F, mask = trim_bucket(54, 8)
    rj = _jax_fused(F, mask, nmf_iter, trim_fast=True)
    for use_kernels in (True, False):
        rt = _port(F, mask, nmf_iter, trim_fast=True,
                   use_kernels=use_kernels)
        assert int(to_np(rt.ran_bs).sum()) > 0, "trim loop never ran"
        assert int(to_np(rt.rounds_active).max()) > 1
        _assert_flags_equal(rt, rj)
        np.testing.assert_allclose(to_np(rt.rho), np.asarray(rj.rho),
                                   rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(to_np(rt.est_K), np.asarray(rj.est_K),
                                   rtol=5e-4, atol=5e-4)
    # and it is a different result from the default loop's
    r0 = _port(F, mask, nmf_iter)
    assert not torch.equal(r0.rho, rt.rho)


def test_trim_fast_plain_loop_matches_trim_loop_pallas_interpret():
    """The plain trim function against the TPU kernel called directly
    (fast=True), on the same loop inputs; the iterations it reports are
    n_it a round that ran its NMF."""
    F, mask = trim_bucket(55, 4)
    nmf_cfg = NMFConfig(nmf_iter=12)
    eng_cfg = EngineConfig(device="cpu", use_kernels=False)
    ti = tb.trim_inputs(_t(F), _t(mask), nmf_cfg, eng_cfg)
    kw = tb.trim_kwargs(nmf_cfg, eng_cfg)
    args = (ti.Fm, ti.bin_id, ti.bin_count, ti.K0, ti.E0, ti.rho0, ti.u0,
            ti.n_hi, ti.n_bins0, ti.active0)
    iters = torch.zeros(len(TRIM_LENGTHS), dtype=torch.int32)
    Kt, rhot, rant, roundst = cuda_trim.trim_loop_plain(
        *args, trim_fast=True, iters_out=iters, **kw)
    Kj, rhoj, ranj, roundsj = trim_loop_pallas(
        *[jnp.asarray(to_np(x)) for x in args], gram_mode="vpu",
        interpret=True, fast=True, **kw)
    assert int(to_np(rant).sum()) > 0
    np.testing.assert_array_equal(to_np(rant), np.asarray(ranj))
    np.testing.assert_array_equal(to_np(roundst), np.asarray(roundsj))
    np.testing.assert_allclose(to_np(rhot), np.asarray(rhoj), rtol=5e-4,
                               atol=5e-5)
    np.testing.assert_allclose(to_np(Kt), np.asarray(Kj), rtol=5e-4,
                               atol=5e-4)
    it, rd = to_np(iters), to_np(roundst)
    assert np.all(it % 8 == 0) and np.all(it <= 8 * rd)
    assert np.all(it[rd > 0] >= 8 * (rd[rd > 0] - 1))


def test_trim_path_nmf_tol_matches_jax():
    """Baseline selection at nmf_tol=1e-4 (tests/test_pallas.py:187-203):
    the port's fused plain loop against the fused kernel in interpret mode,
    and its unfused loop against the XLA while_loop in float64."""
    F, mask = trim_bucket(53, 4)
    rj = _jax_fused(F, mask, 12, nmf_tol=1e-4)
    rt = _port(F, mask, 12, nmf_tol=1e-4, use_kernels=True)
    assert int(to_np(rt.ran_bs).sum()) > 0, "trim loop never ran"
    _assert_flags_equal(rt, rj)
    np.testing.assert_allclose(to_np(rt.rho), np.asarray(rj.rho), rtol=5e-4,
                               atol=5e-5)
    F64 = F.astype(np.float64)
    rx = jb.baseline_select_bucket(
        jnp.asarray(F64), jnp.asarray(mask), JNmf(nmf_iter=12),
        JEng(use_pallas=False, dtype="float64", nmf_tol=1e-4))
    rt64 = _port(F64, mask, 12, nmf_tol=1e-4, use_kernels=False,
                 dtype="float64", power_warm_plain=0)
    _assert_flags_equal(rt64, rx)
    np.testing.assert_allclose(to_np(rt64.rho), np.asarray(rx.rho),
                               rtol=1e-7, atol=1e-12)


def test_trim_plain_loop_reports_iterations_of_its_rounds():
    """Default mode: nmf_iter a round that ran its NMF; nmf_tol (loose
    enough to freeze genes at 20 iterations): at most that, and fewer
    somewhere."""
    F, mask = trim_bucket(56, 8)
    nmf_cfg = NMFConfig(nmf_iter=20)
    eng_cfg = EngineConfig(device="cpu", use_kernels=False)
    ti = tb.trim_inputs(_t(F), _t(mask), nmf_cfg, eng_cfg)
    kw = tb.trim_kwargs(nmf_cfg, eng_cfg)
    args = (ti.Fm, ti.bin_id, ti.bin_count, ti.K0, ti.E0, ti.rho0, ti.u0,
            ti.n_hi, ti.n_bins0, ti.active0)
    it0 = torch.zeros(len(TRIM_LENGTHS), dtype=torch.int32)
    it1 = torch.zeros_like(it0)
    _, _, _, rounds = cuda_trim.trim_loop_plain(*args, iters_out=it0, **kw)
    cuda_trim.trim_loop_plain(*args, iters_out=it1, nmf_tol=2e-2, **kw)
    assert int(rounds.max()) > 0
    assert np.all(to_np(it0) % 20 == 0)
    assert np.all(to_np(it0) <= 20 * to_np(rounds))
    assert np.all(to_np(it1) <= to_np(it0)) and int(it1.sum()) < int(it0.sum())
    with pytest.raises(ValueError):
        cuda_trim.trim_loop_plain(*args, trim_fast=True,
                                  nmf_fn=lambda *a: None, **kw)


# -- rank1_method="eigh" ----------------------------------------------------

def test_eigh_bucket_matches_xla_twin():
    F, mask = trim_bucket(57, 4, dtype=np.float64)
    rj = jb.baseline_select_bucket(
        jnp.asarray(F), jnp.asarray(mask), JNmf(nmf_iter=12),
        JEng(use_pallas=False, dtype="float64", rank1_method="eigh"))
    before = (cuda_nmf.nmf_launches, cuda_trim.trim_launches)
    for use_kernels in (True, False):
        rt = _port(F, mask, 12, rank1_method="eigh", dtype="float64",
                   use_kernels=use_kernels)
        assert int(to_np(rt.ran_bs).sum()) > 0, "trim loop never ran"
        _assert_flags_equal(rt, rj)
        np.testing.assert_allclose(to_np(rt.rho), np.asarray(rj.rho),
                                   rtol=1e-7, atol=1e-12)
        live = ~to_np(rt.bailed)
        np.testing.assert_allclose(to_np(rt.est_K)[live],
                                   np.asarray(rj.est_K)[live], rtol=1e-7)
    assert (cuda_nmf.nmf_launches, cuda_trim.trim_launches) == before
    # the initialisation's row sums too
    cs_j, es_j = jn.ratio_svd_rowsums(jnp.asarray(F), jnp.asarray(mask),
                                      power_iters=8, method="eigh")
    cs_t, es_t = tn.ratio_svd_rowsums(_t(F), _t(mask), power_iters=8,
                                      method="eigh")
    np.testing.assert_allclose(to_np(cs_t), np.asarray(cs_j), rtol=1e-12)
    np.testing.assert_allclose(to_np(es_t), np.asarray(es_j), rtol=1e-9)


def test_eigh_differs_from_the_fused_tpu_path():
    """The deliberate difference (ROADMAP Queue 3): the JAX package on a TPU
    runs eigh in its initial fits but power iteration in its fused trim
    rounds (``use_fused`` ignores the method); the port follows its XLA twin
    and runs eigh in every fit, so its plain unfused loop, not the fused
    one, is what an eigh bucket takes."""
    F, mask = degraded_bucket(58, 4, TRIM_LENGTHS, 256, np.float32)
    cfg = NMFConfig(nmf_iter=12)
    eng = EngineConfig(device="cpu", rank1_method="eigh")
    calls = []
    # the unfused loop is the step generator that trim_loop_plain runs
    orig = cuda_trim.trim_loop_steps

    def spy(*a, **k):
        calls.append(k.get("nmf_fn") is not None)
        return orig(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_trim, "trim_loop_steps", spy)
        mp.setattr(cuda_trim, "trim_loop_cuda",
                   lambda *a, **k: pytest.fail("fused loop taken"))
        tb.baseline_select_bucket(_t(F), _t(mask), cfg, eng)
    assert calls == [True]


# -- where a mode applies ----------------------------------------------------

def test_mode_predicates_equal_the_jax_gates():
    widths = list(range(128, 65537, 128)) + [100, 1000, 4000, 8193, 40000]
    for p in range(2, 33):
        for W in widths:
            shape = (8, p, W)
            assert tconfig.nmf_tol_applies(shape) == jp.pallas_supported(
                shape, jnp.float32), shape
            assert tconfig.trim_fast_applies(shape) == fused_trim_supported(
                shape, jnp.float32), shape
    # the default buckets between the two rules: the port fuses or keeps
    # them resident, the JAX package does not, and the mode is ignored
    for shape in ((8, 8, 8192), (8, 16, 4096), (8, 32, 2048), (8, 7, 8192)):
        assert cuda_trim.fused_trim_supported(shape, torch.float32)
        assert not tconfig.trim_fast_applies(shape)
    for shape in ((8, 8, 8192), (8, 16, 4096), (8, 32, 2048)):
        assert not tconfig.nmf_tol_applies(shape)


def test_trim_fast_ignored_where_the_jax_package_does_not_fuse():
    """p=8 at W=1024 * 7 = 7168 (p*W = 57,344 > 53,248): the port fuses the
    bucket but trim_fast does not apply; the result is the default one."""
    rng = np.random.default_rng(59)
    mats = [random_coverage(rng, 8, L, degraded=(i % 2 == 0)).astype(
        np.float32) for i, L in enumerate((7000, 6500))]
    F = np.zeros((2, 8, 7168), np.float32)
    mask = np.zeros((2, 7168), bool)
    for i, m in enumerate(mats):
        F[i, :, :m.shape[1]] = m
        mask[i, :m.shape[1]] = True
    assert not tconfig.trim_fast_applies(F.shape)
    a = _port(F, mask, 6, trim_fast=True)
    b = _port(F, mask, 6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# -- the engine, each mode ---------------------------------------------------

def _dataset(seed=21, n=16, p=4):
    rng = np.random.default_rng(seed)
    cov = OrderedDict()
    for i in range(n):
        L = int(120 + rng.integers(0, 380))
        cov[f"gene{i}"] = random_coverage(
            rng, p, L, scale=3 + 6 * rng.random(), degraded=(i % 2 == 0))
    X = np.round(np.abs(rng.standard_normal((n, p))) * 300 + 30)
    return cov, X


def _assert_all_up(rt, rj):
    """PARITY.md's all-up tolerances: DI atol 5e-3, adjusted counts rtol
    5e-3, ran_baseline_selection exact."""
    np.testing.assert_array_equal(rt.ran_baseline_selection,
                                  rj.ran_baseline_selection)
    np.testing.assert_allclose(rt.rho, rj.rho, rtol=0, atol=5e-3)
    np.testing.assert_allclose(rt.x_adj, rj.x_adj, rtol=5e-3)


def test_engine_trim_fast_matches_jax_interpret_engine():
    cov, X = _dataset()
    nmf_kw = dict(nmf_iter=12, degnorm_iter=2)
    rj = jengine.DegNormEngine(
        JNmf(**nmf_kw),
        JEng(device_loop=False, use_pallas=True, pallas_interpret=True,
             gram_mode="vpu", bucket_widths=(512,), trim_fast=True)
    ).run(cov, X)
    rt = tengine.DegNormEngine(
        NMFConfig(**nmf_kw),
        EngineConfig(device="cpu", bucket_widths=(512,), trim_fast=True)
    ).run(cov, X)
    assert rt.ran_baseline_selection.any()
    _assert_all_up(rt, rj)


@pytest.mark.parametrize("mode", [dict(nmf_tol=1e-4),
                                  dict(rank1_method="eigh")])
def test_engine_mode_matches_jax_xla_engine(mode):
    """nmf_tol and eigh against the XLA twin in float64 with the port on its
    warm scheme: the bound of tests/test_torch_engine.py (1e-9), well inside
    the all-up tolerances."""
    cov, X = _dataset(seed=22)
    nmf_kw = dict(nmf_iter=10, degnorm_iter=2)
    rj = jengine.DegNormEngine(
        JNmf(**nmf_kw),
        JEng(device_loop=False, use_pallas=False, dtype="float64",
             bucket_widths=(512,), **mode)).run(cov, X)
    rt = tengine.DegNormEngine(
        NMFConfig(**nmf_kw),
        EngineConfig(device="cpu", use_kernels=False, dtype="float64",
                     power_warm_plain=0, bucket_widths=(512,), **mode)
    ).run(cov, X)
    assert rt.ran_baseline_selection.any()
    _assert_all_up(rt, rj)
    np.testing.assert_allclose(rt.rho, rj.rho, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.x_adj, rj.x_adj, rtol=1e-9)


def test_modes_are_accepted_and_validated():
    for kw in (dict(trim_fast=True), dict(nmf_tol=1e-4),
               dict(rank1_method="eigh")):
        cfg = EngineConfig(device="cpu", **kw)
        assert all(getattr(cfg, k) == v for k, v in kw.items())
    with pytest.raises(ValueError):
        EngineConfig(rank1_method="svd")
    with pytest.raises(ValueError):
        EngineConfig(nmf_tol=-1.0)
    assert NMFConfig(downsample_rate=3).ds_compat == "keyed"
