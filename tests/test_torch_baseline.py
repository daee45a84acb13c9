"""PyTorch port, core/baseline.py + the plain trim loop (ops/cuda_trim.py) vs
the JAX package.

  * float64 vs the XLA ``lax.while_loop`` (``use_pallas=False``), with the
    port at ``power_warm_plain=0``: rho rtol 1e-7, every flag exact.
  * float32 vs the fused trim kernel in interpret mode (``gram_mode="vpu"``,
    plain warm matvec), with the port at ``power_warm_plain=1``: rho
    rtol 5e-4 / atol 5e-5, flags exact (tests/test_pallas.py:240).
  * a wide bucket (outside the resident kernels' gate in both packages: the
    unfused loop around the streamed NMF) at the same two tolerances.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from degnorm_tpu.config import EngineConfig as JEng, NMFConfig as JNmf
from degnorm_tpu.core import baseline as jb
from degnorm_tpu.ops.pallas_trim import trim_loop_pallas
from degnorm_tpu_torch.config import EngineConfig, NMFConfig
from degnorm_tpu_torch.core import baseline as tb
from degnorm_tpu_torch.ops import cuda_trim
from tests.torch_port_util import (degraded_bucket, make_bucket_np,
                                   random_coverage, to_np)

torch.set_num_threads(1)

LENGTHS = (200, 256, 180, 230, 140, 250, 210, 160)
FLAGS = ("ran_bs", "est_kind", "bailed", "n_hi", "rounds_active")


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(F, mask, nmf_kw, eng_kw, ds_start=None):
    return tb.baseline_select_bucket(
        _t(F), _t(mask), NMFConfig(**nmf_kw),
        EngineConfig(device="cpu", use_kernels=False, **eng_kw),
        ds_start=None if ds_start is None else _t(ds_start))


def _assert_flags_equal(rt, rj):
    for name in FLAGS:
        np.testing.assert_array_equal(to_np(getattr(rt, name)),
                                      np.asarray(getattr(rj, name)),
                                      err_msg=name)


def test_baseline_matches_xla_loop_f64():
    F, mask = degraded_bucket(46, 4, LENGTHS, 256, np.float64)
    rj = jb.baseline_select_bucket(
        jnp.asarray(F), jnp.asarray(mask), JNmf(nmf_iter=12),
        JEng(use_pallas=False, dtype="float64"))
    rt = _port(F, mask, dict(nmf_iter=12),
               dict(dtype="float64", power_warm_plain=0))
    assert int(to_np(rt.ran_bs).sum()) > 0, "trim loop never ran"
    _assert_flags_equal(rt, rj)
    np.testing.assert_allclose(to_np(rt.rho), np.asarray(rj.rho), rtol=1e-7,
                               atol=1e-12)
    live = ~to_np(rt.bailed)
    np.testing.assert_allclose(to_np(rt.est_K)[live],
                               np.asarray(rj.est_K)[live], rtol=1e-7)
    np.testing.assert_allclose(to_np(rt.est_E)[live],
                               np.asarray(rj.est_E)[live], rtol=1e-7,
                               atol=1e-12)


def test_baseline_matches_fused_interpret_kernel_f32():
    F, mask = degraded_bucket(46, 4, LENGTHS, 256, np.float32)
    rj = jb.baseline_select_bucket(
        jnp.asarray(F), jnp.asarray(mask), JNmf(nmf_iter=12),
        JEng(use_pallas=True, pallas_interpret=True, fuse_trim=True,
             gram_mode="vpu"))
    rt = _port(F, mask, dict(nmf_iter=12), dict(power_warm_plain=1))
    assert int(to_np(rt.ran_bs).sum()) > 0, "trim loop never ran"
    _assert_flags_equal(rt, rj)
    np.testing.assert_allclose(to_np(rt.rho), np.asarray(rj.rho), rtol=5e-4,
                               atol=5e-5)
    np.testing.assert_allclose(to_np(rt.est_K), np.asarray(rj.est_K),
                               rtol=5e-4, atol=5e-4)


def test_plain_trim_loop_matches_trim_loop_pallas_interpret():
    """The plain trim function against the TPU kernel called directly, on
    the same loop inputs (made by the port, handed over as numpy)."""
    F, mask = degraded_bucket(46, 4, LENGTHS, 256, np.float32)
    nmf_cfg = NMFConfig(nmf_iter=12)
    eng_cfg = EngineConfig(device="cpu", use_kernels=False)
    ti = tb.trim_inputs(_t(F), _t(mask), nmf_cfg, eng_cfg)
    kw = tb.trim_kwargs(nmf_cfg, eng_cfg)
    Kt, rhot, rant, roundst = cuda_trim.trim_loop_plain(
        ti.Fm, ti.bin_id, ti.bin_count, ti.K0, ti.E0, ti.rho0, ti.u0,
        ti.n_hi, ti.n_bins0, ti.active0, **kw)
    j = [jnp.asarray(to_np(x)) for x in (
        ti.Fm, ti.bin_id, ti.bin_count, ti.K0, ti.E0, ti.rho0, ti.u0,
        ti.n_hi, ti.n_bins0, ti.active0)]
    Kj, rhoj, ranj, roundsj = trim_loop_pallas(
        *j, gram_mode="vpu", interpret=True, **kw)
    assert int(to_np(rant).sum()) > 0
    np.testing.assert_array_equal(to_np(rant), np.asarray(ranj))
    np.testing.assert_array_equal(to_np(roundst), np.asarray(roundsj))
    np.testing.assert_allclose(to_np(rhot), np.asarray(rhoj), rtol=5e-4,
                               atol=5e-5)
    np.testing.assert_allclose(to_np(Kt), np.asarray(Kj), rtol=5e-4,
                               atol=5e-4)
    # a gene that never enters keeps K0, rho0, False, 0
    out = ~to_np(ti.active0)
    np.testing.assert_array_equal(to_np(Kt)[out], to_np(ti.K0)[out])
    np.testing.assert_array_equal(to_np(rhot)[out], to_np(ti.rho0)[out])
    assert not to_np(rant)[out].any() and to_np(roundst)[out].sum() == 0


def test_trim_wrapper_on_cpu_is_the_plain_version():
    F, mask = degraded_bucket(50, 3, LENGTHS[:4], 256, np.float32)
    nmf_cfg = NMFConfig(nmf_iter=6)
    before = cuda_trim.trim_launches
    a = tb.baseline_select_bucket(_t(F), _t(mask), nmf_cfg,
                                  EngineConfig(device="cpu", use_kernels=True))
    b = tb.baseline_select_bucket(_t(F), _t(mask), nmf_cfg,
                                  EngineConfig(device="cpu", use_kernels=False))
    c = tb.baseline_select_bucket(_t(F), _t(mask), nmf_cfg,
                                  EngineConfig(device="cpu", fuse_trim=False))
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert cuda_trim.trim_launches == before
    # the unfused loop runs with the kernels on or off; the streamed NMF has
    # no other lowering to switch to
    assert EngineConfig(device="cuda", fuse_trim=False,
                        use_kernels=True).fuse_trim is False
    EngineConfig(device="cuda", fuse_trim=False, use_kernels=False)
    with pytest.raises(NotImplementedError):
        EngineConfig(device="cuda", stream_nmf=False)


def test_baseline_downsample_matches_xla_loop_f64():
    F, mask = degraded_bucket(51, 3, (400, 512, 300, 480), 512, np.float64)
    ds = np.array([0, 2, 1, 2], np.int32)
    rj = jb.baseline_select_bucket(
        jnp.asarray(F), jnp.asarray(mask),
        JNmf(nmf_iter=8, downsample_rate=3),
        JEng(use_pallas=False, dtype="float64"), ds_start=jnp.asarray(ds))
    rt = _port(F, mask, dict(nmf_iter=8, downsample_rate=3),
               dict(dtype="float64", power_warm_plain=0), ds_start=ds)
    _assert_flags_equal(rt, rj)
    np.testing.assert_allclose(to_np(rt.rho), np.asarray(rj.rho), rtol=1e-7,
                               atol=1e-12)
    with pytest.raises(ValueError):
        _port(F, mask, dict(nmf_iter=8, downsample_rate=3),
              dict(dtype="float64"))


def test_baseline_skip_baseline_selection():
    """tests/test_core_parity.py::test_baseline_bucket_skip_baseline."""
    rng = np.random.default_rng(12)
    mats = [random_coverage(rng, 4, L, degraded=True) for L in (260, 400)]
    F, mask = make_bucket_np(mats, 512)
    rj = jb.baseline_select_bucket(
        jnp.asarray(F), jnp.asarray(mask),
        JNmf(nmf_iter=8, skip_baseline_selection=True),
        JEng(use_pallas=False, dtype="float64"))
    rt = _port(F, mask, dict(nmf_iter=8, skip_baseline_selection=True),
               dict(dtype="float64", power_warm_plain=0))
    assert not to_np(rt.ran_bs).any()
    _assert_flags_equal(rt, rj)
    np.testing.assert_allclose(to_np(rt.rho), np.asarray(rj.rho), rtol=1e-7)
    for i, m in enumerate(mats):
        est_t = tb.materialize_estimate(
            F[i], m.shape[1], to_np(rt.est_K)[i], to_np(rt.est_E)[i],
            int(to_np(rt.est_kind)[i]))
        est_j = jb.materialize_estimate(
            F[i], m.shape[1], np.asarray(rj.est_K)[i],
            np.asarray(rj.est_E)[i], int(np.asarray(rj.est_kind)[i]))
        np.testing.assert_allclose(est_t, est_j, rtol=1e-7, atol=1e-10)


def test_baseline_tiny_and_padding_genes_bail():
    """Genes below min_high_coverage and all-zero padding genes (length 1)
    bail with rho = 0 and estimate = F, never reaching a NaN
    (tests/test_core_parity.py::test_baseline_bucket_tiny_genes_bail)."""
    rng = np.random.default_rng(13)
    mats = [random_coverage(rng, 3, 30), random_coverage(rng, 3, 40)]
    F, mask = make_bucket_np(mats + [np.zeros((3, 1))], 64)
    for dtype in ("float64", "float32"):
        rt = _port(F.astype(dtype), mask, dict(nmf_iter=5), dict(dtype=dtype))
        assert to_np(rt.bailed).all()
        np.testing.assert_array_equal(to_np(rt.rho), 0.0)
        assert (to_np(rt.est_kind) == tb.EST_INPUT).all()
        for t in rt:
            assert torch.isfinite(t.double()).all()


# ---- wide buckets: the unfused loop around the streamed NMF ----------------

# (p, W) -> threads a block of kernels 1 and 3
LOOP_THREAD_PINS = [
    (8, 1024, 64),       # the narrow fit's two buckets
    (8, 4096, 256),
    (8, 8192, 512),      # the bound of the p <= 8 instances
    (32, 2048, 128),
    (16, 4096, 256),     # the bound of the p > 8 instances
    (4, 384, 32),        # one warp at least
]

WIDE_P, WIDE_W = 32, 2176          # p * W = 69,632: outside both gates
WIDE_LENGTHS = (2176, 1500, 1900, 1300, 2050)


def test_wide_shape_is_outside_both_gates():
    from degnorm_tpu.ops.pallas_nmf import pallas_supported
    from degnorm_tpu.ops.pallas_stream import streamed_supported
    from degnorm_tpu.ops.pallas_trim import fused_trim_supported as jfused
    shape = (len(WIDE_LENGTHS), WIDE_P, WIDE_W)
    assert not pallas_supported(shape, jnp.float32)
    assert not jfused(shape, jnp.float32)
    assert streamed_supported(shape, jnp.float32)
    assert not cuda_trim.fused_trim_supported(shape, torch.float32)
    assert cuda_trim.fused_trim_supported((8, 8, 4096), torch.float32)
    assert not cuda_trim.fused_trim_supported((8, 8, 4096), torch.float64)


def test_wide_bucket_unfused_loop_matches_jax_streamed_f32():
    """Both packages run the unfused trim loop with the streamed NMF per
    round (the JAX kernel in interpret mode, the port's plain version): rho
    rtol 5e-4 / atol 5e-5 and K rtol 5e-4 / atol 5e-4 as for the fused
    kernel above, flags exact."""
    F, mask = degraded_bucket(52, WIDE_P, WIDE_LENGTHS, WIDE_W, np.float32)
    rj = jb.baseline_select_bucket(
        jnp.asarray(F), jnp.asarray(mask), JNmf(nmf_iter=6),
        JEng(use_pallas=True, pallas_interpret=True, gram_mode="vpu"))
    rt = tb.baseline_select_bucket(
        _t(F), _t(mask), NMFConfig(nmf_iter=6),
        EngineConfig(device="cpu", use_kernels=True, power_warm_plain=1))
    assert int(to_np(rt.ran_bs).sum()) > 0, "trim loop never ran"
    assert int(to_np(rt.rounds_active).max()) > 1
    _assert_flags_equal(rt, rj)
    np.testing.assert_allclose(to_np(rt.rho), np.asarray(rj.rho), rtol=5e-4,
                               atol=5e-5)
    np.testing.assert_allclose(to_np(rt.est_K), np.asarray(rj.est_K),
                               rtol=5e-4, atol=5e-4)


def test_wide_bucket_unfused_loop_matches_xla_loop_f64():
    """float64, same warm scheme: rounding only (rho rtol 1e-9)."""
    F, mask = degraded_bucket(52, 4, (8320, 5000, 7000), 8320, np.float64)
    rj = jb.baseline_select_bucket(
        jnp.asarray(F), jnp.asarray(mask), JNmf(nmf_iter=6),
        JEng(use_pallas=False, dtype="float64"))
    rt = _port(F, mask, dict(nmf_iter=6),
               dict(dtype="float64", power_warm_plain=0))
    assert int(to_np(rt.ran_bs).sum()) > 0, "trim loop never ran"
    _assert_flags_equal(rt, rj)
    np.testing.assert_allclose(to_np(rt.rho), np.asarray(rj.rho), rtol=1e-9,
                               atol=1e-12)


def test_wide_bucket_raw_int16_route_is_bit_identical():
    """F_raw + scale handed down to every NMF of the unfused loop give the
    same bits as the pre-adjusted float32 coverage, and the streamed
    wrapper is what received them."""
    from degnorm_tpu_torch.ops import cuda_stream
    rng = np.random.default_rng(53)
    F, mask = degraded_bucket(53, 4, (8320, 6000, 7100), 8320, np.float32)
    raw = _t(np.round(F * 4).astype(np.int16))
    scale = _t((0.6 + rng.random(4)).astype(np.float32))
    F_adj = raw.to(torch.float32) / scale[None, :, None]
    nmf_cfg = NMFConfig(nmf_iter=5)
    eng_cfg = EngineConfig(device="cpu")
    seen = []
    orig = cuda_stream.nmf_masked_streamed_cuda

    def spy(Fin, m, **kw):
        seen.append((Fin.dtype, kw.get("scale") is not None,
                     kw.get("u0") is not None, kw["power_iters_cold"]))
        return orig(Fin, m, **kw)

    cuda_stream.nmf_masked_streamed_cuda = spy
    try:
        a = tb.baseline_select_bucket(F_adj, _t(mask), nmf_cfg, eng_cfg,
                                      F_raw=raw, scale=scale)
    finally:
        cuda_stream.nmf_masked_streamed_cuda = orig
    b = tb.baseline_select_bucket(F_adj, _t(mask), nmf_cfg, eng_cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    rounds = int(to_np(a.rounds_active).max())
    assert rounds > 0
    # one initial NMF (cold) plus one per trim round (u0 resume, at the
    # resume count), all on the raw int16 tensor with the scale vector
    assert len(seen) == 1 + rounds
    assert all(dt == torch.int16 and sc for dt, sc, _, _ in seen)
    assert seen[0][2:] == (False, eng_cfg.power_iters_cold)
    assert all(s[2:] == (True, eng_cfg.power_iters_resume) for s in seen[1:])


@pytest.mark.parametrize("wp", [0, 1])
def test_unfused_hook_equals_fused_plain_loop_on_narrow_bucket(wp):
    """trim_loop_plain with the NMF hook of the unfused loop (here: the
    plain NMF through core/nmf.py) and without it give the same bits."""
    from degnorm_tpu_torch.core.nmf import nmf_masked
    F, mask = degraded_bucket(46, 4, LENGTHS, 256, np.float32)
    nmf_cfg = NMFConfig(nmf_iter=8)
    eng_cfg = EngineConfig(device="cpu", use_kernels=False,
                           power_warm_plain=wp)
    ti = tb.trim_inputs(_t(F), _t(mask), nmf_cfg, eng_cfg)
    kw = tb.trim_kwargs(nmf_cfg, eng_cfg)
    args = (ti.Fm, ti.bin_id, ti.bin_count, ti.K0, ti.E0, ti.rho0, ti.u0,
            ti.n_hi, ti.n_bins0, ti.active0)
    calls = []

    def hook(col_mask, gene_active, u_prev):
        calls.append(int(gene_active.sum()))
        return nmf_masked(ti.Fm, col_mask, gene_active=gene_active,
                          u0=u_prev, use_kernels=False,
                          **dict(tb._nmf_kwargs(nmf_cfg, eng_cfg),
                                 power_iters_cold=eng_cfg.power_iters_resume))

    plain = cuda_trim.trim_loop_plain(*args, **kw)
    hooked = cuda_trim.trim_loop_plain(*args, nmf_fn=hook, **kw)
    for x, y in zip(plain, hooked):
        assert torch.equal(x, y)
    assert len(calls) == int(to_np(plain[3]).max()) > 0
    # and baseline_select_bucket takes the same two routes by fuse_trim
    r_fused = tb.baseline_select_bucket(_t(F), _t(mask), nmf_cfg, eng_cfg)
    r_unfused = tb.baseline_select_bucket(
        _t(F), _t(mask), nmf_cfg,
        EngineConfig(device="cpu", use_kernels=True, fuse_trim=False,
                     power_warm_plain=wp))
    for x, y in zip(r_fused, r_unfused):
        assert torch.equal(x, y)


# ---- launch threads of the resident loop kernels (kernels 1 and 3) ---------

@pytest.mark.parametrize("p,width", [(2, 8192), (4, 384), (8, 1024),
                                     (8, 4096), (8, 8192), (16, 512),
                                     (16, 4096), (32, 1024), (32, 2048)])
def test_loop_threads_are_a_legal_launch(p, width):
    """Every shape inside the resident gate gets whole warps within the
    kernel's bound for p, and a thread's column slots fit the kernels'
    64-bit mask of active slots."""
    from degnorm_tpu_torch.ops import cuda_nmf
    assert cuda_nmf.kernels_supported((8, p, width), torch.float32)
    threads = cuda_nmf.pick_loop_threads(p, width)
    assert threads % 32 == 0 and 32 <= threads <= cuda_nmf.max_loop_threads(p)
    assert -(-width // threads) <= 64


@pytest.mark.parametrize("p,width,want", LOOP_THREAD_PINS)
def test_loop_threads_by_shape(p, width, want):
    """Kernels 1 and 3 share one rule, a thread per 16 columns: the narrow
    fit's launches as the committed sweep (chip_smoke.py --sweep) chose
    them, and the bounds of the rule."""
    from degnorm_tpu_torch.ops import cuda_nmf
    assert cuda_nmf.pick_loop_threads(p, width) == want


def test_plain_trim_loop_with_more_bins_than_a_warp_matches_pallas_interpret():
    """48 trim bins (the fused kernel's 32-thread blocks of narrow genes hold
    fewer threads than that): the plain loop against the TPU kernel in
    interpret mode, flags and round counts equal."""
    from degnorm_tpu.ops.pallas_trim import trim_loop_pallas
    F, mask = degraded_bucket(47, 4, (500, 512, 450, 480), 512, np.float32)
    nmf_cfg = NMFConfig(nmf_iter=6, bins=48)
    eng_cfg = EngineConfig(device="cpu", use_kernels=False)
    ti = tb.trim_inputs(_t(F), _t(mask), nmf_cfg, eng_cfg)
    kw = tb.trim_kwargs(nmf_cfg, eng_cfg)
    args = (ti.Fm, ti.bin_id, ti.bin_count, ti.K0, ti.E0, ti.rho0, ti.u0,
            ti.n_hi, ti.n_bins0, ti.active0)
    assert ti.bin_count.shape[1] == 48 <= cuda_trim.MAX_BINS
    assert int(to_np(ti.n_bins0)[to_np(ti.active0)].max()) > 32
    Kt, rhot, rant, roundst = cuda_trim.trim_loop_plain(*args, **kw)
    Kj, rhoj, ranj, roundsj = trim_loop_pallas(
        *[jnp.asarray(to_np(x)) for x in args], gram_mode="vpu",
        interpret=True, **kw)
    assert int(to_np(roundst).max()) > 1
    np.testing.assert_array_equal(to_np(rant), np.asarray(ranj))
    np.testing.assert_array_equal(to_np(roundst), np.asarray(roundsj))
    np.testing.assert_allclose(to_np(rhot), np.asarray(rhoj), rtol=5e-4,
                               atol=5e-5)
    np.testing.assert_allclose(to_np(Kt), np.asarray(Kj), rtol=5e-4,
                               atol=5e-4)
