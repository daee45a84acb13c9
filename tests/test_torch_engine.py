"""PyTorch port, the slice as a whole: ``DegNormEngine.run`` on the CPU vs the
JAX package's engine with the host float64 outer loop (``device_loop=False``).

Tolerances are the all-up ones of PARITY.md (DI atol 5e-3, adjusted counts
rtol 5e-3, ran_baseline_selection exact, estimates rtol 5e-3).  They are what
holds between the two warm power schemes; with the port on the XLA twin's
scheme (``power_warm_plain=0``) both engines run the same arithmetic and the
tests state the much tighter bound that then holds (float64: 1e-9).
"""
import os
import sys
from collections import OrderedDict

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from degnorm_tpu.config import EngineConfig as JEng, NMFConfig as JNmf
from degnorm_tpu import engine as jengine
from degnorm_tpu.core import degnorm as jd
from degnorm_tpu.data.buckets import pack_buckets as jpack
from degnorm_tpu_torch import EngineConfig, NMFConfig, convert
from degnorm_tpu_torch import engine as tengine
from degnorm_tpu_torch.core import degnorm as td
from tests.torch_port_util import random_coverage, to_np

torch.set_num_threads(1)
WIDTHS = (512, 1024)
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_nmfoa.npz")


def make_dataset(seed=21, n=24, p=4):
    rng = np.random.default_rng(seed)
    cov = OrderedDict()
    for i in range(n):
        L = int(120 + rng.integers(0, 800))
        cov[f"gene{i}"] = random_coverage(
            rng, p, L, scale=3 + 6 * rng.random(), degraded=(i % 2 == 0))
    X = np.round(np.abs(rng.standard_normal((n, p))) * 300 + 30)
    return cov, X


def port_engine(nmf_kw, **eng_kw):
    eng_kw.setdefault("bucket_widths", WIDTHS)
    return tengine.DegNormEngine(
        NMFConfig(**nmf_kw),
        EngineConfig(device="cpu", use_kernels=False, **eng_kw))


def jax_engine(nmf_kw, **eng_kw):
    eng_kw.setdefault("bucket_widths", WIDTHS)
    return jengine.DegNormEngine(
        JNmf(**nmf_kw), JEng(device_loop=False, use_pallas=False, **eng_kw))


@pytest.fixture(scope="module")
def jax_fits():
    cov, X = make_dataset()
    nmf_kw = dict(nmf_iter=10, degnorm_iter=3)
    out = {}
    for dt in ("float64", "float32"):
        res = jax_engine(nmf_kw, dtype=dt).run(cov, X)
        out[dt] = (res, res.estimates())
    return cov, X, nmf_kw, out


def _assert_fit_close(rt, rj_pair, rho_atol, rtol):
    rj, ests_j = rj_pair
    np.testing.assert_array_equal(rt.ran_baseline_selection,
                                  rj.ran_baseline_selection)
    np.testing.assert_allclose(rt.rho, rj.rho, rtol=0, atol=rho_atol)
    np.testing.assert_allclose(rt.x_adj, rj.x_adj, rtol=rtol)
    np.testing.assert_allclose(rt.scale_factors, rj.scale_factors, rtol=rtol)
    np.testing.assert_allclose(rt.norm_factors, rj.norm_factors, rtol=rtol)
    np.testing.assert_allclose(rt.x_weighted, rj.x_weighted, rtol=rtol)
    ests_t = rt.estimates()
    assert len(ests_t) == len(ests_j)
    for a, b in zip(ests_t, ests_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("dtype,rho_atol,rtol", [
    ("float64", 1e-9, 1e-9),        # same arithmetic: rounding only
    ("float32", 1e-4, 1e-4),
])
def test_run_matches_jax_engine_same_scheme(jax_fits, dtype, rho_atol, rtol):
    cov, X, nmf_kw, fits = jax_fits
    eng = port_engine(nmf_kw, dtype=dtype, power_warm_plain=0)
    rt = eng.run(cov, X)
    assert len(eng._buckets) == 2                  # two bucket widths
    assert rt.ran_baseline_selection.any()
    assert rt.rho.dtype == np.float64
    _assert_fit_close(rt, fits[dtype], rho_atol, rtol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_run_default_warm_scheme_within_parity_tolerance(jax_fits, dtype):
    """The port's default (one plain warm matvec, as the fused kernels) vs
    the XLA twin's squared scheme: the PARITY.md all-up tolerances."""
    cov, X, nmf_kw, fits = jax_fits
    rt = port_engine(nmf_kw, dtype=dtype).run(cov, X)
    _assert_fit_close(rt, fits[dtype], 5e-3, 5e-3)


def test_run_matches_golden_corpus():
    """tests/data/golden_nmfoa.npz as tests/test_golden.py uses it."""
    golden = np.load(GOLDEN)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    from make_golden import golden_dataset
    cov, X = golden_dataset()
    np.testing.assert_array_equal(X, golden["x"])
    eng = tengine.DegNormEngine(
        NMFConfig(nmf_iter=int(golden["nmf_iter"]),
                  degnorm_iter=int(golden["degnorm_iter"])),
        EngineConfig(device="cpu", use_kernels=False, dtype="float64",
                     power_warm_plain=0))
    res = eng.run(cov, X)
    np.testing.assert_array_equal(res.ran_baseline_selection,
                                  golden["ran_baseline_selection"])
    np.testing.assert_allclose(res.rho, golden["rho"], rtol=3e-4, atol=3e-6)
    np.testing.assert_allclose(res.x_adj, golden["x_adj"], rtol=3e-4)


def test_refit_reuses_device_buckets():
    cov, X = make_dataset(seed=31, n=20)
    eng = port_engine(dict(nmf_iter=6, degnorm_iter=2))
    first = eng.run(cov, X)
    assert "upload" in eng.timings
    refit = eng.run(cov, X, reuse_device_data=True)
    assert "upload" not in eng.timings and eng.timings["pack"] < 0.05
    np.testing.assert_array_equal(refit.rho, first.rho)
    np.testing.assert_array_equal(refit.ran_baseline_selection,
                                  first.ran_baseline_selection)
    # another dataset under the same flag repacks (fingerprint guard)
    cov2, X2 = make_dataset(seed=32, n=20)
    eng.run(cov2, X2, reuse_device_data=True)
    assert "upload" in eng.timings
    for key in ("pack", "init", "iter_0", "iter_1", "iterations"):
        assert key in eng.timings


def test_multi_chunk_buckets_match_unchunked():
    cov, X = make_dataset(seed=33, n=13)
    nmf_kw = dict(nmf_iter=5, degnorm_iter=2)
    r1 = port_engine(nmf_kw, dtype="float64", bucket_widths=(1024,)).run(cov, X)
    r2 = port_engine(nmf_kw, dtype="float64", bucket_widths=(1024,),
                     max_genes_per_batch=4).run(cov, X)
    np.testing.assert_allclose(r2.rho, r1.rho, rtol=1e-12)
    np.testing.assert_allclose(r2.x_adj, r1.x_adj, rtol=1e-12)


def test_input_validation():
    cov, X = make_dataset(n=4)
    eng = port_engine(dict(nmf_iter=2, degnorm_iter=1))
    with pytest.raises(ValueError):
        eng.run(cov, X[:2])
    with pytest.raises(ValueError):
        eng.run(OrderedDict(), X[:0])
    with pytest.raises(ValueError):
        port_engine(dict(downsample_rate=10 ** 6)).run(cov, X)
    with pytest.raises(ValueError):
        port_engine(dict(degnorm_iter=0)).run(cov, X)
    with pytest.raises(ValueError):
        port_engine({})._materialize_estimates()


def test_downsample_reference_offsets_match_jax_and_keyed_raises():
    cov, X = make_dataset(seed=34, n=10)
    nmf_kw = dict(nmf_iter=6, degnorm_iter=2, downsample_rate=3,
                  ds_compat="reference")
    rj = jax_engine(nmf_kw, dtype="float64").run(cov, X)
    rt = port_engine(nmf_kw, dtype="float64", power_warm_plain=0).run(cov, X)
    np.testing.assert_array_equal(rt.ran_baseline_selection,
                                  rj.ran_baseline_selection)
    np.testing.assert_allclose(rt.rho, rj.rho, rtol=0, atol=1e-9)
    # the default offset source, keyed: the JAX engine's draw
    keyed_kw = dict(nmf_iter=6, degnorm_iter=2, downsample_rate=3)
    rj = jax_engine(keyed_kw, dtype="float64").run(cov, X)
    rt = port_engine(keyed_kw, dtype="float64", power_warm_plain=0).run(cov, X)
    np.testing.assert_array_equal(rt.ran_baseline_selection,
                                  rj.ran_baseline_selection)
    np.testing.assert_allclose(rt.rho, rj.rho, rtol=0, atol=1e-9)


def test_int16_upload_when_integral():
    cov, X = make_dataset(seed=35, n=6)
    icov = OrderedDict((g, np.round(m * 3)) for g, m in cov.items())
    eng = port_engine(dict(nmf_iter=3, degnorm_iter=1))
    eng.run(icov, X)
    assert all(F.dtype == torch.int16 for F in eng._device_F)
    eng64 = port_engine(dict(nmf_iter=3, degnorm_iter=1), dtype="float64")
    eng64.run(icov, X)
    assert all(F.dtype == torch.float64 for F in eng64._device_F)
    eng.run(cov, X)                               # fractional coverage
    assert all(F.dtype == torch.float32 for F in eng._device_F)


def test_convert_carries_one_bucket_step_and_one_outer_update():
    """The JAX package's packed bucket and outer state, carried across by
    convert.py: one _bucket_step and one outer update see identical inputs
    on both sides (float64, same warm scheme: rounding-level agreement)."""
    cov, X = make_dataset(seed=36, n=9)
    mats = [np.round(m * 2) for m in cov.values()]       # integral -> int16
    jb = jpack(mats, bucket_widths=(1024,), dtype=np.int16)[0]
    bucket, F_t, mask_t = convert.buckets_from_numpy(
        jb.F, jb.lengths, jb.gene_indices, jb.width, device="cpu")
    assert F_t.dtype == torch.int16 and bucket.n_real == jb.n_real
    np.testing.assert_array_equal(to_np(mask_t), jb.len_mask())
    np.testing.assert_array_equal(bucket.len_mask(), jb.len_mask())

    rng = np.random.default_rng(7)
    n, p = X.shape
    state_j = jd.init_state(rng.random((n, p)) * 0.3, X)
    state_t = convert.global_state_from_numpy(*state_j, device="cpu")
    for a, b in zip(state_t.to_numpy(), state_j):           # round trip
        np.testing.assert_array_equal(a, b)
    ckpt = dict(state_j._asdict(), iteration=np.int64(0),
                genes=np.array(list(cov), dtype=object))
    for a, b in zip(convert.global_state_from_checkpoint(ckpt, device="cpu"),
                    state_t):
        assert torch.equal(a, b)

    nmf_kw = dict(nmf_iter=8)
    rj = jengine._bucket_step(
        jnp.asarray(jb.F), jnp.asarray(jb.len_mask()),
        jnp.asarray(state_j.scale_factors, jnp.float64),
        jnp.zeros(jb.F.shape[0], jnp.int32), JNmf(**nmf_kw).kernel_key(),
        JEng(use_pallas=False, dtype="float64"))
    rt = tengine._bucket_step(
        F_t, mask_t, state_t.scale_factors, None, NMFConfig(**nmf_kw),
        EngineConfig(device="cpu", use_kernels=False, dtype="float64",
                     power_warm_plain=0))
    np.testing.assert_array_equal(to_np(rt.ran_bs), np.asarray(rj.ran_bs))
    np.testing.assert_array_equal(to_np(rt.rounds_active),
                                  np.asarray(rj.rounds_active))
    np.testing.assert_allclose(to_np(rt.rho), np.asarray(rj.rho), rtol=1e-9,
                               atol=1e-12)

    real = jb.gene_indices >= 0
    rho_raw = np.zeros((n, p))
    rho_raw[jb.gene_indices[real]] = np.asarray(rj.rho)[real]
    new_j = jd.iteration_update(state_j, rho_raw)
    out = td.device_iteration_math(torch.from_numpy(rho_raw),
                                   state_t.x_weighted, state_t.scale_factors)
    for a, b in zip(out, (new_j.rho, new_j.x_adj, new_j.x_weighted,
                          new_j.norm_factors, new_j.scale_factors)):
        np.testing.assert_allclose(to_np(a), b, rtol=1e-12)
    with pytest.raises(ValueError):
        convert.buckets_from_numpy(jb.F, jb.lengths, jb.gene_indices, 512,
                                   device="cpu")


@pytest.mark.parametrize("width,wide", [(2048, False), (2176, True)])
def test_engine_raw_int16_wide_bucket_matches_jax_streamed_engine(
        monkeypatch, width, wide):
    """The JAX package's tests/test_stream.py::
    test_engine_raw_int16_streamed_path through both engines on the CPU: 12
    genes x 32 samples, integral coverage (int16 upload), one bucket width.
    At 2048 the bucket is the edge of the port's resident gate; at 2176 it
    is outside it in both packages, and every NMF of the port goes through
    the streamed wrapper on the raw int16 tensor.  Tolerances of that test:
    rho rtol 5e-3 / atol 5e-4, x_adj rtol 5e-3 / atol 5e-3."""
    from degnorm_tpu_torch.ops import cuda_stream
    rng = np.random.default_rng(70)
    cov = OrderedDict(
        (f"g{i}", np.round(random_coverage(
            rng, 32, int(rng.integers(1100, 2049)), degraded=(i % 2 == 0))
        ).astype(np.float32))
        for i in range(12))
    X = np.round(np.abs(rng.standard_normal((12, 32))) * 150 + 30)
    nmf_kw = dict(nmf_iter=4, degnorm_iter=2)
    jeng = jengine.DegNormEngine(JNmf(**nmf_kw), JEng(
        use_pallas=True, pallas_interpret=True, bucket_widths=(width,)))
    rj = jeng.run(cov, X.copy())
    assert jeng._device_F[0].dtype == jnp.int16

    seen = []
    orig = cuda_stream.nmf_masked_streamed_cuda

    def spy(F, mask, **kw):
        seen.append((F.dtype, kw.get("scale") is not None))
        return orig(F, mask, **kw)

    monkeypatch.setattr(cuda_stream, "nmf_masked_streamed_cuda", spy)
    eng = tengine.DegNormEngine(
        NMFConfig(**nmf_kw),
        EngineConfig(device="cpu", use_kernels=True, bucket_widths=(width,)))
    rt = eng.run(cov, X.copy())
    assert eng._device_F[0].dtype == torch.int16
    assert eng._device_F[0].shape[1:] == (32, width)
    if wide:
        # per iteration: the initial NMF and one call per trim round, the
        # rounds being those the engine counted
        assert len(eng.trim_rounds) == nmf_kw["degnorm_iter"]
        rounds = sum(sum(r) for r in eng.trim_rounds)
        assert rounds >= nmf_kw["degnorm_iter"]
        assert len(seen) == nmf_kw["degnorm_iter"] + rounds
        assert all(dt == torch.int16 and sc for dt, sc in seen)
    else:
        assert not seen
    np.testing.assert_array_equal(rt.ran_baseline_selection,
                                  rj.ran_baseline_selection)
    np.testing.assert_allclose(rt.rho, rj.rho, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(rt.x_adj, rj.x_adj, rtol=5e-3, atol=5e-3)


def test_wide_float64_fit_matches_jax_engine():
    """A fit whose only bucket is wider than the resident gate, float64 and
    the same warm scheme on both sides: rounding only (1e-9)."""
    rng = np.random.default_rng(71)
    cov = OrderedDict(
        (f"g{i}", random_coverage(rng, 4, int(rng.integers(4200, 8321)),
                                  degraded=(i % 2 == 0)))
        for i in range(5))
    X = np.round(np.abs(rng.standard_normal((5, 4))) * 150 + 30)
    nmf_kw = dict(nmf_iter=5, degnorm_iter=2)
    rj = jax_engine(nmf_kw, dtype="float64", bucket_widths=(8320,)).run(cov, X)
    rt = port_engine(nmf_kw, dtype="float64", power_warm_plain=0,
                     bucket_widths=(8320,)).run(cov, X)
    assert rt.ran_baseline_selection.any()
    np.testing.assert_array_equal(rt.ran_baseline_selection,
                                  rj.ran_baseline_selection)
    np.testing.assert_allclose(rt.rho, rj.rho, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.x_adj, rj.x_adj, rtol=1e-9)


def test_pack_refuses_a_bucket_that_cannot_fit(monkeypatch):
    """The memory guard names the sizes when even the smallest bucket of a
    width cannot run one step on the device."""
    cov, X = make_dataset(seed=37, n=3)
    eng = port_engine(dict(nmf_iter=2, degnorm_iter=1))
    monkeypatch.setattr(tengine, "_device_memory", lambda dev: 1 << 20)
    with pytest.raises(RuntimeError, match="GiB"):
        eng.run(cov, X)
