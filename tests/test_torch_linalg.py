"""PyTorch port, core/linalg.py vs the JAX package's core/linalg.py.

float64 on the CPU, rtol 1e-9: both sides run the same op order, so only
the summation order inside the einsums differs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from degnorm_tpu.core import linalg as jl
from degnorm_tpu.ops import pallas_nmf as jp
from degnorm_tpu_torch.core import linalg as tl
from tests.torch_port_util import degraded_bucket, to_np

torch.set_num_threads(1)
RTOL = 1e-9


@pytest.fixture(scope="module")
def bucket():
    return degraded_bucket(3, 4, (100, 230, 256, 57), 256, np.float64)


def _both(F, mask):
    return (jnp.asarray(F), jnp.asarray(mask),
            torch.from_numpy(F), torch.from_numpy(mask))


@pytest.mark.parametrize("n_iters", [4, 32, 128])
def test_masked_rank_one_matches_jax(bucket, n_iters):
    Fj, mj, Ft, mt = _both(*bucket)
    Kj, Ej, uj = jl.masked_rank_one(Fj, mj, n_iters=n_iters)
    Kt, Et, ut = tl.masked_rank_one(Ft, mt, n_iters=n_iters)
    for a, b in ((Kt, Kj), (Et, Ej), (ut, uj)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=RTOL,
                                   atol=1e-12)
    assert np.all(to_np(Et)[~bucket[1]] == 0)     # masked columns exactly 0


def test_uv_then_finish_matches_jax_rank_one(bucket):
    Fj, mj, Ft, mt = _both(*bucket)
    Kj, Ej, uj = jl.masked_rank_one(Fj, mj, n_iters=32)
    ut, vt = tl.masked_rank_one_uv(Ft, mt, n_iters=32)
    Kt, Et = tl.finish_rank_one(Ft, mt, ut, vt)
    uvj = jl.masked_rank_one_uv(Fj, mj, n_iters=32)
    np.testing.assert_allclose(to_np(ut), np.asarray(uvj[0]), rtol=RTOL)
    np.testing.assert_allclose(to_np(vt), np.asarray(uvj[1]), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(to_np(Kt), np.asarray(Kj), rtol=RTOL)
    np.testing.assert_allclose(to_np(Et), np.asarray(Ej), rtol=RTOL,
                               atol=1e-12)


def test_warm_start_u0_matches_jax(bucket):
    Fj, mj, Ft, mt = _both(*bucket)
    rng = np.random.default_rng(5)
    u0 = np.abs(rng.standard_normal(bucket[0].shape[:2])) + 0.1
    u0 /= np.linalg.norm(u0, axis=1, keepdims=True)
    Kj, Ej, uj = jl.masked_rank_one(Fj, mj, n_iters=8, u0=jnp.asarray(u0))
    Kt, Et, ut = tl.masked_rank_one(Ft, mt, n_iters=8,
                                    u0=torch.from_numpy(u0))
    np.testing.assert_allclose(to_np(Kt), np.asarray(Kj), rtol=RTOL)
    np.testing.assert_allclose(to_np(ut), np.asarray(uj), rtol=RTOL)


@pytest.mark.parametrize("n_iters", [2, 6, 24, 128])
def test_squared_power_scheme_matches_jax(bucket, n_iters):
    """max(1, n_iters // 4) bodies of the squared operator."""
    F, mask = bucket
    A = F * mask[:, None, :]
    B = np.einsum("gpw,gqw->gpq", A, A)
    u0 = np.full(F.shape[:2], 0.5)
    uj = jl._power_iterate(jnp.asarray(B), jnp.asarray(u0), n_iters)
    ut = tl._power_iterate(torch.from_numpy(B), torch.from_numpy(u0), n_iters)
    np.testing.assert_allclose(to_np(ut), np.asarray(uj), rtol=RTOL)


@pytest.mark.parametrize("n_iters", [1, 2, 4])
def test_plain_warm_scheme_matches_jax_kernel_helper(bucket, n_iters):
    """The fused kernels' warm scheme (ops/pallas_nmf.py::_power_warm)."""
    F, mask = bucket
    A = F * mask[:, None, :]
    B = np.einsum("gpw,gqw->gpq", A, A)
    rng = np.random.default_rng(6)
    u0 = np.abs(rng.standard_normal(F.shape[:2])) + 0.2
    u0 /= np.linalg.norm(u0, axis=1, keepdims=True)
    uj = jp._power_warm(jnp.asarray(B), jnp.asarray(u0), n_iters)
    ut = tl._power_warm_plain(torch.from_numpy(B), torch.from_numpy(u0),
                              n_iters)
    np.testing.assert_allclose(to_np(ut), np.asarray(uj), rtol=RTOL)


def test_zero_gene_keeps_start_vector_and_no_nan():
    F = np.zeros((2, 3, 64))
    mask = np.ones((2, 64), bool)
    K, E, u = tl.masked_rank_one(torch.from_numpy(F), torch.from_numpy(mask),
                                 n_iters=8)
    assert torch.isfinite(K).all() and torch.isfinite(E).all()
    assert float(K.abs().max()) == 0.0 and float(E.abs().max()) == 0.0
    np.testing.assert_allclose(to_np(u), 1 / np.sqrt(3), rtol=1e-15)


def test_rowsum_outer_product_match_jax(bucket):
    Fj, mj, Ft, mt = _both(*bucket)
    np.testing.assert_allclose(to_np(tl.masked_rowsum(Ft, mt)),
                               np.asarray(jl.masked_rowsum(Fj, mj)),
                               rtol=RTOL)
    K = np.arange(8.0).reshape(2, 4)
    E = np.arange(10.0).reshape(2, 5)
    np.testing.assert_array_equal(
        to_np(tl.outer_product(torch.from_numpy(K), torch.from_numpy(E))),
        np.asarray(jl.outer_product(jnp.asarray(K), jnp.asarray(E))))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8])
def test_median_averages_middle_pair(n):
    """numpy/jnp rule; torch.median would return the lower middle value."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((5, n))
    np.testing.assert_allclose(to_np(tl.median_mid(torch.from_numpy(x), dim=1)),
                               np.median(x, axis=1), rtol=1e-15)
    np.testing.assert_allclose(
        to_np(tl.median_mid(torch.from_numpy(x), dim=1)),
        np.asarray(jnp.median(jnp.asarray(x), axis=1)), rtol=1e-12)
