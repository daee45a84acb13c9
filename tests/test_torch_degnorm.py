"""PyTorch port, core/degnorm.py vs the JAX package's host float64 rules
(``init_state`` / ``iteration_update``): the port's own numpy copies and its
torch.float64 device twins, rtol 1e-12, with an even p so that the median
averages the middle pair."""
import numpy as np
import pytest
import torch

from degnorm_tpu.core import degnorm as jd
from degnorm_tpu_torch import convert
from degnorm_tpu_torch.core import degnorm as td
from tests.torch_port_util import to_np

torch.set_num_threads(1)
RTOL = 1e-12


def _inputs(seed, n=40, p=4, low_di=True):
    rng = np.random.default_rng(seed)
    x = np.round(np.abs(rng.standard_normal((n, p))) * 300 + 30)
    cov = rng.random((n, p)) * 1e4 + 100
    est = cov * (1.0 + rng.random((n, p)) * (0.08 if low_di else 0.0)
                 + (0.0 if low_di else 0.5))
    if low_di:
        est[::3] *= 1.6              # a mix of low- and high-DI genes
    return x, cov, est


@pytest.mark.parametrize("p,low_di", [(4, True), (4, False), (5, True),
                                      (8, True)])
def test_init_twins_match_jax_init_state(p, low_di):
    x, cov, est = _inputs(1, p=p, low_di=low_di)
    rho_j = jd.rho_from_ratio_svd(cov, est)
    st_j = jd.init_state(rho_j, x)
    assert bool((rho_j.max(axis=1) < 0.1).any()) is low_di
    # the port's numpy copy
    st_n = td.init_state(td.rho_from_ratio_svd(cov, est), x)
    for a, b in zip(st_n, st_j):
        np.testing.assert_allclose(a, b, rtol=RTOL)
    # the device twin
    xw, norm, rho = td.device_init_state(
        torch.from_numpy(cov), torch.from_numpy(est), torch.from_numpy(x))
    assert xw.dtype == torch.float64
    np.testing.assert_allclose(to_np(xw), st_j.x_weighted, rtol=RTOL)
    np.testing.assert_allclose(to_np(norm), st_j.norm_factors, rtol=RTOL)
    np.testing.assert_allclose(to_np(rho), st_j.rho, rtol=RTOL, atol=1e-15)


def test_init_twin_widens_float32_row_sums():
    """The kernels hand over float32 row sums; the twin widens them first,
    exactly as the host rule receives them."""
    x, cov, est = _inputs(2)
    cov32, est32 = cov.astype(np.float32), est.astype(np.float32)
    st_j = jd.init_state(jd.rho_from_ratio_svd(cov32.astype(np.float64),
                                               est32.astype(np.float64)), x)
    xw, norm, _ = td.device_init_state(torch.from_numpy(cov32),
                                       torch.from_numpy(est32),
                                       torch.from_numpy(x))
    np.testing.assert_allclose(to_np(xw), st_j.x_weighted, rtol=RTOL)
    np.testing.assert_allclose(to_np(norm), st_j.norm_factors, rtol=RTOL)


@pytest.mark.parametrize("p", [4, 5, 8])
def test_iteration_twins_match_jax_iteration_update(p):
    x, cov, est = _inputs(3, p=p)
    st_j = jd.init_state(jd.rho_from_ratio_svd(cov, est), x)
    rng = np.random.default_rng(4)
    state_t = convert.global_state_from_numpy(*st_j, device="cpu")
    st_n = td.GlobalState(*st_j)
    for it in range(3):
        # float32 kernel output: out-of-range values, and rows of zeros
        # (genes that never ran baseline selection)
        rho_raw = (rng.random(x.shape) * 1.1 - 0.1).astype(np.float32)
        rho_raw[1::4] = 0.0
        st_j = jd.iteration_update(st_j, rho_raw.astype(np.float64))
        st_n = td.iteration_update(st_n, rho_raw.astype(np.float64))
        rho, x_adj, xw, norm, scale = td.device_iteration_math(
            torch.from_numpy(rho_raw), state_t.x_weighted,
            state_t.scale_factors)
        state_t = state_t._replace(rho=rho, x_adj=x_adj, x_weighted=xw,
                                   norm_factors=norm, scale_factors=scale)
        for a, b in zip(st_n, st_j):
            np.testing.assert_allclose(a, b, rtol=RTOL)
        for a, b in zip(state_t.to_numpy(), st_j):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-15)
    assert state_t.rho.dtype == torch.float64
    assert float(state_t.rho.max()) <= 0.9 and float(state_t.rho.min()) >= 0


def test_iteration_twin_without_non_bs_rows():
    x, cov, est = _inputs(5)
    st_j = jd.init_state(jd.rho_from_ratio_svd(cov, est), x)
    rho_raw = np.random.default_rng(6).random(x.shape) * 0.8 + 0.01
    new_j = jd.iteration_update(st_j, rho_raw)
    st_t = convert.global_state_from_numpy(*st_j, device="cpu")
    out = td.device_iteration_math(torch.from_numpy(rho_raw),
                                   st_t.x_weighted, st_t.scale_factors)
    for a, b in zip(out, (new_j.rho, new_j.x_adj, new_j.x_weighted,
                          new_j.norm_factors, new_j.scale_factors)):
        np.testing.assert_allclose(to_np(a), b, rtol=RTOL)
