"""PyTorch port, its copy of the float64 oracle (``degnorm_tpu_torch/oracle``)
and the ``degnorm-tpu-torch-test`` entry point.

The copy must equal the JAX package's oracle bit for bit (same numpy and
scipy calls on the same inputs) on the golden corpus of
tools/make_golden.py, on other configurations and on pieces of the
algorithm.  ARPACK starts from a random vector, which the installed scipy
draws from fresh entropy on every ``svds`` call unless it is given a
generator, so the oracle alone differs from run to run in the last bits
(1e-14 relative); these comparisons pin the start vector (the
``pinned_svds`` fixture).  The copy must also match the frozen
reference outputs (tests/data/golden_nmfoa.npz) at tests/test_golden.py's
tolerances: rho rtol 1e-8 / atol 1e-10, adjusted counts and scale factors
rtol 1e-8, ran_baseline_selection exact.
"""
import os
import sys
from collections import OrderedDict

import numpy as np
import pytest
from scipy.sparse import linalg as sla

from degnorm_tpu.config import NMFConfig as JNmf
from degnorm_tpu.oracle import nmfoa as jo
from degnorm_tpu_torch.config import NMFConfig
from degnorm_tpu_torch.oracle import nmfoa as to
from tests.torch_port_util import random_coverage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "golden_nmfoa.npz")


@pytest.fixture(scope="module")
def golden():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_golden import golden_dataset
    cov, X = golden_dataset()
    return cov, X, np.load(FIXTURE)


@pytest.fixture
def pinned_svds(monkeypatch):
    """Both oracles' ``svds`` with one fixed ARPACK start vector generator
    a call."""
    def svds(A, k=6, **kw):
        return sla.svds(A, k=k, rng=np.random.default_rng(7), **kw)

    monkeypatch.setattr(to, "svds", svds)
    monkeypatch.setattr(jo, "svds", svds)


def _both(cov, X, **kw):
    """The port's oracle and the JAX package's on the same inputs, each from
    the same state of numpy's global generator (the downsample offsets)."""
    np.random.seed(2024)
    rt = to.degnorm_fit(list(cov.values()), X, NMFConfig(**kw))
    np.random.seed(2024)
    rj = jo.degnorm_fit(list(cov.values()), X, JNmf(**kw))
    return rt, rj


def _fields(res):
    return {k: getattr(res, k) for k in ("rho", "x_adj", "scale_factors",
                                         "ran_baseline_selection")}


def test_oracle_equals_the_jax_oracle_on_the_golden_corpus(golden,
                                                           pinned_svds):
    cov, X, g = golden
    rt, rj = _both(cov, X, nmf_iter=int(g["nmf_iter"]),
                   degnorm_iter=int(g["degnorm_iter"]))
    for name, a in _fields(rt).items():
        np.testing.assert_array_equal(a, _fields(rj)[name], err_msg=name)
    for a, b in zip(rt.estimates, rj.estimates):
        np.testing.assert_array_equal(a, b)


def test_oracle_matches_the_golden_fixture(golden):
    cov, X, g = golden
    np.testing.assert_array_equal(X, g["x"])
    res = to.degnorm_fit(list(cov.values()), X,
                         NMFConfig(nmf_iter=int(g["nmf_iter"]),
                                   degnorm_iter=int(g["degnorm_iter"])))
    np.testing.assert_array_equal(res.ran_baseline_selection,
                                  g["ran_baseline_selection"])
    np.testing.assert_allclose(res.rho, g["rho"], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(res.x_adj, g["x_adj"], rtol=1e-8)
    np.testing.assert_allclose(res.scale_factors, g["scale_factors"],
                               rtol=1e-8)


@pytest.mark.parametrize("kw", [dict(downsample_rate=3),
                                dict(skip_baseline_selection=True),
                                dict(bins=7, min_high_coverage=20)])
def test_oracle_equals_the_jax_oracle_on_other_configs(kw, pinned_svds):
    rng = np.random.default_rng(71)
    cov = OrderedDict(
        (f"g{i}", random_coverage(rng, 3, int(rng.integers(150, 600)),
                                  degraded=(i % 2 == 0)))
        for i in range(6))
    X = np.round(np.abs(rng.standard_normal((6, 3))) * 200 + 40)
    rt, rj = _both(cov, X, nmf_iter=8, degnorm_iter=2, **kw)
    for name, a in _fields(rt).items():
        np.testing.assert_array_equal(a, _fields(rj)[name], err_msg=name)


def test_oracle_pieces_equal_the_jax_oracle(pinned_svds):
    rng = np.random.default_rng(72)
    x = random_coverage(rng, 4, 300, degraded=True)
    for fn in (lambda m: m.ratio_svd(x), lambda m: m.nmf_oa(x, 10),
               lambda m: m.rank_one(x)):
        a, b = fn(to), fn(jo)
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(to.high_coverage_idx(x),
                                  jo.high_coverage_idx(x))
    assert to.__all__ == jo.__all__


def test_the_test_entry_point_runs_the_port_tests(monkeypatch):
    from degnorm_tpu_torch import testing
    calls = []
    monkeypatch.setattr(testing.subprocess, "call",
                        lambda cmd, **kw: calls.append((cmd, kw)) or 0)
    assert testing.main(["-x"]) == 0
    (cmd, kw), = calls
    files = [c for c in cmd if c.endswith(".py")]
    assert cmd[1:3] == ["-m", "pytest"] and cmd[-1] == "-x"
    assert kw["cwd"] == REPO
    assert files and all(os.path.basename(f).startswith("test_torch_")
                         for f in files)
    assert os.path.join(REPO, "tests", "test_torch_oracle.py") in files
