"""PyTorch port, core/prng.py and the keyed downsample offsets vs jax.

The numpy Threefry draw must equal ``jax.random.randint(fold_in(PRNGKey(s),
it), (n,), 0, rate, int32)`` exactly, under the flag the JAX engine runs with
(``jax_threefry_partitionable``, True in the installed jax) and with 64-bit
types on, as the test suite runs jax (tests/conftest.py).  The engine fit at
``downsample_rate=3`` holds the port's keyed offsets equal to the JAX
engine's, and its DI and adjusted counts within 1e-9 in float64 (the bound
of tests/test_torch_engine.py at ``power_warm_plain=0``).
"""
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from degnorm_tpu import engine as jengine
from degnorm_tpu.config import EngineConfig as JEng, NMFConfig as JNmf
from degnorm_tpu_torch import EngineConfig, NMFConfig
from degnorm_tpu_torch import engine as tengine
from degnorm_tpu_torch.core import prng
from tests.torch_port_util import random_coverage

torch.set_num_threads(1)

SEEDS = (0, 123, 2 ** 31 - 1, 2 ** 32 + 5)
RATES = (2, 3, 7, 50)
GENE_COUNTS = (1, 7, 1000, 1001)


def test_the_flag_the_jax_engine_runs_with():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_offsets_equal_jax_randint(seed):
    for it in range(6):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), it)
        for rate in RATES:
            for n in GENE_COUNTS:
                want = np.asarray(jax.random.randint(key, (n,), 0, rate,
                                                     dtype=jnp.int32))
                got = prng.downsample_offsets(seed, it, n, rate)
                assert got.dtype == np.int32
                np.testing.assert_array_equal(
                    got, want, err_msg=f"seed={seed} it={it} rate={rate} "
                                       f"n={n}")


def test_keys_and_bits_equal_jax():
    """The pieces: the seed's key, fold_in, the split and the raw bits."""
    for seed in SEEDS + (-5,):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(np.array(prng.seed_key(seed)),
                                      np.asarray(key))
        for data in (0, 1, 77, 2 ** 32 - 1):
            np.testing.assert_array_equal(
                np.array(prng.fold_in(prng.seed_key(seed), data)),
                np.asarray(jax.random.fold_in(key, data)))
        k1, k2 = jax.random.split(key)
        a, b = prng.split2(prng.seed_key(seed))
        np.testing.assert_array_equal(np.array(a), np.asarray(k1))
        np.testing.assert_array_equal(np.array(b), np.asarray(k2))
        np.testing.assert_array_equal(
            prng.random_bits32(prng.seed_key(seed), 1001),
            np.asarray(jax.random.bits(key, (1001,), jnp.uint32)))


def test_randint_wide_spans_and_empty_span():
    key = jax.random.PRNGKey(9)
    for lo, hi in ((0, 70000), (5, 2 ** 31 - 1), (-3, 4), (4, 4)):
        np.testing.assert_array_equal(
            prng.randint(prng.seed_key(9), 333, lo, hi),
            np.asarray(jax.random.randint(key, (333,), lo, hi,
                                          dtype=jnp.int32)))


def _dataset(seed=34, n=10, p=4):
    rng = np.random.default_rng(seed)
    cov = OrderedDict()
    for i in range(n):
        L = int(120 + rng.integers(0, 800))
        cov[f"gene{i}"] = random_coverage(
            rng, p, L, scale=3 + 6 * rng.random(), degraded=(i % 2 == 0))
    X = np.round(np.abs(rng.standard_normal((n, p))) * 300 + 30)
    return cov, X


def test_keyed_fit_matches_the_jax_engine():
    cov, X = _dataset()
    nmf_kw = dict(nmf_iter=6, degnorm_iter=3, downsample_rate=3)
    je = jengine.DegNormEngine(
        JNmf(**nmf_kw), JEng(device_loop=False, use_pallas=False,
                             dtype="float64", bucket_widths=(512, 1024)))
    rj = je.run(cov, X)
    te = tengine.DegNormEngine(
        NMFConfig(**nmf_kw),
        EngineConfig(device="cpu", use_kernels=False, dtype="float64",
                     power_warm_plain=0, bucket_widths=(512, 1024)))
    assert te.nmf_cfg.ds_compat == "keyed"
    rt = te.run(cov, X)
    # the offset of every gene and iteration, as each engine hands them to
    # its bucket steps (by gene id: the JAX engine orders a bucket's slots
    # its own way)
    def by_gene(eng, starts_of):
        out = np.full(len(cov), -1)
        for b in eng._buckets:
            idx = np.asarray(b.gene_indices)
            out[idx[idx >= 0]] = np.asarray(starts_of(b))[idx >= 0]
        return out

    for it in range(3):
        want = by_gene(je, lambda b: je._ds_starts(b, it))
        got = by_gene(te, lambda b: te._ds_starts(b, it).numpy())
        assert want.min() >= 0
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rt.ran_baseline_selection,
                                  rj.ran_baseline_selection)
    np.testing.assert_allclose(rt.rho, rj.rho, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.x_adj, rj.x_adj, rtol=1e-9)


def test_keyed_offsets_need_no_state_to_resume(tmp_path):
    """A fit resumed from its checkpoint after iteration 1 draws the same
    offsets as the uninterrupted one: they depend on (seed, iteration)."""
    cov, X = _dataset(seed=35, n=8)
    nmf_kw = dict(nmf_iter=5, degnorm_iter=3, downsample_rate=2)

    def engine(iters):
        return tengine.DegNormEngine(
            NMFConfig(**dict(nmf_kw, degnorm_iter=iters)),
            EngineConfig(device="cpu", use_kernels=False, dtype="float64",
                         bucket_widths=(512, 1024)))

    full = engine(3).run(cov, X)
    engine(2).run(cov, X, checkpoint_dir=str(tmp_path))
    resumed = engine(3).run(cov, X, checkpoint_dir=str(tmp_path))
    np.testing.assert_allclose(resumed.rho, full.rho, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(resumed.ran_baseline_selection,
                                  full.ran_baseline_selection)
