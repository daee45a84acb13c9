"""PyTorch port, the int16 scan and the bucket pack:
``degnorm_tpu_torch/data/encode.py`` and ``data/buckets.py`` with the host
library's ``pack_kernel.cpp`` against the JAX package's numpy paths, on
inputs made with numpy from a seed; and the 4-bit encoder that
``chip_smoke.py`` phase upload times against the direct upload.
Tolerance: exact equality throughout (verdicts equal, arrays byte-equal).

The JAX package's host library is kept out of these tests (its
``get_fn`` is patched to report no library, which sends every JAX caller
to its numpy form): its build is not safe across processes (ROADMAP
Queue 3), and what is compared here is the port against its results.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from degnorm_tpu.data import buckets as jbuckets
from degnorm_tpu.data import encode as jenc
from degnorm_tpu_torch.data import buckets as tbuckets
from degnorm_tpu_torch.data import encode as tenc
from tests.torch_port_util import random_coverage

EDGE = {
    "zero": [0.0, 0.0],
    "top": [0.0, 32766.0],
    "over": [1.0, 32767.0],
    "neg_zero": [-0.0, 3.0],
    "nan": [1.0, np.nan],
    "inf": [1.0, np.inf],
    "neg_inf": [-np.inf, 1.0],
    "half": [0.5, 2.0],
    "negative": [-1.0, 2.0],
    "empty": [],
    "big": [1e9, 0.0],
}
INT_EDGE = {
    "bool": np.array([True, False]),
    "int_top": np.array([0, 32766], np.int32),
    "int_over": np.array([0, 32767], np.int64),
    "int_neg": np.array([-1, 3], np.int16),
    "uint": np.array([7, 65535], np.uint16),
    "int_empty": np.zeros(0, np.int32),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_on_numpy():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEGNORM_TPU_NO_NATIVE", "1")
        mp.setattr("degnorm_tpu.io.native.build.get_fn", lambda name: None)
        yield


@pytest.fixture(params=["native", "numpy"])
def port_path(request, monkeypatch):
    """The port's native scan/pack/encoder, or its numpy forms
    (DEGNORM_TPU_TORCH_NO_NATIVE=1)."""
    monkeypatch.setenv("DEGNORM_TPU_TORCH_NO_NATIVE",
                       "0" if request.param == "native" else "1")
    return request.param


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_int16able_edge_values_match_jax(port_path, dtype):
    for name, vals in EDGE.items():
        a = np.array(vals, dtype=dtype).reshape(1, -1)
        for arr in (a, np.repeat(a, 3, axis=0)[:, ::-1]):  # + non-contiguous
            assert tenc.int16able(arr) == jenc.int16able(arr), name
        many = [np.ones((2, 5), dtype), a]
        assert (tbuckets.integral_int16able(many)
                == jbuckets.integral_int16able(many)
                == all(jenc.int16able(m) for m in many)), name
    for name, arr in INT_EDGE.items():
        assert tenc.int16able(arr) == jenc.int16able(arr), name


def test_int16able_many_native_matches_jax():
    """One batched native call gives the per-array rule's verdict; inputs it
    does not take (mixed dtypes, a non-contiguous array, integers) are
    refused with None, as in the JAX package."""
    rng = np.random.default_rng(3)
    for dtype in (np.float32, np.float64):
        mats = [np.round(rng.random((4, int(L)))
                         * 30).astype(dtype) for L in
                rng.integers(50, 400, size=40)]
        assert tenc.int16able_many_native(mats) is True
        for name, vals in EDGE.items():
            bad = mats[:20] + [np.array(vals, dtype).reshape(1, -1)] \
                + mats[20:]
            want = all(jenc.int16able(m) for m in bad)
            assert tenc.int16able_many_native(bad, threads=3) == want, name
    assert tenc.int16able_many_native([]) is True
    f32 = np.zeros((2, 3), np.float32)
    for refused in ([f32, f32.astype(np.float64)],
                    [f32, np.zeros((3, 4), np.float32)[:, ::2]],
                    [np.zeros((2, 3), np.int32)]):
        assert tenc.int16able_many_native(refused) is None


def _mats(seed, p=4, n=60, dtype=np.float32):
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([rng.integers(30, 260, size=n - 3),
                              [256, 257, 1100]])
    return [np.round(random_coverage(rng, p, int(L), scale=40.0)
                     ).astype(dtype) for L in lengths]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("layout", ["contiguous", "mixed"])
def test_pack_buckets_int16_byte_equal(port_path, dtype, layout):
    """dn_pack_i16 buckets (mixed lengths, padding genes to the ladder, an
    ad-hoc width past the largest) are byte-equal to the port's numpy fill
    and to the JAX package's pack; a non-contiguous matrix sends its bucket
    to the numpy fill with the same bytes."""
    mats = _mats(5, dtype=dtype)
    if layout == "mixed":
        wide = np.zeros((mats[7].shape[0], 2 * mats[7].shape[1]), dtype)
        wide[:, ::2] = mats[7]
        mats[7] = wide[:, ::2]
        assert not mats[7].flags.c_contiguous
    kw = dict(bucket_widths=(128, 256, 512), dtype=np.int16,
              max_genes_per_bucket=24)
    assert tbuckets.integral_int16able(mats)
    got = tbuckets.pack_buckets(mats, **kw)
    want = jbuckets.pack_buckets(mats, **kw)
    assert len(got) == len(want) and len(got) >= 5
    assert any(b.n_real < b.F.shape[0] for b in got)
    for a, b in zip(got, want):
        assert a.width == b.width and a.F.dtype == b.F.dtype == np.int16
        assert a.F.tobytes() == b.F.tobytes()
        np.testing.assert_array_equal(a.lengths, b.lengths)
        np.testing.assert_array_equal(a.gene_indices, b.gene_indices)


def test_native_pack_takes_only_what_it_can(monkeypatch):
    """_pack_i16_native refuses what its C loop cannot read (another
    sample count, mixed dtypes, an integer source, a float32 bucket) and
    fills an int16 bucket of float64 matrices byte-equal to numpy."""
    monkeypatch.setenv("DEGNORM_TPU_TORCH_NO_NATIVE", "0")
    mats = _mats(9, p=3, n=8, dtype=np.float64)
    lens = np.array([m.shape[1] for m in mats])
    F = np.zeros((8, 3, 2048), np.int16)
    assert tbuckets._pack_i16_native(mats, lens, F)
    want = np.zeros_like(F)
    for i, m in enumerate(mats):
        want[i, :, :m.shape[1]] = m
    assert F.tobytes() == want.tobytes()
    for refused, out in (
            (mats[:2] + [np.zeros((4, 10))], F),
            ([mats[0], mats[1].astype(np.float32)], F),
            ([m.astype(np.int32) for m in mats], F),
            (mats, np.zeros((8, 3, 2048), np.float32))):
        assert not tbuckets._pack_i16_native(refused, lens, out)
    monkeypatch.setenv("DEGNORM_TPU_TORCH_NO_NATIVE", "1")
    assert not tbuckets._pack_i16_native(mats, lens, F)


@pytest.mark.parametrize("W", [301, 300])
def test_upload_phase_encoder_matches_jax_and_round_trips(W):
    """chip_smoke.py phase upload's encoded form (the host library's
    dn_nib_encode, decoded by nib_decode) equals the JAX package's numpy
    4-bit encoder field by field and decodes to the exact bucket on the
    CPU; W odd and even (the tail nibble)."""
    rng = np.random.default_rng(1)
    d = rng.integers(-3, 4, size=(40, 3, W))
    big = rng.random(d.shape) < 0.002
    d[big] = rng.integers(-400, 400, size=int(big.sum()))
    F = np.clip(np.cumsum(d, axis=2) + 500, 0, 32766).astype(np.int16)
    F[35:] = 0                                  # padding genes
    got = chip_smoke.nib_encode(F, 35)
    want = jenc.nibble_encode(F, 35)
    assert len(want.exc_idx) > 0
    for a, b in zip(got, want):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    out = chip_smoke.nib_decode(*(torch.from_numpy(f) for f in got), W)
    assert out.dtype == torch.int16
    assert torch.equal(out, torch.from_numpy(F))
