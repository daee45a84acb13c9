"""PyTorch port, ops/cuda_stream.py (the streamed NMF of wide buckets) vs the
JAX package's ops/pallas_stream.py.

On the CPU the port runs the kernel's plain version; the CUDA kernel itself
is held against that plain version on the card (chip_smoke.py).  Which JAX
function each test matches, and at what tolerance:
  * ``power_warm_plain=1`` -> ``nmf_masked_streamed`` in interpret mode with
    ``gram_mode="vpu"`` and one plain warm matvec: K, E rtol 1e-4 / atol
    1e-4, u rtol 1e-4 / atol 1e-5 (tests/test_stream.py:43-48; float32
    reduction order differs).
  * ``power_warm_plain=0`` -> the XLA twin ``core.nmf.nmf_masked`` (squared
    warm scheme): the same tolerances.
  * raw int16 + scale against pre-adjusted float32: exactly equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from degnorm_tpu.core import nmf as jn
from degnorm_tpu.ops import pallas_stream as jps
from degnorm_tpu_torch.core import nmf as tn
from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream
from tests.torch_port_util import degraded_bucket, to_np

torch.set_num_threads(1)

# (active genes, W, p) -> (blocks a gene, threads)
GEOMETRY_PINS = [
    (16384, 8, (1, 512)),      # the W=16384 bucket of the long-tail fit
    (65536, 8, (4, 512)),      # its W=65536 bucket
    (32768, 8, (2, 512)),      # a custom width between them
    (8192, 16, (2, 256)),
    (4096, 32, (2, 256)),
    (40000, 2, (4, 512)),
    (2176, 32, (2, 256)),      # just past the resident gate
]

W = 2048
KW = dict(nmf_iter=8, power_iters_cold=60, power_iters_warm=10)
TOLS = (dict(rtol=1e-4, atol=1e-4), dict(rtol=1e-4, atol=1e-4),
        dict(rtol=1e-4, atol=1e-5))           # K, E, u


def _t(x):
    return torch.from_numpy(np.array(x))


def _wide(seed, n, p, width=W):
    rng = np.random.default_rng(seed)
    lengths = [int(rng.integers(width // 2, width + 1)) for _ in range(n)]
    return degraded_bucket(seed, p, lengths, width, np.float32)


def _jax_streamed(F, mask, **kw):
    return jps.nmf_masked_streamed(jnp.asarray(F), jnp.asarray(mask),
                                   interpret=True, gram_mode="vpu",
                                   power_warm_plain=1, **kw)


def _assert_close(got, want, sel=slice(None)):
    for a, b, tol in zip(got, want, TOLS):
        np.testing.assert_allclose(to_np(a)[sel], np.asarray(b)[sel], **tol)


@pytest.mark.parametrize("p", [4, 8])
def test_streamed_plain_matches_pallas_stream_interpret(p):
    F, mask = _wide(60 + p, 10, p)
    want = _jax_streamed(F, mask, **KW)
    got = cuda_stream.nmf_masked_streamed_plain(
        _t(F), _t(mask), power_warm_plain=1, **KW)
    _assert_close(got, want)


def test_streamed_plain_matches_xla_twin():
    F, mask = _wide(60, 10, 4)
    want = jn.nmf_masked(jnp.asarray(F), jnp.asarray(mask), **KW)
    got = cuda_stream.nmf_masked_streamed_plain(
        _t(F), _t(mask), power_warm_plain=0, **KW)
    _assert_close(got, want)


def test_streamed_gene_active_zeroes_skipped_genes():
    """The TPU kernel skips by block of 8 genes, the port by gene: a gene
    outside ``gene_active`` returns zeros, an active one the JAX result."""
    F, mask = _wide(62, 16, 4, width=1024)
    act = np.zeros(16, bool)
    act[:8] = True
    act[3] = False               # inside an active TPU block: port skips it
    kw = dict(nmf_iter=4, power_iters_cold=30, power_iters_warm=6)
    want = _jax_streamed(F, mask, gene_active=jnp.asarray(act), **kw)
    got = cuda_stream.nmf_masked_streamed_plain(
        _t(F), _t(mask), power_warm_plain=1, gene_active=_t(act), **kw)
    for a in got:
        assert np.all(to_np(a)[~act] == 0) and np.isfinite(to_np(a)).all()
    for b in want:
        assert np.all(np.asarray(b)[8:] == 0)
    _assert_close(got, want, sel=act)


def test_streamed_u0_resume_matches_jax_resume():
    """The trim rounds' case: u0 from a previous fit, columns dropped, a
    reduced cold count."""
    F, mask = _wide(63, 8, 4)
    _, _, u_prev = jn.nmf_masked(jnp.asarray(F), jnp.asarray(mask), **KW)
    u0 = np.asarray(u_prev)
    mask2 = mask.copy()
    mask2[:, -512:] = False
    kw = dict(KW, nmf_iter=6, power_iters_cold=16)
    want = _jax_streamed(F, mask2, u0=jnp.asarray(u0), **kw)
    got = cuda_stream.nmf_masked_streamed_plain(
        _t(F), _t(mask2), power_warm_plain=1, u0=_t(u0), **kw)
    _assert_close(got, want)
    want0 = jn.nmf_masked(jnp.asarray(F), jnp.asarray(mask2),
                          u0=jnp.asarray(u0), **kw)
    got0 = cuda_stream.nmf_masked_streamed_plain(
        _t(F), _t(mask2), power_warm_plain=0, u0=_t(u0), **kw)
    _assert_close(got0, want0)


def _raw_case(seed, n, p, width=W):
    F, mask = _wide(seed, n, p, width)
    rng = np.random.default_rng(seed + 1000)
    raw = np.round(F * 3).astype(np.int16)
    scale = (0.5 + rng.random(p)).astype(np.float32)
    return raw, scale, mask


@pytest.mark.parametrize("raw_dtype", [np.int16, np.float32])
def test_streamed_raw_plus_scale_is_bit_identical_to_preadjusted(raw_dtype):
    raw, scale, mask = _raw_case(65, 10, 4)
    raw = raw.astype(raw_dtype)
    kw = dict(nmf_iter=6, power_iters_cold=40, power_iters_warm=8,
              power_warm_plain=1)
    F_adj = _t(raw).to(torch.float32) / _t(scale)[None, :, None]
    a = cuda_stream.nmf_masked_streamed_plain(F_adj, _t(mask), **kw)
    b = cuda_stream.nmf_masked_streamed_plain(_t(raw), _t(mask),
                                              scale=_t(scale), **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(to_np(x), to_np(y))
    # int16 without a scale is cast and masked only
    c = cuda_stream.nmf_masked_streamed_plain(
        _t(raw.astype(np.int16)), _t(mask), **kw)
    d = cuda_stream.nmf_masked_streamed_plain(
        _t(raw.astype(np.float32)), _t(mask), **kw)
    for x, y in zip(c, d):
        np.testing.assert_array_equal(to_np(x), to_np(y))


def test_streamed_raw_route_matches_jax_raw_route():
    raw, scale, mask = _raw_case(66, 8, 4)
    kw = dict(nmf_iter=6, power_iters_cold=40, power_iters_warm=8)
    want = _jax_streamed(raw, mask, scale=jnp.asarray(scale), **kw)
    got = cuda_stream.nmf_masked_streamed_plain(
        _t(raw), _t(mask), scale=_t(scale), power_warm_plain=1, **kw)
    _assert_close(got, want)


@pytest.mark.parametrize("shape,wide", [
    ((6, 8, 1024), False),          # inside the resident gate -> kernel 1
    ((6, 32, 2048), False),         # p * W = 65,536: the gate's edge
    ((4, 32, 2176), True),          # p * W just past it -> kernel 4
    ((3, 4, 8320), True),           # W past 8,192 -> kernel 4
])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_nmf_masked_routes_by_the_resident_gate(monkeypatch, shape, wide,
                                                use_kernels):
    """core/nmf.py::nmf_masked sends a bucket inside the gate to kernel 1's
    wrapper (or plain version) and one outside it to kernel 4's, on the raw
    tensor with the scale vector when both are given."""
    G, p, width = shape
    raw, scale, mask = _raw_case(70 + p, G, p, width)
    F_adj = _t(raw).to(torch.float32) / _t(scale)[None, :, None]
    hits = []

    def spy_on(mod, name):
        orig = getattr(mod, name)

        def spy(Fin, m, **kw):
            hits.append((name, Fin.dtype, kw.get("scale")))
            return orig(Fin, m, **kw)
        monkeypatch.setattr(mod, name, spy)

    for mod, name in ((cuda_nmf, "nmf_masked_cuda"),
                      (cuda_nmf, "nmf_masked_plain"),
                      (cuda_stream, "nmf_masked_streamed_cuda"),
                      (cuda_stream, "nmf_masked_streamed_plain")):
        spy_on(mod, name)
    kw = dict(nmf_iter=2, power_iters_cold=8, power_iters_warm=4,
              power_warm_plain=1, use_kernels=use_kernels)
    with_raw = tn.nmf_masked(F_adj, _t(mask), F_raw=_t(raw),
                             scale=_t(scale), **kw)
    first = hits[0]
    want_name = ("nmf_masked_streamed_" if wide else "nmf_masked_") + (
        "cuda" if use_kernels else "plain")
    assert first[0] == want_name
    if wide:
        assert first[1] == torch.int16 and torch.equal(first[2], _t(scale))
    else:
        assert first[1] == torch.float32 and first[2] is None
    hits.clear()
    # F_raw without scale (or the reverse) is not the raw route
    only_adj = tn.nmf_masked(F_adj, _t(mask), F_raw=_t(raw), **kw)
    assert hits[0][0] == want_name and hits[0][1] == torch.float32
    assert hits[0][2] is None
    for x, y in zip(with_raw, only_adj):
        assert torch.equal(x, y)


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    raw, scale, mask = _raw_case(67, 5, 4)
    kw = dict(nmf_iter=3, power_iters_cold=16, power_iters_warm=4,
              power_warm_plain=1, scale=_t(scale))
    before = cuda_stream.stream_launches
    a = cuda_stream.nmf_masked_streamed_cuda(_t(raw), _t(mask), **kw)
    b = cuda_stream.nmf_masked_streamed_plain(_t(raw), _t(mask), **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert cuda_stream.stream_launches == before


# ---- launch geometry of kernel 4 (ops/cuda_stream.py::pick_geometry) -------

@pytest.mark.parametrize("p", [2, 8, 16, 32])
@pytest.mark.parametrize("width", [4096, 8320, 16384, 40000, 65536])
def test_pick_geometry_is_a_legal_launch(width, p):
    """Every (W, p) gives a launch csrc/stream.cuh takes: whole warps within
    the kernel's bound for p, a power-of-two cluster within the portable
    size, and the cluster's blocks are dealt every column up to the gene's
    last chunk exactly once."""
    cl, threads = cuda_stream.pick_geometry(width, p)
    assert cl in (1, 2, 4, 8)
    assert threads % 32 == 0
    assert 32 <= threads <= cuda_nmf.max_loop_threads(p)
    # a thread's column slots fit the kernel's 64-bit mask
    assert -(-cuda_stream.block_share(width, cl) // threads) <= 64
    assert cuda_stream.RULE_SLOTS <= 64
    assert cuda_nmf.max_loop_threads(p) == (512 if p <= 8 else 256)
    for ncols in (1, width // 3, width):
        dealt = [w for r in range(cl)
                 for w in cuda_stream.block_columns(ncols, width, cl, r)]
        nch = -(-ncols // cuda_stream.CHUNK)
        assert sorted(dealt) == list(
            range(min(nch * cuda_stream.CHUNK, width)))
        share = max(len(cuda_stream.block_columns(ncols, width, cl, r))
                    for r in range(cl))
        assert share <= cuda_stream.block_share(width, cl)


@pytest.mark.parametrize("width,p", [(16384, 8), (65536, 8), (8192, 16),
                                     (4096, 32)])
def test_pick_geometry_takes_the_smallest_cluster_within_the_slot_bound(
        width, p):
    """A gene gets the smallest cluster that leaves a thread at most 256 / p
    column slots (32 at most): the next smaller one would exceed them, and
    a wider gene never gets a smaller cluster."""
    bound = min(cuda_stream.RULE_SLOTS, 256 // p)
    top = cuda_nmf.max_loop_threads(p)

    def slots(cl):
        return -(-cuda_stream.block_share(width, cl) // top)

    cl, threads = cuda_stream.pick_geometry(width, p)
    assert slots(cl) <= bound or cl == cuda_stream.CLUSTERS[-1]
    assert cl == 1 or slots(cl // 2) > bound
    assert threads == top
    cls = [cuda_stream.pick_geometry(w, p)[0]
           for w in (width // 2, width, 2 * width, 4 * width)]
    assert cls == sorted(cls)


@pytest.mark.parametrize("width,p,want", GEOMETRY_PINS)
def test_pick_geometry_at_the_main_path_shapes(width, p, want):
    """The launches of the long-tail fit and the p = 16, 32 shapes, as the
    committed sweep (chip_smoke.py --sweep) chose them."""
    assert cuda_stream.pick_geometry(width, p) == want


def test_wrapper_geometry_override_is_ignored_on_cpu():
    """``_geometry`` chooses a launch; on a CPU tensor there is none and the
    plain version's result is unchanged."""
    raw, scale, mask = _raw_case(68, 5, 4)
    kw = dict(nmf_iter=3, power_iters_cold=16, power_iters_warm=4,
              power_warm_plain=1, scale=_t(scale))
    a = cuda_stream.nmf_masked_streamed_cuda(_t(raw), _t(mask), **kw)
    b = cuda_stream.nmf_masked_streamed_cuda(_t(raw), _t(mask),
                                             _geometry=(4, 128), **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_raw_route_takes_int16_only():
    """core/nmf.py::nmf_masked hands the streamed wrapper the raw tensor
    only where it is int16 (half the bytes); a raw float32 tensor saves
    none, so the adjusted coverage goes instead, without the scales."""
    raw, scale, mask = _raw_case(69, 3, 4, 8320)
    F_adj = _t(raw).to(torch.float32) / _t(scale)[None, :, None]
    seen = []
    orig = cuda_stream.nmf_masked_streamed_cuda

    def spy(Fin, m, **kw):
        seen.append((Fin.dtype, kw.get("scale") is not None))
        return orig(Fin, m, **kw)

    kw = dict(nmf_iter=2, power_iters_cold=8, power_iters_warm=4,
              power_warm_plain=1, scale=_t(scale))
    cuda_stream.nmf_masked_streamed_cuda = spy
    try:
        a = tn.nmf_masked(F_adj, _t(mask), F_raw=_t(raw), **kw)
        b = tn.nmf_masked(F_adj, _t(mask),
                          F_raw=_t(raw).to(torch.float32), **kw)
    finally:
        cuda_stream.nmf_masked_streamed_cuda = orig
    assert seen == [(torch.int16, True), (torch.float32, False)]
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---- the quotient of the int16 + scale form (csrc/common.cuh::scaled_i16) ---

def _fma32(a, b, c):
    """Correctly rounded float32 a * b + c of float32 arrays: the product is
    exact in float64, the sum is taken with its exact error (TwoSum), and a
    float64 sum that sits on a float32 tie is resolved by that error."""
    prod = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    tot = prod + c64
    bb = tot - prod
    err = (prod - (tot - bb)) + (c64 - bb)
    r = tot.astype(np.float32)
    r64 = r.astype(np.float64)
    up = np.nextafter(r, np.float32(np.inf))
    dn = np.nextafter(r, np.float32(-np.inf))
    r = np.where((tot == (r64 + up.astype(np.float64)) / 2) & (err > 0), up, r)
    r = np.where((tot == (r64 + dn.astype(np.float64)) / 2) & (err < 0), dn, r)
    return r.astype(np.float32)


def test_fma_emulation_resolves_a_double_rounding_tie():
    """2^-36 * 2^-24 + (1 + 2^-24 + ...): float64 rounds 1 + 2^-23 + 2^-24 +
    2^-60 to the float32 tie between 1 + 2^-23 and 1 + 2^-22, which float32
    rounding alone would send to the even neighbour; the exact sum lies above
    the tie and rounds up."""
    c = np.array([1 + 2.0 ** -23 + 2.0 ** -24], np.float64)
    a = np.array([2.0 ** -36], np.float32)
    b = np.array([2.0 ** -24], np.float32)
    # c itself is no float32: feed the tie through the product instead
    got = _fma32(np.array([2.0 ** -12], np.float32),
                 np.array([2.0 ** -12 + 2.0 ** -35], np.float32),
                 np.array([1 + 2.0 ** -23], np.float32))
    # exact: 1 + 2^-23 + 2^-24 + 2^-47 -> above the tie -> 1 + 2^-22
    assert got[0] == np.float32(1 + 2.0 ** -22)
    assert c.astype(np.float32)[0] == np.float32(1 + 2.0 ** -22)  # even
    got = _fma32(a, b, np.array([1 + 2.0 ** -23], np.float32))
    assert got[0] == np.float32(1 + 2.0 ** -23)


@pytest.mark.parametrize("seed,lo,hi", [(0, 0.8, 1.25), (1, 0.05, 0.2),
                                        (2, 3.0, 40.0), (3, 0.999, 1.001),
                                        (4, 1e-3, 1e3)])
def test_hoisted_reciprocal_quotient_equals_ieee_divide(seed, lo, hi):
    """q = a r; twice (e = fma(-q, s, a); q = fma(e, r, q)) with r = 1 / s
    equals the IEEE float32 divide a / s for all 65,536 int16 numerators and
    8 scales drawn from [lo, hi) (log-uniform), plus scales with all-ones
    and single-bit mantissas."""
    rng = np.random.default_rng(seed)
    scales = np.exp(rng.uniform(np.log(lo), np.log(hi), 8)).astype(np.float32)
    scales = np.concatenate([scales, np.array(
        [np.nextafter(np.float32(2 * lo), np.float32(0)), lo, hi],
        np.float32)])
    a = np.arange(-32768, 32768).astype(np.int16).astype(np.float32)
    for s in scales:
        sv = np.full_like(a, s)
        r = np.float32(1) / sv
        q = a * r
        for _ in range(2):
            e = _fma32(-q, sv, a)
            q = _fma32(e, r, q)
        want = a / sv
        assert np.array_equal(q.view(np.int32), want.view(np.int32)), (
            s, int((q != want).sum()))
