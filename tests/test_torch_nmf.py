"""PyTorch port, core/nmf.py (+ the plain versions in ops/cuda_nmf.py) vs the
JAX package.

Which JAX function each test matches:
  * ``power_warm_plain=0``  -> the XLA twin ``core.nmf.nmf_masked`` (it always
    runs the squared warm scheme).  float64 rtol 1e-8 (same op order; the
    einsum summation order differs); float32 rtol 1e-4 / atol 1e-4.
  * ``power_warm_plain=1``  -> the fused kernel ``nmf_masked_pallas`` in
    interpret mode with ``gram_mode="vpu"``.  float32 rtol 1e-4 / atol 1e-4
    (the tolerance of tests/test_pallas.py).
Inactive genes: the port returns zeros (as the kernels do), the XLA twin
computes them anyway, so only active genes are compared against it.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from degnorm_tpu.core import nmf as jn
from degnorm_tpu.ops import pallas_nmf as jp
from degnorm_tpu_torch.core import nmf as tn
from degnorm_tpu_torch.ops import cuda_nmf
from tests.torch_port_util import degraded_bucket, to_np

torch.set_num_threads(1)

KW = dict(nmf_iter=12, power_iters_cold=60, power_iters_warm=12)
LENGTHS = (150, 256, 90, 200, 231, 64)
TOL = {np.float64: dict(rtol=1e-8, atol=1e-10),
       np.float32: dict(rtol=1e-4, atol=1e-4)}


def _bucket(dtype, seed=44, p=4):
    return degraded_bucket(seed, p, LENGTHS, 256, dtype)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nmf_masked_matches_xla_twin(dtype):
    F, mask = _bucket(dtype)
    Kj, Ej, uj = jn.nmf_masked(jnp.asarray(F), jnp.asarray(mask), **KW)
    Kt, Et, ut = tn.nmf_masked(_t(F), _t(mask), power_warm_plain=0,
                               use_kernels=False, **KW)
    assert Kt.dtype == _t(F).dtype
    for a, b in ((Kt, Kj), (Et, Ej), (ut, uj)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nmf_masked_resume_and_gene_active_match_xla_twin(dtype):
    """u0 resume at a reduced cold count, with some genes switched off."""
    F, mask = _bucket(dtype, seed=45)
    _, _, u_prev = jn.nmf_masked(jnp.asarray(F), jnp.asarray(mask), **KW)
    u0 = np.asarray(u_prev)
    act = np.array([True, False, True, True, False, True])
    kw = dict(KW, power_iters_cold=8)
    Kj, Ej, uj = jn.nmf_masked(jnp.asarray(F), jnp.asarray(mask),
                               u0=jnp.asarray(u0), **kw)
    Kt, Et, ut = tn.nmf_masked(_t(F), _t(mask), u0=_t(u0),
                               gene_active=_t(act), power_warm_plain=0,
                               use_kernels=False, **kw)
    for a, b in ((Kt, Kj), (Et, Ej), (ut, uj)):
        np.testing.assert_allclose(to_np(a)[act], np.asarray(b)[act],
                                   **TOL[dtype])
        assert np.all(to_np(a)[~act] == 0)        # the kernels' contract


def test_nmf_masked_matches_pallas_interpret():
    F, mask = _bucket(np.float32)
    Kj, Ej, uj = jp.nmf_masked_pallas(
        jnp.asarray(F), jnp.asarray(mask), interpret=True, gram_mode="vpu",
        power_warm_plain=1, **KW)
    Kt, Et, ut = tn.nmf_masked(_t(F), _t(mask), power_warm_plain=1,
                               use_kernels=False, **KW)
    for a, b in ((Kt, Kj), (Et, Ej), (ut, uj)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_nmf_masked_resume_gene_active_match_pallas_interpret():
    F, mask = _bucket(np.float32, seed=46)
    rng = np.random.default_rng(9)
    u0 = (np.abs(rng.standard_normal(F.shape[:2])) + 0.2).astype(np.float32)
    u0 /= np.linalg.norm(u0, axis=1, keepdims=True)
    act = np.array([True, True, False, True, True, True])
    kw = dict(KW, power_iters_cold=32)
    Kj, Ej, uj = jp.nmf_masked_pallas(
        jnp.asarray(F), jnp.asarray(mask), interpret=True, gram_mode="vpu",
        power_warm_plain=1, u0=jnp.asarray(u0),
        gene_active=jnp.asarray(act), **kw)
    Kt, Et, ut = tn.nmf_masked(_t(F), _t(mask), power_warm_plain=1,
                               u0=_t(u0), gene_active=_t(act),
                               use_kernels=False, **kw)
    # the TPU kernel still computes an inactive gene inside an active
    # block; callers consume active genes only
    for a, b in ((Kt, Kj), (Et, Ej), (ut, uj)):
        np.testing.assert_allclose(to_np(a)[act], np.asarray(b)[act],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("wp", [0, 1, 2])
def test_warm_schemes_agree_within_convergence_class(wp):
    """Both warm schemes chase the same Perron vector (tolerance of
    tests/test_pallas.py::test_packed_and_plain_warm_modes)."""
    F, mask = _bucket(np.float32, seed=48, p=8)
    ref = tn.nmf_masked(_t(F), _t(mask), power_warm_plain=4,
                        use_kernels=False, **KW)
    got = tn.nmf_masked(_t(F), _t(mask), power_warm_plain=wp,
                        use_kernels=False, **KW)
    np.testing.assert_allclose(to_np(got[0]), to_np(ref[0]), rtol=5e-3,
                               atol=1e-3)
    np.testing.assert_allclose(to_np(got[1]), to_np(ref[1]), rtol=5e-3,
                               atol=5e-3)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ratio_svd_rowsums_matches_xla_twin(dtype):
    F, mask = _bucket(dtype, seed=47)
    cj, ej = jn.ratio_svd_rowsums(jnp.asarray(F), jnp.asarray(mask),
                                  power_iters=60)
    ct, et = tn.ratio_svd_rowsums(_t(F), _t(mask), power_iters=60,
                                  use_kernels=False)
    tol = dict(rtol=1e-8) if dtype == np.float64 else dict(rtol=1e-4,
                                                            atol=1e-3)
    np.testing.assert_allclose(to_np(ct), np.asarray(cj), **tol)
    np.testing.assert_allclose(to_np(et), np.asarray(ej), **tol)


def test_ratio_svd_rowsums_matches_pallas_interpret():
    F, mask = _bucket(np.float32, seed=47)
    cj, ej = jp.ratio_rowsums_pallas(jnp.asarray(F), jnp.asarray(mask),
                                     power_iters=60, interpret=True)
    ct, et = tn.ratio_svd_rowsums(_t(F), _t(mask), power_iters=60,
                                  use_kernels=False)
    np.testing.assert_allclose(to_np(ct), np.asarray(cj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(to_np(et), np.asarray(ej), rtol=1e-4,
                               atol=1e-3)


def test_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    """On a CPU tensor a wrapper runs its plain version (bit-identical) and
    its launch counter stays where it was."""
    F, mask = _bucket(np.float32)
    before = (cuda_nmf.nmf_launches, cuda_nmf.ratio_launches)
    a = tn.nmf_masked(_t(F), _t(mask), power_warm_plain=1, use_kernels=True,
                      **KW)
    b = cuda_nmf.nmf_masked_plain(_t(F), _t(mask), power_warm_plain=1, **KW)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = tn.ratio_svd_rowsums(_t(F), _t(mask), power_iters=16,
                             use_kernels=True)
    d = cuda_nmf.ratio_rowsums_plain(_t(F), _t(mask), power_iters=16)
    for x, y in zip(c, d):
        assert torch.equal(x, y)
    assert (cuda_nmf.nmf_launches, cuda_nmf.ratio_launches) == before


@pytest.mark.parametrize("shape,dtype,ok", [
    ((64, 8, 1024), torch.float32, True),
    ((64, 8, 4096), torch.float32, True),
    ((64, 32, 2048), torch.float32, True),
    ((64, 8, 16384), torch.float32, False),     # the streamed kernel's
    ((64, 33, 256), torch.float32, True),       # a wide instance (p > 32)
    ((64, 64, 1024), torch.float32, True),
    ((64, 64, 2048), torch.float32, False),     # p * W past the gate
    ((64, 129, 256), torch.float32, True),      # the panel instance (p > 128)
    ((64, 257, 256), torch.float32, False),     # p * W past the gate
    ((64, 8, 1024), torch.float64, False),
])
def test_kernel_shape_gate(shape, dtype, ok):
    assert cuda_nmf.kernels_supported(shape, dtype) is ok


def test_kernel_input_check_names_the_pending_kernel():
    # a resident kernel handed a wide bucket names the kernel that takes it
    wide = torch.zeros((1, 8, 16384), dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="streamed"):
        cuda_nmf.check_kernel_input(wide, "nmf_masked_cuda")
    cuda_nmf.check_coverage_input(wide, "ratio_rowsums_cuda")   # any width
    with pytest.raises(TypeError):
        cuda_nmf.check_kernel_input(torch.zeros((1, 4, 64), dtype=torch.float64),
                                    "nmf_masked_cuda")
    with pytest.raises(ValueError, match="contiguous"):
        cuda_nmf.check_kernel_input(
            torch.zeros((2, 64, 4), dtype=torch.float32).permute(0, 2, 1),
            "nmf_masked_cuda")


# ---- launch rules and the int16 route of kernel 2 --------------------------

# every width inside the resident gate, in steps of 8, and a few odd ones
GATE_WIDTHS = sorted(set(range(8, cuda_nmf.MAX_W + 1, 8)) | {1, 31, 100, 383})
SMEM_PER_BLOCK = 232448     # the H100's opt-in shared memory a block


@pytest.mark.parametrize("p", [*range(2, cuda_nmf.WIDE_MAX_P + 1), 129, 256])
def test_pick_nmf_geometry_gives_a_legal_launch(p):
    """For every width inside the gate and bucket sizes from one gene to
    more than the card's warps: threads in whole warps within the kernel's
    bound; a block a gene keeps a thread's column slots inside the 64-bit
    mask; a warp a gene fits its warps' shared memory (Gram, tile, uint16
    column indices) in a block."""
    for W in GATE_WIDTHS:
        if p * W > cuda_nmf.MAX_PW:
            continue
        assert cuda_nmf.kernels_supported((1, p, W), torch.float32)
        for G in (1, 64, 1536, cuda_nmf.warp_slots(p), 24576):
            kind, threads = cuda_nmf.pick_nmf_geometry(p, W, G)
            assert threads % 32 == 0
            assert 32 <= threads <= cuda_nmf.max_loop_threads(p)
            if kind == "block":
                assert -(-W // threads) <= 64
            else:
                assert kind == "warp" and W <= 65535
                assert p <= cuda_nmf.GENE_WARP_MAX_P
                assert threads // 32 * cuda_nmf.warp_gene_bytes(p, W) \
                    <= SMEM_PER_BLOCK


NMF_GEOMETRY_PINS = [
    (8, 1024, 24576, ("warp", 128)),    # the narrow fit's W=1024 bucket
    (8, 4096, 1536, ("block", 256)),    # ... and its W=4096 bucket
]


@pytest.mark.parametrize("p,W,G,want", NMF_GEOMETRY_PINS)
def test_pick_nmf_geometry_at_the_main_path_shapes(p, W, G, want):
    """Kernel 1's launches of the narrow fit, as the committed sweep
    (chip_smoke.py --sweep) chose them."""
    assert cuda_nmf.pick_nmf_geometry(p, W, G) == want


@pytest.mark.parametrize("p", [2, 3, 8, 16, 32])
def test_pick_ratio_geometry_gives_a_legal_launch(p):
    """Kernel 2's cluster grows with the width, never past 8; threads in
    whole warps within its 256; the copy within a block's shared memory.
    The rule sees no dtype, so int16 and float32 input share a launch."""
    for G in (1, 384, 24576):
        cls = []
        for W in (256, 1024, 4096, 16384, 65536, 200000):
            cl, threads, kb = cuda_nmf.pick_ratio_geometry(p, W, G)
            assert cl in (1, 2, 4, 8) and threads in (128, 256)
            assert cl == 8 or p * -(-W // cl) * 2 <= 65536
            assert 0 <= kb <= 200
            cls.append(cl)
        assert cls == sorted(cls)


RATIO_GEOMETRY_PINS = [
    (8, 1024, 24576, (1, 128, 24)),     # the narrow fit's buckets
    (8, 4096, 1536, (1, 256, 24)),
    (8, 16384, 2048, (4, 128, 24)),     # the long-tail fit's buckets
    (8, 65536, 384, (8, 256, 24)),
]


@pytest.mark.parametrize("p,W,G,want", RATIO_GEOMETRY_PINS)
def test_pick_ratio_geometry_at_the_main_path_shapes(p, W, G, want):
    """Kernel 2's launches of both fits, as the committed sweep
    (chip_smoke.py --sweep) chose them."""
    assert cuda_nmf.pick_ratio_geometry(p, W, G) == want


def _int16_bucket(seed=47, p=4):
    F, mask = _bucket(np.float32, seed=seed, p=p)
    return np.round(F * 20).astype(np.int16), mask


def test_ratio_rowsums_int16_equals_float32_cast_and_pallas_interpret():
    """The wrapper on a CPU int16 tensor (the engine's upload) gives the
    plain version's bits on its float32 cast, and matches the TPU kernel in
    interpret mode on that cast, as degnorm_tpu/engine.py hands it over
    (tolerance of test_ratio_svd_rowsums_matches_pallas_interpret)."""
    raw, mask = _int16_bucket()
    Ff = raw.astype(np.float32)
    got = cuda_nmf.ratio_rowsums_cuda(_t(raw), _t(mask), power_iters=60)
    ref = cuda_nmf.ratio_rowsums_plain(_t(Ff), _t(mask), power_iters=60)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    cj, ej = jp.ratio_rowsums_pallas(jnp.asarray(Ff), jnp.asarray(mask),
                                     power_iters=60, interpret=True)
    np.testing.assert_allclose(to_np(got[0]), np.asarray(cj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(to_np(got[1]), np.asarray(ej), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("dtype,seen", [("float32", torch.int16),
                                        ("float64", torch.float64)])
def test_bucket_init_hands_the_int16_upload_through_uncast(monkeypatch, dtype,
                                                           seen):
    """A float32 engine's initialisation gives kernel 2's wrapper the int16
    upload as it is (no float32 copy of the bucket); a float64 engine keeps
    its cast."""
    from degnorm_tpu_torch import EngineConfig
    from degnorm_tpu_torch import engine as tengine
    raw, mask = _int16_bucket(seed=49)
    dtypes = []
    orig = cuda_nmf.ratio_rowsums_cuda

    def spy(F, m, **kw):
        dtypes.append(F.dtype)
        return orig(F, m, **kw)

    monkeypatch.setattr(cuda_nmf, "ratio_rowsums_cuda", spy)
    cfg = EngineConfig(device="cpu", dtype=dtype, power_iters_cold=16)
    cs, es = tengine._bucket_init(_t(raw), _t(mask), cfg)
    assert dtypes == [seen]
    want = cuda_nmf.ratio_rowsums_plain(_t(raw).to(seen if dtype == "float64"
                                                   else torch.float32),
                                        _t(mask), power_iters=16)
    assert torch.equal(cs, want[0]) and torch.equal(es, want[1])


def test_chip_smoke_ratio_bound_counts_the_element_size():
    """chip_smoke.bound_ratio counts 2 bytes an int16 element and 4 a
    float32 one: the active columns' coverage, or every element with
    ``full``, beside the whole mask and the two outputs."""
    import chip_smoke
    G, p, W = 6, 4, 256
    raw, mask = _int16_bucket(seed=50)
    cols = int(mask.sum())
    rest = G * (W + 2 * p * 4)

    def byts(F, full=False):
        ms, by = chip_smoke.bound_ratio(F, _t(mask), full=full)
        assert by == "bytes"
        return ms / 1e3 * chip_smoke.PEAK_BYTES_PER_S

    assert raw.shape == (G, p, W)
    for F, size in ((_t(raw), 2), (_t(raw).to(torch.float32), 4)):
        assert byts(F) == pytest.approx(cols * p * size + rest)
        assert byts(F, full=True) == pytest.approx(G * p * W * size + rest)


def test_nmf_wrapper_launch_overrides_are_ignored_on_cpu():
    """``_geometry`` chooses a launch; on a CPU tensor there is none and the
    plain version's result is unchanged."""
    F, mask = _bucket(np.float32)
    a = cuda_nmf.nmf_masked_cuda(_t(F), _t(mask), power_warm_plain=1, **KW)
    b = cuda_nmf.nmf_masked_cuda(_t(F), _t(mask), power_warm_plain=1,
                                 _geometry=("warp", 64), **KW)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
