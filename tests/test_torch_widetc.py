"""PyTorch port, the resident core of the wide kernels 1 and 3
(csrc/wide_res.cuh, 33 to 128 samples): a gene's X held in the shared
memory of a block or a cluster of blocks for the whole loop, and the Gram on
the tensor cores at float32 accuracy (3xTF32).

On the CPU the wrappers take their plain versions, so the kernels
themselves are checked on the card (``chip_smoke.py`` phase ``wide_p``).
Here: (a) the geometry rule ``cuda_nmf.res_geometry`` and its mirror of the
CUDA source, at every resident shape the gate admits; (b) the arithmetic of
the 3xTF32 Gram, emulated in torch (in this file alone) and patched into
the plain versions' Gram, against the float32 plain versions and the JAX
package's Pallas interpret path at the tolerances ``chip_smoke.py`` holds
the kernels to (``check_kernels_at``: K, E, u rtol 1e-3 / atol 1e-3;
``check_trim_at``: rho within 5e-4 and ran_bs / rounds equal on 99% of the
genes that enter the loop).
"""
import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from degnorm_tpu.ops import pallas_nmf as jp
from degnorm_tpu.ops.pallas_trim import trim_loop_pallas
from degnorm_tpu_torch.config import EngineConfig, NMFConfig
from degnorm_tpu_torch.core import baseline as tb
from degnorm_tpu_torch.core import linalg
from degnorm_tpu_torch.ops import cuda_nmf, cuda_trim
from tests.torch_port_util import random_coverage, to_np

torch.set_num_threads(1)
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "degnorm_tpu_torch", "csrc")
SMEM_PER_BLOCK = 232448        # the H100's opt-in shared memory a block
PMAX_P = {48: range(33, 49), 64: range(49, 65), 96: range(65, 97),
          128: range(97, 129)}


# ---- (a) the geometry --------------------------------------------------------

def deal(n, cl):
    """The slots each block of a cluster of ``cl`` holds of a gene with
    ``n`` active columns (csrc/wide_res.cuh::res_deal: numbers n r / cl ..
    n (r + 1) / cl - 1 to rank r)."""
    return [n * (r + 1) // cl - n * r // cl for r in range(cl)]


@pytest.mark.parametrize("pmax", sorted(PMAX_P))
def test_res_geometry_holds_every_resident_shape(pmax):
    """Every (p, W) the resident gate admits at this instance: at most
    RES_MAX_CLUSTER launches, each block inside the block's shared memory;
    a gene of all W columns active, of one, and of every count between
    (sampled) gets a cluster that one of the launches runs, whose blocks
    hold its shares, and no smaller cluster would; capmax is the most that
    fits."""
    for p in PMAX_P[pmax]:
        assert cuda_nmf.pmax_of(p) == pmax
        for W in range(1, min(cuda_nmf.MAX_W, cuda_nmf.MAX_PW // p) + 1):
            assert cuda_nmf.kernels_supported((1, p, W), torch.float32)
            capmax, launches = cuda_nmf.res_geometry(p, W)
            assert capmax % 8 == 0 and capmax > 0
            assert (capmax >= W or cuda_nmf.res_smem_bytes(
                pmax, W, capmax + 8) > SMEM_PER_BLOCK)
            assert 1 <= len(launches) <= cuda_nmf.RES_MAX_CLUSTER
            for k, (cl, cap, smem) in enumerate(launches):
                assert cl == k + 1 and cap % 8 == 0 and cap <= capmax
                assert smem == cuda_nmf.res_smem_bytes(pmax, W, cap)
                assert smem <= SMEM_PER_BLOCK
                assert cuda_nmf.res_ldc(cap) % 32 == 8
            for n in {W, 1, *range(1, W + 1, 97)}:
                cl = cuda_nmf.res_gene_cluster(n, capmax)
                assert 1 <= cl <= len(launches)
                counts = deal(n, cl)
                assert sum(counts) == n
                assert max(counts) <= launches[cl - 1][1]
                assert cl == 1 or max(deal(n, cl - 1)) > capmax


@pytest.mark.parametrize("p, W, capmax, launches, full", [
    (64, 1024, 776, 2, 2), (64, 512, 512, 1, 1), (48, 1024, 1024, 1, 1),
    (128, 512, 296, 2, 2), (128, 256, 256, 1, 1), (96, 512, 456, 2, 2),
    (33, 1985, 1064, 2, 2), (65, 1008, 456, 3, 3), (97, 675, 296, 3, 3)])
def test_res_geometry_at_the_main_path_and_edge_shapes(p, W, capmax, launches,
                                                       full):
    """The shapes phase wide_p runs, and the edges (the widest p of each
    instance at the gate's widest W): the most slots a block holds, the
    launches, the cluster of a gene of all W columns; a narrow gene of
    about 500 of 1,024 columns at p = 64 takes one block."""
    got_cap, got = cuda_nmf.res_geometry(p, W)
    assert (got_cap, len(got)) == (capmax, launches)
    assert cuda_nmf.res_gene_cluster(W, got_cap) == full
    assert cuda_nmf.res_gene_cluster(500, cuda_nmf.res_geometry(64, 1024)[0]) \
        == 1


def test_res_geometry_refuses_outside_the_wide_instances():
    for p in (32, 129):
        with pytest.raises(ValueError):
            cuda_nmf.res_geometry(p, 256)
    with pytest.raises(ValueError):
        cuda_nmf.res_geometry(64, 8192)


def test_res_mirror_matches_the_source():
    """cuda_nmf's mirror of csrc/wide_res.cuh: the cluster limit, the
    block's shared memory, the instances that run the core, the byte
    formula's terms."""
    with open(os.path.join(CSRC, "wide_res.cuh")) as f:
        src = f.read()
    assert int(re.search(r"#define DN_RES_MAX_CLUSTER (\d+)", src).group(1)) \
        == cuda_nmf.RES_MAX_CLUSTER
    assert int(re.search(r"#define DN_SMEM_BLOCK (\d+)", src).group(1)) \
        == cuda_nmf.SMEM_BLOCK_BYTES == SMEM_PER_BLOCK
    on = re.search(r"constexpr bool dn_res_on\(\) \{\s*return ([^;]+);",
                   src).group(1).strip()
    if on == "true":
        assert cuda_nmf.RES_PMAX == (48, 64, 96, 128)
    else:
        for pm in (48, 64, 96, 128):
            assert (pm in cuda_nmf.RES_PMAX) == bool(
                eval(on.replace("PMAX", str(pm)).replace("&&", " and ")
                     .replace("||", " or ")))
    for term in ("16 * pmax + 1024", "5 * pmax + 40", "(W + 3) / 4 * 4",
                 "(2 * cap + 15) / 16 * 16 +", "(cap + 15) / 16 * 16",
                 "((W + cl - 1) / cl + 7) / 8 * 8",
                 "((8 - cap % 32) % 32 + 32) % 32",
                 "n <= capmax ? 1 : (n + capmax - 1) / capmax",
                 "int cap = (W + 7) / 8 * 8;"):
        assert term in src, term


# ---- (b) the 3xTF32 Gram, emulated --------------------------------------------

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 to TF32 (10 mantissa bits) by nearest, ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds: add half a unit of the 13 dropped bits
    to the magnitude, then drop them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def gram_3xtf32(A: torch.Tensor) -> torch.Tensor:
    """The kernels' Gram of a float32 (G, p, W) batch: each value split
    into hi = tf32(x) and lo = tf32(x - hi), hi hi^T + hi lo^T + lo hi^T
    (lo lo^T dropped) summed here in float64 and rounded to float32 once,
    the upper triangle mirrored."""
    hi = tf32_rna(A)
    lo = tf32_rna(A - hi)
    h, l = hi.double(), lo.double()
    B = (torch.einsum("gpw,gqw->gpq", h, h) + torch.einsum("gpw,gqw->gpq", h, l)
         + torch.einsum("gpw,gqw->gpq", l, h)).to(A.dtype)
    return torch.triu(B) + torch.triu(B, 1).transpose(1, 2)


def test_tf32_rna_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 3.0e-3], dtype=torch.float32)
    got = tf32_rna(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                         1.0 + 2 ** -9, -(1.0 + 2 ** -10)],
                        dtype=torch.float32)
    assert torch.equal(got[:5], want)
    # the low 13 bits are gone and the split is exact
    assert int((got.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert torch.equal(x - got + got, x)


def test_gram_3xtf32_is_float32_accurate():
    """hi + lo carries 22 of float32's 24 bits: the emulated Gram sits
    within a few float32 roundings of the float64 one."""
    rng = np.random.default_rng(3)
    A = torch.from_numpy(rng.gamma(2.0, 5.0, (3, 64, 256)).astype(np.float32))
    got = gram_3xtf32(A).double()
    want = linalg._gram(A.double())
    assert float(((got - want).abs() / want.abs()).max()) < 2e-6
    assert torch.equal(got, got.transpose(1, 2))


LENGTHS_SEED = 21
GENES = 24
W_RES = 256
KW = dict(nmf_iter=12)


def bucket(p):
    """GENES genes of 200-256 positions at p samples, every other one
    degraded, in a (GENES, p, 256) float32 bucket with its length mask."""
    rng = np.random.default_rng(LENGTHS_SEED + p)
    lengths = rng.integers(200, W_RES + 1, GENES)
    F = np.zeros((GENES, p, W_RES), np.float32)
    mask = np.zeros((GENES, W_RES), bool)
    for i, L in enumerate(lengths):
        F[i, :, :L] = random_coverage(rng, p, L, degraded=i % 2 == 0)
        mask[i, :L] = True
    return torch.from_numpy(F), torch.from_numpy(mask)


def loop_inputs(p):
    """The trim loop's inputs of the bucket at p, made by the port's plain
    versions (float32 Gram), and the configs."""
    F, mask = bucket(p)
    nmf_cfg = NMFConfig(**KW)
    eng_cfg = EngineConfig(device="cpu", use_kernels=False)
    return tb.trim_inputs(F, mask, nmf_cfg, eng_cfg), nmf_cfg, eng_cfg


def emulated(monkeypatch):
    monkeypatch.setattr(linalg, "_gram", gram_3xtf32)


@pytest.mark.parametrize("p", [48, 64])
def test_nmf_with_3xtf32_gram_matches_float32_and_pallas(monkeypatch, p):
    """Kernel 1's arithmetic with the tensor cores' Gram: K, E, u against
    the float32 plain version and the TPU kernel's interpret path, cold and
    resumed (with inactive genes), at check_kernels_at's tolerance."""
    ti, nmf_cfg, eng_cfg = loop_inputs(p)
    nkw = dict(tb._nmf_kwargs(nmf_cfg, eng_cfg), power_warm_plain=1)
    act = ~ti.bailed
    act[::5] = False
    want = cuda_nmf.nmf_masked_plain(ti.Fm, ti.hi, gene_active=act, **nkw)
    rkw = dict(nkw, power_iters_cold=eng_cfg.power_iters_resume)
    want_r = cuda_nmf.nmf_masked_plain(ti.Fm, ti.hi, gene_active=act,
                                       u0=want[2], **rkw)
    Kj, Ej, uj = jp.nmf_masked_pallas(
        jnp.asarray(to_np(ti.Fm * ti.hi[:, None, :])), jnp.asarray(
            to_np(ti.hi)), interpret=True, gram_mode="vpu", **nkw)
    emulated(monkeypatch)
    got = cuda_nmf.nmf_masked_plain(ti.Fm, ti.hi, gene_active=act, **nkw)
    got_r = cuda_nmf.nmf_masked_plain(ti.Fm, ti.hi, gene_active=act,
                                      u0=want[2], **rkw)
    a = to_np(act)
    assert a.sum() >= GENES // 2
    for g_, w_, j_ in zip(got, want, (Kj, Ej, uj)):
        np.testing.assert_allclose(to_np(g_), to_np(w_), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(to_np(g_)[a], np.asarray(j_)[a],
                                   rtol=1e-3, atol=1e-3)
        assert np.all(to_np(g_)[~a] == 0)
    for g_, w_ in zip(got_r, want_r):
        np.testing.assert_allclose(to_np(g_), to_np(w_), rtol=1e-3, atol=1e-3)


def assert_trim_close(got, want, ti, what):
    """check_trim_at's gate: ran_bs and rounds equal, rho within 5e-4, on
    99% of the genes that enter (here, with a few dozen genes: all)."""
    K_g, rho_g, ran_g, rounds_g = (to_np(x) for x in got)
    K_w, rho_w, ran_w, rounds_w = (np.asarray(x) for x in want)
    n_ent = int(to_np(ti.active0).sum())
    assert n_ent >= GENES // 2, what
    same = (ran_g == ran_w) & (rounds_g == rounds_w)
    assert len(same) - same.sum() <= 0.01 * n_ent, what
    rho_ok = (np.abs(rho_g.astype(np.float64) - rho_w).max(axis=1) <= 5e-4)
    assert len(same) - (rho_ok & same).sum() <= 0.01 * n_ent, what
    assert int(rounds_g.sum()) > n_ent, f"{what}: the loop ran no rounds"


@pytest.mark.parametrize("p", [48, 64])
def test_trim_with_3xtf32_gram_matches_float32_and_pallas(monkeypatch, p):
    """Kernel 3's arithmetic with the tensor cores' Gram: the whole trim
    loop against the float32 plain version and the TPU kernel's interpret
    path (``gram_mode="vpu"``), at check_trim_at's gate."""
    ti, nmf_cfg, eng_cfg = loop_inputs(p)
    tkw = dict(tb.trim_kwargs(nmf_cfg, eng_cfg), power_warm_plain=1)
    args = (ti.Fm, ti.bin_id, ti.bin_count, ti.K0, ti.E0, ti.rho0, ti.u0,
            ti.n_hi, ti.n_bins0, ti.active0)
    want = cuda_trim.trim_loop_plain(*args, **tkw)
    jargs = [jnp.asarray(to_np(x)) for x in args]
    pallas = trim_loop_pallas(*jargs, gram_mode="vpu", interpret=True, **tkw)
    emulated(monkeypatch)
    got = cuda_trim.trim_loop_plain(*args, **tkw)
    assert_trim_close(got, [to_np(x) for x in want], ti, f"float32 p={p}")
    assert_trim_close(got, pallas, ti, f"pallas p={p}")
    inact = ~to_np(ti.active0)
    np.testing.assert_array_equal(to_np(got[0])[inact], to_np(ti.K0)[inact])


@pytest.mark.parametrize("mode", [dict(trim_fast=True), dict(nmf_tol=1e-4)])
def test_trim_branches_with_3xtf32_gram_match_float32(monkeypatch, mode):
    """The trim_fast and nmf_tol instances (3aw, 3bw) at p = 64 with the
    tensor cores' Gram against their float32 plain versions, and the
    iterations they report."""
    ti, nmf_cfg, eng_cfg = loop_inputs(64)
    tkw = dict(tb.trim_kwargs(nmf_cfg, eng_cfg), power_warm_plain=1, **mode)
    args = (ti.Fm, ti.bin_id, ti.bin_count, ti.K0, ti.E0, ti.rho0, ti.u0,
            ti.n_hi, ti.n_bins0, ti.active0)
    it_w = torch.zeros(GENES, dtype=torch.int32)
    it_g = torch.zeros_like(it_w)
    want = cuda_trim.trim_loop_plain(*args, iters_out=it_w, **tkw)
    emulated(monkeypatch)
    got = cuda_trim.trim_loop_plain(*args, iters_out=it_g, **tkw)
    assert_trim_close(got, [to_np(x) for x in want], ti, str(mode))
    slack = to_np(want[3]) if "nmf_tol" in mode else 0
    assert np.all(np.abs(to_np(it_g) - to_np(it_w)) <= slack)
