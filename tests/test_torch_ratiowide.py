"""Kernel 2 at 33-128 samples (csrc/ratio_wide.cuh): its phases over the
card against their Python mirror in ops/cuda_nmf.py (chunks of a gene's
columns, threads a row of a tile's sums and of B^2, each launch's shared
memory, a slot of the workspace and the genes of a group) at PMAX 48, 64,
96 and 128 and W = 256, 1,024, 16,384 and 65,536; the wrapper's
workspace; and a float32 emulation of the phases' arithmetic (partial
Grams summed in chunk order, each row of B^2 whole or in two shares of
its columns, four partial sums a share, the second pass a chunk at a time) against the plain
version ``ratio_rowsums_plain`` at the
kernel's tolerance on the card (rtol/atol 1e-3, ``chip_smoke.py``'s
``check_ratio_at``), with int16 input giving the bits of float32 input.

The kernel itself runs only on the card (``chip_smoke.py`` phase
``wide_p``)."""
import os
import re

import numpy as np
import pytest
import torch

from degnorm_tpu_torch.ops import build, cuda_nmf
from tests.test_torch_panelcl import CSRC

SMEM_PER_BLOCK = 232448        # the H100's opt-in shared memory a block
SMEM_PER_SM = 233472           # ... and an SM's (1 KB of it a block's own)
PMAX = (48, 64, 96, 128)
WIDTHS = (256, 1024, 16384, 65536)
TC = 64


# csrc/ratio_wide.cuh's launch geometry (its dn_rw_* code that the wrapper
# does not need): tiles copied ahead into a ring of stages, the threads that
# sum each row of a tile, the power step's threads (a row of B^2 whole in a
# thread's registers up to PMAX 64, RW_TR threads a row above), each
# launch's shared memory
RW_AHEAD = 2
RW_STAGES = RW_AHEAD + 1
RW_TR = 2


def chunk_columns(W, ch):
    """The columns of chunk ``ch`` (``rw_chunk_end``'s tiles)."""
    tiles = -(-W // TC)
    k0 = ch * cuda_nmf.RW_CHUNK_TILES
    k1 = min(tiles, k0 + cuda_nmf.RW_CHUNK_TILES)
    return range(k0 * TC, min(W, k1 * TC))


def row_threads(p):
    """Threads that sum each row of a tile (``dn_rw_rs``)."""
    return 4 if cuda_nmf.pmax_of(p) <= 64 else 2


def power_threads(p):
    """Threads of a gene's power step (``dn_rw_power_threads``): a warp at
    PMAX 48 (two rows of B^2 a lane), two at 64 (a row a lane), 256 above
    (RW_TR threads a row)."""
    pm = cuda_nmf.pmax_of(p)
    return 32 if pm <= 48 else 64 if pm <= 64 else cuda_nmf.WIDE_THREADS


def smem_bytes(p, itemsize=2):
    """Dynamic shared memory of a block of each launch at p's PMAX with
    input elements of ``itemsize`` bytes (``dn_rw_tiles_bytes``,
    ``dn_rw_power_bytes``, ``dn_rw_est_bytes``): the stages, two float32
    tiles, 256 floats of row-sum partials, the tile list and the chunk's
    mask bytes; the power step's B, two p-vectors and 32 floats; the second
    pass's v partials, u and K beside the tiles'."""
    pm = cuda_nmf.pmax_of(p)
    tiles = (RW_STAGES * pm * TC * itemsize
             + 4 * (2 * TC * (pm + 4) + 256 + cuda_nmf.RW_CHUNK_TILES + 4)
             + cuda_nmf.RW_CHUNK_TILES * TC)
    return {"gram": tiles, "power": 4 * (pm * (pm + 4) + 2 * pm + 32),
            "est": tiles + 4 * (4 * TC + 2 * pm)}


def _src():
    with open(os.path.join(CSRC, "ratio_wide.cuh")) as f:
        return f.read()


def _define(src, name):
    return int(re.search(rf"#define {name} (\d+)", src).group(1))


def _returned(src, fn, **names):
    """The value of a C function of ratio_wide.cuh that returns one
    expression (at most one ``const int`` before it), at ``names``."""
    m = re.search(fn + r"\([^)]*\) \{\s*(?:const int (\w+) = ([^;]*);\s*)?"
                  r"return (.*?);\s*\}", src, re.S)
    env = dict(names, DN_WIDE_TC=TC,
               DN_RW_CHUNK_TILES=_define(src, "DN_RW_CHUNK_TILES"),
               DN_RW_SCAL=_define(src, "DN_RW_SCAL"),
               DN_RW_STAGES=_define(src, "DN_RW_AHEAD") + 1,
               DN_WIDE_THREADS=cuda_nmf.WIDE_THREADS,
               dn_rw_chunks=cuda_nmf.ratio_wide_chunks,
               dn_rw_tiles_bytes=lambda pmax, esize: _returned(
                   src, "dn_rw_tiles_bytes", pmax=pmax, esize=esize))

    def ev(expr):
        expr = " ".join(expr.replace("(size_t)", "").split())
        t = re.fullmatch(r"(.*?)\s*\?\s*(.*?)\s*:\s*(.*)", expr)
        if t:   # (a right-nested ? : chain)
            return ev(t.group(2)) if ev(t.group(1)) else ev(t.group(3))
        return eval(expr.replace("/", "//"), {}, env)

    if m.group(1):
        env[m.group(1)] = ev(m.group(2))
    return ev(m.group(3))


def test_ratio_wide_constants_match_the_sources():
    """The mirror's constants are the kernel's, and the block layout of the
    first design (one block of 256 threads a gene for the whole call) is
    gone."""
    src = _src()
    assert _define(src, "DN_RW_CHUNK_TILES") == cuda_nmf.RW_CHUNK_TILES
    assert _define(src, "DN_RW_SCAL") == cuda_nmf.RW_SCAL
    assert _define(src, "DN_RW_AHEAD") == RW_AHEAD
    assert _define(src, "DN_RW_TR") == RW_TR
    assert "#define DN_RW_STAGES (DN_RW_AHEAD + 1)" in src
    assert RW_STAGES == RW_AHEAD + 1
    assert cuda_nmf.WIDE_TC == TC
    assert "ratio_wide_kernel<" not in src
    for name in ("ratio_wide_gram_kernel", "ratio_wide_power_warp_kernel",
                 "ratio_wide_power_kernel", "ratio_wide_est_kernel",
                 "ratio_wide_sum_kernel"):
        assert f"    {name}(RatioArgs a, int base)" in src, name
    for form in ("f32", "i16"):
        with open(os.path.join(CSRC, f"ratio_wide_{form}.cu")) as f:
            assert f"launch_ratio_wide<{str(form == 'i16').lower()}>(a)" \
                in f.read()


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("pmax", PMAX)
def test_ratio_wide_mirror_matches_the_sources(pmax, W):
    """At (PMAX, W): the chunks of a gene, a slot's floats, the threads a
    row (of a tile's sums and of B^2) and each launch's shared memory at
    both input forms as the sources compute them equal the mirror's, for
    every p of the instance."""
    src = _src()
    assert _returned(src, "dn_rw_chunks", W=W) == \
        cuda_nmf.ratio_wide_chunks(W)
    for p in range(max(33, pmax - 15), pmax + 1):
        assert cuda_nmf.pmax_of(p) == pmax
        assert _returned(src, "dn_rw_slot_floats", pmax=pmax, W=W) == \
            cuda_nmf.ratio_wide_slot_floats(p, W)
        assert _returned(src, "dn_rw_rs", pmax=pmax) == \
            row_threads(p)
        assert _returned(src, "dn_rw_power_threads", pmax=pmax) == \
            power_threads(p)
        for esize in (2, 4):
            smem = {"gram": _returned(src, "dn_rw_tiles_bytes", pmax=pmax,
                                      esize=esize),
                    "power": _returned(src, "dn_rw_power_bytes", pmax=pmax),
                    "est": _returned(src, "dn_rw_est_bytes", pmax=pmax,
                                     esize=esize)}
            assert smem == smem_bytes(p, esize)


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("pmax", PMAX)
def test_ratio_wide_geometry(pmax, W):
    """Every column of a gene in exactly one chunk, in order (so the
    partials are summed in column order by chunk); one chunk up to 1,024
    columns, chunks of RW_CHUNK_TILES tiles past it; the threads that sum
    a tile's rows within a block of 256; B^2's rows whole in a thread's
    registers up to PMAX 64 (one or two warps a gene), else RW_TR threads a
    row, each share in float4 steps;
    every launch's shared memory within a
    block's, and within half an SM's where the launch bounds name two blocks
    an SM (PMAX <= 64); a slot 16-byte aligned; a group of at least one
    gene, and within RW_WS_FLOATS where a slot fits."""
    nch = cuda_nmf.ratio_wide_chunks(W)
    cols = [list(chunk_columns(W, c)) for c in range(nch)]
    assert [x for c in cols for x in c] == list(range(W))
    assert all(cols)
    assert nch == (1 if W <= 1024 else -(-W // (TC * cuda_nmf.RW_CHUNK_TILES)))
    assert all(len(c) <= TC * cuda_nmf.RW_CHUNK_TILES for c in cols)
    assert row_threads(pmax) * pmax <= 256
    if pmax <= 64:   # whole rows a thread: two at 48, one at 64
        rows = 2 if pmax <= 48 else 1
        assert power_threads(pmax) == \
            -(-(pmax // rows) // 32) * 32 and pmax % 4 == 0
    else:
        tr = RW_TR
        assert tr * pmax <= 256 and (pmax // tr) % 4 == 0
    for esize in (2, 4):
        smem = smem_bytes(pmax, esize)
        assert max(smem.values()) <= SMEM_PER_BLOCK
        if pmax <= 64:
            assert 2 * (smem["gram"] + 1024) <= SMEM_PER_SM
    assert cuda_nmf.ratio_wide_slot_floats(pmax, W) % 4 == 0
    for G in (1, 8, 256, 1024, 20480):
        slots = cuda_nmf.ratio_wide_slots(G, pmax, W)
        assert 1 <= slots <= G
        floats = slots * cuda_nmf.ratio_wide_slot_floats(pmax, W)
        assert slots == 1 or floats <= cuda_nmf.RW_WS_FLOATS


@pytest.mark.parametrize("p,W,G", [(40, 300, 3), (64, 1024, 5),
                                   (100, 2100, 2), (128, 65536, 1)])
def test_ratio_wide_wrapper_passes_its_workspace(monkeypatch, p, W, G):
    """The wrapper hands kernel 2's wide instance the mirror's workspace:
    ``ratio_wide_slots`` slots of ``ratio_wide_slot_floats`` floats, its
    launch geometry (one cluster block, WIDE_THREADS), and counts the
    launch.  Meta tensors stand for the card's; the library is a stub."""
    seen = {}

    class Lib:
        def dn_ratio_rowsums(self, *args):
            seen["args"] = args
            return 0

    monkeypatch.setattr(build, "get_lib", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    F = torch.empty((G, p, W), dtype=torch.int16, device="meta")
    m = torch.empty((G, W), dtype=torch.bool, device="meta")
    before = cuda_nmf.ratio_wide_launches
    cuda_nmf.ratio_rowsums_cuda(F, m, power_iters=8)
    a = seen["args"]
    cl, threads, stage_kb, ws, slots = a[9], a[10], a[11], a[12], a[13]
    assert (cl, threads, stage_kb) == (1, cuda_nmf.WIDE_THREADS, 0)
    assert slots == cuda_nmf.ratio_wide_slots(G, p, W) >= 1
    assert cuda_nmf.ratio_wide_launches == before + 1


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _emulate(F, mask, power_iters):
    """csrc/ratio_wide.cuh's arithmetic in float32 on the CPU, one gene at
    a time: A0 = F * mask at PMAX rows, each chunk's partial Gram and row
    sums summed in chunk order, B^2 of B / (max|B| + eps) a row at a time,
    max(1, power_iters / 4) bodies of two matvecs (each share of a row's
    columns four partial sums over j mod 4, the shares added) and a
    renormalisation, s, then e of each active column and the row sums of
    max(K e, A0) a chunk at a time."""
    G, p, W = F.shape
    pm = cuda_nmf.pmax_of(p)
    eps = np.float32(1e-30)
    cov = np.zeros((G, p), np.float32)
    est = np.zeros((G, p), np.float32)
    nch = cuda_nmf.ratio_wide_chunks(W)
    for g in range(G):
        A = np.zeros((pm, W), np.float32)
        A[:p] = F[g].astype(np.float32) * mask[g].astype(np.float32)
        chunks = [chunk_columns(W, c) for c in range(nch)]
        B = np.zeros((pm, pm), np.float32)
        rs = np.zeros(pm, np.float32)
        for c in chunks:
            Ac = A[:, c.start:c.stop]
            B = B + Ac @ Ac.T
            rs = rs + Ac.sum(axis=1, dtype=np.float32)
        cov[g] = rs[:p]
        Bn = B * (np.float32(1) / (np.abs(B).max() + eps))
        B2 = (Bn.T @ Bn).astype(np.float32)

        tr = 1 if pm <= 64 else RW_TR

        def mv(x):
            shares = []
            for h in range(tr):
                cols = slice(h * pm // tr, (h + 1) * pm // tr)
                Bh, xh = B2[:, cols], x[cols]
                parts = [Bh[:, j::4] @ xh[j::4] for j in range(4)]
                shares.append((parts[0] + parts[1]) + (parts[2] + parts[3]))
            return shares[0] if tr == 1 else shares[0] + shares[1]

        u = np.zeros(pm, np.float32)
        u[:p] = np.float32(1) / np.sqrt(np.float32(p))
        for _ in range(max(1, power_iters // 4)):
            vb = mv(mv(u))
            nrm = np.sqrt(np.float32((vb * vb).sum(dtype=np.float32)))
            if nrm > eps:
                u = vb / (nrm + eps)
        s = np.sqrt(max(np.float32(u @ (B @ u)), np.float32(0)))
        K = u * s
        es = np.zeros(pm, np.float32)
        for c in chunks:
            Ac = A[:, c.start:c.stop]
            on = mask[g, c.start:c.stop]
            e = (u @ Ac) / (s + eps)
            Y = np.where(on[None, :], np.maximum(K[:, None] * e[None, :], Ac),
                         0).astype(np.float32)
            es = es + Y.sum(axis=1, dtype=np.float32)
        est[g] = es[:p]
    return cov, est


@pytest.mark.parametrize("p,W", [(33, 300), (48, 1024), (64, 1100),
                                 (96, 2100), (128, 700)])
def test_ratio_wide_emulation_matches_plain(p, W):
    """The phases' arithmetic (``_emulate``) within the card's tolerance of
    ``ratio_rowsums_plain`` on genes of assorted lengths (every column
    masked past a gene's length, one gene of a few columns), and int16
    input the same bits as its float32 cast."""
    rng = np.random.default_rng(p * 7 + W)
    G = 4
    lens = np.array([W, W // 2 + 3, 5, max(1, W - 70)])
    F16 = np.zeros((G, p, W), np.int16)
    for g, L in enumerate(lens):
        prof = np.exp(-np.linspace(0, rng.uniform(0.5, 3), L))
        F16[g, :, :L] = rng.poisson(
            40 * prof[None, :] * rng.uniform(0.5, 2, (p, 1))).astype(np.int16)
    mask = np.arange(W)[None, :] < lens[:, None]
    got = _emulate(F16, mask, 32)
    got_f = _emulate(F16.astype(np.float32), mask, 32)
    for a, b in zip(got, got_f):
        assert np.array_equal(a, b)
    want = cuda_nmf.ratio_rowsums_plain(torch.from_numpy(F16),
                                        torch.from_numpy(mask),
                                        power_iters=32)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_, w_.numpy(), rtol=1e-3, atol=1e-3)
