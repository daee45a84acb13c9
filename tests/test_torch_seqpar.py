"""PyTorch port, column-sharded (sequence-parallel) outlier buckets
(``parallel/seqpar.py``) on meshes of CPU devices: the column layout, which
buckets are column-sharded, fits against the port's one-device fit and the
JAX package's seqpar engine (its 8 CPU devices, ``tests/conftest.py``), the
partitioning edges (a trim bin cut by a shard boundary, high-coverage
columns in one shard, ``-d 3`` at shard offsets that are not multiples of
3), the plain versions of kernels 4c and 2c against the whole-gene ones, the
launch geometry of kernels 4c and 2c (``pick_cols_geometry``: every chunk
up to a gene's last active column dealt to one block), the partials handed
back unsummed for the kernels' next launch (``Columns.gather_``), the
estimates, checkpoints across the two forms and the opt-in modes.

Tolerances: float64 throughout.  The column-sharded fit sums each reduction
over the columns in another order than one device, so it is held at rtol
1e-9 (not bit for bit); the plain versions at 1e-12.
"""
import os
import re
from collections import OrderedDict

import numpy as np
import pytest
import torch

from degnorm_tpu.config import EngineConfig as JEng, NMFConfig as JNmf
from degnorm_tpu.engine import DegNormEngine as JEngine
from degnorm_tpu.parallel.sharded import make_mesh as jax_make_mesh
from degnorm_tpu_torch import EngineConfig, NMFConfig
from degnorm_tpu_torch.core import baseline as tb
from degnorm_tpu_torch.engine import DegNormEngine
from degnorm_tpu_torch.ops import cuda_nmf, cuda_stream
from degnorm_tpu_torch.ops.cuda_trim import run_steps
from degnorm_tpu_torch.parallel import make_mesh
from degnorm_tpu_torch.parallel.seqpar import (CHUNK, ColumnGroup,
                                               column_slots, shard_columns)
from tests.torch_port_util import random_coverage

torch.set_num_threads(2)
NMF_KW = dict(nmf_iter=6, degnorm_iter=2)
F64 = dict(device="cpu", dtype="float64")


def seqpar_dataset():
    """The JAX package's tests/test_seqpar.py inputs: three short genes and
    one of 40,000 bases (a W=65536 bucket), p=4."""
    rng = np.random.default_rng(5)
    cov = OrderedDict()
    for i, L in enumerate((900, 1400, 700)):
        cov[f"g{i}"] = random_coverage(rng, 4, L)
    cov["glong"] = random_coverage(rng, 4, 40_000, degraded=True)
    X = np.round(np.abs(rng.standard_normal((4, 4))) * 200 + 50)
    return cov, X


def small_dataset(seed=3, n=10, p=3):
    """Genes of 300-1900 bases: with bucket widths (1024, 2048) and
    ``seqpar_width=1024`` every bucket is column-sharded on a mesh."""
    rng = np.random.default_rng(seed)
    cov = OrderedDict()
    for i in range(n):
        L = int(rng.integers(300, 1900))
        cov[f"s{i}"] = random_coverage(rng, p, L, scale=3 + 6 * rng.random(),
                                       degraded=(i % 2 == 0))
    X = np.round(np.abs(rng.standard_normal((n, p))) * 300 + 30)
    return cov, X


SMALL = dict(bucket_widths=(1024, 2048), seqpar_width=1024)


def fit(cov, X, mesh=None, nmf_kw=NMF_KW, **eng_kw):
    eng = DegNormEngine(NMFConfig(**nmf_kw), EngineConfig(**F64, **eng_kw),
                        mesh=mesh)
    return eng, eng.run(cov, X.copy())


def assert_fits_close(got, want, rtol=1e-9):
    np.testing.assert_array_equal(got.ran_baseline_selection,
                                  want.ran_baseline_selection)
    np.testing.assert_allclose(got.rho, want.rho, rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(got.x_adj, want.x_adj, rtol=rtol)


@pytest.fixture(scope="module")
def fits():
    """The seqpar inputs on one device and on 2 and 3 CPU shards, with the
    JAX package's XLA warm scheme (``power_warm_plain=0``)."""
    cov, X = seqpar_dataset()
    out = {1: fit(cov, X, power_warm_plain=0)}
    for k in (2, 3):
        out[k] = fit(cov, X, mesh=make_mesh(["cpu"] * k), power_warm_plain=0)
    return out


@pytest.mark.parametrize("W,n", [(65536, 2), (65536, 3), (40064, 8),
                                 (1024, 3), (1280, 2), (384, 5)])
def test_column_slots_cover_every_column_once(W, n):
    slots, width = column_slots(W, n)
    assert width % CHUNK == 0 and width * n >= W
    assert width * n - W < n * CHUNK              # padding under a chunk each
    assert [a for a, _ in slots] == [min(s * width, W) for s in range(n)]
    assert [c for a, b in slots for c in range(a, b)] == list(range(W))


# kernels 4c and 2c: a gene's shard over several blocks
# (``cuda_stream.pick_cols_geometry``; the kernels deal the chunks as
# ``cuda_stream.block_columns`` mirrors them) and the partials handed back
# unsummed (``Columns.gather_``) for the next launch to sum

@pytest.mark.parametrize("G,p,W,ncols", [
    (1, 8, 55040, 55040), (1, 8, 55040, 31000), (1, 8, 110080, 110000),
    (1, 32, 59584, 59000), (3, 8, 59584, 700), (64, 8, 59584, 59500),
    (384, 8, 32768, 32700), (5, 3, 2048, 2048), (2, 16, 256, 1)])
def test_cols_geometry_deals_every_chunk_up_to_the_last_once(G, p, W, ncols):
    nb, threads = cuda_stream.pick_cols_geometry(G, p, W, 132)
    assert 1 <= nb <= -(-W // CHUNK)
    assert threads % 32 == 0 and 32 <= threads <= cuda_nmf.max_loop_threads(p)
    dealt = [c for r in range(nb)
             for c in cuda_stream.block_columns(ncols, W, nb, r)]
    assert sorted(dealt) == list(range(min(-(-ncols // CHUNK) * CHUNK, W)))
    assert len(dealt) == len(set(dealt))


def test_cols_geometry_one_block_where_genes_fill_the_card():
    # the long tail's W=65536 bucket cut in two: 384 slots
    assert cuda_stream.pick_cols_geometry(384, 8, 32768, 132)[0] == 1
    assert cuda_stream.pick_cols_geometry(132, 16, 32768, 132)[0] == 1


@pytest.mark.parametrize("W", [110080, 55040])
def test_cols_geometry_spreads_one_outlier_gene_over_the_sms(W):
    # one 110,000-base gene, whole or one of two column shards
    nb, _ = cuda_stream.pick_cols_geometry(1, 8, W, 132)
    assert nb >= 132
    assert cuda_stream.pick_cols_geometry(3, 8, W, 132)[0] * 3 >= 132


CSRC = os.path.join(os.path.dirname(cuda_stream.__file__), os.pardir, "csrc")


def _c_to_py(expr):
    """A C integer expression of ``+ - * /``, comparisons, calls and
    ``?:`` as Python (``/`` on non-negative ints is ``//``)."""
    def conv(s):
        depth = 0
        for i, ch in enumerate(s):
            depth += (ch == "(") - (ch == ")")
            if ch == "?" and depth == 0:       # ?: binds loosest
                nest = d = 0
                for j in range(i + 1, len(s)):
                    d += (s[j] == "(") - (s[j] == ")")
                    if d == 0 and s[j] == "?":
                        nest += 1
                    elif d == 0 and s[j] == ":":
                        if nest == 0:
                            break
                        nest -= 1
                return (f"(({conv(s[i + 1:j])}) if ({conv(s[:i])}) "
                        f"else ({conv(s[j + 1:])}))")
        out, depth, start = [], 0, 0
        for i, ch in enumerate(s):
            if ch == "(":
                if depth == 0:
                    out.append(s[start:i + 1])
                    start = i + 1
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    out.append(conv(s[start:i]))
                    start = i
        out.append(s[start:])
        return "".join(out)
    return conv(" ".join(expr.replace("/", "//").split()))


def _wcr_rules():
    """csrc/stream_cols_wide.cuh's layout rules as the compiler reads them:
    its ``constexpr int wcr_*`` functions evaluated in Python over the
    sources' ``#define DN_*`` integers."""
    ns = {}
    for name in os.listdir(CSRC):
        with open(os.path.join(CSRC, name)) as f:
            for k, v in re.findall(r"^#define (DN_\w+) (\d+)\b", f.read(),
                                   re.M):
                ns[k] = int(v)
    with open(os.path.join(CSRC, "stream_cols_wide.cuh")) as f:
        src = f.read()
    for fn, params, body in re.findall(
            r"constexpr int (wcr_\w+)\(([^)]*)\)\s*\{\s*return\s+(.*?);\s*\}",
            src, re.S):
        args = ", ".join(a.split()[-1] for a in params.split(","))
        ns[fn] = eval(f"lambda {args}: {_c_to_py(body)}", ns)
    return ns


def test_c_to_py_reads_the_conditional_operator():
    # the translation _wcr_rules relies on, on the forms the header uses
    assert eval(_c_to_py("3 <= 4 ? 2 : 1")) == 2
    assert eval(_c_to_py("(1 == 2 ? 10 : 7 / 2) - 1")) == 2
    assert [eval(_c_to_py(f"{x} <= 1 ? 8 : {x} <= 2 ? 6 : 4"))
            for x in (1, 2, 3)] == [8, 6, 4]


@pytest.mark.parametrize("G,W", [(64, 32768), (1, 55040), (3, 59584),
                                 (64, 32765), (7, 1003)])
@pytest.mark.parametrize("p", [48, 64, 96, 128])
def test_cols_wide_plan_fits_the_sm_and_deals_every_chunk_once(p, G, W):
    # the wide instances' plan: the geometry the wrapper picks
    # (pick_cols_geometry, one producer and eight consumer warps, within
    # the launch's geometry check wcols_geometry_ok) and the header's own
    # layout rules (a ring of at least four half-tile stages within an
    # SM's shared memory, the static_assert of its launches), every chunk
    # dealt once, no block's chain past COLS_WIDE_BLOCK_COLS, the launches
    # and gathers of a call
    r = _wcr_rules()
    pm = cuda_nmf.pmax_of(p)
    nb, threads = cuda_stream.pick_cols_geometry(G, p, W)
    assert threads == cuda_stream.COLS_WIDE_THREADS == r["DN_WCR_THREADS"]
    chunks = -(-W // CHUNK)
    assert -(-chunks // nb) * CHUNK <= r["DN_WCR_MAX_TILES"] * r["DN_WIDE_TC"]
    for itemsize in (2, 4):
        ns = r["wcr_stages"](pm, itemsize)
        dyn = r["wcr_dyn_bytes"](pm, itemsize, ns)
        assert ns in (4, 6, 8)
        assert dyn <= r["wcr_budget"](pm) <= r["DN_SMEM_BLOCK"] - 1024
        assert r["wcr_blocks"](pm) == (2 if p <= 64 else 1)
        assert (r["wcr_blocks"](pm) * (dyn + 2048)
                <= r["DN_WCR_SMEM_SM"] == 233472)
    shares = [cuda_stream.block_columns(W, W, nb, k) for k in range(nb)]
    assert max(len(s) for s in shares) <= cuda_stream.COLS_WIDE_BLOCK_COLS
    dealt = [c for s in shares for c in s]
    assert sorted(dealt) == list(range(W))
    assert cuda_stream.cols_calls(p, 50) == (2 * 50 + 3, 51)
    assert cuda_stream.ratio_cols_calls(p) == (3, 1)
    assert cuda_stream.cols_calls(8, 50) == (52, 51)
    assert cuda_stream.ratio_cols_calls(8) == (2, 1)


def test_cols_wide_plan_mirrors_the_sources():
    # the package's constants of the wide instances against the header's
    # defines, and every wcr_* rule read (a new one is evaluated too)
    r = _wcr_rules()
    assert r["DN_WCR_THREADS"] == cuda_stream.COLS_WIDE_THREADS
    assert r["DN_WCR_CONSUMERS"] == cuda_stream.COLS_WIDE_THREADS - 32
    assert (r["DN_WCR_MAX_TILES"] * r["DN_WIDE_TC"]
            == cuda_stream.COLS_WIDE_BLOCK_COLS)
    assert r["DN_WIDE_TC"] == cuda_nmf.WIDE_TC
    assert r["DN_SMEM_BLOCK"] == cuda_nmf.SMEM_BLOCK_BYTES
    assert r["DN_STREAM_CHUNK"] == CHUNK
    assert {"wcr_blocks", "wcr_stage_bytes", "wcr_ld", "wcr_fixed_bytes",
            "wcr_dyn_bytes", "wcr_budget", "wcr_stages"} <= set(r)


def _gather_and_sum(cols, parts):
    """Each shard writes its partial into its slot of the group's buffer
    and asks for every shard's (``gather_``), then for their sum
    (``sum_``)."""
    def step(c, t):
        buf = c.partials(t.shape, t.device)[1]
        buf[c.shard] = t
        got = yield from c.gather_(buf)
        red = yield from c.sum_(t)
        return got, red
    return run_steps(step(c, t) for c, t in zip(cols, parts))


@pytest.mark.parametrize("S", [2, 3, 4])
def test_gather_hands_back_the_partials_in_shard_order(S):
    """On S CPU shards: every shard gets the S partials unsummed, in global
    shard order, as the group's one buffer (no copy where the shards share
    a device), and their left-to-right float32 sum is the bits ``sum_``
    answers."""
    rng = np.random.default_rng(S)
    parts = [torch.from_numpy((rng.standard_normal((7, 10)) * 10 ** rng
                               .uniform(-3, 3, (7, 10))).astype(np.float32))
             for _ in range(S)]
    group = ColumnGroup(make_mesh(["cpu"] * S), S * CHUNK, genes=7)
    out = _gather_and_sum(group.columns(), parts)
    assert (group.reductions, group.gathers) == (1, 1)
    for got, red in out:
        assert got.dtype == torch.float32
        assert torch.equal(got, torch.stack(parts))
        assert got.data_ptr() == out[0][0].data_ptr()
        acc = got[0].clone()
        for t in got[1:]:
            acc = acc + t
        assert torch.equal(acc, red)


def test_gather_copies_the_rows_between_buffers():
    """Shards whose buffers differ (shards on several devices) each get the
    other shards' rows copied into theirs: the answer of ``combine`` to a
    gather ask, read from each shard's own buffer."""
    from degnorm_tpu_torch.parallel.seqpar import Reduction
    S = 3
    group = ColumnGroup(make_mesh(["cpu"] * S), S * CHUNK, genes=7)
    rng = np.random.default_rng(9)
    parts = torch.from_numpy(rng.standard_normal((S, 4, 6)).astype(np.float32))
    bufs = [torch.full((S, 4, 6), np.nan, dtype=torch.float32)
            for _ in range(S)]
    for s, b in enumerate(bufs):
        b[s] = parts[s]
    got = group.combine([Reduction(group, "gather", b) for b in bufs])
    for b, g in zip(bufs, got):
        assert g is b and torch.equal(g, parts)


def test_gather_on_one_device_is_the_buffer_itself():
    from degnorm_tpu_torch.parallel.seqpar import ONE_DEVICE
    buf = ONE_DEVICE.partials((3, 4), torch.device("cpu"))
    assert tuple(buf.shape) == (2, 1, 3, 4) and ONE_DEVICE.count == 1

    def step():
        return (yield from ONE_DEVICE.gather_(buf[0]))
    (got,) = run_steps([step()])
    assert got.data_ptr() == buf[0].data_ptr()


def test_columns_read_the_genes_of_their_group():
    """The launch geometry of kernels 4c and 2c reads the bucket's genes
    from the column group alone: every shard's ``Columns`` gives the
    group's, and a bucket on one device has none to give."""
    from degnorm_tpu_torch.parallel.seqpar import ONE_DEVICE
    group = ColumnGroup(make_mesh(["cpu"] * 2), 2 * CHUNK, genes=1)
    assert [c.genes for c in group.columns()] == [1, 1]
    with pytest.raises(ValueError):
        ONE_DEVICE.genes


def test_only_wide_buckets_are_column_sharded():
    """On two shards exactly the bucket with W >= seqpar_width is cut along
    its columns, into shards of equal padded width; on a mesh of one, and
    with seqpar_width above W, none is."""
    cov, _ = seqpar_dataset()
    mats = list(cov.values())

    def shards(mesh, **kw):
        eng = DegNormEngine(NMFConfig(**NMF_KW), EngineConfig(**F64, **kw),
                            mesh=mesh)
        eng._n_genes = len(mats)
        eng._pack(mats)
        return eng, [(eng._buckets[sh.bucket].width, sh.cols.sharded,
                      sh.cols.offset, tuple(F.shape))
                     for sh, F in zip(eng._shards, eng._device_F)]

    eng, got = shards(make_mesh(["cpu"] * 2))
    assert [b.width for b in eng._buckets] == [1024, 2048, 65536]
    wide = [g for g in got if g[1]]
    assert [(w, off, shape[2]) for w, _, off, shape in wide] == [
        (65536, 0, 32768), (65536, 32768, 32768)]
    assert all(w < 32768 for w, sharded, _, _ in got if not sharded)
    assert [g is None for g in eng._col_groups] == [True, True, False]
    for mesh, kw in ((make_mesh(["cpu"]), {}),
                     (make_mesh(["cpu"] * 2), dict(seqpar_width=65537))):
        _, got = shards(mesh, **kw)
        assert not any(sharded for _, sharded, _, _ in got)


@pytest.mark.parametrize("k", [2, 3])
def test_column_sharded_fit_matches_one_device(fits, k):
    eng, got = fits[k]
    assert sum(sh.cols.sharded for sh in eng._shards) == k
    assert eng.reductions > 0 and eng.timings["reduce"] >= 0
    assert_fits_close(got, fits[1][1])


def test_estimates_match_one_device(fits):
    for a, b in zip(fits[2][1].estimates(), fits[1][1].estimates()):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)


def test_matches_the_jax_seqpar_engine(fits):
    """The JAX engine on its 8 CPU devices (the W=65536 bucket column-
    sharded onto its XLA path) against the port on two CPU shards with the
    XLA path's warm scheme (the ``fits`` fixture)."""
    cov, X = seqpar_dataset()
    cfg = JEng(seqpar_width=32768, dtype="float64", use_pallas=False,
               device_loop=False)
    jeng = JEngine(JNmf(**NMF_KW), cfg, mesh=jax_make_mesh())
    rj = jeng.run(cov, X.copy())
    assert [b.width >= 32768 for b in jeng._buckets] == [False, False, True]
    assert_fits_close(fits[2][1], rj)


# ---------------------------------------------------------------------------
# partitioning edges, at the bucket step
# ---------------------------------------------------------------------------

def colsharded_step(F, mask, n_shards, nmf_cfg, eng_cfg, ds_start=None):
    """``baseline_select_steps`` over ``n_shards`` CPU column shards of a
    (G, p, W) numpy bucket; returns the first shard's result with its E
    joined along the columns, and every shard's result."""
    mesh = make_mesh(["cpu"] * n_shards)
    group = ColumnGroup(mesh, F.shape[2], genes=F.shape[0])
    ds = None if ds_start is None else torch.from_numpy(ds_start)
    res = run_steps(
        tb.baseline_select_steps(Fs, ms, nmf_cfg, eng_cfg, ds_start=ds,
                                 cols=c)
        for (Fs, ms), c in zip(shard_columns(F, mask, mesh), group.columns()))
    for r in res[1:]:       # per-gene rows: the same bits on every shard
        for f in ("rho", "ran_bs", "est_K", "est_kind", "rounds_active"):
            assert torch.equal(getattr(r, f), getattr(res[0], f)), f
    return res[0]._replace(est_E=group.cat_columns([r.est_E for r in res]))


def assert_steps_close(got, want):
    for f in ("ran_bs", "est_kind", "bailed", "n_hi", "rounds_active"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("rho", "est_K", "est_E"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(want, f).numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=f)


def edge_bucket(seed, G, p, W, hi_cols=None):
    rng = np.random.default_rng(seed)
    F = np.zeros((G, p, W))
    mask = np.zeros((G, W), bool)
    for g in range(G):
        L = int(rng.integers(W // 2, W + 1))
        F[g, :, :L] = random_coverage(rng, p, L, degraded=(g % 2 == 0))
        mask[g, :L] = True
        if hi_cols is not None:      # low coverage past hi_cols
            F[g, :, hi_cols:] *= 0.01
    return F, mask


STEP_NMF = NMFConfig(nmf_iter=8, degnorm_iter=1)
STEP_ENG = EngineConfig(**F64)


def test_trim_bin_straddles_a_shard_boundary():
    """A trim bin whose high-coverage columns lie on both sides of a shard
    boundary: the ranks continue across shards (an exclusive scan), so the
    bins, drops and results are one device's."""
    F, mask = edge_bucket(11, 6, 3, 1024)
    Ft, mt = torch.from_numpy(F), torch.from_numpy(mask)
    ti = tb.trim_inputs(Ft, mt, STEP_NMF, STEP_ENG)
    width = column_slots(1024, 3)[1]
    straddle = []
    for g in range(6):
        ids = ti.bin_id[g].numpy()
        for s in (1, 2):
            left = ids[:s * width][ti.hi[g, :s * width].numpy()]
            right = ids[s * width:][ti.hi[g, s * width:].numpy()]
            if len(left) and len(right) and left[-1] == right[0]:
                straddle.append((g, s))
    assert straddle
    assert ti.active0.any()
    assert_steps_close(colsharded_step(F, mask, 3, STEP_NMF, STEP_ENG),
                       tb.baseline_select_bucket(Ft, mt, STEP_NMF, STEP_ENG))


def test_high_coverage_columns_all_in_one_shard():
    """Every gene's high-coverage columns lie in the first of three shards:
    the other shards' partials are zeros and their ranks start after the
    first shard's count."""
    F, mask = edge_bucket(12, 6, 3, 1152, hi_cols=300)
    Ft, mt = torch.from_numpy(F), torch.from_numpy(mask)
    ti = tb.trim_inputs(Ft, mt, STEP_NMF, STEP_ENG)
    width = column_slots(1152, 3)[1]
    assert not ti.hi[:, width:].any() and ti.hi[:, :width].any(dim=1).all()
    assert_steps_close(colsharded_step(F, mask, 3, STEP_NMF, STEP_ENG),
                       tb.baseline_select_bucket(Ft, mt, STEP_NMF, STEP_ENG))


def test_downsample_rate_3_at_offsets_off_the_rate():
    """``-d 3`` on two shards of 640 columns: the second shard starts at
    column 640 (640 % 3 = 1), and the downsample mask follows the global
    column number."""
    F, mask = edge_bucket(13, 6, 3, 1280)
    nmf_cfg = NMFConfig(nmf_iter=8, degnorm_iter=1, downsample_rate=3)
    ds = np.random.default_rng(1).integers(0, 3, 6).astype(np.int32)
    assert column_slots(1280, 2)[1] % 3 != 0
    want = tb.baseline_select_bucket(torch.from_numpy(F),
                                     torch.from_numpy(mask), nmf_cfg,
                                     STEP_ENG, ds_start=torch.from_numpy(ds))
    got = colsharded_step(F, mask, 2, nmf_cfg, STEP_ENG, ds_start=ds)
    assert_steps_close(got, want)


# ---------------------------------------------------------------------------
# the plain versions of kernels 4c and 2c
# ---------------------------------------------------------------------------

def shards_of(F, mask, k):
    mesh = make_mesh(["cpu"] * k)
    group = ColumnGroup(mesh, F.shape[2], genes=F.shape[0])
    return shard_columns(F, mask, mesh), group


@pytest.mark.parametrize("case", ["warm_squared", "warm_plain", "nmf_tol",
                                  "eigh"])
def test_colsharded_nmf_plain_matches_whole_gene(case):
    """Kernel 4c's plain version on 3 shards (raw int16 + scale, a
    ``gene_active`` mask, a warm start) against the whole-gene plain
    version of kernel 4 (``nmf_tol``: kernel 1's adaptive plain loop;
    ``eigh``: the eigendecomposition), float64 1e-12; the kernel wrapper on
    CPU tensors takes the plain version, bit for bit."""
    rng = np.random.default_rng(7)
    G, p, W = 5, 4, 1000
    F = rng.integers(0, 400, (G, p, W)).astype(np.int16)
    mask = rng.random((G, W)) > 0.3
    act = torch.tensor([True, False, True, True, True])
    u0 = torch.from_numpy(np.abs(rng.standard_normal((G, p))) + 0.1)
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, p))
    kw = dict(nmf_iter=7, power_iters_cold=40, power_iters_warm=8,
              power_warm_plain=1 if case == "warm_plain" else 0,
              gene_active=act, u0=u0)
    extra = dict(nmf_tol=1e-3) if case == "nmf_tol" else (
        dict(method="eigh") if case == "eigh" else {})
    A0 = torch.from_numpy(F).double() / scale[None, :, None]
    mt = torch.from_numpy(mask)
    want = cuda_nmf.nmf_masked_plain(A0, mt, **kw, **extra)
    parts, group = shards_of(F, mask, 3)
    for fn in (cuda_stream.nmf_masked_colsharded_plain,
               cuda_stream.nmf_masked_colsharded_cuda):
        got = run_steps(fn(Fs, ms, c, scale=scale, **kw, **extra)
                        for (Fs, ms), c in zip(parts, group.columns()))
        for r in got[1:]:
            assert torch.equal(r[0], got[0][0]) and torch.equal(r[2], got[0][2])
        E = group.cat_columns([r[1] for r in got])
        for a, b in zip((got[0][0], E, got[0][2]), want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-12)


@pytest.mark.parametrize("method", ["power", "eigh"])
def test_colsharded_ratio_plain_matches_whole_gene(method):
    """Kernel 2c's plain version on 2 shards of the raw int16 coverage
    against kernel 2's plain version, float64 1e-12 (the wrapper on CPU
    tensors: the plain version, bit for bit)."""
    rng = np.random.default_rng(8)
    G, p, W = 4, 5, 700
    F = rng.integers(0, 300, (G, p, W)).astype(np.int16)
    mask = rng.random((G, W)) > 0.2
    want = cuda_nmf.ratio_rowsums_plain(torch.from_numpy(F).double(),
                                        torch.from_numpy(mask),
                                        power_iters=40, method=method)
    parts, group = shards_of(F, mask, 2)
    for fn in (cuda_nmf.ratio_rowsums_colsharded_plain,
               cuda_nmf.ratio_rowsums_colsharded_cuda):
        got = run_steps(fn(Fs.double(), ms, c, power_iters=40, method=method)
                        for (Fs, ms), c in zip(parts, group.columns()))
        assert all(torch.equal(a, b) for a, b in zip(got[0], got[1]))
        for a, b in zip(got[0], want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)


@pytest.mark.parametrize("p,case", [(48, "warm_squared"), (48, "nmf_tol"),
                                    (128, "warm_squared")])
def test_wide_colsharded_nmf_plain_matches_whole_gene(p, case):
    """Kernel 4c's plain version at the wide instances' p (48 and 128; the
    kernel runs csrc/stream_cols_wide.cuh there) on 2 shards of raw int16 +
    scale, a ``gene_active`` mask and a warm start, against the whole-gene
    plain version (``nmf_tol``: kernel 1's adaptive plain loop), float64
    1e-12; the wrapper on CPU tensors takes the plain version, bit for
    bit."""
    rng = np.random.default_rng(p)
    G, W = 3, 600
    F = rng.integers(0, 400, (G, p, W)).astype(np.int16)
    mask = rng.random((G, W)) > 0.3
    act = torch.tensor([True, False, True])
    u0 = torch.from_numpy(np.abs(rng.standard_normal((G, p))) + 0.1)
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, p))
    kw = dict(nmf_iter=5, power_iters_cold=40, power_iters_warm=8,
              gene_active=act, u0=u0)
    extra = dict(nmf_tol=1e-3) if case == "nmf_tol" else {}
    A0 = torch.from_numpy(F).double() / scale[None, :, None]
    want = cuda_nmf.nmf_masked_plain(A0, torch.from_numpy(mask), **kw,
                                     **extra)
    nb, threads = cuda_stream.pick_cols_geometry(G, p, W // 2, 132)
    assert threads == cuda_stream.COLS_WIDE_THREADS
    assert cuda_stream.block_share(W // 2, nb) <= \
        cuda_stream.COLS_WIDE_BLOCK_COLS
    parts, group = shards_of(F, mask, 2)
    for fn in (cuda_stream.nmf_masked_colsharded_plain,
               cuda_stream.nmf_masked_colsharded_cuda):
        got = run_steps(fn(Fs, ms, c, scale=scale, **kw, **extra)
                        for (Fs, ms), c in zip(parts, group.columns()))
        assert torch.equal(got[1][0], got[0][0])
        E = group.cat_columns([r[1] for r in got])
        for a, b in zip((got[0][0], E, got[0][2]), want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-12)


@pytest.mark.parametrize("p", [48, 128])
def test_wide_colsharded_ratio_plain_matches_whole_gene(p):
    """Kernel 2c's plain version at the wide instances' p on 2 shards of
    the raw int16 coverage against kernel 2's plain version, float64 1e-12
    (the wrapper on CPU tensors: the plain version, bit for bit)."""
    rng = np.random.default_rng(100 + p)
    G, W = 3, 500
    F = rng.integers(0, 300, (G, p, W)).astype(np.int16)
    mask = rng.random((G, W)) > 0.2
    want = cuda_nmf.ratio_rowsums_plain(torch.from_numpy(F).double(),
                                        torch.from_numpy(mask),
                                        power_iters=40)
    parts, group = shards_of(F, mask, 2)
    for fn in (cuda_nmf.ratio_rowsums_colsharded_plain,
               cuda_nmf.ratio_rowsums_colsharded_cuda):
        got = run_steps(fn(Fs.double(), ms, c, power_iters=40)
                        for (Fs, ms), c in zip(parts, group.columns()))
        assert all(torch.equal(a, b) for a, b in zip(got[0], got[1]))
        for a, b in zip(got[0], want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)


@pytest.mark.parametrize("p", [40, 64, 128])
def test_wide_column_sharded_fit_matches_one_device_and_jax(p):
    """More than 32 samples, every bucket column-sharded on two CPU shards
    (kernels 4c and 2c's wide instances on the card; nothing declined): the
    fit against the port's one-device fit (rtol 1e-9, float64) and against
    the JAX seqpar engine on its 8 CPU devices with the XLA path's warm
    scheme, at this file's tolerances."""
    cov, X = small_dataset(seed=6, n=6, p=p)
    eng, got = fit(cov, X, mesh=make_mesh(["cpu"] * 2), power_warm_plain=0,
                   **SMALL)
    assert eng.colshard_declined == 0
    assert all(sh.cols.sharded for sh in eng._shards)
    _, one = fit(cov, X, power_warm_plain=0, **SMALL)
    assert_fits_close(got, one)
    rj = JEngine(JNmf(**NMF_KW),
                 JEng(dtype="float64", use_pallas=False, device_loop=False,
                      **SMALL), mesh=jax_make_mesh()).run(cov, X.copy())
    assert_fits_close(got, rj)


# ---------------------------------------------------------------------------
# checkpoints across the two forms, and the opt-in modes against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", ["columns_then_one", "one_then_columns"])
def test_checkpoint_resumes_across_forms(tmp_path, order):
    """A fit of 2 iterations writes its checkpoint in one form (column-
    sharded on two CPU shards, or one device); a fit of 3 in the other form
    resumes it and ends where that form's uninterrupted fit ends."""
    cov, X = small_dataset()
    col = make_mesh(["cpu"] * 2)
    first, second = (col, None) if order == "columns_then_one" else (None, col)
    e1 = DegNormEngine(NMFConfig(nmf_iter=6, degnorm_iter=2),
                       EngineConfig(**F64, **SMALL), mesh=first)
    ckpt = str(tmp_path)
    e1.run(cov, X.copy(), checkpoint_dir=ckpt)
    nmf3 = NMFConfig(nmf_iter=6, degnorm_iter=3)
    resumed = DegNormEngine(nmf3, EngineConfig(**F64, **SMALL), mesh=second)
    got = resumed.run(cov, X.copy(), checkpoint_dir=ckpt)
    assert list(resumed.timings).count("iter_2") == 1
    assert "iter_0" not in resumed.timings
    assert any(sh.cols.sharded for sh in (e1 if first else resumed)._shards)
    # the uninterrupted run of the resuming form, from the same state
    _, ref = fit(cov, X, mesh=second, nmf_kw=dict(nmf_iter=6, degnorm_iter=3),
                 **SMALL)
    assert_fits_close(got, ref, rtol=1e-8)


@pytest.mark.parametrize("mode", [dict(nmf_tol=1e-4), dict(rank1_method="eigh"),
                                  dict(trim_fast=True), "d3"])
def test_opt_in_modes_match_the_jax_seqpar_engine(mode):
    """Every bucket column-sharded (``seqpar_width`` at the smallest width),
    as on the JAX package's XLA path: nmf_tol applies at any width, eigh
    takes u from the summed Gram, trim_fast is ignored (the fused loop is
    never taken), keyed ``-d 3`` offsets at shard offsets off the rate."""
    cov, X = small_dataset(seed=4)
    nmf_kw = dict(nmf_iter=8, degnorm_iter=2)
    eng_kw = {}
    if mode == "d3":
        nmf_kw["downsample_rate"] = 3
    else:
        eng_kw = mode
    rj = JEngine(JNmf(**nmf_kw),
                 JEng(dtype="float64", use_pallas=False, device_loop=False,
                      **SMALL, **eng_kw),
                 mesh=jax_make_mesh()).run(cov, X.copy())
    eng, rt = fit(cov, X, mesh=make_mesh(["cpu"] * 2), nmf_kw=nmf_kw,
                  power_warm_plain=0, **SMALL, **eng_kw)
    assert all(sh.cols.sharded for sh in eng._shards)
    assert_fits_close(rt, rj)
