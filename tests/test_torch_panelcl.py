"""The cluster layout of the panel instances of kernels 1-4 (p > 128:
csrc/panel.cuh's ``pcl_*`` code, csrc/nmf_panel.cu, csrc/stream_panel.cu,
csrc/trim_panel.cu, csrc/ratio_panel.cu) against its Python mirror in
ops/cuda_nmf.py: the cut by kind of kernel, the cluster by p, the panel
pairs and their order, each block's shared memory at every p from 129 to
1,000, the X scratch's layout, the workspaces and the engine's memory
guard (tests/test_torch_panelbig.py: past 640 samples).
The kernels themselves run only on the card (``chip_smoke.py`` phase
``panels``); their arithmetic is the plain versions', which
tests/test_torch_widep.py holds against the JAX package."""
import os
import re
import types

import numpy as np
import pytest
import torch

from degnorm_tpu_torch import EngineConfig, NMFConfig
from degnorm_tpu_torch import engine as tengine
from degnorm_tpu_torch.ops import cuda_nmf, cuda_trim

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "degnorm_tpu_torch", "csrc")
SMEM_PER_BLOCK = 232448        # the H100's opt-in shared memory a block
MAX_CLUSTER = 8                # the largest portable cluster
STATIC = {"nmf": 0, "stream": 4, "ratio": 0,
          "trim": 12 * cuda_trim.MAX_BINS + 12}
# the kind of each kernel: its cluster layout's cut (``pcl_max_p``)
KIND = {"nmf": "loop", "trim": "loop", "stream": "stream", "ratio": "stream"}
LAUNCH = {"nmf": "nmf_panel.cu", "trim": "trim_panel.cu",
          "stream": "stream_panel.cu", "ratio": "ratio_panel.cu"}


def _panel_src():
    with open(os.path.join(CSRC, "panel.cuh")) as f:
        return f.read()


def _define(src, name):
    return int(re.search(rf"#define {name} \(?(\d+)", src).group(1))


def _body(src, fn):
    """The returned expression of a short C function of panel.cuh (at most
    one ``const int`` before it), as Python."""
    body = re.search(fn + r"\([^)]*\) \{\s*(?:const int \w+ = [^;]*;\s*)?"
                     r"return (.*?);\s*\}", src, re.S).group(1)
    return " ".join(body.split())


def _c_eval(expr, **names):
    """An int expression of C (one top-level ``a ? b : c`` at most)."""
    expr = expr.replace("/", "//")
    m = re.fullmatch(r"(.*?) \? (.*?) : (.*)", expr)
    if m:
        expr = f"({m.group(2)}) if ({m.group(1)}) else ({m.group(3)})"
    return eval(expr, {}, names)


def test_cluster_mirror_matches_the_sources():
    """The constants and formulas of csrc/panel.cuh's cluster layout equal
    the mirror's: its largest p for each kind of kernel (kernels 1 and 3
    take it up to PCL_MAX_P, kernels 2 and 4 up to PCL_MAX_P_STREAM: each
    launch asks its own kind, once), the kernel's vectors, the pairs,
    pairs a block and blocks of a cluster, where the blocks share the
    power step, the workspace, the scratch's column length and the shared
    memory, at every p of the cluster layout."""
    src = _panel_src()
    assert _define(src, "DN_PCL_MAX_P") == cuda_nmf.PCL_MAX_P
    assert _define(src, "DN_PCL_MAX_P_STREAM") == cuda_nmf.PCL_MAX_P_STREAM
    assert _define(src, "DN_PCL_PORTABLE") == cuda_nmf.PCL_PORTABLE
    assert _body(src, "dn_pcl_max_p") == \
        "kind == DN_PCL_STREAM ? DN_PCL_MAX_P_STREAM : DN_PCL_MAX_P"
    assert _body(src, "dn_pcl_on") == \
        "p >= DN_PANEL_MIN_P && p <= dn_pcl_max_p(kind)"
    assert "if (!dn_pcl_on(p, kind)) return (int)cudaErrorInvalidValue;" in src
    for kernel, name in LAUNCH.items():
        with open(os.path.join(CSRC, name)) as f:
            launch = f.read()
        kind = "DN_PCL_" + KIND[kernel].upper()
        assert launch.count(f"if (dn_pcl_on(a.p, {kind})) {{") == 1, name
        assert "a.p <= DN_PCL_MAX_P" not in launch, name
        macro = launch[launch.index("#define DN_"):launch.index("#undef")]
        assert re.match(rf"#define DN_\w+_PCL_ARGS\s*\\\s*{kind},", macro), \
            name
    assert _define(src, "DN_PCL_NX") == cuda_nmf.PCL_NX
    assert _define(src, "DN_PANEL_MIN_P") == cuda_nmf.WIDE_MAX_P + 1
    assert _define(src, "DN_PCL_MAX_C") == cuda_nmf.PCL_MAX_C
    assert _body(src, "dn_pcl_pairs") == "T * (T + 1) / 2"
    assert ("const int c = dn_pcl_T(p) > DN_PCL_MAX_C ? dn_pcl_T(p) : "
            "DN_PCL_MAX_C;") in src
    assert _body(src, "dn_pcl_held") == "(dn_pcl_pairs(p) + c - 1) / c"
    assert _body(src, "dn_pcl_size") == "(dn_pcl_pairs(p) + h - 1) / h"
    assert _body(src, "dn_pcl_shared_power") == "dn_pcl_T(p) > DN_PCL_MAX_C"
    # a cluster past the portable size is asked for as such
    assert ("if (C > DN_PCL_PORTABLE) {\n    e = cudaFuncSetAttribute(kern,\n"
            "                             "
            "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);") in src
    assert ("return (size_t)dn_pcl_pairs(p) *\n"
            "         (2 * DN_PCL_PAIR + 2 * DN_PANEL_ROWS * DN_PANEL_ROWS);") \
        in src
    # a cluster of dn_pcl_size(p) blocks, block `rank` holding the pairs
    # rank, rank + C, ...
    assert "const int C = dn_pcl_size(p);" in src
    assert "attr[0].val.clusterDim.x = (unsigned)C;" in src
    assert "const int e = rank + h * C;" in src
    ldx = _body(src, "dn_pcl_ldx")
    smem = (_body(src, "dn_pcl_smem_floats")
            .replace("DN_PCL_PAIR", "(DN_PANEL_ROWS * DN_PANEL_LD)")
            .replace("DN_PCL_STAGE_A", "(2 * DN_PANEL_ROWS * DN_WIDE_TC)")
            .replace("DN_PANEL_LD", "(DN_PANEL_ROWS + 4)")
            .replace("DN_PANEL_ROWS", str(cuda_nmf.PANEL_ROWS))
            .replace("DN_WIDE_TC", "64")
            .replace("DN_PCL_NX", str(cuda_nmf.PCL_NX)))
    assert cuda_nmf.PCL_MAX_P_STREAM > cuda_nmf.PCL_MAX_P
    for p in range(cuda_nmf.WIDE_MAX_P + 1, cuda_nmf.PCL_MAX_P_STREAM + 1):
        assert _c_eval(ldx, p=p) == cuda_nmf.pcl_ldx(p)
        T = cuda_nmf.pmax_of(p) // cuda_nmf.PANEL_ROWS
        assert cuda_nmf.pcl_T(p) == T
        shared = T > cuda_nmf.PCL_MAX_C
        assert cuda_nmf.pcl_shared_power(p) == shared
        assert 4 * _c_eval(smem.replace("dn_panel_np(p)",
                                        str(cuda_nmf.pmax_of(p)))) == \
            cuda_nmf.pcl_smem_bytes(p)
        n, h, C = (cuda_nmf.pcl_pairs(p), cuda_nmf.pcl_held(p),
                   cuda_nmf.pcl_size(p))
        assert n == T * (T + 1) // 2
        assert h == -(-n // max(T, cuda_nmf.PCL_MAX_C)) and C == -(-n // h)
        assert [cuda_nmf.panel_cluster(p, k) for k in ("loop", "stream")] \
            == [p <= cuda_nmf.PCL_MAX_P, True]
        assert cuda_nmf.pcl_ws_floats(p) == (
            0 if h == 1 else n * (2 * 128 * 132 + 2 * 128 * 128))


@pytest.mark.parametrize("T", range(1, 9))
def test_pairs_are_the_upper_triangle_diagonal_first(T):
    """Pair e of T panels (``dn_pcl_pair``, mirrored by ``pcl_pair``) runs
    over every I <= J once, the diagonal pairs first (block P of a cluster
    holds panel P's diagonal pair, whose v partial it publishes), and the
    source's ``dn_pcl_index`` is its inverse."""
    index = _body(_panel_src(), "dn_pcl_index")
    pairs = [cuda_nmf.pcl_pair(T, e) for e in range(T * (T + 1) // 2)]
    assert sorted(pairs) == [(i, j) for i in range(T) for j in range(i, T)]
    assert pairs[:T] == [(i, i) for i in range(T)]
    assert pairs[T:] == sorted(pairs[T:])
    for e, (i, j) in enumerate(pairs):
        assert _c_eval(index, T=T, I=i, J=j) == e


def test_every_p_to_1000_fits_a_block_and_a_cluster():
    """At every p from 129 to 1,000, for kernels 4 and 2 (streamed genes,
    kind "stream") and for kernels 1 and 3 (resident ones, "loop"): on the
    kind's cluster layout (p <= ``pcl_max_p``) the T(T+1)/2 pairs over a
    portable cluster of at least T blocks (the diagonal pairs are its
    first T blocks' first pairs), each block's shared memory (the core's,
    the kernel's static state and, for kernel 3, the W residual scores of
    its widest bucket) within the card's limit, a workspace only where a
    block holds several pairs (one slot a cluster the card holds), and an
    X scratch column by column; above it the phased layout, within the
    limit too, with its workspace (kernel 3: and its trim state)."""
    from tests.test_torch_widep import wide_smem_bytes
    dev = torch.device("cpu")
    for p in range(cuda_nmf.WIDE_MAX_P + 1, 1001):
        W_trim = min(cuda_nmf.MAX_W, cuda_nmf.MAX_PW // p)
        for kernel, W in (("nmf", W_trim), ("stream", 16384),
                          ("trim", W_trim), ("ratio", 16384)):
            kind = KIND[kernel]
            cluster = cuda_nmf.panel_cluster(p, kind)
            assert cluster == (p <= cuda_nmf.pcl_max_p(kind))
            smem = wide_smem_bytes(kernel, p, W)
            assert smem <= SMEM_PER_BLOCK, (p, kernel, smem)
            ws, slots = cuda_nmf.kernel_workspace(24576, p, dev, kind, W, 8)
            if cluster:
                T = cuda_nmf.pmax_of(p) // cuda_nmf.PANEL_ROWS
                C, h = cuda_nmf.pcl_size(p), cuda_nmf.pcl_held(p)
                assert T <= C <= MAX_CLUSTER
                assert (C - 1) * h < T * (T + 1) // 2 <= C * h
                assert smem == (cuda_nmf.pcl_smem_bytes(p) + STATIC[kernel]
                                + (4 * W if kernel == "trim" else 0))
                if h == 1:
                    assert (ws, slots) == (None, 0)
                else:
                    assert slots == cuda_nmf.SMS // C
                    assert ws.numel() == slots * cuda_nmf.pcl_ws_floats(p)
                assert cuda_nmf.scratch_shape(3, p, 40, kind) == \
                    (3, 40, -(-p // 4) * 4)
            else:
                assert cuda_nmf.panel_phase(p, kind)
                assert slots == cuda_nmf.SMS and ws.numel() == (
                    cuda_nmf.phase_ws_floats(p, slots, 24576)
                    + (cuda_nmf.trim_phase_floats(p, W, 8, 24576)
                       if kind == "loop" else 0))
                assert cuda_nmf.scratch_shape(3, p, 40, kind) == (3, p, 40)
    for kind in cuda_nmf.PCL_KINDS:
        assert not cuda_nmf.panel_cluster(cuda_nmf.WIDE_MAX_P, kind)
        assert cuda_nmf.kernel_workspace(8, 128, dev, kind) == (None, 0)


@pytest.fixture
def a_card(monkeypatch):
    """An H100's SM count and memory where there is no card: enough for
    the workspace rule and the engine's memory guard."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(tengine, "_device_memory", lambda d: 80 << 30)
    return torch.device("cuda", 0)


@pytest.mark.parametrize("p", [129, 256, 512, 640, 641, 768, 1000, 1024])
def test_memory_guard_sets_aside_the_largest_workspace(p, a_card,
                                                       monkeypatch):
    """``panel_workspace_bytes`` is the largest workspace any launch at p
    takes on a card (the phased layout above a kind's cluster layout, kernel
    3's with its trim state at the gate's widest resident bucket, a smaller
    one on a cluster layout where a block holds several pairs, none where a
    block holds one: kernel 3 past 640 samples, kernels 2 and 4 below
    1,152, past 256 samples), and ``DegNormEngine._pack_host``'s memory guard
    caps a bucket at a twelfth of the card's memory less exactly that of
    the kinds its fit launches (``workspace_kinds``)."""
    slots = cuda_nmf.panel_slots(1 << 30, a_card)
    cluster = 4 * (slots // cuda_nmf.pcl_size(p)) * cuda_nmf.pcl_ws_floats(p)
    phased = 4 * cuda_nmf.phase_ws_floats(p, slots, 1 << 16)
    one = phased + 4 * cuda_nmf.trim_phase_floats(
        p, cuda_nmf.MAX_PW // p, cuda_nmf.TRIM_MAX_BINS, 1 << 16)
    per_launch = {kind: cluster if cuda_nmf.panel_cluster(p, kind)
                  else one if kind == "loop" else phased
                  for kind in ("nmf", "loop", "stream")}
    ws = cuda_nmf.panel_workspace_bytes(p, a_card)
    assert ws == max(per_launch.values())
    assert (ws > 0) == (p > 256)
    if p > cuda_nmf.PCL_MAX_P:
        assert ws == one > max(cluster, phased)
    # the fit below packs genes of 300 bases: one bucket of width 512,
    # resident (kernels 1-3) only where p * 512 <= MAX_PW
    kinds = cuda_nmf.workspace_kinds(p, [512])
    assert kinds == (("stream",) if p * 512 > cuda_nmf.MAX_PW
                     else cuda_nmf.WORKSPACE_KINDS)
    ws = cuda_nmf.panel_workspace_bytes(p, a_card, kinds, genes=3)
    assert cuda_nmf.panel_workspace_bytes(p, torch.device("cpu")) == 0
    assert cuda_nmf.panel_workspace_bytes(32, a_card) == 0
    # at 33-128 samples kernel 2's wide instance: its cap, no widths given
    assert cuda_nmf.panel_workspace_bytes(128, a_card) == \
        4 * cuda_nmf.RW_WS_FLOATS

    seen = {}
    pack = tengine.pack_buckets

    def spy(*a, **kw):
        seen["cap"] = kw["max_bucket_bytes"]
        return pack(*a, **kw)

    monkeypatch.setattr(tengine, "pack_buckets", spy)
    eng = tengine.DegNormEngine(NMFConfig(nmf_iter=2),
                                EngineConfig(device="cpu"))
    eng.mesh = types.SimpleNamespace(devices=(a_card,), process_count=1)
    rng = np.random.default_rng(p)
    eng._pack_host([rng.integers(0, 40, (p, 300)).astype(np.float64)
                    for _ in range(3)])
    assert seen["cap"] == max(((80 << 30) - ws) // 12, 512 << 20)
