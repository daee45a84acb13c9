"""Kernel 3 past 640 samples on the phased layout (csrc/trim_panel.cu's
``dn_trim_phase``): the route the launcher takes there, its light path
for a bucket no gene enters, its workspace against the Python mirror, and
the plain trim loop at p = 704, W = 64 with ``min_gene_len`` and
``min_bins`` lowered so that rounds run, against the JAX package's trim
loop (its XLA twin, ``degnorm_tpu/core/baseline.py``'s lax.while_loop).

The kernel runs only on the card (``chip_smoke.py`` phase ``panels``).
Tolerance against the JAX package: PARITY.md's gate (DI and K rtol/atol
5e-3), ran_bs and rounds exact, as the other p = 704 tests hold it."""
import dataclasses
import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from degnorm_tpu.config import EngineConfig as JEng, NMFConfig as JNmf
from degnorm_tpu.core import baseline as jb
from degnorm_tpu_torch import EngineConfig, NMFConfig
from degnorm_tpu_torch.core import baseline as tb
from degnorm_tpu_torch.ops import cuda_nmf, cuda_trim
from tests.torch_port_util import random_coverage

torch.set_num_threads(2)
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "degnorm_tpu_torch", "csrc")
P, W, G = 704, 64, 8
LOW_GENE_LEN, LOW_BINS = 8, 2     # so that genes of 40-64 columns enter


def _src(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _body(src, name):
    """The body of the C function ``name`` (to its closing brace at the
    start of a line)."""
    i = src.index(f"{name}(const TrimArgs& a, int mode) {{")
    return src[i:src.index("\n}\n", i)]


@dataclasses.dataclass(frozen=True)
class _LowT(NMFConfig):
    """The port's config with the trim loop's floors lowered."""
    @property
    def min_gene_len(self):
        return LOW_GENE_LEN

    @property
    def min_bins(self):
        return LOW_BINS


@dataclasses.dataclass(frozen=True)
class _LowJ(JNmf):
    """The JAX package's config with the same floors."""
    @property
    def min_gene_len(self):
        return LOW_GENE_LEN

    @property
    def min_bins(self):
        return LOW_BINS


def _bucket(seed):
    """G seeded genes of 40-64 columns at p = P, a resident W = 64 bucket."""
    rng = np.random.default_rng(seed)
    F = np.zeros((G, P, W), np.float32)
    mask = np.zeros((G, W), bool)
    for g in range(G):
        L = int(rng.integers(40, W + 1))
        F[g, :, :L] = random_coverage(rng, P, L, scale=3 + 6 * rng.random(),
                                      degraded=(g % 2 == 0))
        mask[g, :L] = True
    return F, mask


def test_launcher_takes_the_phased_route_past_640():
    """Past PCL_MAX_P kernel 3 takes the phased layout (the mirror and the
    launcher): dn_trim_panel hands every p past its cluster layout to
    dn_trim_phase, which runs each round's NMF loop through phase_loop on
    its round's list; the wrapper sizes its workspace for it."""
    for p in (641, 704, 768, 1024, 1153):
        assert cuda_nmf.panel_phase(p, "loop") and not cuda_nmf.panel_cluster(
            p, "loop")
        ws, slots = cuda_nmf.kernel_workspace(
            3, p, torch.device("cpu"), "loop", 64, 20)
        assert slots == 3 and ws.numel() == (
            cuda_nmf.phase_ws_floats(p, 3, 3)
            + cuda_nmf.trim_phase_floats(p, 64, 20, 3))
    assert not cuda_nmf.panel_phase(cuda_nmf.PCL_MAX_P, "loop")
    panel = _body(_src("trim_panel.cu"), "int dn_trim_panel")
    assert panel.index("if (dn_pcl_on(a.p, DN_PCL_LOOP)) {") < panel.index(
        "return dn_trim_phase(a, mode);")
    phase = _body(_src("trim_panel.cu"), "static int dn_trim_phase")
    assert "e = phase_loop(pa, false, t.in_round, nullptr, S, n_cold," in phase
    # the mirror of dn_trim_phase_floats
    c = re.search(r"dn_trim_phase_floats\(int p, int W, int B,\s*int G\) "
                  r"\{\s*return (.*?);", _src("trim_panel.cu"), re.S).group(1)
    c = c.replace("(size_t)", "").replace("DN_TRIM_ST", str(cuda_nmf.TRIM_ST))
    c = c.replace("/ 4", "// 4")
    for p, w, b, g in ((704, 64, 20, 3), (1153, 56, 64, 1000)):
        assert eval(" ".join(c.split()), dict(p=p, W=w, B=b, G=g)) == \
            cuda_nmf.trim_phase_floats(p, w, b, g)
    assert re.search(r"constexpr int DN_TRIM_ST = (\d+);",
                     _src("trim_panel.cu")).group(1) == str(cuda_nmf.TRIM_ST)


def test_a_bucket_no_gene_enters_takes_the_light_path():
    """dn_trim_phase's work before it reads whether any gene enters is one
    launch (the set-up: K0, rho0 and the loop-never-ran results; an
    entering gene writes the call's number into page-locked host memory
    mapped for the card) and one wait, and no gene entering returns there:
    no copy, no round's launches, no NMF loop."""
    phase = _body(_src("trim_panel.cu"), "static int dn_trim_phase")
    light = phase[:phase.index(
        "if (e != 0 || *(volatile int*)h != call) return e;")]
    assert light.count("<<<") == 1 and "trim_ph_init_kernel<<<" in light
    assert light.count("cudaStreamSynchronize(") == 1
    for gone in ("trim_ph_read(", "cudaMemsetAsync(", "cudaMemcpyAsync(",
                 "phase_loop", "for ("):
        assert gone not in light, gone
    # the set-up writes every gene's loop-never-ran results
    init = _src("trim_panel.cu")
    init = init[init.index("trim_ph_init_kernel(TrimArgs a, TrimPh t, "):]
    init = init[:init.index("\n}\n")]
    for line in ("a.K[g * p + i] = a.K0[g * p + i];",
                 "a.rho[g * p + i] = a.rho0[g * p + i];",
                 "a.ran_bs[g] = 0;", "a.rounds_active[g] = 0;",
                 "if (alive) *flag = call;"):
        assert line in init, line


@pytest.mark.parametrize("mode", ["default", "nmf_tol"])
def test_plain_trim_loop_with_rounds_matches_jax_at_p704(monkeypatch, mode):
    """The port's plain trim loop (the CPU side of ``trim_loop_cuda``, the
    resident route at 704 x 64) with its floors lowered, on 8 seeded genes
    of which some run several trim rounds, against the JAX package's trim
    loop (its XLA twin) with the same floors: K and rho at PARITY.md's
    gate, ran_bs and the rounds each gene stayed active exact."""
    F, mask = _bucket(31)
    extra = dict(nmf_tol=1e-4) if mode == "nmf_tol" else {}
    nmf_kw = dict(nmf_iter=4, bins=8)
    calls = []
    orig = cuda_trim.trim_loop_cuda

    def rec(Fm, *a, **k):
        calls.append((tuple(Fm.shape), k["min_gene_len"], k["min_bins"]))
        return orig(Fm, *a, **k)
    monkeypatch.setattr(cuda_trim, "trim_loop_cuda", rec)
    rt = tb.baseline_select_bucket(
        torch.from_numpy(F), torch.from_numpy(mask), _LowT(**nmf_kw),
        EngineConfig(device="cpu", **extra))
    rj = jb.baseline_select_bucket(
        jnp.asarray(F), jnp.asarray(mask), _LowJ(**nmf_kw),
        JEng(use_pallas=False, device_loop=False, **extra))
    assert calls == [((G, P, W), LOW_GENE_LEN, LOW_BINS)]
    rounds = rt.rounds_active.numpy()
    assert rt.ran_bs.numpy().sum() >= 3 and rounds.max() >= 2, rounds
    np.testing.assert_array_equal(rt.ran_bs.numpy(), np.asarray(rj.ran_bs))
    np.testing.assert_array_equal(rounds, np.asarray(rj.rounds_active))
    np.testing.assert_allclose(rt.rho.numpy(), np.asarray(rj.rho),
                               rtol=5e-3, atol=5e-3)
    # K where the estimate is built from it (a bailed gene's estimate is
    # its input, whatever K it carries)
    kind = rt.est_kind.numpy()
    np.testing.assert_array_equal(kind, np.asarray(rj.est_kind))
    built = kind != tb.EST_INPUT
    np.testing.assert_allclose(rt.est_K.numpy()[built],
                               np.asarray(rj.est_K)[built], rtol=5e-3,
                               atol=5e-3)
    print(f"p={P} W={W} rounds {rounds.tolist()}: rho gap",
          float(np.abs(rt.rho.numpy() - np.asarray(rj.rho)).max()))
