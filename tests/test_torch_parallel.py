"""PyTorch port, gene-sharded fits in one process (``parallel/``) on CPU
devices: the shard layout, a mesh fit against the port's one-device fit
(bit for bit in float64) and against the JAX package's, the wide bucket the
JAX package would column-shard, the plot-gene split, the string broadcast,
coordinator-only checkpoints, ``--profile-dir``, ``dryrun_multichip`` and the
kernel build's lock across processes.
"""
import os
import subprocess
import sys
from collections import OrderedDict

import numpy as np
import pytest
import torch

from degnorm_tpu.config import EngineConfig as JEng, NMFConfig as JNmf
from degnorm_tpu.engine import DegNormEngine as JEngine
from degnorm_tpu.pipeline.run import _shard_plot_genes as jax_shard_plot
from degnorm_tpu_torch import EngineConfig, NMFConfig
from degnorm_tpu_torch import cli as tcli
from degnorm_tpu_torch.core import degnorm as td
from degnorm_tpu_torch.engine import DegNormEngine
from degnorm_tpu_torch.ops import build as kbuild
from degnorm_tpu_torch.ops import cuda_nmf
from degnorm_tpu_torch.parallel import distributed, make_mesh, shard_slots
from degnorm_tpu_torch.parallel.dryrun import dryrun_multichip
from degnorm_tpu_torch.pipeline import checkpoints
from degnorm_tpu_torch.pipeline.run import _shard_plot_genes
from tests.torch_port_util import (random_coverage, run_command,
                                   write_sim_dataset)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = (512, 1024)


def make_dataset(seed=21, n=23, p=3):
    rng = np.random.default_rng(seed)
    cov = OrderedDict()
    for i in range(n):
        L = int(150 + rng.integers(0, 850))
        cov[f"gene{i}"] = random_coverage(
            rng, p, L, scale=3 + 6 * rng.random(), degraded=(i % 2 == 0))
    X = np.round(np.abs(rng.standard_normal((n, p))) * 300 + 30)
    return cov, X


def port_fit(cov, X, nmf_kw, mesh=None, **eng_kw):
    eng_kw.setdefault("bucket_widths", WIDTHS)
    eng = DegNormEngine(NMFConfig(**nmf_kw),
                        EngineConfig(device="cpu", **eng_kw), mesh=mesh)
    return eng, eng.run(cov, X)


@pytest.mark.parametrize("G", range(1, 51))
def test_shard_slots_cover_every_slot_once(G):
    for n in range(1, 5):
        slots = shard_slots(G, n)
        assert len(slots) == n
        covered = [i for a, b in slots for i in range(a, b)]
        assert covered == list(range(G))
        sizes = [b - a for a, b in slots]
        assert max(sizes) - min(sizes) <= 1


def test_make_mesh_needs_a_card_or_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default mesh is its cards")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    mesh = make_mesh(["cpu", "cpu", "cpu"])
    assert mesh.size == 3 and list(mesh.local_shards) == [0, 1, 2]
    assert mesh.device_of(2) == torch.device("cpu")


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("ds", ["default", "reference_d3"])
def test_mesh_fit_is_bit_equal_to_one_device(k, ds):
    """k CPU shards give the one-device fit's bits in float64: DI, adjusted
    counts, factors, the baseline-selection flags and the estimates; with
    ``-d 3`` under ``ds_compat="reference"`` too (the offsets are drawn in
    gene order and each shard takes its slice)."""
    cov, X = make_dataset()
    nmf_kw = dict(nmf_iter=6, degnorm_iter=3)
    if ds == "reference_d3":
        nmf_kw.update(downsample_rate=3, ds_compat="reference")
    _, one = port_fit(cov, X, nmf_kw, dtype="float64")
    eng, got = port_fit(cov, X, nmf_kw, dtype="float64",
                        mesh=make_mesh(["cpu"] * k))
    assert {sh.device.type for sh in eng._shards} == {"cpu"}
    assert len(eng._shards) == k * len(eng._buckets)
    for f in ("rho", "x_adj", "x_weighted", "scale_factors", "norm_factors",
              "ran_baseline_selection"):
        assert np.array_equal(getattr(got, f), getattr(one, f)), f
    assert eng.trim_rounds and eng.timings["gather"] >= 0
    for a, b in zip(got.estimates(), one.estimates()):
        assert np.array_equal(a, b)


def test_mesh_fit_matches_the_jax_engine():
    """The sharded fit against the JAX package's one-device fit at the
    engine gate (PARITY.md: DI atol 5e-3, adjusted rtol 5e-3, flags exact);
    on the same scheme and in float64 it holds to 1e-9, as the one-device
    port does (tests/test_torch_engine.py)."""
    cov, X = make_dataset(seed=8, n=20, p=4)
    nmf_kw = dict(nmf_iter=8, degnorm_iter=3)
    rj = JEngine(JNmf(**nmf_kw), JEng(device_loop=False, use_pallas=False,
                                      dtype="float64",
                                      bucket_widths=WIDTHS)).run(cov, X)
    _, rt = port_fit(cov, X, nmf_kw, dtype="float64", power_warm_plain=0,
                     mesh=make_mesh(["cpu"] * 2))
    np.testing.assert_array_equal(rt.ran_baseline_selection,
                                  rj.ran_baseline_selection)
    np.testing.assert_allclose(rt.rho, rj.rho, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.x_adj, rj.x_adj, rtol=1e-9)
    # the port's defaults (float32, its warm scheme) at the engine gate
    _, r32 = port_fit(cov, X, nmf_kw, mesh=make_mesh(["cpu"] * 3))
    np.testing.assert_array_equal(r32.ran_baseline_selection,
                                  rj.ran_baseline_selection)
    np.testing.assert_allclose(r32.rho, rj.rho, rtol=0, atol=5e-3)
    np.testing.assert_allclose(r32.x_adj, rj.x_adj, rtol=5e-3)


def test_wide_bucket_is_gene_sharded():
    """A W=65536 bucket with ``seqpar_width`` above its width (by default
    it is column-sharded on a mesh: tests/test_torch_seqpar.py) is
    gene-sharded like any other and gives the one-device fit's bits."""
    rng = np.random.default_rng(4)
    cov = OrderedDict()
    for i in range(3):
        L = int(rng.integers(33_000, 60_000))
        cov[f"long{i}"] = random_coverage(rng, 3, L, scale=4 + 4 * rng.random(),
                                          degraded=(i % 2 == 0))
    X = np.round(np.abs(rng.standard_normal((3, 3))) * 300 + 30)
    nmf_kw = dict(nmf_iter=3, degnorm_iter=1)
    kw = dict(dtype="float64", bucket_widths=(65536,), seqpar_width=65537)
    one_eng, one = port_fit(cov, X, nmf_kw, **kw)
    assert [b.width for b in one_eng._buckets] == [65536]
    eng, got = port_fit(cov, X, nmf_kw, mesh=make_mesh(["cpu"] * 2), **kw)
    assert len(eng._shards) == 2
    assert not any(sh.cols.sharded for sh in eng._shards)
    for f in ("rho", "x_adj", "ran_baseline_selection"):
        assert np.array_equal(getattr(got, f), getattr(one, f)), f


def test_shards_launch_by_the_whole_bucket(monkeypatch):
    """Every kernel call of a shard carries the whole bucket's gene count,
    which the launch rules read: a shard launches as the whole bucket
    would, and gives its bits on the card."""
    seen = []
    for name in ("nmf_masked_cuda", "ratio_rowsums_cuda"):
        orig = getattr(cuda_nmf, name)

        def spy(F, *a, _orig=orig, _name=name, bucket_genes=None, **kw):
            seen.append((_name, F.shape[0], bucket_genes))
            return _orig(F, *a, bucket_genes=bucket_genes, **kw)
        monkeypatch.setattr(cuda_nmf, name, spy)
    cov, X = make_dataset(n=12)
    eng, _ = port_fit(cov, X, dict(nmf_iter=4, degnorm_iter=1),
                      fuse_trim=False, mesh=make_mesh(["cpu"] * 3))
    whole = {b.F.shape[0] for b in eng._buckets}
    assert {n for n, _, _ in seen} == {"nmf_masked_cuda",
                                       "ratio_rowsums_cuda"}
    assert all(g in whole and shard < g for _, shard, g in seen)


def test_shard_plot_genes_matches_jax():
    """The cases of tests/test_multiprocess.py:217-232 on both packages."""
    fitted = ["GENE2", "GENE0", "GENE1", "OTHER"]
    req = ["gene1", "Gene0", "GENE2", "missing", "gene1"]
    cases = [(req, fitted), (req, fitted, 0, 2), (req, fitted, 1, 2),
             (["nope"], fitted, 0, 2), (req, fitted, 2, 3)]
    for args in cases:
        assert _shard_plot_genes(*args) == jax_shard_plot(*args)
    assert _shard_plot_genes(req, fitted) == ["GENE0", "GENE1", "GENE2"]
    assert _shard_plot_genes(req, fitted, 0, 2) == ["GENE0", "GENE2"]
    assert _shard_plot_genes(req, fitted, 1, 2) == ["GENE1"]


def test_broadcast_string_round_trips_and_bounds():
    s = "dir/å-π ok/degnorm_101726_120000"
    assert distributed.broadcast_string(s) == s
    assert distributed.broadcast_string("ü" * 512) == "ü" * 512   # 1024 B
    with pytest.raises(ValueError, match="1024"):
        distributed.broadcast_string("ü" * 513)
    with pytest.raises(ValueError):
        distributed.broadcast_string("x" * 1025)


def test_one_process_needs_no_process_group(monkeypatch):
    for k in ("DEGNORM_TPU_COORDINATOR", "DEGNORM_TPU_NUM_PROCESSES",
              "DEGNORM_TPU_PROCESS_ID", "MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize_multihost(device="cpu")
    assert not torch.distributed.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert distributed.is_coordinator()
    distributed.barrier("noop")
    t = torch.arange(6).reshape(3, 2)
    assert distributed.gather_rows(t) is t
    mesh = distributed.global_mesh("cpu")
    assert mesh.size == 1 and mesh.devices == (torch.device("cpu"),)
    monkeypatch.setenv("DEGNORM_TPU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize_multihost(device="cpu")


def test_only_the_coordinator_writes_the_checkpoint(tmp_path, monkeypatch):
    state = td.init_state(np.full((3, 2), 0.1), np.ones((3, 2)))
    ran = np.zeros((3, 1), bool)
    monkeypatch.setattr(checkpoints, "is_coordinator", lambda: False)
    path = checkpoints.save_checkpoint(str(tmp_path), 0, state, ran, "abc")
    assert not os.path.exists(path) and not os.listdir(tmp_path)
    monkeypatch.setattr(checkpoints, "is_coordinator", lambda: True)
    checkpoints.save_checkpoint(str(tmp_path), 0, state, ran, "abc")
    assert checkpoints.load_checkpoint(str(tmp_path), "abc")["iteration"] == 0


def test_profile_dir_writes_a_trace(tmp_path):
    """``--profile-dir`` (``EngineConfig.profile_dir``): a torch.profiler
    trace of the fit's iterations appears there."""
    (tmp_path / "data").mkdir()
    d = write_sim_dataset(tmp_path / "data", n_genes=6)
    prof = tmp_path / "prof"
    run = run_command(tcli.main, str(tmp_path / "out"),
                      ["-o", str(tmp_path / "out"),
                       "--bam-files", *d["bams"], "-g", d["gtf"],
                       "--nmf-iter", "3", "--iter", "1", "--device", "cpu",
                       "--profile-dir", str(prof)])
    assert os.path.isfile(os.path.join(run, "degradation_index_scores.csv"))
    (trace,) = os.listdir(prof)
    assert trace.endswith(".pt.trace.json")
    with open(prof / trace) as f:
        head = f.read(4096)
    assert "traceEvents" in head


def test_mesh_flag_runs_the_command(tmp_path):
    """``--mesh`` with ``--device cpu`` (a mesh of the one CPU) writes what
    the command without it writes."""
    (tmp_path / "data").mkdir()
    d = write_sim_dataset(tmp_path / "data", n_genes=6)
    args = ["--bam-files", *d["bams"], "-g", d["gtf"], "--nmf-iter", "3",
            "--iter", "1", "--device", "cpu"]
    a = run_command(tcli.main, str(tmp_path / "a"),
                    args + ["-o", str(tmp_path / "a"), "--mesh"])
    b = run_command(tcli.main, str(tmp_path / "b"),
                    args + ["-o", str(tmp_path / "b")])
    for name in ("degradation_index_scores.csv", "adjusted_read_counts.csv"):
        with open(os.path.join(a, name), "rb") as x, \
                open(os.path.join(b, name), "rb") as y:
            assert x.read() == y.read()


@pytest.mark.parametrize("n", [2, 3])
def test_dryrun_multichip_on_cpu_devices(n):
    """The gene-sharded step bit for bit; the fit, whose outlier gene is
    column-sharded, within float32 summation order of one device's (DI
    1e-5, the bound PERF.md states for the card)."""
    out = dryrun_multichip(n, devices=["cpu"])
    assert out["bit_equal"] and out["shards"] == n
    assert out["devices"] == ["cpu"] * n
    assert out["column_sharded_buckets"] == 1
    assert out["fit_max_diff"] <= 1e-5


# ---------------------------------------------------------------------------
# the kernel build, safe across processes
# ---------------------------------------------------------------------------

_STUB_NVCC = """#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
time.sleep(0.3)
if {fail}:
    sys.exit("stub nvcc: refused")
if "-shared" in args:
    # a link whose objects another process removed or has not written
    gone = [a for a in args if a.endswith(".o") and not os.path.isfile(a)]
    if gone:
        sys.exit("stub nvcc: missing object " + gone[0])
with open(out, "w") as f:
    f.write("stub " + " ".join(a for a in args if a.endswith((".cu", ".o"))))
"""

_BUILD_CHILD = (
    "import os, sys\n"
    "from degnorm_tpu_torch.ops.build import build\n"
    "path = build(build_dir=sys.argv[1])\n"
    "assert os.path.isfile(path)\n"
    "print('built', os.path.basename(path))\n")


def _stub_nvcc(tmp_path, fail=False):
    stub = tmp_path / ("bad_nvcc" if fail else "nvcc")
    stub.write_text(_STUB_NVCC.format(python=sys.executable, fail=fail))
    stub.chmod(0o755)
    return str(stub)


def test_kernel_build_is_process_safe(tmp_path):
    """Six processes build the kernels into one fresh directory at once
    (a stub compiler named by NVCC stands in for nvcc): every one finds the
    library, and one library remains with no object or temporary file
    beside it."""
    target = str(tmp_path / "build")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["NVCC"] = _stub_nvcc(tmp_path)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, target],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = sorted(os.listdir(target))
    libs = [n for n in names if n.endswith(".so")]
    assert len(libs) == 1, names
    assert {o.strip() for o, _ in outs} == {f"built {libs[0]}"}
    assert not [n for n in names if n.endswith((".o", ".tmp"))], names
    with open(os.path.join(target, libs[0])) as f:
        assert f.read().startswith("stub ")     # the link step's output


def test_failed_kernel_build_raises_and_leaves_nothing(tmp_path, monkeypatch):
    """No fallback: a compiler that fails raises, and no object, library or
    temporary file is left."""
    monkeypatch.setenv("NVCC", _stub_nvcc(tmp_path, fail=True))
    target = tmp_path / "build"
    with pytest.raises(RuntimeError, match="kernel build failed"):
        kbuild.build(build_dir=str(target))
    assert [n for n in os.listdir(target) if not n.endswith(".lock")] == []
