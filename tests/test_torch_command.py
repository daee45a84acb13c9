"""PyTorch port, the command: checkpoints that each engine resumes from the
other's run, the ETL of a multi-chromosome dataset against the JAX
package's, and the cases of tests/test_pipeline.py on the port's command
(``--device cpu``): filters, plots, --bam-dir, streaming ETL and flag
validation.
"""
import filecmp
import os
import pickle
import shutil
from collections import OrderedDict

import numpy as np
import pandas as pd
import pytest
import torch

from degnorm_tpu.config import EngineConfig as JEng
from degnorm_tpu.config import NMFConfig as JNmf
from degnorm_tpu.config import PipelineConfig as JPipe
from degnorm_tpu.engine import DegNormEngine as JEngine
from degnorm_tpu.pipeline import run as jrun
from degnorm_tpu_torch import cli as tcli
from degnorm_tpu_torch.config import EngineConfig, NMFConfig, PipelineConfig
from degnorm_tpu_torch.engine import DegNormEngine
from degnorm_tpu_torch.io.simulate import (make_genes, write_gtf,
                                           write_multichrom_bam)
from degnorm_tpu_torch.pipeline import run as trun
from tests.torch_port_util import (SIM_SAMPLES, random_coverage,
                                   run_command, write_sim_dataset)
from tests.torch_port_util import jax_host_layer_on_numpy  # noqa: F401

torch.set_num_threads(2)
FIT = ["--nmf-iter", "5", "--iter", "2"]
DI_CSV = "degradation_index_scores.csv"
pytestmark = pytest.mark.usefixtures("jax_host_layer_on_numpy")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_sim_dataset(tmp_path_factory.mktemp("tcmd"), n_genes=8)


def port_cmd(base, args):
    return run_command(tcli.main, base, [*args, "--device", "cpu"])


def cold_args(dataset, extra=()):
    return ["--bam-files", *dataset["bams"], "-g", dataset["gtf"], *FIT,
            *extra]


def _small_fit_data(seed=5, n=12, p=3):
    rng = np.random.default_rng(seed)
    cov = OrderedDict()
    for i in range(n):
        L = int(300 + rng.integers(0, 700))
        cov[f"g{i}"] = random_coverage(rng, p, L, scale=3 + 6 * rng.random(),
                                       degraded=(i % 2 == 0))
    X = np.round(np.abs(rng.standard_normal((n, p))) * 300 + 30)
    return cov, X


def _port_engine(iters, rate):
    return DegNormEngine(
        NMFConfig(nmf_iter=8, degnorm_iter=iters, downsample_rate=rate,
                  ds_compat="reference"),
        EngineConfig(device="cpu", use_kernels=False, dtype="float64",
                     power_warm_plain=0, bucket_widths=(512, 1024)))


def _jax_engine(iters, rate):
    return JEngine(
        JNmf(nmf_iter=8, degnorm_iter=iters, downsample_rate=rate,
             ds_compat="reference"),
        JEng(dtype="float64", device_loop=False, use_pallas=False,
             bucket_widths=(512, 1024)))


@pytest.mark.parametrize("rate", [1, 3])
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_checkpoint_resumed_by_the_other_engine(tmp_path, writer, reader,
                                                rate):
    """One engine fits one iteration and leaves its checkpoint; the other
    resumes it for two more.  The result equals the reader's engine fitting
    all three iterations without a stop (float64, same arithmetic: 1e-9),
    downsample offsets included: the resumed fit draws past the first
    iteration's offsets as the uninterrupted one did."""
    make = {"port": _port_engine, "jax": _jax_engine}
    cov, X = _small_fit_data()
    ckpt = str(tmp_path)
    make[writer](1, rate).run(cov, X, checkpoint_dir=ckpt)
    with np.load(os.path.join(ckpt, "degnorm_checkpoint.npz"),
                 allow_pickle=True) as z:
        assert int(z["iteration"]) == 0
    eng = make[reader](3, rate)
    resumed = eng.run(cov, X, checkpoint_dir=ckpt)
    assert "iter_0" not in eng.timings and "iter_2" in eng.timings
    whole = make[reader](3, rate).run(cov, X)
    np.testing.assert_array_equal(resumed.ran_baseline_selection,
                                  whole.ran_baseline_selection)
    assert resumed.ran_baseline_selection.shape == (len(cov), 3)
    np.testing.assert_allclose(resumed.rho, whole.rho, rtol=0, atol=1e-9)
    np.testing.assert_allclose(resumed.x_adj, whole.x_adj, rtol=1e-9)
    with np.load(os.path.join(ckpt, "degnorm_checkpoint.npz"),
                 allow_pickle=True) as z:
        assert int(z["iteration"]) == 2
        np.testing.assert_allclose(z["rho"], whole.rho, rtol=0, atol=1e-9)


def test_finished_checkpoint_is_not_resumed(tmp_path):
    cov, X = _small_fit_data(seed=6, n=10)
    eng = _port_engine(2, 1)
    first = eng.run(cov, X, checkpoint_dir=str(tmp_path))
    again = eng.run(cov, X, checkpoint_dir=str(tmp_path))
    assert "init" in eng.timings and "iter_0" in eng.timings
    np.testing.assert_array_equal(first.rho, again.rho)


@pytest.mark.parametrize("paired", [False, True])
def test_cold_start_artifacts_equal_multichrom(tmp_path, paired):
    """The ETL of a two-chromosome dataset: gene table, counts, coverage and
    the files the JAX package's ETL writes, byte for byte; then the port's
    command on it writes per-chromosome outputs."""
    rng = np.random.default_rng(77)
    g1 = make_genes(rng, chrom="chr1", n_genes=5, name_prefix="a.")
    g2 = make_genes(rng, chrom="chr2", n_genes=4, name_prefix="b.")
    gtf = str(tmp_path / "mc.gtf")
    write_gtf(gtf, g1 + g2)
    lens = {"chr1": 60_000, "chr2": 60_000}
    bams = []
    for i in range(2):
        b = str(tmp_path / f"mcs{i}.bam")
        write_multichrom_bam(b, {"chr1": g1, "chr2": g2}, lens,
                             seed=200 + i, mean_reads_per_gene=100,
                             paired=paired)
        bams.append(b)
    outs = {}
    for name, cfg_cls, mod in (("port", PipelineConfig, trun),
                               ("jax", JPipe, jrun)):
        d = tmp_path / f"etl_{name}"
        d.mkdir()
        cfg = cfg_cls(bam_files=tuple(bams), genome_annotation=gtf, n_jobs=2)
        outs[name] = (str(d), mod._cold_start(cfg, str(d)))
    (dt, rt), (dj, rj) = outs["port"], outs["jax"]
    assert list(rt[0]) == list(rj[0])
    for g in rt[0]:
        np.testing.assert_array_equal(rt[0][g], rj[0][g])
    for a, b in zip(rt[1:4], rj[1:4]):
        pd.testing.assert_frame_equal(a, b)
    assert rt[4] == rj[4]
    for name in ("read_counts.csv", "gene_exon_metadata.csv",
                 os.path.join("chr1", "coverage_matrices_chr1.pkl"),
                 os.path.join("chr2", "coverage_matrices_chr2.pkl")):
        assert filecmp.cmp(os.path.join(dt, name), os.path.join(dj, name),
                           shallow=False), name
    if paired:
        return
    run = port_cmd(str(tmp_path / "out"),
                   ["--bam-files", *bams, "-g", gtf, "-o",
                    str(tmp_path / "out"), "--nmf-iter", "4", "--iter", "1"])
    di = pd.read_csv(os.path.join(run, DI_CSV))
    assert set(di.chr) == {"chr1", "chr2"} and len(di) == 9
    for c in ("chr1", "chr2"):
        for prefix in ("coverage_matrices", "estimated_coverage_matrices"):
            assert os.path.isfile(os.path.join(run, c, f"{prefix}_{c}.pkl"))


def test_plot_genes_bam_dir_and_minimax_filter(dataset, tmp_path):
    """--plot-genes (with .txt expansion), --bam-dir scanning and
    --minimax-coverage in one run: every fitted gene clears the threshold,
    and the plot genes, which include report genes (their figures wait for
    the report), have their figures."""
    bam_dir = tmp_path / "bams"
    bam_dir.mkdir()
    for b in dataset["bams"]:
        shutil.copy(b, bam_dir)
    genes_txt = tmp_path / "genes.txt"
    genes_txt.write_text("gene000\ngene001\n")
    out = str(tmp_path / "out")
    run = port_cmd(out, ["--bam-dir", str(bam_dir), "-g", dataset["gtf"],
                         "-o", out, *FIT, "--minimax-coverage", "5",
                         "--plot-genes", str(genes_txt), "gene002"])
    di = pd.read_csv(os.path.join(run, DI_CSV))
    cov = pickle.load(open(os.path.join(run, "chr1",
                                        "coverage_matrices_chr1.pkl"), "rb"))
    assert len(di) > 0
    for g in di.gene:
        assert cov[g].max() >= 5
    pngs = {f.lower() for f in os.listdir(os.path.join(run, "chr1"))
            if f.endswith("_coverage.png")}
    assert {"gene000_coverage.png", "gene001_coverage.png",
            "gene002_coverage.png"} <= pngs
    hi, lo = trun.report_genes(di[list(SIM_SAMPLES)].values, list(di.gene))
    assert {g.lower() for g in hi + lo} & {"gene000", "gene001", "gene002"}


def test_stream_etl_matches(dataset, tmp_path):
    """Streaming ETL builds the missing .bai indexes and gives the coverage,
    counts and files of the whole-file decode."""
    d = tmp_path / "stream_bams"
    d.mkdir()
    bams = tuple(str(shutil.copy(b, d)) for b in dataset["bams"])
    outs = []
    for stream in (True, False):
        out = tmp_path / f"etl_{stream}"
        out.mkdir()
        cfg = PipelineConfig(bam_files=bams, stream_etl=stream,
                             genome_annotation=dataset["gtf"])
        outs.append((str(out), trun._cold_start(cfg, str(out))))
    assert all(os.path.isfile(b + ".bai") for b in bams)
    (d_on, on), (d_off, off) = outs
    assert list(on[0]) == list(off[0])
    for g in on[0]:
        np.testing.assert_array_equal(on[0][g], off[0][g])
    pd.testing.assert_frame_equal(on[1], off[1])
    for name in ("read_counts.csv", "gene_exon_metadata.csv",
                 os.path.join("chr1", "coverage_matrices_chr1.pkl")):
        assert filecmp.cmp(os.path.join(d_on, name),
                           os.path.join(d_off, name), shallow=False), name


def test_cli_flag_validation(dataset, tmp_path):
    """The JAX command's rejections (reference utils.py:343-344, 398-403,
    434-436, 443-457, 478-480), and the flags the port has since carried."""
    parse = tcli.parse_config
    base = ["--bam-files", *dataset["bams"], "-g", dataset["gtf"]]
    for bad in (["-d", "0"], ["--nmf-iter", "0"], ["--iter", "-1"],
                ["-d", "-3"]):
        with pytest.raises(SystemExit):
            parse(base + bad)
    for argv in (base + ["--bam-dir", str(dataset["dir"])],
                 ["--bam-files", "reads.txt", dataset["bams"][0],
                  "-g", dataset["gtf"]],
                 ["--bam-dir", str(tmp_path / "nope"), "-g", dataset["gtf"]],
                 ["--bam-files", dataset["bams"][0], dataset["bams"][0],
                  "-g", dataset["gtf"]],
                 base + ["--bai-files", "one.bai"],
                 base + ["--bai-files", "a.txt", "b.txt", "c.txt"],
                 base + ["--bai-files", *(str(tmp_path / f"{i}.bai")
                                          for i in range(3))],
                 base + ["-o", str(tmp_path / "no_such_dir")],
                 ["-w", str(tmp_path / "no_warm")]):
        with pytest.raises(SystemExit):
            parse(argv)
    cfg = parse(base + ["-w", str(dataset["dir"])])
    assert cfg.warm_start_dir and not cfg.bam_files
    assert cfg.genome_annotation is None
    cfg = parse(base)
    assert len(cfg.bam_files) == 3 and cfg.engine.device == "cuda"
    assert parse(base + ["--device", "cpu"]).engine.device == "cpu"
    assert parse(base + ["-d", "2", "--ds-compat", "reference"]
                 ).nmf.downsample_rate == 2
    # the opt-in modes and keyed downsample offsets are ported: accepted
    for flag, check in (
            (["--trim-fast"], lambda c: c.engine.trim_fast),
            (["--nmf-tol", "1e-4"], lambda c: c.engine.nmf_tol == 1e-4),
            (["--rank1-method", "eigh"],
             lambda c: c.engine.rank1_method == "eigh"),
            (["-d", "2"], lambda c: (c.nmf.downsample_rate, c.nmf.ds_compat)
             == (2, "keyed")),
            (["-d", "2", "--ds-compat", "keyed"],
             lambda c: (c.nmf.downsample_rate, c.nmf.ds_compat)
             == (2, "keyed"))):
        assert check(parse(base + flag)), flag
    # every flag of the JAX command is ported: the multi-GPU flags and the
    # profiler trace are accepted
    cfg, args = parse(base + ["--multihost"], return_args=True)
    assert args.multihost and not args.mesh
    cfg, args = parse(base + ["--mesh"], return_args=True)
    assert args.mesh and not args.multihost
    assert parse(base + ["--profile-dir", str(tmp_path)]
                 ).engine.profile_dir == str(tmp_path)


def test_command_runs_on_the_gpu_by_default(dataset, tmp_path):
    """Without --device the command fits on the GPU; where there is none it
    raises instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main([*cold_args(dataset), "-o", str(tmp_path)])
