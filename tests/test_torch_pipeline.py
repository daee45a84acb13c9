"""PyTorch port, the command as a whole: ``degnorm_tpu_torch`` (``--device
cpu``) against the JAX package's ``degnorm_tpu`` on ``io/simulate.py``
fixtures: the output directory, the float64 pipeline, and warm starts from
each other's runs.  (Checkpoints across the engines and the cases of
tests/test_pipeline.py on the port: tests/test_torch_command.py.)

Tolerances (PARITY.md, all-up): ``read_counts.csv`` and
``gene_exon_metadata.csv`` byte-equal, coverage pickles exactly equal,
``ran_baseline_selection.csv`` exact, DI atol 5e-3, adjusted counts rtol
5e-3, estimates 5e-2 of each gene's scale.  The two commands fit with
different warm power schemes (the port's default follows the kernels, the
JAX package's CPU path is its XLA twin); with the port on the XLA twin's
scheme in float64 (``power_warm_plain=0``) both run the same arithmetic and
the DI agree to 1e-9, as tests/test_torch_engine.py holds the engines.
"""
import filecmp
import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from degnorm_tpu import cli as jcli
from degnorm_tpu.config import EngineConfig as JEng
from degnorm_tpu.config import NMFConfig as JNmf
from degnorm_tpu.config import PipelineConfig as JPipe
from degnorm_tpu.pipeline import run as jrun
from degnorm_tpu_torch import cli as tcli
from degnorm_tpu_torch.config import EngineConfig, NMFConfig, PipelineConfig
from degnorm_tpu_torch.pipeline import run as trun
from tests.torch_port_util import (SIM_SAMPLES as SAMPLES, run_command,
                                   write_sim_dataset)
from tests.torch_port_util import jax_host_layer_on_numpy  # noqa: F401

torch.set_num_threads(2)
FIT = ["--nmf-iter", "5", "--iter", "2"]
CSVS = ("degradation_index_scores.csv", "adjusted_read_counts.csv",
        "ran_baseline_selection.csv", "read_counts.csv",
        "gene_exon_metadata.csv")
pytestmark = pytest.mark.usefixtures("jax_host_layer_on_numpy")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_sim_dataset(tmp_path_factory.mktemp("tpipe"))


def port_cmd(base, args):
    return run_command(tcli.main, base, [*args, "--device", "cpu"])


def cold_args(dataset, extra=()):
    return ["--bam-files", *dataset["bams"], "-g", dataset["gtf"], *FIT,
            *extra]


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):
    """One run of each command on the dataset, shared by the tests."""
    base = tmp_path_factory.mktemp("runs")
    out = {}
    out["jax"] = run_command(jcli.main, str(base / "jax"),
                             [*cold_args(dataset), "-o", str(base / "jax")])
    out["port"] = port_cmd(str(base / "port"),
                           [*cold_args(dataset), "-o", str(base / "port")])
    return out


def _csv(run, name):
    return pd.read_csv(os.path.join(run, name))


def _pickle(run, chrom, prefix):
    with open(os.path.join(run, chrom, f"{prefix}_{chrom}.pkl"), "rb") as f:
        return pickle.load(f)


def _assert_fit_files_close(a, b, ran_exact=True):
    """DI, adjusted counts, baseline tracker and estimates of two runs."""
    da, db = _csv(a, CSVS[0]), _csv(b, CSVS[0])
    assert list(da.columns) == list(db.columns)
    assert list(da.gene) == list(db.gene)
    np.testing.assert_allclose(da[list(SAMPLES)], db[list(SAMPLES)],
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(_csv(a, CSVS[1])[list(SAMPLES)],
                               _csv(b, CSVS[1])[list(SAMPLES)], rtol=5e-3)
    if ran_exact:
        assert filecmp.cmp(os.path.join(a, CSVS[2]), os.path.join(b, CSVS[2]),
                           shallow=False)
    ea = _pickle(a, "chr1", "estimated_coverage_matrices")
    eb = _pickle(b, "chr1", "estimated_coverage_matrices")
    assert list(ea) == list(eb)
    for g in ea:
        assert ea[g].shape == eb[g].shape
        scale = max(float(np.abs(eb[g]).max()), 1.0)
        assert float(np.abs(ea[g] - eb[g]).max()) <= 5e-2 * scale, g


def test_command_writes_the_jax_commands_output_directory(runs):
    jax, port = runs["jax"], runs["port"]
    for name in ("read_counts.csv", "gene_exon_metadata.csv"):
        assert filecmp.cmp(os.path.join(port, name), os.path.join(jax, name),
                           shallow=False), name
    ct = _pickle(port, "chr1", "coverage_matrices")
    cj = _pickle(jax, "chr1", "coverage_matrices")
    assert list(ct) == list(cj)
    for g in ct:
        assert ct[g].dtype == cj[g].dtype
        np.testing.assert_array_equal(ct[g], cj[g])
    _assert_fit_files_close(port, jax)
    di = _csv(port, CSVS[0])[list(SAMPLES)].values
    assert np.isfinite(di).all() and (di >= 0).all() and (di <= 0.9).all()
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax))
    assert os.path.isfile(os.path.join(port, "report",
                                       "degnorm_summary.html"))
    with np.load(os.path.join(port, "degnorm_checkpoint.npz"),
                 allow_pickle=True) as z, \
            np.load(os.path.join(jax, "degnorm_checkpoint.npz"),
                    allow_pickle=True) as w:
        assert sorted(z.files) == sorted(w.files)
        assert int(z["iteration"]) == int(w["iteration"]) == 1
        assert list(z["genes"]) == list(w["genes"])
    with open(os.path.join(port, "degnorm.log")) as f:
        assert "fit device: cpu" in f.read()


def test_run_pipeline_float64_matches_jax(dataset, tmp_path):
    """Both pipelines on the same arithmetic: DI at atol 1e-9."""
    nmf = dict(nmf_iter=5, degnorm_iter=2)
    kw = dict(bam_files=tuple(dataset["bams"]),
              genome_annotation=dataset["gtf"])
    outs = {}
    for name, cfg, run in (
            ("port", PipelineConfig(
                nmf=NMFConfig(**nmf), **kw,
                engine=EngineConfig(device="cpu", dtype="float64",
                                    power_warm_plain=0)), trun.run_pipeline),
            ("jax", JPipe(nmf=JNmf(**nmf), **kw,
                          engine=JEng(dtype="float64", device_loop=False,
                                      use_pallas=False)),
             jrun.run_pipeline)):
        d = tmp_path / name
        d.mkdir()
        outs[name] = run(cfg, output_dir=str(d))
    rt, rj = outs["port"]["result"], outs["jax"]["result"]
    assert rt.genes == rj.genes
    np.testing.assert_array_equal(rt.ran_baseline_selection,
                                  rj.ran_baseline_selection)
    np.testing.assert_allclose(rt.rho, rj.rho, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.x_adj, rj.x_adj, rtol=1e-9)
    timings = outs["port"]["timings"]
    for k in ("etl", "filters", "fit", "estimates", "save", "report",
              "report_render", "fit.iterations"):
        assert k in timings, k


def test_warm_start_across_commands(runs, tmp_path):
    """The port warm-starts from the JAX command's run directory, and the
    JAX command from the port's: each fit agrees with the run it started
    from, whose coverage and counts it copies unchanged."""
    port_w = port_cmd(str(tmp_path / "pw"),
                      ["-w", runs["jax"], "-o", str(tmp_path / "pw"), *FIT])
    jax_w = run_command(jcli.main, str(tmp_path / "jw"),
                    ["-w", runs["port"], "-o", str(tmp_path / "jw"), *FIT])
    for warm, src in ((port_w, runs["jax"]), (jax_w, runs["port"])):
        for name in ("read_counts.csv", "gene_exon_metadata.csv",
                     os.path.join("chr1", "coverage_matrices_chr1.pkl")):
            assert filecmp.cmp(os.path.join(warm, name),
                               os.path.join(src, name), shallow=False), name
        _assert_fit_files_close(warm, src)
    # a warm start refits the same data: the port from the JAX directory
    # gives the port's own cold result exactly
    for name in CSVS[:3]:
        pd.testing.assert_frame_equal(_csv(port_w, name),
                                      _csv(runs["port"], name))


def _eqx_bam(d, genes, seed):
    """A single-end .bam whose aligner wrote '='/'X' CIGAR operations: the
    simulated reads with each M run split into '=' runs around one 'X'."""
    import re
    from degnorm_tpu_torch.io import bam as tbam
    from degnorm_tpu_torch.io.simulate import simulate_sample

    def eqx(cigar):
        def split(m):
            n = int(m.group(1))
            return f"{n}=" if n < 3 else f"{n // 2}=1X{n - n // 2 - 1}="
        return re.sub(r"(\d+)M", split, cigar)

    recs = [(r[0], r[1], r[2], r[3], eqx(r[4]), *r[5:])
            for r in simulate_sample(np.random.default_rng(seed), genes,
                                     80_000, mean_reads_per_gene=120,
                                     degradation=0.3 * (seed % 2))]
    path = os.path.join(str(d), f"eqx{seed}.bam")
    tbam.write_bam(path, [genes[0].chrom], [80_000], recs)
    return path


def _both_pipelines(tmp_path, bams, gtf, jax_kw=(), **pipe_kw):
    """run_pipeline of the port and of the JAX package on the same
    arithmetic (float64, the XLA twin's warm power scheme); ``jax_kw``
    goes to the JAX config only."""
    nmf = dict(nmf_iter=5, degnorm_iter=2)
    kw = dict(bam_files=tuple(bams), genome_annotation=gtf, **pipe_kw)
    outs = {}
    for name, cfg, run in (
            ("port", PipelineConfig(
                nmf=NMFConfig(**nmf), **kw,
                engine=EngineConfig(device="cpu", dtype="float64",
                                    power_warm_plain=0)), trun.run_pipeline),
            ("jax", JPipe(nmf=JNmf(**nmf), **kw, **dict(jax_kw),
                          engine=JEng(dtype="float64", device_loop=False,
                                      use_pallas=False)),
             jrun.run_pipeline)):
        d = tmp_path / name
        d.mkdir()
        outs[name] = run(cfg, output_dir=str(d))["result"]
    return outs["port"], outs["jax"]


def test_run_pipeline_strict_cigars_matches_jax(tmp_path):
    """cigar_compat="strict" reaches the ETL: on a .bam with '='/'X'
    CIGARs the port's pipeline equals the JAX package's with the same
    config, where the default "reference" mode refuses the reads."""
    from degnorm_tpu_torch.io.simulate import make_genes, write_gtf
    genes = make_genes(np.random.default_rng(42), n_genes=12,
                       overlap_fraction=0.25)
    gtf = str(tmp_path / "sim.gtf")
    write_gtf(gtf, genes)
    bams = [_eqx_bam(tmp_path, genes, seed) for seed in (1, 2, 3)]
    rt, rj = _both_pipelines(tmp_path, bams, gtf, cigar_compat="strict")
    assert rt.genes == rj.genes and len(rt.genes) > 0
    np.testing.assert_array_equal(rt.ran_baseline_selection,
                                  rj.ran_baseline_selection)
    np.testing.assert_allclose(rt.rho, rj.rho, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.x_adj, rj.x_adj, rtol=1e-9)
    out = tmp_path / "ref"
    out.mkdir()
    with pytest.raises(ValueError, match="cigar_compat='strict'"):
        trun.run_pipeline(PipelineConfig(
            bam_files=tuple(bams), genome_annotation=gtf,
            engine=EngineConfig(device="cpu")), output_dir=str(out))
    with pytest.raises(ValueError, match="cigar_compat"):
        PipelineConfig(cigar_compat="spec")


def test_gene_caps_drop_the_same_genes(dataset, tmp_path, monkeypatch):
    """The port's gene-length and coverage caps are the JAX config's
    defaults, and drop the same genes as the JAX pipeline's
    max_gene_length / max_coverage (caps set between the fixture genes'
    lengths and peaks, in the port by its module constants)."""
    from degnorm_tpu_torch.io.gtf import process_annotation
    assert trun._MAX_GENE_LENGTH == JPipe().max_gene_length
    assert trun._MAX_COVERAGE == JPipe().max_coverage
    exons = process_annotation(dataset["gtf"])
    lens = (exons.gene_end - exons.gene_start + 1).unique()
    caps = dict(max_gene_length=int(np.median(lens)), max_coverage=40.0)
    monkeypatch.setattr(trun, "_MAX_GENE_LENGTH", caps["max_gene_length"])
    monkeypatch.setattr(trun, "_MAX_COVERAGE", caps["max_coverage"])
    rt, rj = _both_pipelines(tmp_path, dataset["bams"], dataset["gtf"],
                             jax_kw=caps)
    assert rt.genes == rj.genes
    assert 0 < len(rt.genes) < len(exons.gene.unique())
    np.testing.assert_allclose(rt.rho, rj.rho, rtol=0, atol=1e-9)
