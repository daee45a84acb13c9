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
