"""End-to-end pipeline orchestration — the ``degnorm`` CLI body
(reference ``__main__.py:16-319``) with the fit on the port's engine.

Cold path: BAM ETL -> merge -> gene filters -> bucketed NMF-OA on the
device -> output contract.  Warm path: reload a prior run's coverage/counts
and jump straight to the device loop.  One process drives one device, or
with a mesh several (gene shards); in a multi-process run
(parallel/distributed.py) the processes split the ETL by sample and the
``--plot-genes``, and the coordinator writes every artifact.
"""
from __future__ import annotations

import logging
import os
import shutil
import sys
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from typing import Dict, Optional

import numpy as np
import torch

from degnorm_tpu_torch.config import PipelineConfig
from degnorm_tpu_torch.engine import DegNormEngine, resolve_device
from degnorm_tpu_torch.io.gtf import process_annotation
from degnorm_tpu_torch.io.merge import merge_coverage, merge_read_counts
from degnorm_tpu_torch.io.overlap import overlap_structure
from degnorm_tpu_torch.parallel import distributed
from degnorm_tpu_torch.pipeline import outputs
from degnorm_tpu_torch.pipeline.sample import BamSampleProcessor
from degnorm_tpu_torch.pipeline.warm_start import load_from_previous
from degnorm_tpu_torch.report.report import REPORT_TOP_N, report_genes

log = logging.getLogger("degnorm_tpu_torch")

# the gene caps of the filters before NMF; the reference drops genes with
# max coverage > 2147483647 (2^31 - 1, __main_mpi__.py:377), not > 2^31
_MAX_GENE_LENGTH = 9_000_000
_MAX_COVERAGE = float(2 ** 31 - 1)


def create_output_dir(base_dir: str) -> str:
    """Timestamped run directory, reference naming scheme
    (utils.py:49-79): degnorm_<mmddYY>_<HHMMSS>."""
    stamp = datetime.now().strftime("%m%d%Y_%H%M%S")
    out = os.path.join(base_dir, f"degnorm_{stamp}")
    os.makedirs(out, exist_ok=True)
    return out


_WELCOME = r"""
 ___   ___  ___  _  _  ___  ___  __  __
|   \ | __|| __|| \| |/ _ \| _ \|  \/  |
| |) || _| | (_ || .` | (_) |   /| |\/| |
|___/ |___||___||_|\_|\___/|_|_\|_|  |_|
    transcript degradation normalization on a CUDA GPU
"""


def welcome() -> None:
    """ASCII banner (the reference's utils.py:37-46 equivalent)."""
    for line in _WELCOME.strip("\n").splitlines():
        log.info(line)


def configure_logger(output_dir: Optional[str] = None,
                     process_tag: Optional[str] = None) -> None:
    """Stream + degnorm.log file logging (utils.py:16-34 format);
    ``process_tag`` prefixes messages in multi-process runs (the
    reference's rank prefix, __main_mpi__.py:33-40)."""
    tag = f"[{process_tag}] " if process_tag else ""
    fmt = logging.Formatter(f"DegNorm (%(asctime)s) ---- {tag}%(message)s")
    log.setLevel(logging.DEBUG)
    for old in log.handlers:
        old.close()
    log.handlers.clear()
    h = logging.StreamHandler(sys.stdout)
    h.setFormatter(fmt)
    log.addHandler(h)
    if output_dir:
        fh = logging.FileHandler(os.path.join(output_dir, "degnorm.log"))
        fh.setFormatter(fmt)
        log.addHandler(fh)


def _shard_plot_genes(plot_genes, result_genes,
                      process_index: int = 0, process_count: int = 1):
    """This process's round-robin share of --plot-genes: case-insensitive
    intersection with the fitted genes (CoverageLoader matches
    case-insensitively, reference data_access.py:61-63), sorted for a
    deterministic split across processes (the reference scatters plot
    genes over ranks, __main_mpi__.py:461-488)."""
    canon = {g.upper(): g for g in result_genes}
    wanted = sorted({canon[g.upper()] for g in plot_genes
                     if g.upper() in canon})
    return wanted[process_index::process_count]


def _plot_gene_shard(wanted, output_dir: str) -> None:
    """Plot the coverage of ``wanted`` genes (this process's share).  Reads
    the saved run artifacts, so they must have been written first."""
    if not wanted:
        return
    log.info("plotting coverage for %d gene(s): %s",
             len(wanted), ", ".join(wanted))
    try:
        from degnorm_tpu_torch.report.data_access import get_coverage_plots
        get_coverage_plots(wanted, degnorm_dir=output_dir,
                           save_dir=output_dir)
    except Exception as e:   # plots must never fail the pipeline
        log.warning("coverage plotting failed: %s", e)


def _device_name(dev: torch.device) -> str:
    """The engine's device with its index (``cuda:0``)."""
    if dev.type == "cuda" and dev.index is None:
        return f"cuda:{torch.cuda.current_device()}"
    return str(dev)


def run_pipeline(cfg: PipelineConfig, output_dir: Optional[str] = None,
                 mesh=None, write_outputs: bool = True) -> Dict:
    """Run the full DegNorm pipeline; returns a dict with the fit result,
    gene tables, and the output directory path.

    ``mesh``: a ``parallel.GeneMesh`` to gene-shard the fit over (one
    process over several devices, or ``parallel.distributed.global_mesh``
    in a multi-process run).  ``write_outputs``: False on the workers of a
    multi-process run: the coordinator owns every artifact of the (shared)
    output directory; a worker keeps to the shared ETL scratch, plots its
    share of ``--plot-genes`` once the coordinator's artifacts are written,
    and returns its result without estimates.

    The returned dict carries a ``timings`` mapping with wall-clock
    seconds per phase (etl, filters, fit, fit.*, estimates, save, plots,
    report, report_render) — the whole-pipeline observability the
    reference lacks (its only visibility is log timestamps, SURVEY.md
    §5.1)."""
    if mesh is None:
        resolve_device(cfg.engine.device)  # no GPU: raise before the ETL
    timings: Dict[str, float] = {}
    _t0 = time.perf_counter()
    output_dir = output_dir or create_output_dir(cfg.output_dir)

    if cfg.warm_start_dir:
        log.info("WARM START: loading preprocessed data from %s",
                 cfg.warm_start_dir)
        warm = load_from_previous(cfg.warm_start_dir, output_dir,
                                  copy_artifacts=write_outputs)
        gene_cov_dict = warm["gene_cov_dict"]
        read_count_df = warm["read_count_df"]
        genes_df = warm["genes_df"]
        sample_ids = warm["sample_ids"]
        exon_df = warm["exon_df"]
    else:
        gene_cov_dict, read_count_df, genes_df, exon_df, sample_ids = (
            _cold_start(cfg, output_dir, write_outputs=write_outputs))
    timings["etl"] = time.perf_counter() - _t0

    # ---- gene filters before NMF (reference __main__.py:221-238, plus the
    # MPI-only caps __main_mpi__.py:374-376, unified per SURVEY.md §7.2) ----
    _t0 = time.perf_counter()
    drop = []
    for gene, F in gene_cov_dict.items():
        too_low = F.max() < cfg.minimax_coverage
        too_short = F.shape[1] <= cfg.nmf.downsample_rate
        too_long = F.shape[1] > _MAX_GENE_LENGTH
        too_high = F.max() > _MAX_COVERAGE
        if too_low or too_short or too_long or too_high:
            drop.append(gene)
    for gene in drop:
        del gene_cov_dict[gene]
    if drop:
        genes_df = genes_df[~genes_df.gene.isin(drop)].reset_index(drop=True)
        read_count_df = read_count_df[
            ~read_count_df.gene.isin(drop)].reset_index(drop=True)
    if not gene_cov_dict:
        raise ValueError("No genes available to run through DegNorm!")

    log.info("DegNorm will run on %d genes across %d samples.",
             len(gene_cov_dict), len(sample_ids))
    timings["filters"] = time.perf_counter() - _t0

    # ---- the device loop ----
    # Warm the plotting stack on a background thread while the device fit
    # runs, so its imports do not land inside the report phase.
    def _warm_plot_stack():
        try:
            import degnorm_tpu_torch.report.data_access  # noqa: F401
        except ImportError:
            pass
    threading.Thread(target=_warm_plot_stack, daemon=True).start()

    _t0 = time.perf_counter()
    engine = DegNormEngine(cfg.nmf, cfg.engine, mesh=mesh)
    log.info("fit device: %s", _device_name(engine.device))
    if engine.mesh.size > 1:
        log.info("gene mesh: %d shards, %d process(es), this one's on %s",
                 engine.mesh.size, engine.mesh.process_count,
                 ", ".join(_device_name(d) for d in engine.mesh.devices))
    counts = read_count_df[sample_ids].values.astype(np.float64)
    # every process resumes from the shared checkpoint; only the
    # coordinator writes it (pipeline/checkpoints.py)
    result = engine.run(gene_cov_dict, counts, checkpoint_dir=output_dir)
    timings["fit"] = time.perf_counter() - _t0
    timings.update({f"fit.{k}": v for k, v in engine.timings.items()})
    wanted = _shard_plot_genes(cfg.plot_genes, result.genes)
    my_plots = _shard_plot_genes(cfg.plot_genes, result.genes,
                                 distributed.process_index(),
                                 distributed.process_count())

    if not write_outputs:
        # a worker: plots its share of --plot-genes (the reference scatters
        # them over ranks, __main_mpi__.py:461-488) once the coordinator
        # has written the artifacts they are read from
        if wanted:
            distributed.barrier("degnorm-outputs-written")
            _plot_gene_shard(my_plots, output_dir)
        log.info("pipeline phase timings (s): %s",
                 {k: round(v, 4) for k, v in timings.items()})
        return {"result": result, "genes_df": genes_df,
                "read_count_df": read_count_df, "sample_ids": sample_ids,
                "output_dir": output_dir, "exon_df": exon_df,
                "timings": timings}

    _t0 = time.perf_counter()
    estimates = OrderedDict(zip(result.genes, result.estimates()))
    timings["estimates"] = time.perf_counter() - _t0

    # ---- outputs (reference nmf.py:603-711 contract) ----
    # The summary report renders CONCURRENTLY with the artifact writes:
    # with in-memory rho (DI figures) and coverage/estimates (gene
    # figures) it reads nothing save_results is writing.  The reference
    # runs them serially (__main__.py:283-316).
    _t_rep0 = time.perf_counter()
    rep_done = {}

    def _report_job():
        try:
            from degnorm_tpu_torch.report.report import render_report
            render_report(
                data_dir=output_dir,
                degnorm_data={"degnorm_iter": cfg.nmf.degnorm_iter,
                              "nmf_iter": cfg.nmf.nmf_iter,
                              "downsample_rate": cfg.nmf.downsample_rate,
                              "rho": result.rho, "genes": result.genes},
                bam_files=(list(cfg.bam_files) if not cfg.warm_start_dir
                           else [cfg.warm_start_dir]),
                sample_ids=sample_ids, top_n_genes=REPORT_TOP_N,
                output_dir=output_dir,
                # reuse the arrays already in memory: no re-unpickling of
                # the artifacts being written next door
                cov_data={"raw": gene_cov_dict, "estimate": estimates},
                exon_df=exon_df)
        except Exception as e:
            log.warning("report rendering failed: %s", e)
        rep_done["wall"] = time.perf_counter() - _t_rep0
    rep_thread = threading.Thread(target=_report_job, daemon=True)
    rep_thread.start()

    _t0 = time.perf_counter()
    gene_chrom = dict(zip(genes_df.gene, genes_df.chr))
    outputs.save_results(
        output_dir, result.genes, gene_chrom, result.rho, result.x_adj,
        result.ran_baseline_selection, estimates, sample_ids)
    timings["save"] = time.perf_counter() - _t0

    if wanted:
        _t0 = time.perf_counter()
        # the report writes <chrom>/<gene>_coverage.png for its top and
        # bottom genes: where one of those is to be plotted, by any
        # process, the plots wait for the report, so that two writers never
        # write one file at once
        hi, lo = report_genes(result.rho, result.genes)
        if {g.upper() for g in hi + lo} & {g.upper() for g in wanted}:
            rep_thread.join()
        distributed.barrier("degnorm-outputs-written")
        _plot_gene_shard(my_plots, output_dir)
        timings["plots"] = time.perf_counter() - _t0

    # "report" = tail latency beyond the save/plot phases it overlapped;
    # "report_render" = the render's own wall for comparison
    _t0 = time.perf_counter()
    rep_thread.join()
    timings["report"] = time.perf_counter() - _t0
    timings["report_render"] = rep_done.get("wall", 0.0)
    log.info("pipeline phase timings (s): %s",
             {k: round(v, 4) for k, v in timings.items()})

    return {"result": result, "genes_df": genes_df,
            "read_count_df": read_count_df, "sample_ids": sample_ids,
            "output_dir": output_dir, "exon_df": exon_df,
            "timings": timings}


def _cold_start(cfg: PipelineConfig, output_dir: str,
                write_outputs: bool = True):
    """BAM/GTF ETL (reference __main__.py:55-209)."""
    if not cfg.bam_files:
        raise ValueError("no .bam files supplied")
    if not cfg.genome_annotation:
        raise ValueError("no genome annotation (.gtf) supplied")

    # multi-process: the samples are split over the processes (the
    # reference scatters them over MPI ranks, __main_mpi__.py:236-262) and
    # the per-(sample, chrom) artifacts in a shared scratch directory of the
    # output directory are the transport (the reference likewise hands
    # coverage off through the shared file system, __main_mpi__.py:400-416).
    # Sample ownership is disjoint, so writes into the scratch never collide.
    pcount = distributed.process_count()
    pindex = distributed.process_index()
    etl_dir = output_dir
    if pcount > 1:
        etl_dir = os.path.join(output_dir, ".etl_shared")
        os.makedirs(etl_dir, exist_ok=True)

    bais = (list(cfg.bai_files) if cfg.bai_files
            else [None] * len(cfg.bam_files))
    if len(bais) != len(cfg.bam_files):
        # strict pairing, like the reference's flag validation
        # (utils.py:318-484) — a shorter list would silently drop samples
        raise ValueError(
            f"--bai-files count ({len(bais)}) does not match .bam count "
            f"({len(cfg.bam_files)})")
    samples = [BamSampleProcessor(b, unique_alignment=cfg.unique_alignments,
                                  output_dir=etl_dir,
                                  compat=cfg.cigar_compat, bai_file=bai,
                                  # a sample another process owns is loaded
                                  # from its artifacts, never decoded here
                                  stream=(cfg.stream_etl
                                          if i % pcount == pindex else False))
               for i, (b, bai) in enumerate(zip(cfg.bam_files, bais))]
    sample_ids = [s.sample_id for s in samples]
    if len(set(sample_ids)) < len(sample_ids):
        raise ValueError("duplicate sample IDs among .bam files")

    # chromosomes: intersection of all samples' headers, restricted to the
    # annotation (reference __main__.py:87-99)
    chroms = set(samples[0].chroms)
    for s in samples[1:]:
        chroms &= set(s.chroms)
    exon_df = process_annotation(cfg.genome_annotation,
                                 chroms=sorted(chroms))
    gene_df = exon_df[["chr", "gene", "gene_start", "gene_end"]
                      ].drop_duplicates().reset_index(drop=True)

    used_chroms = exon_df.chr.unique().tolist()
    overlap_by_chrom = {
        c: overlap_structure(gene_df[gene_df.chr == c]) for c in used_chroms}

    owned = [s for i, s in enumerate(samples) if i % pcount == pindex]
    if pcount > 1:
        log.info("multi-process ETL: this process owns %d/%d sample(s): %s",
                 len(owned), len(samples),
                 ", ".join(s.sample_id for s in owned) or "(none)")

    # -p is a TOTAL host-thread budget (the reference's proc-per-node):
    # split it between the sample fan-out and each sample's per-chromosome
    # threads so p samples don't oversubscribe to n_jobs^2 threads.
    # Samples run in parallel host threads (BGZF/BAM decode is native and
    # releases the GIL).
    sample_workers = min(cfg.n_jobs, max(len(owned), 1))
    inner_jobs = max(1, cfg.n_jobs // max(sample_workers, 1))

    def etl(s: BamSampleProcessor):
        s.chroms = used_chroms
        log.info("SAMPLE %s: computing coverage/read counts (%s)",
                 s.sample_id, "paired" if s.paired else "single-end")
        return s.sample_id, s.coverage_read_counts(
            overlap_by_chrom, gene_df, exon_df, n_jobs=inner_jobs)

    is_cram = any(s.is_cram for s in samples)
    if is_cram:
        from degnorm_tpu_torch.io import cram_fast
        declined_before = cram_fast.declined
    results = {}
    if sample_workers > 1 and len(owned) > 1:
        with ThreadPoolExecutor(max_workers=sample_workers) as ex:
            for sid, r in ex.map(etl, owned):
                results[sid] = r
    else:
        for s in owned:
            sid, r = etl(s)
            results[sid] = r

    if pcount > 1:
        # every owner has written its artifacts: load the other processes'
        # samples from the shared scratch (coverage_read_counts is then a
        # pure load)
        distributed.barrier("degnorm-etl-shards")
        for i, s in enumerate(samples):
            if i % pcount == pindex:
                continue
            s.chroms = used_chroms
            log.info("SAMPLE %s: loading another process's artifacts from "
                     "the shared ETL scratch", s.sample_id)
            results[s.sample_id] = s.coverage_read_counts(
                overlap_by_chrom, gene_df, exon_df, n_jobs=inner_jobs)

    if is_cram:
        # the counter is process-wide: log this ETL's share of it
        log.info("CRAM slices decoded record by record (the vectorized "
                 "decoder declined them): %d",
                 cram_fast.declined - declined_before)
    read_count_df = merge_read_counts(results, sample_ids, used_chroms)
    gene_cov_dict = merge_coverage(results, sample_ids, exon_df)

    # clean up per-sample scratch (reference __main__.py:168-170); in a
    # multi-process run the shared scratch outlives the barrier, so that
    # every process has loaded every sample before the coordinator removes
    # it
    if pcount > 1:
        distributed.barrier("degnorm-etl-consumed")
        if write_outputs:
            shutil.rmtree(etl_dir)
    else:
        for sid in sample_ids:
            scratch = os.path.join(etl_dir, sid)
            if os.path.isdir(scratch):
                shutil.rmtree(scratch)

    # order counts/genes by coverage-dict order (reference __main__.py:175-190)
    genes = list(gene_cov_dict.keys())
    genes_df = (gene_df.set_index("gene").loc[genes].reset_index()
                [["chr", "gene", "gene_start", "gene_end"]])
    read_count_df = (read_count_df.set_index("gene").loc[genes].reset_index()
                     [["gene", "chr"] + sample_ids])
    read_count_df = read_count_df[["chr", "gene"] + sample_ids]
    exon_df = exon_df[exon_df.gene.isin(genes)]

    # save gene annotation metadata + raw read counts (__main__.py:199-209)
    if write_outputs:
        exon_df.to_csv(os.path.join(output_dir, "gene_exon_metadata.csv"),
                       index=False)
        # reference column order is gene-first: __main__.py:181-190 runs
        # set_index('gene')/loc[genes]/reset_index before the save
        rc_cols = (["gene"]
                   + [c for c in read_count_df.columns if c != "gene"])
        read_count_df[rc_cols].to_csv(
            os.path.join(output_dir, "read_counts.csv"), index=False)

        # raw coverage matrices pickles (reads_coverage_merge.py:439-452)
        gene_chrom = dict(zip(genes_df.gene, genes_df.chr))
        outputs.save_coverage_matrices(output_dir, gene_chrom,
                                       gene_cov_dict)

    return gene_cov_dict, read_count_df, genes_df, exon_df, sample_ids
