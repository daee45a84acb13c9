"""Typed configuration of the PyTorch/CUDA DegNorm engine.

``NMFConfig`` is this package's own copy of the algorithm parameters
(reference ``degnorm/nmf.py:12-53``); ``EngineConfig`` holds the execution
knobs of the port; ``PipelineConfig`` the options of the command.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class NMFConfig:
    """Parameters of the NMF-over-approximation algorithm.

    Defaults mirror reference ``degnorm/nmf.py:12-13`` exactly.
    """

    degnorm_iter: int = 5          # outer DegNorm iterations
    nmf_iter: int = 100            # Lagrangian fixed-point iterations per NMF call
    downsample_rate: int = 1       # systematic "take every r-th" column sample
    min_high_coverage: int = 50    # min # of high-coverage positions to attempt NMF
    bins: int = 20                 # baseline-selection trim bins
    skip_baseline_selection: bool = False
    random_state: int = 123
    # Systematic-downsample offset source (only meaningful when
    # downsample_rate > 1):
    #   "keyed"     (default) — per-(seed, iteration, gene) PRNG keys.
    #   "reference" — reproduce the reference's EXACT offset stream: one
    #               np.random.choice(rate) per gene per iteration in gene
    #               order from np.random.seed(123) (nmf.py:422,556).
    ds_compat: str = "keyed"

    def __post_init__(self):
        object.__setattr__(self, "degnorm_iter", abs(int(self.degnorm_iter)))
        object.__setattr__(self, "nmf_iter", abs(int(self.nmf_iter)))
        object.__setattr__(self, "bins", abs(int(self.bins)))
        object.__setattr__(self, "downsample_rate", abs(int(self.downsample_rate)))

    @property
    def effective_min_high_coverage(self) -> int:
        # Reference forces this to 2 whenever downsampling (nmf.py:34,51-53),
        # otherwise max(2, min_high_coverage).
        if self.downsample_rate > 1:
            return 2
        return max(2, abs(int(self.min_high_coverage)))

    @property
    def min_bins(self) -> int:
        # ceil(bins * 0.2)  (nmf.py:35)
        return int(math.ceil(self.bins * 0.2))

    @property
    def min_gene_len(self) -> int:
        # max(2, ceil(200 / downsample_rate))  (nmf.py:261)
        return max(2, int(math.ceil(200.0 / self.downsample_rate)))

    def kernel_key(self) -> "NMFConfig":
        """Normalized copy with the fields that do not reach the device
        kernels (outer-iteration count, RNG seed, offset source) zeroed."""
        return dataclasses.replace(self, degnorm_iter=0, random_state=0,
                                   ds_compat="keyed")

    @property
    def max_trim_rounds(self) -> int:
        """Upper bound on baseline-selection trim-loop rounds.

        Each round drops exactly one bin and the loop halts at ``min_bins``
        bins (nmf.py:323), so at most ``bins - min_bins`` drops occur — 16 at
        the defaults.
        """
        return max(self.bins - self.min_bins, 1)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Execution knobs of the PyTorch/CUDA engine."""

    # Where the engine runs.  The default is the GPU and the engine raises
    # when none is present; only a caller that asks for "cpu" gets the CPU.
    device: str = "cuda"
    # Route the NMF loop (resident or, for a wide bucket, streamed), the
    # ratio-SVD row sums and the trim loop through the hand-written CUDA
    # kernels (ops/).  On CPU tensors the wrappers take
    # their plain PyTorch versions whatever this says; on CUDA tensors
    # False selects the plain versions (the parity reference on the card).
    use_kernels: bool = True
    # Power-iteration steps for the dominant eigenpair of the p x p Gram
    # matrix on a cold start and when warm-started from the previous
    # Lagrangian iteration's vector (squared-operator scheme: effectively
    # 4 * max(1, n // 4) plain steps).
    power_iters_cold: int = 128
    power_iters_warm: int = 24
    # Cold-start power iterations for trim rounds >= 1, which resume from
    # the previous round's left vector (0 = use power_iters_cold).
    power_iters_resume: int = 32
    # Warm-restart power steps per Lagrangian iteration: > 0 replaces the
    # squared-operator scheme with this many plain matvecs.  The kernels'
    # default (1) follows the JAX package's fused kernels; 0 matches its
    # XLA twin, which always runs the squared scheme at power_iters_warm.
    power_warm_plain: int = 1
    # Run the whole baseline-selection trim loop in one kernel launch per
    # bucket (ops/cuda_trim.py) where the bucket is inside that kernel's
    # gate.  False, and any bucket outside the gate, takes the unfused form:
    # a Python loop around one NMF kernel launch per round.  The plain
    # versions are the Python loop whatever this says.
    fuse_trim: bool = True
    # Computation dtype of the bucket kernels.  The CUDA kernels are
    # float32; float64 runs the plain versions (CPU parity tests).
    dtype: str = "float32"
    # Length-bucket widths used by the packer (positions).
    bucket_widths: Sequence[int] = (256, 512, 1024, 2048, 4096, 8192, 16384, 65536)
    # Cap on genes per device batch within one bucket; 0 = unbounded.
    max_genes_per_batch: int = 0
    # On a mesh of two or more shards, a bucket at least this wide has its
    # COLUMNS (positions) cut across the shards instead of its genes
    # (parallel/seqpar.py): the few genes of such a bucket are the longest of
    # the annotation.  Each reduction over the columns is then a partial on
    # each shard and one sum (max, scan) across them.  A mesh of one never
    # column-shards.  The JAX package's default (its config.py:214), and like
    # it unchecked: 0 column-shards every bucket.
    seqpar_width: int = 32768
    # Dominant eigenvector of the p x p Gram in every rank-1 fit: "power"
    # (power iteration, the kernels) or "eigh" (a batched exact
    # eigendecomposition, torch.linalg.eigh).  "eigh" runs every fit through
    # the plain versions and launches no kernel: the JAX package's XLA twin
    # (its use_pallas=False path), which its CPU runs take.
    rank1_method: str = "power"
    # Opt-in: each trim round restarts its Lagrangian from the previous
    # round's multipliers (masked to the surviving columns) and left vector,
    # with max(nmf_iter // 4, 8) steps of size 1/sqrt(that).  Applies to the
    # fused trim loop of a bucket that trim_fast_applies(); ignored
    # elsewhere, as in the JAX package.
    trim_fast: bool = False
    # Opt-in: > 0 freezes a gene's NMF state after the first iteration with
    # max|dK| <= nmf_tol * max|K| (the update of that iteration kept).
    # Applies to the NMF loops of a bucket that nmf_tol_applies() (kernel 1
    # and the plain rounds of the trim loop, fused or not); the streamed
    # kernel and trim_fast's rounds ignore it, as in the JAX package.
    nmf_tol: float = 0.0
    # Not carried over: the port has no other lowering for a wide bucket
    # than the streamed kernel, so only True is accepted.
    stream_nmf: bool = True
    # Write a torch.profiler trace of the fit's DegNorm iterations into this
    # directory (the JAX engine's jax.profiler trace; ``--profile-dir``).
    profile_dir: Optional[str] = None
    # Where the outer update between bucket steps runs (the JAX field, its
    # config.py:227).  None (the default) and True: float64 on the device
    # (core/degnorm.py's torch twins), no host sync an iteration beyond the
    # trim loop's.  False: the host numpy float64 loop of core/degnorm.py
    # (the original parity reference), the per-gene rows fetched to the
    # host every iteration.  A mesh that spans processes runs the device
    # loop whatever this says, as the JAX engine does (its engine.py:674).
    device_loop: Optional[bool] = None

    def __post_init__(self):
        if not self.stream_nmf:
            raise NotImplementedError(
                "not ported (only the default is accepted): stream_nmf=False")
        if self.rank1_method not in ("power", "eigh"):
            raise ValueError(
                f"rank1_method must be power or eigh, got {self.rank1_method!r}")
        if not self.nmf_tol >= 0.0:
            raise ValueError(f"nmf_tol must be >= 0, got {self.nmf_tol}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be float32 or float64, got {self.dtype!r}")


# Where an opt-in mode changes numbers: the JAX package applies nmf_tol and
# trim_fast only inside the kernels that carry them, its resident NMF kernel
# (degnorm_tpu/ops/pallas_nmf.py::pallas_supported) and its fused trim
# kernel (ops/pallas_trim.py::fused_trim_supported); a bucket outside them
# is streamed or trimmed by the unfused loop, and the mode is ignored there.
# The port decides by the same rules, copied below as rules on the bucket's
# shape, whatever kernel it launches: W a multiple of 128 and a minimal block
# of 8 genes within the JAX kernels' 13 MiB VMEM budget at 7 (NMF) or 8
# (trim) live (p, W) float32 buffers a gene, i.e. p * W <= 60,854 or 53,248.
_JAX_VMEM_BUDGET = 13 * 1024 * 1024


def _jax_resident_fits(p: int, W: int, live_buffers: int) -> bool:
    return W % 128 == 0 and 8 * live_buffers * p * W * 4 <= _JAX_VMEM_BUDGET


def nmf_tol_applies(shape) -> bool:
    """True when ``EngineConfig.nmf_tol`` applies to the NMF loops of a
    (G, p, W) bucket: the JAX package's resident NMF kernel takes it."""
    _, p, W = shape
    return _jax_resident_fits(p, W, 7)


def trim_fast_applies(shape) -> bool:
    """True when ``EngineConfig.trim_fast`` applies to the trim loop of a
    (G, p, W) bucket whose loop is fused (``fuse_trim``): the JAX package's
    fused trim kernel takes it."""
    _, p, W = shape
    return _jax_resident_fits(p, W, 8)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline options — the typed replacement for the CLI flag
    set validated in reference ``degnorm/utils.py:318-484``."""

    bam_files: Sequence[str] = ()
    bai_files: Sequence[str] = ()
    genome_annotation: Optional[str] = None
    output_dir: str = "."
    plot_genes: Sequence[str] = ()
    warm_start_dir: Optional[str] = None
    # Gene filters applied before NMF (reference __main__.py:221-238 and the
    # MPI-only caps __main_mpi__.py:374-376, unified here per SURVEY.md §7.2).
    minimax_coverage: int = 0
    unique_alignments: bool = True
    # CIGAR/pairing semantics: "reference" reproduces the reference
    # implementation's parser quirks exactly (needed for bitwise coverage
    # parity); "strict" follows the SAM spec (io/coverage.py docstring).
    cigar_compat: str = "reference"
    # BAI-driven per-chromosome streaming ETL: None = auto (stream when an
    # index exists and the BAM exceeds BamSampleProcessor.STREAM_THRESHOLD),
    # True/False = force. Streaming bounds host memory by the largest
    # chromosome instead of the whole file.
    stream_etl: Optional[bool] = None
    n_jobs: int = 1
    nmf: NMFConfig = dataclasses.field(default_factory=NMFConfig)
    # the fit runs on engine.device: "cuda" unless the caller asks for "cpu"
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)

    def __post_init__(self):
        if self.cigar_compat not in ("reference", "strict"):
            raise ValueError("cigar_compat must be reference or strict, got "
                             f"{self.cigar_compat!r}")
