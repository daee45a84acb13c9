"""Shared helpers of the tests/test_torch_*.py files: inputs are made with
numpy from a seed and handed to both the JAX package and the PyTorch port."""
import numpy as np
import pytest


def random_coverage(rng, p, L, scale=10.0, degraded=False):
    """Plausible coverage matrix: smooth positive envelope with
    sample-specific degradation ramps (same recipe as tests/conftest.py)."""
    t = np.linspace(0, 1, L)
    base = scale * (0.25 + np.abs(np.sin(np.pi * t)
                                  + 0.3 * rng.standard_normal(L) * 0.05))
    rows = []
    for j in range(p):
        amp = 0.5 + rng.random() * 1.5
        row = amp * base
        if degraded and j % 2 == 1:
            row = row * np.exp(-2.0 * (1 - t) * rng.random())
        rows.append(row)
    return np.round(np.maximum(np.vstack(rows), 0.0), 3)


def make_bucket_np(mats, W, dtype=np.float64):
    """Pad (p, L_i) matrices into a (G, p, W) array + (G, W) length mask."""
    G, p = len(mats), mats[0].shape[0]
    F = np.zeros((G, p, W), dtype=dtype)
    mask = np.zeros((G, W), dtype=bool)
    for i, m in enumerate(mats):
        F[i, :, :m.shape[1]] = m
        mask[i, :m.shape[1]] = True
    return F, mask


def degraded_bucket(seed, p, lengths, W, dtype):
    rng = np.random.default_rng(seed)
    mats = [random_coverage(rng, p, L, degraded=(i % 2 == 0)).astype(dtype)
            for i, L in enumerate(lengths)]
    return make_bucket_np(mats, W, dtype=dtype)


def to_np(t):
    return t.detach().cpu().numpy()


SIM_SAMPLES = ("sample0", "sample1", "sample2")


def write_sim_dataset(d, n_genes=12, chrom_len=80_000, fmt="bam"):
    """The command tests' fixture: a .gtf and one single-end .bam (or, with
    ``fmt="cram"``, .cram) a sample of SIM_SAMPLES (degraded 0, 0.5 and
    0.3), written by the port's io/simulate.py from fixed seeds, in
    directory ``d``."""
    import os
    from degnorm_tpu_torch.io.simulate import (make_genes, write_gtf,
                                               write_sample_bam,
                                               write_sample_cram)
    write = write_sample_cram if fmt == "cram" else write_sample_bam
    genes = make_genes(np.random.default_rng(42), n_genes=n_genes,
                       overlap_fraction=0.25)
    gtf = os.path.join(str(d), "sim.gtf")
    write_gtf(gtf, genes)
    bams = []
    for i, deg in enumerate((0.0, 0.5, 0.3)):
        bam = os.path.join(str(d), f"{SIM_SAMPLES[i]}.{fmt}")
        write(bam, genes, chrom_len, seed=100 + i, mean_reads_per_gene=120,
              degradation=deg)
        bams.append(bam)
    return {"gtf": gtf, "bams": bams, "dir": d}


def run_command(main, base, args):
    """``main(args)`` with ``-o base``'s directory made first; returns the
    one run directory it created there."""
    import os
    os.makedirs(base, exist_ok=True)
    assert main(list(args)) == 0
    runs = [p for p in os.listdir(base) if p.startswith("degnorm_")]
    assert len(runs) == 1, runs
    return os.path.join(base, runs[0])


@pytest.fixture(scope="module")
def jax_host_layer_on_numpy():
    """The JAX package's host layer takes its numpy paths in the command
    tests: its native build is not safe across processes (ROADMAP Queue 3),
    and what they compare is the port against its results, not its
    build."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEGNORM_TPU_NO_NATIVE", "1")
        yield
