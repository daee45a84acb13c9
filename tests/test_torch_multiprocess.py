"""PyTorch port, multi-process runs on torch.distributed (gloo, on the CPU):
two OS processes fit one gene mesh, and the ``--multihost`` command writes
the single-process command's output directory.  The counterpart of
tests/test_multiprocess.py, whose fixed ports these tests avoid: each binds
a free port of its own.
"""
import os
import pickle
import shutil
import socket
import subprocess
import sys
from collections import OrderedDict

import numpy as np
import pandas as pd
import pytest
import torch

from degnorm_tpu_torch import cli as tcli
from degnorm_tpu_torch.config import EngineConfig, NMFConfig
from degnorm_tpu_torch.engine import DegNormEngine
from tests.torch_port_util import random_coverage, write_sim_dataset

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NMF_KW = dict(nmf_iter=6, degnorm_iter=3)
ENG_KW = dict(device="cpu", dtype="float64", bucket_widths=(512, 1024))
FIT = ["--nmf-iter", "5", "--iter", "2"]
PLOT = ["--plot-genes", "gene000", "GENE001"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(argv_of, n=2, timeout=120):
    """Start ``n`` processes (``argv_of(rank)``) as one job on a free port;
    returns their outputs once all have exited 0."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(DEGNORM_TPU_COORDINATOR=f"localhost:{free_port()}",
               DEGNORM_TPU_NUM_PROCESSES=str(n), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(argv_of(r), cwd=REPO,
                              env=dict(env, DEGNORM_TPU_PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=timeout)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    failed = [r for r, pr in enumerate(procs) if pr.returncode != 0]
    assert not failed, "\n".join(f"rank {r}:\n{out[-3000:]}"
                                  for r, out in enumerate(outs))
    return outs


def _fit_data(n=14, p=3, seed=21):
    rng = np.random.default_rng(seed)
    cov = OrderedDict()
    for i in range(n):
        L = int(150 + rng.integers(0, 850))
        cov[f"g{i}"] = random_coverage(rng, p, L, scale=3 + 6 * rng.random(),
                                       degraded=(i % 2 == 0))
    X = np.round(np.abs(rng.standard_normal((n, p))) * 300 + 30)
    return cov, X


_ENGINE_RANK = r"""
import sys
from collections import OrderedDict
import numpy as np, torch
torch.set_num_threads(2)
from degnorm_tpu_torch.config import EngineConfig, NMFConfig
from degnorm_tpu_torch.engine import DegNormEngine
from degnorm_tpu_torch.parallel import distributed
out, ckpt = sys.argv[1], sys.argv[2] or None
distributed.initialize_multihost(device="cpu")
rank = distributed.process_index()
assert distributed.process_count() == 2
with np.load(out + "/data.npz") as d:
    cov = OrderedDict((f"g{i}", d[f"g{i}"]) for i in range(int(d["n"])))
    X = d["X"]
eng = DegNormEngine(NMFConfig(**%(nmf)r), EngineConfig(**%(eng)r),
                    mesh=distributed.global_mesh("cpu"))
res = eng.run(cov, X, checkpoint_dir=ckpt)
np.save(f"{out}/rho_{rank}.npy", res.rho)
np.save(f"{out}/adj_{rank}.npy", res.x_adj)
np.save(f"{out}/ran_{rank}.npy", res.ran_baseline_selection)
if rank == 0:
    ests = res.estimates()
    np.save(f"{out}/est0.npy", np.concatenate([e.ravel() for e in ests]))
else:
    try:
        res.estimates()
        raise SystemExit("a worker materialized estimates")
    except ValueError as e:
        assert "coordinator" in str(e)
got = distributed.broadcast_string("dir/å-π ok" if rank == 0 else "")
assert got == "dir/å-π ok", got
print("rank", rank, "shards", [(s.bucket, s.start, s.stop) for s in eng._shards],
      "gather_s", eng.timings["gather"], flush=True)
print("rank", rank, "column shards",
      [(s.bucket, s.cols.offset) for s in eng._shards if s.cols.sharded],
      "reductions", eng.reductions, flush=True)
distributed.shutdown()
print("ENGINE OK", flush=True)
"""


def _two_process_fit(tmp_path, cov, X, ckpt="", eng=ENG_KW):
    np.savez(tmp_path / "data.npz", n=len(cov), X=X,
             **{g: m for g, m in cov.items()})
    code = _ENGINE_RANK % {"nmf": NMF_KW, "eng": eng}
    outs = run_ranks(lambda r: [sys.executable, "-c", code, str(tmp_path),
                                ckpt])
    assert all("ENGINE OK" in o for o in outs)
    return outs


def test_two_process_engine_fit_equals_one_process(tmp_path):
    """Both ranks' DI, adjusted counts and the coordinator's estimates equal
    the single-process fit (rtol 1e-10, tests/test_multiprocess.py:278's
    bound), the mesh splits every bucket between the ranks, and the
    coordinator's unicode string reaches the worker."""
    cov, X = _fit_data()
    outs = _two_process_fit(tmp_path, cov, X)
    single = DegNormEngine(NMFConfig(**NMF_KW), EngineConfig(**ENG_KW)).run(
        cov, X)
    for r in range(2):
        np.testing.assert_allclose(np.load(tmp_path / f"rho_{r}.npy"),
                                   single.rho, rtol=1e-10)
        np.testing.assert_allclose(np.load(tmp_path / f"adj_{r}.npy"),
                                   single.x_adj, rtol=1e-10)
    want = np.concatenate([e.ravel() for e in single.estimates()])
    np.testing.assert_allclose(np.load(tmp_path / "est0.npy"), want,
                               rtol=1e-10)
    assert "rank 0 shards" in outs[0] and "rank 1 shards" in outs[1]


def test_two_process_fit_resumes_a_single_process_checkpoint(tmp_path):
    """A single-process run's checkpoint (2 of 3 iterations) is resumed by
    a two-process run, which ends where the single-process resume does;
    only the coordinator rewrote the checkpoint (its iteration is the
    last)."""
    cov, X = _fit_data(seed=33)
    first = tmp_path / "first"
    first.mkdir()
    DegNormEngine(NMFConfig(**dict(NMF_KW, degnorm_iter=2)),
                  EngineConfig(**ENG_KW)).run(cov, X,
                                              checkpoint_dir=str(first))
    solo, duo = tmp_path / "solo", tmp_path / "duo"
    shutil.copytree(first, solo)
    shutil.copytree(first, duo)
    resumed = DegNormEngine(NMFConfig(**NMF_KW), EngineConfig(**ENG_KW)).run(
        cov, X, checkpoint_dir=str(solo))
    _two_process_fit(tmp_path, cov, X, ckpt=str(duo))
    for r in range(2):
        np.testing.assert_allclose(np.load(tmp_path / f"rho_{r}.npy"),
                                   resumed.rho, rtol=1e-10)
    with np.load(duo / "degnorm_checkpoint.npz", allow_pickle=True) as z:
        assert int(z["iteration"]) == NMF_KW["degnorm_iter"] - 1
        np.testing.assert_allclose(z["rho"], resumed.rho, rtol=1e-10)
    assert sorted(os.listdir(duo)) == ["degnorm_checkpoint.npz"]


def test_two_processes_column_shard_the_wide_bucket(tmp_path):
    """Two gloo processes, one shard each: the bucket at least
    ``seqpar_width`` wide is cut along its columns (one column shard a
    process, its reductions gathered over the group), every other bucket
    along its genes.  Both ranks give the same bits, within 1e-9 of the
    single-process fit, and the coordinator's estimates too."""
    cov, X = _fit_data(seed=44)
    rng = np.random.default_rng(45)
    cov[f"g{len(cov)}"] = random_coverage(rng, 3, 3000, scale=6,
                                          degraded=True)
    X = np.vstack([X, np.round(np.abs(rng.standard_normal((1, 3))) * 300
                               + 30)])
    eng = dict(ENG_KW, bucket_widths=(512, 1024, 4096), seqpar_width=4096)
    outs = _two_process_fit(tmp_path, cov, X, eng=eng)
    single = DegNormEngine(NMFConfig(**NMF_KW), EngineConfig(**eng)).run(
        cov, X)
    assert "column shards [(2, 0)]" in outs[0]
    assert "column shards [(2, 2048)]" in outs[1]
    for name in ("rho", "adj", "ran"):
        a, b = (np.load(tmp_path / f"{name}_{r}.npy") for r in range(2))
        assert np.array_equal(a, b), name
    np.testing.assert_array_equal(np.load(tmp_path / "ran_0.npy"),
                                  single.ran_baseline_selection)
    np.testing.assert_allclose(np.load(tmp_path / "rho_0.npy"), single.rho,
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.load(tmp_path / "adj_0.npy"), single.x_adj,
                               rtol=1e-9)
    want = np.concatenate([e.ravel() for e in single.estimates()])
    np.testing.assert_allclose(np.load(tmp_path / "est0.npy"), want,
                               rtol=1e-9, atol=1e-9)


_GATHER_RANK = r"""
import sys
import numpy as np, torch
from degnorm_tpu_torch.ops.cuda_trim import run_steps
from degnorm_tpu_torch.parallel import distributed
from degnorm_tpu_torch.parallel.seqpar import ColumnGroup
out = sys.argv[1]
distributed.initialize_multihost(device="cpu")
rank = distributed.process_index()
group = ColumnGroup(distributed.global_mesh("cpu"), 2 * 128, genes=5)
(cols,) = group.columns()
rng = np.random.default_rng(70 + rank)
t = torch.from_numpy((rng.standard_normal((5, 36))
                      * 10 ** rng.uniform(-3, 3, (5, 36))).astype(np.float32))

def step():
    buf = cols.partials(t.shape, t.device)[0]
    buf[cols.shard] = t
    got = yield from cols.gather_(buf)
    red = yield from cols.sum_(t)
    return got, red

((got, red),) = run_steps([step()])
np.save(f"{out}/part_{rank}.npy", t.numpy())
np.save(f"{out}/got_{rank}.npy", got.numpy())
np.save(f"{out}/red_{rank}.npy", red.numpy())
distributed.shutdown()
print("GATHER OK", flush=True)
"""


def test_two_processes_gather_the_partials_unsummed(tmp_path):
    """Two gloo processes, one column shard each: the gather ask of kernels
    4c and 2c answers both with both shards' partials in global shard order
    (one all-gather), and their left-to-right float32 sum is the bits the
    sum ask answers."""
    outs = run_ranks(lambda r: [sys.executable, "-c", _GATHER_RANK,
                                str(tmp_path)])
    assert all("GATHER OK" in o for o in outs)
    parts = [np.load(tmp_path / f"part_{r}.npy") for r in range(2)]
    for r in range(2):
        got = np.load(tmp_path / f"got_{r}.npy")
        np.testing.assert_array_equal(got, np.stack(parts))
        red = np.load(tmp_path / f"red_{r}.npy")
        np.testing.assert_array_equal(got[0] + got[1], red)
        assert red.dtype == np.float32


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["bam", "cram"])
def dataset(request, tmp_path_factory):
    return write_sim_dataset(tmp_path_factory.mktemp(f"mp_{request.param}"),
                             n_genes=8, fmt=request.param)


def _files(run):
    out = set()
    for root, _, names in os.walk(run):
        for n in names:
            out.add(os.path.relpath(os.path.join(root, n), run))
    return out


def _assert_same_outputs(a, b):
    """Two run directories with the same files: the tables byte for byte,
    the coverage pickles and the checkpoint value for value."""
    fa, fb = _files(a), _files(b)
    assert fa == fb, sorted(fa ^ fb)
    for rel in sorted(fa):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".csv"):
            with open(pa, "rb") as x, open(pb, "rb") as y:
                assert x.read() == y.read(), rel
        elif rel.endswith(".pkl"):
            with open(pa, "rb") as x, open(pb, "rb") as y:
                ma, mb = pickle.load(x), pickle.load(y)
            assert list(ma) == list(mb), rel
            for g in ma:
                np.testing.assert_array_equal(ma[g], mb[g], err_msg=rel)
        elif rel.endswith(".npz"):
            with np.load(pa, allow_pickle=True) as x, \
                    np.load(pb, allow_pickle=True) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_two_process_command_writes_the_single_process_output(dataset,
                                                              tmp_path):
    """``--multihost`` in two processes (gloo, --device cpu): one run
    directory, named by the coordinator and broadcast; the ETL split by
    sample, each process loading the other's from the shared scratch,
    which is gone afterwards; the worker writes no artifact of its own (the
    directory holds what the single-process command writes, and the
    coordinator's log alone); the outputs equal the single-process
    command's; the --plot-genes split over the ranks."""
    base = tmp_path / "mh"
    base.mkdir()
    args = ["--bam-files", *dataset["bams"], "-g", dataset["gtf"], *FIT,
            *PLOT, "--device", "cpu", "-o", str(base), "--multihost"]
    outs = run_ranks(lambda r: [sys.executable, "-m", "degnorm_tpu_torch",
                                *args], timeout=240)
    runs = [p for p in os.listdir(base) if p.startswith("degnorm_")]
    assert len(runs) == 1, runs
    run = os.path.join(base, runs[0])
    assert not [p for p in os.listdir(run) if p.startswith(".etl")]
    names = [os.path.basename(b).rsplit(".", 1)[0] for b in dataset["bams"]]
    for r, out in enumerate(outs):
        mine = names[r::2]
        theirs = [s for s in names if s not in mine]
        assert ("multi-process ETL: this process owns "
                f"{len(mine)}/3 sample(s): {', '.join(mine)}") in out
        for s in mine:
            assert f"SAMPLE {s}: computing coverage/read counts" in out
        for s in theirs:
            assert f"SAMPLE {s}: computing coverage/read counts" not in out
            assert f"SAMPLE {s}: loading another process's artifacts" in out
        assert f"[rank {r}]" in out
    assert "plotting coverage for 1 gene(s): gene000" in outs[0]
    assert "plotting coverage for 1 gene(s): gene001" in outs[1]
    with open(os.path.join(run, "degnorm.log")) as f:
        log = f.read()
    assert "[rank 0]" in log and "[rank 1]" not in log

    solo_base = tmp_path / "solo"
    solo_base.mkdir()
    assert tcli.main(["--bam-files", *dataset["bams"], "-g", dataset["gtf"],
                      *FIT, *PLOT, "--device", "cpu", "-o",
                      str(solo_base)]) == 0
    (solo,) = [os.path.join(solo_base, p) for p in os.listdir(solo_base)]
    _assert_same_outputs(run, solo)
    di = pd.read_csv(os.path.join(run, "degradation_index_scores.csv"))
    assert len(di) > 0 and np.isfinite(di.iloc[:, 2:].to_numpy()).all()


_GROUP_OF_ONE = r"""
import torch
from degnorm_tpu_torch.parallel import distributed
distributed.initialize_multihost(device="cpu")
assert torch.distributed.is_initialized()
assert torch.distributed.get_backend() == "gloo"
assert (distributed.process_index(), distributed.process_count()) == (0, 1)
rows = torch.arange(6.0).reshape(3, 2)
got = distributed.gather_rows(rows)
assert torch.equal(got, rows) and got is not rows
flags = distributed.gather_rows(torch.tensor([True, False]))
assert flags.dtype == torch.bool and flags.tolist() == [True, False]
assert distributed.broadcast_string("å-π") == "å-π"
distributed.barrier("one")
distributed.shutdown()
assert not torch.distributed.is_initialized()
print("GROUP OK", flush=True)
"""


def test_a_group_of_one_runs_the_collectives():
    """With a coordinator address one process forms a group of its own (as
    jax.distributed does), and the gather, broadcast and barrier run
    through the backend: the gloo counterpart of chip_smoke.py's
    one-process NCCL group."""
    (out,) = run_ranks(lambda r: [sys.executable, "-c", _GROUP_OF_ONE], n=1)
    assert "GROUP OK" in out
