"""The port stands alone: importing it (and chip_smoke) loads neither jax nor
the JAX package, and its entry points refuse to run on the CPU unless asked."""
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "degnorm_tpu_torch")


def _run(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_loads_neither_jax_nor_the_jax_package():
    r = _run(
        "import sys\n"
        "import degnorm_tpu_torch\n"
        "import degnorm_tpu_torch.engine, degnorm_tpu_torch.convert\n"
        "import degnorm_tpu_torch.core.baseline, degnorm_tpu_torch.core.degnorm\n"
        "import degnorm_tpu_torch.ops.cuda_nmf, degnorm_tpu_torch.ops.cuda_trim\n"
        "import degnorm_tpu_torch.ops.build, degnorm_tpu_torch.data.buckets\n"
        "import degnorm_tpu_torch.ops.cuda_stream\n"
        "import degnorm_tpu_torch.cli, degnorm_tpu_torch.__main__\n"
        "import degnorm_tpu_torch.io.bgzf, degnorm_tpu_torch.io.bam\n"
        "import degnorm_tpu_torch.io.bai, degnorm_tpu_torch.io.gtf\n"
        "import degnorm_tpu_torch.io.overlap, degnorm_tpu_torch.io.coverage\n"
        "import degnorm_tpu_torch.io.coverage_native\n"
        "import degnorm_tpu_torch.io.merge, degnorm_tpu_torch.io.simulate\n"
        "import degnorm_tpu_torch.io.native.build\n"
        "import degnorm_tpu_torch.pipeline.sample\n"
        "import degnorm_tpu_torch.pipeline.outputs\n"
        "import degnorm_tpu_torch.pipeline.warm_start\n"
        "import degnorm_tpu_torch.pipeline.checkpoints\n"
        "import degnorm_tpu_torch.pipeline.run\n"
        "import degnorm_tpu_torch.report.report\n"
        "import degnorm_tpu_torch.report.data_access\n"
        "import degnorm_tpu_torch.report.visualizations\n"
        "import degnorm_tpu_torch.oracle, degnorm_tpu_torch.oracle.nmfoa\n"
        "import degnorm_tpu_torch.testing, degnorm_tpu_torch.core.prng\n"
        "import degnorm_tpu_torch.data.encode, degnorm_tpu_torch.io.rans\n"
        "import degnorm_tpu_torch.io.cram, degnorm_tpu_torch.io.cram_fast\n"
        "import degnorm_tpu_torch.parallel\n"
        "import degnorm_tpu_torch.parallel.sharded\n"
        "import degnorm_tpu_torch.parallel.distributed\n"
        "import degnorm_tpu_torch.parallel.dryrun\n"
        "import degnorm_tpu_torch.parallel.seqpar\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'degnorm_tpu' or m.startswith('degnorm_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean')\n")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("clean")


def test_no_import_statement_names_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|degnorm_tpu)(\.|\s|$)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            for no, line in enumerate(f, 1):
                assert not pat.match(line), f"{path}:{no}: {line.strip()}"


def test_every_module_imports_without_a_gpu_toolchain():
    """No module builds a kernel or needs nvcc at import time, and the
    command's modules build no host library and load no plotting library
    on import."""
    r = _run("import sys\n"
             "import degnorm_tpu_torch.ops.build as b\n"
             "import degnorm_tpu_torch.cli, degnorm_tpu_torch.pipeline.run\n"
             "import degnorm_tpu_torch.io.native.build as h\n"
             "import degnorm_tpu_torch.data.buckets, degnorm_tpu_torch.io.cram\n"
             "import degnorm_tpu_torch.io.cram_fast, degnorm_tpu_torch.io.rans\n"
             "assert b._lib is None and not b.build_info\n"
             "assert h._LIB is None\n"
             "assert 'matplotlib' not in sys.modules\n"
             "print(sorted(b._SIGNATURES))\n")
    assert r.returncode == 0, r.stderr
    assert "dn_nmf_masked" in r.stdout and "dn_trim_loop" in r.stdout
    assert "dn_nmf_streamed" in r.stdout


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    from degnorm_tpu_torch import EngineConfig
    from degnorm_tpu_torch.convert import (buckets_from_numpy,
                                           global_state_from_numpy)
    from degnorm_tpu_torch.engine import DegNormEngine
    import numpy as np
    assert EngineConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        DegNormEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        buckets_from_numpy(np.zeros((1, 2, 8), np.float32), [8], [0], 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        global_state_from_numpy(*([np.zeros((1, 2))] * 4 + [np.ones(2)] * 2))
    DegNormEngine(eng_cfg=EngineConfig(device="cpu"))    # asked for: fine


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("kw", [dict(trim_fast=True), dict(nmf_tol=1e-4),
                                dict(rank1_method="eigh"),
                                dict(stream_nmf=False)])
def test_unported_opt_in_modes_raise(kw):
    """Only stream_nmf=False is still refused (not carried over); the
    three opt-in modes are ported and accepted."""
    from degnorm_tpu_torch import EngineConfig
    if "stream_nmf" in kw:
        with pytest.raises(NotImplementedError):
            EngineConfig(**kw)
    else:
        cfg = EngineConfig(**kw)
        assert all(getattr(cfg, k) == v for k, v in kw.items())
