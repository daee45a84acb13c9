"""degnorm_tpu_torch: the PyTorch/CUDA port of the DegNorm NMF-OA engine.

Module names mirror the JAX package (``degnorm_tpu``) so a reader finds the
counterpart of each file; this package imports ``torch`` and ``numpy``, its
host layer (``io/``, ``pipeline/``) ``pandas`` and ``scipy``, and its report
matplotlib, seaborn and jinja2 when it renders — nothing of ``jax`` or of
``degnorm_tpu``.  ``python -m degnorm_tpu_torch`` is the ``degnorm`` command.
The four hot kernels (Lagrangian NMF loop, ratio-SVD row sums, fused
baseline-selection trim loop, and the streamed NMF loop of wide buckets) are
CUDA C++ sources under ``csrc/``, built on first use by ``ops/build.py``.  Entry points run on the GPU unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from degnorm_tpu_torch.config import EngineConfig, NMFConfig  # noqa: F401


def DegNormEngine(*args, **kwargs):
    """Convenience constructor re-export (lazy import)."""
    from degnorm_tpu_torch.engine import DegNormEngine as _E
    return _E(*args, **kwargs)
