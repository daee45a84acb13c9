"""Sharded fits over several devices and processes (counterpart of
``degnorm_tpu/parallel/``): buckets cut along their genes (``sharded``), and
the outlier buckets along their columns (``seqpar``)."""
from degnorm_tpu_torch.parallel.sharded import (  # noqa: F401
    GeneMesh, make_mesh, shard_bucket, shard_slots, sharded_iteration_step)
