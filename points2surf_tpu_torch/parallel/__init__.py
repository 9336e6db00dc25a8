"""Multi-process data parallelism: ``torchrun`` ranks with batch statistics
summed across them (``distributed``), replication and batch sharding
(``mesh``)."""

from points2surf_tpu_torch.parallel import distributed  # noqa: F401
from points2surf_tpu_torch.parallel.mesh import (  # noqa: F401
    replicate,
    shard_batch,
)
