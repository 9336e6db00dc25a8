"""Multi-process data and tensor parallelism: ``torchrun`` ranks on a
``(data, model)`` grid with batch statistics summed across the data ranks
(``distributed``), the grid, replication and batch sharding (``mesh``), and
the wide layers' column blocks over the model ranks (``sharding``)."""

from points2surf_tpu_torch.parallel import distributed  # noqa: F401
from points2surf_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    replicate,
    replicate_array,
    shard_batch,
)
from points2surf_tpu_torch.parallel.sharding import (  # noqa: F401
    gather_full,
    param_spec,
    partition_like,
    partition_params,
)
