"""Data parallelism and multiple processes (port of
emotiongestures_tpu/parallel/): one process per card, global-batch
semantics written out between the ranks (`mesh.py`), the process group and
its rows of each batch (`distributed.py`). Tensor parallelism is
ROADMAP.md queue 1, item 6b."""
from . import distributed  # noqa: F401
from .distributed import broadcast_module, process_batch_slice  # noqa: F401
from .mesh import (  # noqa: F401
    all_gather,
    all_reduce_mean,
    all_reduce_sum,
    dp_setup,
    launch,
    resolve_num_devices,
)
