"""Data and tensor parallelism over processes (port of
emotiongestures_tpu/parallel/): one process per card, global-batch
semantics written out between the ranks (`mesh.py`), the process group,
its data x model grid and its rows of each batch (`distributed.py`), and
the Megatron shard rules of the FFN and MHA weights (`tensor.py`)."""
from . import distributed  # noqa: F401
from .distributed import broadcast_module, process_batch_slice  # noqa: F401
from .mesh import (  # noqa: F401
    all_gather,
    all_reduce_mean,
    all_reduce_sum,
    dp_setup,
    launch,
    resolve_num_devices,
    tp_setup,
)
