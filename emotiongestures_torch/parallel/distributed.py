"""Processes and their group (port of emotiongestures_tpu/parallel/
distributed.py).

The JAX package runs one process per TPU host and lets GSPMD place the
global batch on every chip of the pod. The port runs one process per card:
a process is a rank of the default `torch.distributed` group, and the data
parallelism of `parallel/mesh.py` is written out between those ranks.

  1. every process calls `initialize(coordinator, num_processes,
     process_id)`; with no argument, the group comes from torchrun's
     environment (`env://`), the counterpart of the TPU pod's
     auto-detection; a group that is already up is joined as it is;
  2. each process loads only its rows of every global batch
     (`process_batch_slice`);
  3. rank 0's parameters and buffers are broadcast (`broadcast_module`):
     weights built from one seed are equal already, the broadcast makes it
     a fact;
  4. the same train step runs in every process; its collectives (the
     global BatchNorm statistics, TMMemory's batch coupling, the
     contrastive terms' gathers, the gradient mean) are in `mesh.py`.

Only the primary process (`is_primary`) writes checkpoints and logs.
`barrier` takes the place of the JAX `coordination_barrier`.

Under tensor parallelism (`set_grid`) the ranks form the JAX package's
`devices.reshape(n_data, n_model)` mesh: global rank r is data index
r // n_model and model index r % n_model. The ranks of one model index
form a data group (the batch's rows are split over it), those of one data
index a model group (they hold one row slice and split the weights).

The backend is NCCL for a card and gloo for the CPU. An explicit "gloo" on
a card (the JAX `cpu_collectives`) lets two ranks share one card, which
NCCL refuses: gloo moves CUDA tensors through the host.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# a rank that waits longer than this in a collective raises instead of
# hanging (torch's default for NCCL is 10 minutes, for gloo 30)
TIMEOUT = datetime.timedelta(minutes=10)

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None, device=None):
    """Join (or form) the group of processes. Returns (process_index,
    process_count).

    The three arguments go together: `coordinator_address` is the
    `host:port` of process 0, where the group meets. With none of them the
    group comes from torchrun's environment. A group that is already
    initialised is joined as it is. `backend` None is NCCL when `device`
    (default: the card) is CUDA and gloo for the CPU."""
    if is_initialized():
        return dist.get_rank(), dist.get_world_size()
    given = [coordinator_address, num_processes, process_id]
    if all(v is not None for v in given):
        init = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    elif any(v is not None for v in given):
        raise ValueError("give --coordinator_address, --num_processes and "
                         "--process_id together, or none of them")
    elif all(k in os.environ for k in TORCHRUN_ENV):
        init = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        raise ValueError(
            "no process group to join: pass coordinator_address, "
            "num_processes and process_id, or start under torchrun")
    _init(init, world, rank, backend, device)
    return rank, world


def _init(init_method: str, world: int, rank: int, backend=None,
          device=None) -> None:
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} is outside 0..{world - 1}")
    if backend is None:
        dev = torch.device("cuda" if device is None else device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=TIMEOUT)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    """This process's index among the processes of its host: torchrun's
    LOCAL_RANK, else the global index modulo the host's cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    cards = torch.cuda.device_count()
    return process_index() % cards if cards else process_index()


# (n_data, n_model, data group, model group, the data group's gloo twin
# for host tensors or None) on a grid of more than one model index
_grid = None


def set_grid(n_model: int) -> None:
    """Lay the group's ranks out as n_data x n_model (one data group per
    model index, one model group per data index); 1 is no grid. Every rank
    calls it, with the same value (it makes process groups). Setting the
    grid it already has is a no-op."""
    global _grid
    n_model = int(n_model)
    if _grid is not None and _grid[1] == n_model:
        return
    _grid = None
    if n_model <= 1:
        return
    world = process_count()
    if world % n_model:
        raise ValueError(f"model parallel {n_model} does not divide the "
                         f"{world} processes of the group")
    n_data = world // n_model
    host = dist.get_backend() == "nccl"
    r = process_index()
    data = model = data_host = None
    for m in range(n_model):  # every rank makes every group, in order
        ranks = [d * n_model + m for d in range(n_data)]
        g = dist.new_group(ranks)
        h = dist.new_group(ranks, backend="gloo") if host else None
        if r % n_model == m:
            data, data_host = g, h
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if r // n_model == d:
            model = g
    _grid = (n_data, n_model, data, model, data_host)


def model_count() -> int:
    """Ranks that split one model's weights (1 off a grid)."""
    return _grid[1] if _grid else 1


def model_index() -> int:
    return process_index() % _grid[1] if _grid else 0


def data_count() -> int:
    """Ranks that split the global batch's rows."""
    return _grid[0] if _grid else process_count()


def data_index() -> int:
    return process_index() // _grid[1] if _grid else process_index()


def data_group():
    """This rank's data group; None (the whole group) off a grid."""
    return _grid[2] if _grid else None


def model_group():
    return _grid[3] if _grid else None


def process_batch_slice(n_global: int) -> slice:
    """The half-open row range of the global batch this process loads: its
    data index's share, so the model ranks of one data group load the same
    rows. Requires the global batch to divide evenly over the data axis."""
    n_proc = data_count()
    if n_global % n_proc:
        raise ValueError(
            f"global batch {n_global} must divide across {n_proc} "
            "processes")
    per = n_global // n_proc
    i = data_index()
    return slice(i * per, (i + 1) * per)


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs."""
    return process_index() == 0


def barrier() -> None:
    """Every process of the group waits here for the others; a no-op in
    one process."""
    if process_count() > 1:
        dist.barrier()


def broadcast_module(module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers into every rank's `module`, in
    place (the JAX `replicate_to_global`)."""
    if process_count() > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return module


_host_group = None


def host_sum(t: torch.Tensor, data_axis: bool = False) -> torch.Tensor:
    """The sum over the processes (`data_axis`: over this rank's data
    group) of a small CPU tensor (flags, counts): beside NCCL through a
    gloo group of its own, so that it neither touches the card nor waits
    for its stream."""
    global _host_group
    group = data_group() if data_axis else None
    if dist.get_backend() == "nccl":
        if data_axis and _grid:
            group = _grid[4]
        else:
            if _host_group is None:
                _host_group = dist.new_group(backend="gloo")
            group = _host_group
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def shutdown() -> None:
    global _host_group, _grid
    if is_initialized():
        dist.destroy_process_group()
    _host_group = None
    _grid = None
