"""Data parallelism over processes (port of emotiongestures_tpu/parallel/
mesh.py:53-88).

The JAX package jits one train step over a `data` mesh and GSPMD makes it
equal to one device on the global batch: BatchNorm normalises over the
global batch, TMMemory's `mem @ (mem.T @ pe)` couples the global batch, the
contrastive terms build B x B matrices over it and a dropout mask is a slice
of one global draw. The port runs one process per card and writes each of
these out, so that R ranks compute what one process computes on the whole
batch, up to float reassociation:

  * `all_reduce_sum` (backward: a sum all-reduce) for BatchNorm's
    (sum x, sum x^2) and TMMemory's (D, C) product;
  * `all_gather` (backward: this rank's rows of the summed gradient) for
    the contrastive features;
  * `rank_rows` / `global_rand` / `global_randn`: a draw for the global
    batch from the step's generator, of which each rank keeps its rows;
  * `all_reduce_mean`: the gradients' mean, one collective per dtype.

Each rank's loss is then its share of the one-process loss, L = (1/R) sum
L_r, and the mean of the ranks' gradients is the one-process gradient.
`torch.nn.parallel.DistributedDataParallel` is not used: it does not work
with `torch.autograd.grad`, which every trainer of the port takes.

`resolve_num_devices` and `dp_setup` keep the JAX semantics of
--num_devices: 0 is every visible card, degraded to the largest count that
divides the batch; an explicit count that cannot shard the batch, or that
exceeds the visible cards, is a SystemExit. On the CPU, 0 means one process
and ranks start only when a count is given (the JAX package's CPU tests see
8 virtual devices instead). `launch` starts one process per rank.

Tensor parallelism (port of mesh.py:91-158, `--model_parallel N`): the
ranks form an n_data x n_model grid (`distributed.set_grid`, `tp_setup`),
and every collective above runs over this rank's data group: `world()` and
`rank()` are the data axis's size and index, so BatchNorm, TMMemory, the
contrastive terms, the dropout draws and the gradient mean see each row
once. The model group splits the FFN and MHA weights
(`parallel/tensor.py`) and joins their partial products with Megatron's
two operators: `model_copy` (identity forward, sum all-reduce backward)
where a replicated activation enters a sharded layer, `model_sum` (sum
all-reduce forward, identity backward) where its partial output leaves.
"""
from __future__ import annotations

import contextlib
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from . import distributed

_single = False  # single_process() in force


def world() -> int:
    """The number of data-parallel ranks (the data axis of a grid): 1
    outside a group, or inside `single_process()`."""
    return 1 if _single else distributed.data_count()


def rank() -> int:
    """This rank's index on the data axis."""
    return 0 if _single else distributed.data_index()


def active() -> bool:
    return world() > 1


@contextlib.contextmanager
def single_process():
    """The block computes as one process on its own rows, inside a group:
    no collective, no slice of a global draw."""
    global _single
    before, _single = _single, True
    try:
        yield
    finally:
        _single = before


def visible_devices(device) -> int:
    """Cards for a CUDA device; on the CPU, the host's cores."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def resolve_num_devices(num_devices: int, device="cuda") -> int:
    """CLI `--num_devices` semantics: 0 = auto (every visible card; one
    process on the CPU), N > 0 = exactly N (a SystemExit if fewer are
    visible)."""
    avail = visible_devices(device)
    if num_devices == 0:
        return avail if torch.device(device).type == "cuda" else 1
    if num_devices > avail:
        raise SystemExit(
            f"--num_devices {num_devices} requested but only {avail} "
            f"{torch.device(device).type} device(s) visible")
    return num_devices


def dp_setup(num_devices: int, batch_size: int, device="cuda"):
    """The number of data-parallel ranks for a CLI, None when the run is
    one process.

    Auto mode (num_devices=0) degrades like the reference's DataParallel:
    if the global batch does not divide across all visible cards, the
    largest count that does divide it is used (worst case 1). An explicit
    count that cannot shard the batch is an error: the user asked for
    exactly that."""
    n = resolve_num_devices(num_devices, device)
    if num_devices == 0:
        while n > 1 and batch_size % n:
            n -= 1
    elif n > 1 and batch_size % n:
        raise SystemExit(
            f"--batch_size {batch_size} must be divisible by the "
            f"{n}-device data mesh")
    return None if n <= 1 else n


def tp_setup(num_devices: int, model_parallel: int, batch_size: int,
             device="cuda"):
    """The (n_data, n_model) grid of a `--model_parallel` run, None when it
    is 1 x 1 (mesh.py:91-111). `num_devices` keeps the semantics of
    `resolve_num_devices`; the device count must factor as n_data x
    model_parallel and the global batch must divide over n_data."""
    return _grid(resolve_num_devices(num_devices, device), model_parallel,
                 batch_size)


def _grid(n: int, model_parallel: int, batch_size: int):
    if n % model_parallel:
        raise SystemExit(
            f"--model_parallel {model_parallel} must divide the "
            f"{n}-device mesh")
    n_data = n // model_parallel
    if n_data > 1 and batch_size % n_data:
        raise SystemExit(
            f"--batch_size {batch_size} must be divisible by the "
            f"data axis ({n_data} = {n} devices / "
            f"{model_parallel}-way model parallel)")
    if n_data == 1 and model_parallel == 1:
        return None
    return n_data, model_parallel


# ---------------------------------------------------------------------------
# the CLIs' rule: join a group, or start one
# ---------------------------------------------------------------------------

def multihost(args) -> bool:
    return any(getattr(args, k, None) is not None for k in
               ("coordinator_address", "num_processes", "process_id"))


def plan(args, batch_size: int, device) -> int:
    """How a CLI run is laid out, before anything is built. Returns the
    number of processes this run needs: 1, or the ranks of the group this
    process has joined (the multi-host flags, torchrun, or a group that
    its caller initialised), or more than 1 with no group yet, when the
    caller starts them with `launch`. In a group, `--model_parallel`
    lays the ranks out as a grid (`distributed.set_grid`)."""
    model_parallel = getattr(args, "model_parallel", 1)
    if model_parallel < 1:
        raise SystemExit(f"--model_parallel must be >= 1, got "
                         f"{model_parallel}")
    mh = multihost(args)
    torchrun = all(k in os.environ for k in distributed.TORCHRUN_ENV)
    if not distributed.is_initialized() and (mh or torchrun):
        if mh:
            n = args.num_processes
            if n is None or args.coordinator_address is None or \
                    args.process_id is None:
                raise SystemExit("give --coordinator_address, "
                                 "--num_processes and --process_id together")
            if not 0 <= args.process_id < n:
                raise SystemExit(f"--process_id {args.process_id} is "
                                 f"outside 0..{n - 1}")
        else:
            n = int(os.environ["WORLD_SIZE"])
        _check_group(args, batch_size, n)
        distributed.initialize(
            getattr(args, "coordinator_address", None),
            getattr(args, "num_processes", None),
            getattr(args, "process_id", None), device=device)
    if distributed.is_initialized():
        n = distributed.process_count()
        _check_group(args, batch_size, n)
        distributed.set_grid(model_parallel)
        return n
    if model_parallel > 1:
        grid = tp_setup(args.num_devices, model_parallel, batch_size, device)
        return 1 if grid is None else grid[0] * grid[1]
    return dp_setup(args.num_devices, batch_size, device) or 1


def _check_group(args, batch_size: int, n: int) -> None:
    if args.num_devices not in (0, n):
        raise SystemExit(f"--num_devices {args.num_devices} disagrees with "
                         f"the {n} processes of the group (one per card)")
    model_parallel = getattr(args, "model_parallel", 1)
    if model_parallel > 1:
        _grid(n, model_parallel, batch_size)
        return
    if batch_size % n:
        raise SystemExit(f"--batch_size {batch_size} must divide over the "
                         f"{n}-process global mesh")


def rank_device(device) -> torch.device:
    """The device of this process: on a card in a group, the card of its
    local rank (made current); otherwise `device` itself."""
    device = torch.device(device)
    if device.type == "cuda" and distributed.is_initialized():
        device = torch.device("cuda", distributed.local_rank())
        torch.cuda.set_device(device)
    return device


def launch(fn, nprocs: int, *args, device="cuda", backend=None,
           timeout: float | None = None, threads: int | None = None):
    """Run `fn(*args)` in `nprocs` new processes (the `spawn` start
    method), joined in one group: rank i on `cuda:{i % cards}` for a card,
    or the CPU. Returns each rank's result (picklable), rank order. A
    failed rank stops the others and raises its traceback here; a run
    longer than `timeout` seconds is killed and raises TimeoutError.
    `threads` caps each CPU rank's torch threads."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    store = tempfile.mkdtemp(prefix="egtp_group_")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=False,
        args=(fn, args, r, nprocs, f"file://{store}/rendezvous",
              str(device), backend, threads, results))
        for r in range(nprocs)]
    for p in procs:
        p.start()
    out, failed = {}, None
    start = time.monotonic()
    try:
        while len(out) < nprocs and failed is None:
            try:
                r, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    failed = (f"rank {procs.index(dead[0])} exited with "
                              f"code {dead[0].exitcode}")
                elif timeout is not None and \
                        time.monotonic() - start > timeout:
                    raise TimeoutError(f"{nprocs} ranks did not finish "
                                       f"within {timeout} s")
                continue
            if ok:
                out[r] = payload
            else:
                failed = f"rank {r} failed:\n{payload}"
        if failed is not None:
            raise RuntimeError(failed)
        for p in procs:
            p.join(timeout=60)
        return [out[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        shutil.rmtree(store, ignore_errors=True)


def _rank_main(fn, args, r, nprocs, init, device, backend, threads, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        os.environ["LOCAL_RANK"] = str(r % max(visible_devices(device), 1))
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        distributed._init(init, nprocs, r, backend, dev)
        try:
            results.put((r, True, fn(*args)))
        finally:
            distributed.shutdown()
    except BaseException:
        results.put((r, False, traceback.format_exc()))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _wide(x: torch.Tensor) -> torch.Tensor:
    """Low-precision floats go over the wire in fp32."""
    if x.is_floating_point() and x.dtype not in (torch.float32,
                                                 torch.float64):
        return x.float()
    return x


def _comm(x: torch.Tensor) -> torch.Tensor:
    """A tensor the backend takes: NCCL moves only CUDA tensors."""
    if dist.get_backend() == "nccl" and x.device.type != "cuda":
        return x.to(torch.device("cuda", torch.cuda.current_device()))
    return x


def _sum_(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over `group`, by default this rank's data group."""
    y = _comm(_wide(x).contiguous().clone())
    dist.all_reduce(y, group=distributed.data_group() if group is None
                    else group)
    return y.to(device=x.device, dtype=x.dtype)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _sum_(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_(g)


class _ModelCopy(torch.autograd.Function):
    """Megatron's f: a replicated activation into a sharded layer."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _sum_(g, distributed.model_group())


class _ModelSum(torch.autograd.Function):
    """Megatron's g: a sharded layer's partial output summed."""

    @staticmethod
    def forward(ctx, x):
        return _sum_(x, distributed.model_group())

    @staticmethod
    def backward(ctx, g):
        return g


def model_copy(x: torch.Tensor) -> torch.Tensor:
    """`x` itself; its gradient is summed over the model group."""
    return _ModelCopy.apply(x) if distributed.model_count() > 1 else x


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of the model group's partial outputs (in fp32 on the wire);
    the gradient passes through unchanged."""
    return _ModelSum.apply(x) if distributed.model_count() > 1 else x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _gather(x)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[0] // world()
        return _sum_(g)[rank() * n:(rank() + 1) * n]


def _gather(x: torch.Tensor) -> torch.Tensor:
    """(R * n, ...) from every rank's (n, ...), rank order. NCCL gathers;
    gloo, which gathers no CUDA tensor, sums zeros around each rank's rows
    (exact)."""
    n = x.shape[0]
    w = _comm(_wide(x).contiguous())
    out = w.new_zeros((world() * n,) + tuple(x.shape[1:]))
    group = distributed.data_group()
    if dist.get_backend() == "nccl":
        dist.all_gather_into_tensor(out, w, group=group)
    else:
        out[rank() * n:(rank() + 1) * n] = w
        dist.all_reduce(out, group=group)
    return out.to(device=x.device, dtype=x.dtype)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, on every rank; differentiable (the
    gradient of the sum is the sum of the ranks' gradients). `x` itself in
    one process."""
    return _AllReduceSum.apply(x) if active() else x


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` stacked along dim 0 in rank order; differentiable
    (the backward keeps this rank's rows of the summed gradient). `x`
    itself in one process."""
    if not active():
        return x
    return _AllGather.apply(x) if x.requires_grad else _gather(x)


def all_reduce_mean(tensors) -> list:
    """The mean over the ranks of each tensor: one collective per dtype on
    one flat buffer (not one per tensor). Returns new tensors."""
    tensors = list(tensors)
    if not active():
        return tensors
    out = [None] * len(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = _sum_(torch.cat([tensors[i].reshape(-1) for i in idx]))
        flat /= world()
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def mean_metrics(metrics: dict) -> dict:
    """0-d metric tensors averaged over the ranks in one collective: each
    rank's loss is its share of the global batch's, so the mean is the
    one-process value."""
    if not active() or not metrics:
        return metrics
    keys = list(metrics)
    means = all_reduce_mean([torch.stack(
        [metrics[k].float() for k in keys])])[0]
    return dict(zip(keys, means.unbind()))


def _grouped() -> bool:
    return not _single and distributed.process_count() > 1


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is true on one (a signal that reached
    one process stops them all at the same step); every rank of the group,
    both axes of a grid."""
    if not _grouped():
        return bool(flag)
    return bool(distributed.host_sum(torch.tensor([int(flag)])).item())


def same_on_ranks(value: int, what: str) -> int:
    """Raise unless every rank of the group holds the same integer
    `value`."""
    if _grouped():
        s, s2 = distributed.host_sum(
            torch.tensor([value, value * value], dtype=torch.int64)).tolist()
        if s2 * distributed.process_count() != s * s:
            raise RuntimeError(f"ranks disagree on {what} (this rank: "
                               f"{value})")
    return value


# ---------------------------------------------------------------------------
# one global draw, each rank's rows
# ---------------------------------------------------------------------------

def rank_rows(full: torch.Tensor, n: int, blocks: int = 1) -> torch.Tensor:
    """This rank's rows of a tensor drawn for the global batch: `full` holds
    `blocks` blocks of R * n rows each (the global batch, or several
    batches concatenated), of which this rank keeps rows [r n, (r + 1) n)
    of every block, in order."""
    R, r = world(), rank()
    parts = [full[(j * R + r) * n:(j * R + r + 1) * n]
             for j in range(blocks)]
    return parts[0] if blocks == 1 else torch.cat(parts)


def global_rand(shape, generator=None, device=None, blocks: int = 1):
    """torch.rand(shape) of this rank's rows, drawn for the global batch:
    every rank draws the (R * shape[0], ...) tensor that one process would
    and keeps its rows, so masks equal the one-process run's and no two
    ranks share one."""
    if world() == 1:
        return torch.rand(shape, generator=generator, device=device)
    n = shape[0] // blocks
    full = torch.rand((world() * shape[0],) + tuple(shape[1:]),
                      generator=generator, device=device)
    return rank_rows(full, n, blocks)


def global_randn(shape, generator=None, device=None, dtype=None):
    """torch.randn(shape) of this rank's rows, drawn for the global batch
    (the CVAE's noise), as `global_rand`."""
    if world() == 1:
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype)
    full = torch.randn((world() * shape[0],) + tuple(shape[1:]),
                       generator=generator, device=device, dtype=dtype)
    return rank_rows(full, shape[0])
