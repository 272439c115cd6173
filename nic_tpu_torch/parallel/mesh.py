"""Process groups, their launcher and the collectives the port uses
(counterpart of nic_tpu/parallel/mesh.py).

nic_tpu runs one process per host, which owns all of that host's chips, and
shards arrays over a 1-D 'data' mesh. The port runs one process per rank and
one rank per card: a rank is a process, and ``--num_processes`` counts ranks.
Ranks talk through ``torch.distributed``:
- NCCL when every rank has a card of its own (``cuda:{LOCAL_RANK}``);
- gloo on the CPU, and gloo on CUDA tensors when several ranks share one
  card (``backend="gloo"``, device "cuda"), which gloo stages through the
  host. Nothing switches backend on its own: NCCL with more ranks than cards
  raises.

``Comm`` holds a group and offers the two collectives the port needs,
``all_gather`` and ``all_reduce`` (sum), which NCCL and gloo both take on
CUDA tensors, and ``average_grad``, an all-reduce in the backward. A group
of one rank still runs them (NCCL at world size 1 takes the path of a node
of cards); with no group there is one rank and each is the identity. It
counts the calls and the bytes it sends and, when ``timed`` is set, the
host time spent in them with the device synchronised on both sides.
"""

import os
import pickle
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from nic_tpu_torch.config import resolve_device

# How long a collective may wait for the other ranks before it fails.
DEFAULT_TIMEOUT_S = 600
# Gloo ranks that ``--data_parallel`` and ``--spatial`` run with --device cpu
# (on the card they run one rank per visible card).
CPU_RANKS_ENV = "NIC_TPU_TORCH_CPU_RANKS"


def visible_ranks(device) -> int:
    """Ranks a data-parallel or spatial command runs: one per visible card,
    or ``NIC_TPU_TORCH_CPU_RANKS`` (default 1) gloo ranks on the CPU."""
    if resolve_device(device).type == "cuda":
        return torch.cuda.device_count()
    return int(os.environ.get(CPU_RANKS_ENV, "1"))


def default_backend(device) -> str:
    """NCCL on the card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_group(init_method: str, world_size: int, rank: int, device="cuda",
               backend: Optional[str] = None) -> torch.device:
    """Join the default process group; returns this rank's device.

    ``backend`` defaults to the device's (``default_backend``). Under NCCL
    the rank takes card ``cuda:{LOCAL_RANK}``, or ``cuda:{rank % cards}``
    when ``LOCAL_RANK`` is not set (ranks numbered host by host), and raises
    when this host has no such card. Under gloo it keeps the caller's
    device, so several ranks can share one card."""
    device = resolve_device(device)
    backend = backend or default_backend(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("NCCL needs the card; use backend='gloo' on the CPU")
        count = torch.cuda.device_count()
        local_rank = int(os.environ.get("LOCAL_RANK", rank % count))
        if local_rank >= count:
            raise RuntimeError(_too_few_cards(f"rank {rank} needs card cuda:{local_rank}",
                                              count))
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    elif backend != "gloo":
        raise ValueError(f"unsupported backend {backend!r}")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timedelta(seconds=DEFAULT_TIMEOUT_S))
    return device


def _too_few_cards(need: str, count: int) -> str:
    return (f"{need}, but this host has {count} card(s): NCCL takes one rank per card "
            "(backend='gloo' lets ranks share a card)")


def initialize_multihost(coordinator_address: str, num_processes: int, process_id: int,
                         device="cuda") -> torch.device:
    """Multi-host training: join the ranks that meet at ``host:port`` over
    TCP. ``num_processes`` counts ranks (one per card), not hosts."""
    return init_group(f"tcp://{coordinator_address}", num_processes, process_id, device)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


class Comm:
    """The collectives of one process group (None: one rank, no group)."""

    def __init__(self, group=None):
        self.group = group
        self.size = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.calls = 0
        self.bytes = 0
        self.ms = 0.0
        self.timed = False

    def _run(self, op, tensor: torch.Tensor):
        self.calls += 1
        self.bytes += tensor.numel() * tensor.element_size()
        if not self.timed:
            return op()
        sync = torch.cuda.synchronize if tensor.is_cuda else (lambda: None)
        sync()
        t = time.perf_counter()
        out = op()
        sync()
        self.ms += (time.perf_counter() - t) * 1e3
        return out

    def all_reduce(self, tensor: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Sum (or ``op``) over the ranks, in place; returns the tensor."""
        if self.group is not None:
            self._run(lambda: dist.all_reduce(tensor, op=op, group=self.group), tensor)
        return tensor

    def max(self, tensor: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the ranks, in ``tensor``'s dtype (a
        new tensor; reduced in float32, which holds a bfloat16 exactly)."""
        if self.group is None:
            return tensor
        return self.all_reduce(tensor.float().clone(), dist.ReduceOp.MAX).to(tensor.dtype)

    def all_gather(self, tensor: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's tensor (each of the same shape), in rank order."""
        if self.group is None:
            return [tensor]
        tensor = tensor.contiguous()
        out = [torch.empty_like(tensor) for _ in range(self.size)]
        self._run(lambda: dist.all_gather(out, tensor, group=self.group), tensor)
        return out

    def all_gather_cat(self, tensor: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.cat(self.all_gather(tensor), dim=dim)

    def average_grad(self, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor`` itself, whose gradient is averaged over the ranks on
        its way back (with no group, ``tensor``)."""
        if self.group is None:
            return tensor
        return _AverageGrad.apply(tensor, self)

    def shard(self, size: int):
        """This rank's [start, stop) of ``size`` items split evenly."""
        if size % self.size:
            raise ValueError(f"{size} items do not split over {self.size} ranks")
        step = size // self.size
        return self.rank * step, (self.rank + 1) * step


class _AverageGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm: Comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.comm.all_reduce(g) / ctx.comm.size, None


# ------------------------------------------------------------------ launcher


def _rank_main(rank: int, world_size: int, fn: Callable, args: Sequence, device,
               backend: Optional[str], init_method: str, queue) -> None:
    try:
        rank_device = init_group(init_method, world_size, rank, device, backend)
        # Pickled here, by value: torch's queue would pass a tensor's storage
        # as a file descriptor, which dies with this process.
        queue.put((rank, True, pickle.dumps(fn(rank, rank_device, *args))))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise
    finally:
        shutdown()


def spawn(fn: Callable, world_size: int, args: Sequence = (), device="cuda",
          backend: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, device, *args)`` on ``world_size`` ranks, each in the
    default process group of them all; returns every rank's result, in rank
    order.

    One rank runs in this process; more run in processes of their own
    (``torch.multiprocessing``, the spawn method, so ``fn`` and ``args``
    must pickle). They meet through a file in a temporary directory, so no
    TCP port is taken. A rank that raises stops them all, and the error is
    raised here with its traceback. Every rank runs on this host: under
    NCCL, ``world_size`` may not exceed its cards."""
    device = resolve_device(device)
    if device.type == "cuda" and (backend or "nccl") == "nccl" and \
            world_size > torch.cuda.device_count():
        raise RuntimeError(_too_few_cards(f"{world_size} ranks", torch.cuda.device_count()))
    tmp = tempfile.mkdtemp(prefix="nic_tpu_torch_group_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    try:
        if world_size == 1:
            rank_device = init_group(init_method, 1, 0, device, backend)
            try:
                return [fn(0, rank_device, *args)]
            finally:
                shutdown()
        return _spawn_ranks(fn, world_size, args, device, backend, init_method)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _spawn_ranks(fn, world_size, args, device, backend, init_method):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, world_size, fn, args, device, backend,
                                                  init_method, queue))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        # Drain the queue before joining: a rank blocks on a full pipe. A
        # rank stuck in a collective fails after DEFAULT_TIMEOUT_S and reports.
        while len(results) + len(errors) < world_size:
            try:
                rank, ok, value = queue.get(timeout=1.0)
            except queue_lib.Empty:  # are the ranks alive?
                if any(p.exitcode not in (None, 0) for p in procs):
                    errors.append(f"rank(s) exited with {[p.exitcode for p in procs]} "
                                  "before reporting")
                    break
                continue
            if ok:
                results[rank] = pickle.loads(value)
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        if errors:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        queue.close()
    if errors:
        raise RuntimeError("a rank failed: " + "\n".join(errors))
    return [results[r] for r in range(world_size)]
