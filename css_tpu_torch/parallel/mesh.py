"""Data parallelism over processes, one per device, counterpart of
``css_tpu/parallel/mesh.py``.

The JAX package drives every device from one process: a 1-D mesh over the
``data`` axis and a ``shard_map``-wrapped step whose collectives (gradient
``pmean``, BatchNorm statistics, prototype sums, mixing partners) are XLA's.
The port runs one process per device, as the reference's ``mp.spawn`` does,
with ``torch.distributed``: NCCL on the card, gloo on the CPU.  Every rank
holds the whole replicated state and its shard of each batch; the
collectives the step issues are the functions below, on the default group.

* :func:`spawn` starts ``world_size`` processes (start method ``spawn``);
  rank r joins the group on ``devices[r]`` and runs ``fn(device, *args)``;
  the caller gets every rank's return value.
* :func:`init_from_env` joins a group that ``torchrun`` set up (its
  ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and ``MASTER_ADDR`` variables).
* :func:`distributed_init`, the counterpart of ``css_tpu``'s, joins a group
  from an explicit coordinator, from ``COORDINATOR_ADDRESS`` or from a SLURM
  ``srun`` job step (:func:`expand_hostlist` reads its node list); outside
  those it does nothing.  The training entry point does not call it: it is
  the library's entry for launchers.
* :func:`all_reduce_sum` is a differentiable sum over ranks: its backward
  sums the cotangents over ranks, the transpose of JAX's ``psum`` (under
  ``check_vma=False``).  After :func:`mean_gradients` this gives the exact
  gradient of the ranks' mean loss.

Every rank must issue the same collectives in the same order: nothing here
branches on the rank around a collective.
"""

from __future__ import annotations

import datetime
import itertools
import os
import pickle
import re
import shutil
import tempfile
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["backend_for", "launched_by_torchrun", "is_initialized", "rank",
           "world_size", "rank_devices", "init_from_env", "distributed_init", "expand_hostlist",
           "spawn", "all_reduce_sum", "mean_gradients", "broadcast_", "any_process"]

_TORCHRUN_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR")
DEFAULT_TIMEOUT_S = 1800.0      # a collective that waits longer raises in its rank


def backend_for(device: torch.device) -> str:
    """NCCL for CUDA devices, gloo otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def launched_by_torchrun() -> bool:
    return all(v in os.environ for v in _TORCHRUN_VARS)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The number of ranks; 1 without a group."""
    return dist.get_world_size() if is_initialized() else 1


def rank_devices(device: torch.device, num_devices: Optional[int]) -> List[str]:
    """The device of each rank for ``--num_devices`` (None: 1) on devices of
    ``device``'s type: ``cuda:r`` for rank r, or the CPU for every rank.
    Raises ValueError for fewer than one device or more than the host's
    cards."""
    world = 1 if num_devices is None else num_devices
    if world < 1:
        raise ValueError(f"--num_devices {world}: need at least one device")
    if device.type != "cuda":
        return ["cpu"] * world
    if world > torch.cuda.device_count():
        raise ValueError(f"--num_devices {world} exceeds the {torch.cuda.device_count()} "
                         f"CUDA devices of this host")
    return [f"cuda:{r}" for r in range(world)]


def _join(backend: str, device: torch.device, rank_: int, world: int, init_method: str,
          timeout_s: float) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)     # before anything touches the card
    dist.init_process_group(backend, init_method=init_method, rank=rank_, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def init_from_env(device_type: str = "cuda") -> torch.device:
    """Joins the group that ``torchrun`` describes in the environment and
    returns this rank's device: ``cuda:LOCAL_RANK`` (NCCL), or the CPU
    (gloo)."""
    local = int(os.environ["LOCAL_RANK"])
    device = torch.device(f"cuda:{local}" if device_type == "cuda" else "cpu")
    _join(backend_for(device), device, int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
          "env://", DEFAULT_TIMEOUT_S)
    return device


def expand_hostlist(hostlist: str) -> List[str]:
    """The host names of a SLURM hostlist, in order: ``a,b``, ``node[0-7]``,
    ``node[01-03,7]`` (a range keeps its zero padding), several bracket
    groups in one name (each expanded, the last fastest)."""
    hosts = []
    for name in re.findall(r"(?:[^,\[]|\[[^\]]*\])+", hostlist):
        parts = re.split(r"\[([^\]]*)\]", name)     # text, group, text, group, ..., text
        choices = []
        for i, part in enumerate(parts):
            if i % 2 == 0:
                choices.append([part])
                continue
            values = []
            for item in part.split(","):
                lo, _, hi = item.partition("-")
                if not hi:
                    values.append(lo)
                    continue
                if not (lo.isdigit() and hi.isdigit()) or int(hi) < int(lo):
                    raise ValueError(f"hostlist {hostlist!r}: bad range {item!r}")
                values += [str(v).zfill(len(lo)) for v in range(int(lo), int(hi) + 1)]
            choices.append(values)
        hosts += ["".join(c) for c in itertools.product(*choices)]
    return hosts


def distributed_init(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, debug_nans: bool = False,
                     device_type: str = "cuda") -> torch.device:
    """Joins the default process group of a run over several processes, one
    per device, and returns this rank's device (``cuda:<local index>`` over
    NCCL, or the CPU over gloo); the counterpart of ``css_tpu``'s
    ``distributed_init``.

    The group's address, in this order: ``coordinator`` (``host:port``),
    ``COORDINATOR_ADDRESS``, or the first host of an ``srun`` job step's
    ``SLURM_STEP_NODELIST`` with the port JAX's SLURM detector picks
    (``SLURM_JOB_ID`` mod 4096 + 61440).  ``num_processes`` and
    ``process_id`` default to ``SLURM_NTASKS`` and ``SLURM_PROCID``; the
    local device index is ``SLURM_LOCALID``, else ``process_id`` modulo the
    host's cards.  An ``srun`` step is ``SLURM_NTASKS`` > 1 with
    ``SLURM_STEP_NODELIST`` set: a process inside a multi-task allocation
    but not started by ``srun`` waits for no peers.  Without any of the
    three sources the call joins nothing and returns ``device_type``'s
    device.

    ``debug_nans`` turns on ``torch.autograd.set_detect_anomaly(True,
    check_nan=True)``: a NaN produced in backward raises, naming the forward
    operation that made its input.  Unlike ``jax_debug_nans`` it does not
    check every forward operation's output, only the backward's.
    """
    if debug_nans:
        torch.autograd.set_detect_anomaly(True, check_nan=True)
    env = os.environ
    address = coordinator or env.get("COORDINATOR_ADDRESS")
    if not address:
        if int(env.get("SLURM_NTASKS", "1")) <= 1 or "SLURM_STEP_NODELIST" not in env:
            return torch.device(device_type)
        port = int(env["SLURM_JOB_ID"]) % 2**12 + (65535 - 2**12 + 1)
        address = f"{expand_hostlist(env['SLURM_STEP_NODELIST'])[0]}:{port}"
    if (num_processes is None and "SLURM_NTASKS" not in env
            or process_id is None and "SLURM_PROCID" not in env):
        raise ValueError(f"distributed_init: joining {address} needs num_processes and "
                         f"process_id (or SLURM_NTASKS and SLURM_PROCID)")
    world = num_processes if num_processes is not None else int(env["SLURM_NTASKS"])
    rank_ = process_id if process_id is not None else int(env["SLURM_PROCID"])
    if device_type == "cuda":
        local = int(env.get("SLURM_LOCALID", rank_ % max(torch.cuda.device_count(), 1)))
        device = torch.device(f"cuda:{local}")
    else:
        device = torch.device("cpu")
    _join(backend_for(device), device, rank_, world, f"tcp://{address}", DEFAULT_TIMEOUT_S)
    return device


def _rank_main(rank_: int, fn: Callable, args: tuple, world: int, backend: str,
               devices: Sequence[str], init_method: str, out_dir: str, timeout_s: float):
    device = torch.device(devices[rank_])
    _join(backend, device, rank_, world, init_method, timeout_s)
    try:
        result = fn(device, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"result{rank_}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, args: tuple, world_size: int, backend: str, devices: Sequence[str],
          workdir: Optional[str] = None) -> List:
    """Runs ``fn(device, *args)`` in ``world_size`` new processes, rank r on
    ``devices[r]`` in a ``backend`` group (``file://`` rendezvous in a fresh
    directory under ``workdir``, or the system's temporary directory);
    returns their return values in rank order.  A rank that raises makes the
    others stop and this call raise; a collective that waits longer than
    ``DEFAULT_TIMEOUT_S`` (as it reads here, when the call is made) raises
    in its rank.  ``fn`` and ``args`` must pickle."""
    if len(devices) != world_size:
        raise ValueError(f"spawn: {len(devices)} devices for {world_size} ranks")
    out_dir = tempfile.mkdtemp(prefix="css_tpu_torch_spawn_", dir=workdir)
    try:
        torch.multiprocessing.spawn(
            _rank_main, nprocs=world_size, join=True,
            args=(fn, args, world_size, backend, list(devices),
                  "file://" + os.path.join(out_dir, "rendezvous"), out_dir,
                  DEFAULT_TIMEOUT_S))
        results = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"result{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; the cotangent of x is the sum over ranks of
    the cotangents of y."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (a new tensor)."""
    return _AllReduceSum.apply(x)


@torch.no_grad()
def mean_gradients(params: Sequence[torch.Tensor]) -> None:
    """Replaces each parameter's gradient by its mean over the ranks: one
    all-reduce of one flat f32 buffer.  A parameter without a gradient sends
    zeros and keeps none (which parameters get one is fixed by the graph, the
    same on every rank)."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    offset = 0
    for p in params:
        n = p.numel()
        if p.grad is not None:
            p.grad.copy_(flat[offset:offset + n].view(p.shape))
        offset += n


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor]) -> None:
    """Overwrites each tensor in place with rank 0's."""
    for t in tensors:
        buf = t if t.is_contiguous() else t.contiguous()
        dist.broadcast(buf, 0)
        if buf is not t:
            t.copy_(buf)


def any_process(flag: bool, device: torch.device) -> bool:
    """True on every rank when ``flag`` is true on any (a host sync)."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
