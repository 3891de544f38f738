"""Data parallelism over ``torch.distributed`` (the port's counterpart of
:mod:`t2igan.parallel.mesh`).

The JAX package runs each train step as one jitted program over a 1-D
``data`` mesh of every local device: the parameters are replicated, the
global batch is sharded on its leading axis, and XLA inserts the
collectives.  The port runs one process per card (``torchrun``) and makes
the same function out of per-rank programs:

========================================  ===================================
JAX (``t2igan/parallel/mesh.py``)         port
========================================  ===================================
``make_mesh`` (:23)                       :func:`init_distributed` (the world
                                          group over every rank)
``make_mesh_for_batch`` (:38)             :func:`ranks_for_batch`,
                                          :meth:`DataMesh.for_batch`
``replicated`` / ``batch_sharded``        each rank holds the whole model and
(:52-58)                                  its contiguous rows of the batch
``shard_batch`` (:61)                     :meth:`DataMesh.local_rows`
``replicate`` (:67)                       :meth:`DataMesh.replicate_`
``global_batch`` (:73)                    the loader's (host, local) split
                                          (``data/pipeline.py``) plus
                                          :meth:`DataMesh.gather_rows` and
                                          :meth:`DataMesh.gather_rows_live`
``emulated_global_batch`` (:99)           none: it assembles a ``jax.Array``;
                                          its rule, host slices stitched in
                                          host order, is the loader's split
========================================  ===================================

Rank ``r`` holds rows ``[r * b, (r + 1) * b)`` of the global batch, with
``r = host_index * local_count + local_index``: host ``h`` takes the
``h``-th contiguous slab of the epoch and splits each host batch over its
local ranks in order, as the JAX loader and device order do (PARITY D11).

Every objective is written so that the per-rank objectives sum to ``W``
times the global loss (``W`` the ranks): a mean over local rows is
``1 / W``-th of its global mean times ``W``, and a loss over the whole
batch (the DAMSM ``[B, B]`` terms, NT-Xent) is computed whole on every rank
from rows gathered with :meth:`DataMesh.gather_rows_live`, whose backward
sums over ranks.  Averaging the gradients over ranks
(:meth:`DataMesh.all_reduce_grads_`) then gives exactly the gradient of the
global loss.

Without a process group (``WORLD_SIZE`` unset or 1 and none initialised)
:func:`init_distributed` creates none, every collective is the identity,
and the callers run the code they ran before this module existed.

Only ``all_reduce``, ``broadcast``, ``barrier``, ``all_gather_object`` and
``torch.distributed.nn.functional.all_reduce`` are used.  A gather of rows
is an ``all_reduce`` of the rank's rows placed in zeros: exact, since every
other summand of an entry is zero, and it works for CUDA tensors under
gloo as well as NCCL.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import time
import traceback
import warnings
from typing import Any, Callable, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn


def sum_autograd(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` by ``torch.distributed.nn``'s autograd
    all_reduce: the backward sums the gradients over the group too.
    (torch 2.13 marks it deprecated in favour of the functional
    collectives; it is kept as the one autograd all_reduce that torch 2.11
    and 2.13 both have, and its warning is silenced.)"""
    from torch.distributed.nn.functional import all_reduce
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return all_reduce(x, group=group)


def ranks_for_batch(batch: int, local_count: int) -> int:
    """The local ranks that take part in a step on a per-host batch of
    ``batch``: the largest count ``<= local_count`` that divides it
    (``make_mesh_for_batch``'s rule; a batch of 4 on 8 local ranks uses 4).
    """
    n = max(1, local_count)
    while n > 1 and batch % n:
        n -= 1
    return n


@dataclasses.dataclass
class DataMesh:
    """One rank's place in the data-parallel layout.

    ``rank``/``world`` count the ranks that take part; ``host_index`` /
    ``host_count`` the nodes (a host is a node, as in PARITY D11) and
    ``local_index``/``local_count`` the rank's place among its node's
    taking part.  ``group`` is None for a single process (every collective
    is then the identity).  A rank with ``takes_part`` False was left out
    by :meth:`for_batch`: it takes no step and writes nothing."""

    rank: int = 0
    world: int = 1
    host_index: int = 0
    host_count: int = 1
    local_index: int = 0
    local_count: int = 1
    group: Optional[Any] = None
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    backend: Optional[str] = None
    takes_part: bool = True

    @classmethod
    def single(cls, device) -> "DataMesh":
        """One process, no group."""
        return cls(device=torch.device(device))

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def writes(self) -> bool:
        """Whether this rank writes files: rank 0 of a taking-part mesh."""
        return self.takes_part and self.rank == 0

    # ---------------------------------------------------------- layout --

    def for_batch(self, batch: int) -> "DataMesh":
        """The mesh of a per-host batch of ``batch``: the first
        :func:`ranks_for_batch` local ranks of every host, over a subgroup
        when that leaves any out.  Every rank of this mesh must call it
        (``new_group`` is collective)."""
        n = ranks_for_batch(batch, self.local_count)
        if not self.distributed or n == self.local_count:
            return self
        ranks = [h * self.local_count + i for h in range(self.host_count)
                 for i in range(n)]
        group = dist.new_group(ranks, backend=self.backend)
        if self.local_index >= n:
            return dataclasses.replace(self, group=None, takes_part=False)
        return dataclasses.replace(
            self, rank=self.host_index * n + self.local_index,
            world=n * self.host_count, local_count=n, group=group)

    def row_range(self, b: int) -> slice:
        """This rank's rows of a global batch of ``b * world`` rows."""
        return slice(self.rank * b, (self.rank + 1) * b)

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous rows of a global batch ``x`` [W * b, ...]
        (a tensor or an array), as a fresh copy (so a bf16 kernel operand
        starts aligned, ROADMAP F11).  Without a group, ``x`` itself."""
        if not self.distributed:
            return x
        rows = x[self.row_range(x.shape[0] // self.world)]
        return rows.clone() if torch.is_tensor(rows) else rows.copy()

    # ----------------------------------------------------- collectives --

    def _placed(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [b, ...] at this rank's rows of zeros [W * b, ...]."""
        b = x.shape[0]
        before = x.new_zeros((self.rank * b,) + x.shape[1:])
        after = x.new_zeros(((self.world - self.rank - 1) * b,)
                            + x.shape[1:])
        return torch.cat([before, x, after])

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows [W * b, ...] in rank order, forward only (no
        gradient reaches any rank's rows)."""
        if not self.distributed:
            return x
        if x.dtype == torch.bool:
            return self.gather_rows(x.to(torch.uint8)).bool()
        buf = self._placed(x.detach())
        dist.all_reduce(buf, group=self.group)
        return buf

    def gather_rows_live(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows [W * b, ...] in rank order, with this rank's
        own rows carrying autograd.  The backward sums the gradients of
        all ranks' objectives with respect to this rank's rows, so a loss
        computed whole on every rank from the gathered rows contributes
        ``W`` times its gradient, as the per-rank objectives promise."""
        if not self.distributed:
            return x
        return sum_autograd(self._placed(x), self.group)

    def mean_over_ranks(self, tensors: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
        """Each (detached, f32) tensor averaged over ranks in one
        collective; without a group, the tensors as they are."""
        if not self.distributed:
            return list(tensors)
        flat = torch.stack([t.detach().float().reshape(()) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        return list((flat / self.world).unbind())

    @torch.no_grad()
    def all_reduce_grads_(self, params: Iterable[nn.Parameter],
                          group: Any = None,
                          divisor: Optional[int] = None) -> None:
        """Each parameter's ``.grad`` summed over the ranks of ``group``
        (default the mesh's) and divided by ``divisor`` (default the
        mesh's world), in one flattened collective per dtype.  Parameters
        without a gradient are skipped (the same on every rank)."""
        if not self.distributed:
            return
        group = self.group if group is None else group
        divisor = self.world if divisor is None else divisor
        by_dtype = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            flat.div_(divisor)
            for g, v in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(v.view_as(g))

    @torch.no_grad()
    def replicate_(self, modules: Iterable[nn.Module]) -> None:
        """Rank 0's parameters and buffers (spectral ``u``/``v``, BN
        running statistics, an EMA copy) on every rank, one flattened
        broadcast per module and dtype."""
        if not self.distributed:
            return
        src = dist.get_global_rank(self.group, 0)
        for module in modules:
            by_dtype = {}
            for t in [*module.parameters(), *module.buffers()]:
                by_dtype.setdefault(t.dtype, []).append(t)
            for ts in by_dtype.values():
                flat = torch.cat([t.detach().reshape(-1) for t in ts])
                dist.broadcast(flat, src, group=self.group)
                for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                    t.copy_(v.view_as(t))

    def any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (a stop every rank agrees
        on: one rank stopping alone would leave the others waiting in a
        collective)."""
        if not self.distributed:
            return flag
        t = torch.tensor([float(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier(group=self.group)

    def gather_objects(self, obj: Any) -> List[Any]:
        """Every rank's ``obj`` (picklable) in rank order."""
        if not self.distributed:
            return [obj]
        out: List[Any] = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def by_host(self, obj: Any) -> List[Any]:
        """Each host's ``obj`` (its first rank's), in host order."""
        return self.gather_objects(obj)[::self.local_count]


def init_distributed(device="cuda", backend: Optional[str] = None
                     ) -> DataMesh:
    """This process's :class:`DataMesh`.

    Reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``
    (as ``torchrun`` sets them).  With ``WORLD_SIZE`` unset or 1 and no
    process group initialised it returns the single-process mesh on
    ``device`` and creates nothing.  Otherwise it joins (or initialises,
    from ``MASTER_ADDR``/``MASTER_PORT``) the default group: backend NCCL
    on ``cuda``, gloo on ``cpu``, or ``backend``; the device is
    ``cuda:LOCAL_RANK`` unless ``device`` names an index."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if not dist.is_initialized() and world <= 1:
        return DataMesh.single(device)
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        backend = dist.get_backend()
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        dist.init_process_group(backend, rank=rank, world_size=world)
    if world % local_world:
        raise ValueError(f"WORLD_SIZE {world} is not a multiple of "
                         f"LOCAL_WORLD_SIZE {local_world}")
    return DataMesh(rank=rank, world=world, host_index=rank // local_world,
                    host_count=world // local_world, local_index=local_rank,
                    local_count=local_world, group=dist.group.WORLD,
                    device=dev, backend=backend)


def shutdown() -> None:
    """Destroy the default process group, if one was made (the end of an
    entry point under ``torchrun``)."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------- spawning --

def _to_cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _spawned(fn, rank: int, world: int, backend: str, device: str,
             init_file: str, timeout: float, threads: int,
             args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(threads)
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(init_file, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(init_distributed(device, backend), *args)
            path = f"{init_file}.rank{rank}.pt"
            torch.save(_to_cpu(result), path + ".tmp")
            os.replace(path + ".tmp", path)
        finally:
            shutdown()
    except BaseException:
        with open(f"{init_file}.rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_local(fn: Callable, world: int, backend: str, device: str,
                init_file: str, timeout: float = 120.0, args: tuple = (),
                threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world`` new processes of this host,
    ranks ``0 .. world - 1``, over a ``FileStore`` at ``init_file`` (a path
    that does not exist yet), even at ``world`` 1; returns each rank's
    result (tensors moved to the CPU) in rank order.  Each process runs
    ``threads`` CPU threads (default the host's cores over ``world``: ranks
    that each take every core slow each other down several times over).

    ``fn`` must be importable by name (a module-level function).  If a rank
    raises, exits non-zero or is still running ``timeout`` seconds after
    the start, every rank is stopped and this raises ``RuntimeError`` with
    the failing rank's traceback."""
    ctx = multiprocessing.get_context("spawn")
    threads = threads or max(1, (os.cpu_count() or 1) // world)
    procs = [ctx.Process(target=_spawned,
                         args=(fn, r, world, backend, device, init_file,
                               timeout, threads, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"spawn_local: {fn.__name__} over {world} ranks did not "
                    f"finish within {timeout:.0f} s")
            time.sleep(0.05)
        else:
            bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
            failed = bad[0] if bad else None
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()
    if failed is not None:
        err = f"{init_file}.rank{failed}.err"
        detail = open(err).read() if os.path.exists(err) else \
            "(no traceback written; see its standard error)"
        raise RuntimeError(f"spawn_local: rank {failed} of {world} failed "
                           f"with exit code {procs[failed].exitcode}:\n"
                           f"{detail}")
    return [torch.load(f"{init_file}.rank{r}.pt", weights_only=False)
            for r in range(world)]
