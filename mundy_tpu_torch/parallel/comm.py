"""Collectives over torch.distributed: the port's counterpart of the `lax`
collectives the reference's multi-device engines use.

The reference runs its engines inside `shard_map` over a device mesh and
talks with `lax.ppermute`, `lax.psum` and `lax.pmax`. The port runs one
process per rank instead (the reference's own `mpirun -n N` model), each
holding its shard, and a `Group` gives those processes the same three
collectives plus `all_gather`:

- `ppermute(x, perm)`: every rank sends x to its destination in `perm`
  (a list of (source, destination) rank pairs) and receives its source's x,
  through `dist.batch_isend_irecv`; a self-pair (one rank) is a copy;
- `psum(x)`, `pmax(x)`: `all_reduce` with SUM or MAX;
- `all_gather(x)`: the list of every rank's x (equal shapes).

The backend rule (`backend_plan`), explicit and printed by `spawn_ranks`:
- NCCL when each rank has a CUDA device of its own (rank r on
  cuda:(r % device_count));
- gloo on the CPU;
- gloo when ranks share a card: NCCL refuses two ranks on one GPU. The group
  then stages each CUDA tensor through a pinned host buffer, counted in
  `stage_s` (host seconds spent copying) beside `bytes_moved`.
Nothing switches backend on a failure, and no rank asked for CUDA carries on
on the CPU.

`spawn_ranks(fn, n, device="cuda", ...)` starts n processes with the "spawn" start
method, joins them through a FileStore in a temporary directory (no TCP
port), runs `fn(group, *args)` on each and returns their results in rank
order. It waits at most `timeout` seconds: on expiry it kills every rank and
raises, so a hang fails the run. A rank's exception is raised again in the
caller. `fn` must be importable by module name in a fresh interpreter (a
module-level function of a module that does not import JAX).
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import queue as _queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Plan:
    """How n ranks run: the backend, each rank's device, and whether CUDA
    tensors are staged through host memory for the backend."""

    backend: str  # "nccl" | "gloo" | "none" (one rank, no process group)
    devices: tuple  # torch.device per rank
    stage: bool  # CUDA tensors staged through pinned host buffers

    def describe(self) -> str:
        devs = ", ".join(str(d) for d in self.devices)
        how = " (CUDA tensors staged through pinned host buffers)" if self.stage else ""
        return f"ranks {len(self.devices)}, backend {self.backend}{how}, devices [{devs}]"


def backend_plan(n: int, device, n_cards: Optional[int] = None) -> Plan:
    """The backend rule for n ranks on `device` ("cuda" or "cpu"); n_cards
    defaults to torch.cuda.device_count()."""
    kind = torch.device(device).type
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    if kind == "cpu":
        return Plan("gloo", (torch.device("cpu"),) * n, False)
    if kind != "cuda":
        raise ValueError(f"no backend for device type {kind!r}")
    if n_cards is None:
        if not torch.cuda.is_available():
            raise RuntimeError("ranks on 'cuda' need a CUDA device, and torch sees none")
        n_cards = torch.cuda.device_count()
    devices = tuple(torch.device("cuda", r % n_cards) for r in range(n))
    if n_cards >= n:
        return Plan("nccl", devices, False)
    return Plan("gloo", devices, True)


class Group:
    """One rank's view of the ranks: rank, size, device, backend and the
    collectives. `bytes_moved` counts the bytes this rank sent through
    ppermute, psum, pmax and all_gather; `stage_s` the host seconds it spent
    copying CUDA tensors to and from host memory (gloo on a shared card),
    not counting the wait for the kernels that produce them."""

    def __init__(self, rank: int, size: int, device, backend: str, stage: bool = False,
                 pg=None, members: Optional[tuple] = None):
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.stage = bool(stage)
        self.pg = pg  # the process group (None: the default one)
        self.members = members  # global rank of each rank of a subgroup
        self.bytes_moved = 0
        self.stage_s = 0.0
        self._pinned = {}  # (role, shape, dtype) -> a reused pinned host buffer

    @classmethod
    def single(cls, device) -> "Group":
        """A group of one rank with no process group: every collective is
        the identity (ppermute a copy). A one-rank process group (NCCL on a
        card) runs its reductions through the backend all the same."""
        return cls(0, 1, device, "none")

    def subgroup(self, ranks: Sequence[int]) -> Optional["Group"]:
        """The Group of `ranks` of this group, renumbered 0.. in that order,
        on its members, None elsewhere. A collective: every rank calls it
        with the same ranks."""
        ranks = tuple(int(r) for r in ranks)
        glob = tuple(self.members[r] for r in ranks) if self.members else ranks
        pg = dist.new_group(list(glob))
        if self.rank not in ranks:
            return None
        return Group(ranks.index(self.rank), len(ranks), self.device, self.backend, self.stage,
                     pg=pg, members=glob)

    def _peer(self, r: int) -> int:
        return self.members[r] if self.members else r

    def reset_counters(self) -> None:
        self.bytes_moved = 0
        self.stage_s = 0.0

    # ---- staging ----------------------------------------------------------
    def _host(self, role: str, like: torch.Tensor) -> torch.Tensor:
        """The pinned host buffer of `role` for tensors like `like`, made
        once per shape (a pinned allocation costs far more than the copy)."""
        key = (role, tuple(like.shape), like.dtype)
        if key not in self._pinned:
            self._pinned[key] = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return self._pinned[key]

    def _staged(self, x: torch.Tensor) -> bool:
        return self.stage and x.device.type == "cuda"

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        if not self._staged(x):
            return x
        # the copy waits for the kernels that produce x: wait first, so
        # that stage_s counts the copies alone
        torch.cuda.current_stream(x.device).synchronize()
        t0 = time.perf_counter()
        host = self._host("send", x)
        host.copy_(x)
        self.stage_s += time.perf_counter() - t0
        return host

    def _recv_buffer(self, wire: torch.Tensor, role: str) -> torch.Tensor:
        """Where a message like `wire` lands: a pinned buffer when staging,
        else a new tensor on wire's device."""
        if wire.is_pinned():
            return self._host(role, wire)
        return torch.empty_like(wire)

    def _from_wire(self, x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if x.device == like.device:
            return x
        t0 = time.perf_counter()
        out = x.to(like.device)
        if out.device.type == "cuda":
            torch.cuda.current_stream(out.device).synchronize()
        self.stage_s += time.perf_counter() - t0
        return out

    # ---- collectives ------------------------------------------------------
    def ppermute(self, x: torch.Tensor, perm: Sequence[tuple]) -> torch.Tensor:
        """lax.ppermute: send x along this rank's pair of `perm`, return what
        arrives (zeros where no pair sends to this rank, as in JAX)."""
        dst = [d for s, d in perm if s == self.rank]
        src = [s for s, d in perm if d == self.rank]
        if dst == [self.rank] and src == [self.rank]:
            return x.clone()
        if self.size == 1:
            raise ValueError(f"perm {perm} leaves a group of one rank")
        wire = self._to_wire(x)
        out = self._recv_buffer(wire, "recv").zero_()
        ops = []
        if dst:
            ops.append(dist.P2POp(dist.isend, wire, self._peer(dst[0]), group=self.pg))
            self.bytes_moved += wire.numel() * wire.element_size()
        if src:
            ops.append(dist.P2POp(dist.irecv, out, self._peer(src[0]), group=self.pg))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._from_wire(out, x)

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.backend == "none":
            return x.clone()
        wire = self._to_wire(x)
        if wire is x:
            wire = x.clone()
        dist.all_reduce(wire, op=op, group=self.pg)
        self.bytes_moved += wire.numel() * wire.element_size()
        return self._from_wire(wire, x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """lax.psum: the sum over ranks."""
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """lax.pmax: the maximum over ranks."""
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor) -> list:
        """Every rank's x (equal shapes on every rank), in rank order."""
        if self.backend == "none":
            return [x.clone()]
        wire = self._to_wire(x)
        outs = [self._recv_buffer(wire, f"gather{r}") for r in range(self.size)]
        dist.all_gather(outs, wire, group=self.pg)
        self.bytes_moved += wire.numel() * wire.element_size()
        return [self._from_wire(o, x) for o in outs]


def ring_perms(d: int) -> tuple:
    """(up, down): the ring permutations i -> i + 1 and i -> i - 1 (mod d)."""
    return ([(i, (i + 1) % d) for i in range(d)],
            [(i, (i - 1) % d) for i in range(d)])


def init_group(rank: int, size: int, device, store_path: str,
               timeout: float = 120.0) -> Group:
    """Join the process group of `size` ranks through a FileStore at
    `store_path` (every rank passes the same path) by the backend rule, and
    return this rank's Group. NCCL ranks bind their card first."""
    plan = backend_plan(size, device)
    dev = plan.devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, size)
    dist.init_process_group(backend=plan.backend, store=store, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout))
    return Group(rank, size, dev, plan.backend, plan.stage)


def close_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_entry(fn, rank, n, device, store_path, args, timeout, threads, results):
    try:
        torch.set_num_threads(threads)
        group = init_group(rank, n, device, store_path, timeout)
        try:
            out = fn(group, *args)
        finally:
            close_group()
        results.put((rank, True, out))
    except BaseException:
        # report the traceback to the caller (which raises it), then exit
        # with the failure
        results.put((rank, False, traceback.format_exc()))
        raise


class RankError(RuntimeError):
    """A rank raised; the message carries its traceback."""


def spawn_ranks(fn: Callable, n: int, device="cuda", args: tuple = (),
                timeout: float = 120.0, threads: int = 1,
                log: Optional[Callable[[str], None]] = print) -> list:
    """Run fn(group, *args) on n spawned ranks on `device` (the card unless
    the caller asks for "cpu"; without a card a "cuda" call raises before
    any rank starts); their results in rank order. Prints the plan (ranks, backend, devices) through `log`. Raises
    RankError with the traceback of the first rank that failed, and
    TimeoutError, after killing every rank, when they have not all finished
    within `timeout` seconds."""
    plan = backend_plan(n, device)
    if log is not None:
        log(plan.describe())
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mundy_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn, r, n, str(device), os.path.join(tmp, "store"), args,
                               timeout, threads, results))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + timeout
        while len(out) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n - len(out)} of {n} ranks did not finish within "
                                   f"{timeout} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if not dead:
                    continue
                try:  # what a failed rank reported before it exited
                    rank, ok, val = results.get(timeout=2.0)
                except _queue.Empty:
                    raise RankError(f"rank {dead[0]} exited with code "
                                    f"{procs[dead[0]].exitcode} and no result") from None
            if not ok:
                raise RankError(f"rank {rank} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        return [out[r] for r in range(n)]
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
