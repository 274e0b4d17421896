"""The rank mesh: G processes of one torch.distributed group, W/G workers
each.

Port of src/repro/launch/mesh.py and core/compat.make_mesh. The
reference runs the sort as one SPMD program over a mesh of W devices;
here W stays a plan parameter (the spill runs and reducer offsets depend
on it) and G ranks, each a process that owns one card, split it: rank r
holds workers [r*W/G, (r+1)*W/G) as the leading batch axis of its
tensors, exactly as one process holds all W when there is no mesh
(`mesh=None` everywhere). The collectives that cross ranks are in
core/collectives.py.

The backend is NCCL on cards and gloo on the CPU. NCCL puts one rank on
each card and refuses two on one, so `init_rank_mesh` raises before
`init_process_group` when two ranks would share a card. gloo also moves
CUDA tensors (through the host), which is how several ranks run on one
card: each names the card explicitly (`device="cuda:0"`). There is no
fallback from NCCL to gloo, or from a card to the CPU.

A mesh may also name its axes, as the reference's (data, model) mesh
does (`axes={"data": 2, "model": 4}`; `("pod", "data", "model")` is
reserved for the pod-group gradient compression): ranks are laid out
row-major over the axes, the last the fastest, as jax lays devices out,
so rank r = g * |model| + j sits at data index g and model index j. Each
axis, and the data axes together (every axis but "model"), gets one
process subgroup per line of the mesh along it (`group_of`);
`index_of` is the reference's axis_index. The sort's flat path ignores
the axes: it keeps `group` (the whole world) and `workers_per_rank`.

A rank that dies leaves the others blocked in their next collective; the
group's `timeout` turns that into an exception in each of them.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import tempfile

import torch
import torch.distributed as dist

from repro_torch.kernels import u32

#: Default collective timeout: a dead rank raises in the others after it.
DEFAULT_TIMEOUT_S = 300.0


class RankMesh:
    """One rank's view of the group: who it is, where its tensors live
    and which of the W workers it holds.

    `exchanges` is None, or a list to which core/collectives appends one
    record per collective (`record_exchanges`); reading it with
    `exchange_log` waits for the card and turns CUDA events into ms.

    `axes` ({name: size}, sizes multiplying to `world`) names the mesh's
    axes, and `groups` maps each axis name, and the tuple of the data
    axes, to this rank's subgroup along it (init_rank_mesh makes them; a
    mesh without groups is a rank's layout only, for "meta" runs, whose
    collectives move no data).
    """

    def __init__(self, *, world: int, rank: int, device: torch.device,
                 num_workers: int, backend: str,
                 timeout: datetime.timedelta, axes: dict | None = None,
                 groups: dict | None = None):
        if num_workers % world:
            raise ValueError(f"num_workers={num_workers} must divide evenly "
                             f"over {world} ranks")
        self.world = int(world)
        self.rank = int(rank)
        self.device = device
        self.num_workers = int(num_workers)
        self.backend = backend
        self.timeout = timeout
        self.group = dist.group.WORLD
        self.exchanges: list | None = None
        self.axes = check_axes(axes, world) if axes else {}
        self.coords = dict(zip(self.axes, _unravel(rank, self.axes.values())))
        self.groups = dict(groups or {})

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.axes)

    @property
    def data_axes(self) -> tuple[str, ...]:
        """Every named axis but "model": the axes the batch splits over."""
        return tuple(a for a in self.axes if a != "model")

    def _names(self, axis) -> tuple[str, ...]:
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in names:
            if a not in self.axes:
                raise KeyError(f"axis {a!r} is not an axis of {self}")
        return names

    def size_of(self, axis) -> int:
        """The number of ranks along `axis` (a name, or a tuple of names:
        the product)."""
        return math.prod(self.axes[a] for a in self._names(axis))

    def index_of(self, axis) -> int:
        """This rank's position along `axis`, the reference's axis_index;
        over a tuple of axes, row-major."""
        idx = 0
        for a in self._names(axis):
            idx = idx * self.axes[a] + self.coords[a]
        return idx

    def group_of(self, axis):
        """The process subgroup of the ranks that differ from this one
        only along `axis` (a name, or the tuple of the data axes); its
        group ranks are in the order of `index_of(axis)`."""
        names = self._names(axis)
        key = names[0] if len(names) == 1 else names
        if key not in self.groups:
            raise KeyError(f"no process group along {axis!r} on {self}")
        return self.groups[key]

    @property
    def workers_per_rank(self) -> int:
        return self.num_workers // self.world

    @property
    def worker_lo(self) -> int:
        """Global id of this rank's first worker."""
        return self.rank * self.workers_per_rank

    def share(self, n: int) -> tuple[int, int]:
        """[lo, hi) of this rank's equal share of n items (n % world == 0):
        its workers' records of a wave, its partitions of R = W*R1."""
        if n % self.world:
            raise ValueError(f"{n} items do not split over {self.world} ranks")
        per = n // self.world
        return self.rank * per, (self.rank + 1) * per

    def barrier(self) -> None:
        if self.device.type == "cuda" and self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def all_gather_object(self, obj) -> list:
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def record_exchanges(self) -> None:
        """Start (or restart) the per-all_to_all log."""
        self.exchanges = []

    def exchange_log(self) -> list[dict]:
        """The logged all_to_alls as {"what", "bytes", "ms", "clock"}:
        "clock" is "device" (CUDA events on the rank's stream around the
        collective) or "host" (wall clock of a CPU collective)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = []
        for what, nbytes, start, end in self.exchanges or ():
            if isinstance(start, float):
                out.append({"what": what, "bytes": nbytes,
                            "ms": (end - start) * 1e3, "clock": "host"})
            else:
                out.append({"what": what, "bytes": nbytes,
                            "ms": start.elapsed_time(end), "clock": "device"})
        return out

    def close(self) -> None:
        """Leave the group (every rank calls it; safe to call twice)."""
        if dist.is_initialized():
            dist.destroy_process_group()

    def __enter__(self) -> "RankMesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        axes = "".join(f", {a}={self.coords[a]}/{n}"
                       for a, n in self.axes.items())
        return (f"RankMesh(rank={self.rank}/{self.world}{axes}, "
                f"{self.backend}, {self.device}, workers {self.worker_lo}.."
                f"{self.worker_lo + self.workers_per_rank - 1} of "
                f"{self.num_workers})")


#: The axis names a mesh may have, in order.
AXIS_NAMES = (("data", "model"), ("pod", "data", "model"))


def check_axes(axes, world: int) -> dict:
    """{name: size} of a named mesh, checked: the reference's axis names
    in their order, sizes >= 1 multiplying to `world`."""
    axes = {str(a): int(n) for a, n in dict(axes).items()}
    if tuple(axes) not in AXIS_NAMES:
        raise ValueError(f"mesh axes {tuple(axes)}: must be one of "
                         f"{AXIS_NAMES}")
    if min(axes.values()) < 1 or math.prod(axes.values()) != world:
        raise ValueError(f"mesh axes {axes} do not multiply to {world} "
                         "ranks")
    return axes


def parse_axes(text: str) -> dict:
    """"data=D,model=M" (a command line's --mesh) -> {"data": D, "model":
    M}, checked by check_axes."""
    axes = {}
    for part in text.split(","):
        name, _, size = part.partition("=")
        axes[name.strip()] = int(size)
    return check_axes(axes, math.prod(axes.values()))


def _unravel(rank: int, sizes) -> list[int]:
    sizes = list(sizes)
    out = []
    for n in reversed(sizes):
        out.append(rank % n)
        rank //= n
    return out[::-1]


def _axis_groups(axes: dict, rank: int, timeout) -> dict:
    """Every rank's subgroups along each axis, and along the data axes
    together when there are two of them: dist.new_group for every line
    of the mesh, called by every rank in the same order (torch requires
    it of non-members too); this rank keeps the groups it belongs to."""
    names = list(axes)
    data = tuple(a for a in names if a != "model")
    keys = [(a,) for a in names] + ([data] if len(data) > 1 else [])
    world = math.prod(axes.values())
    coords = [dict(zip(names, _unravel(r, axes.values())))
              for r in range(world)]
    groups = {}
    for key in keys:
        lines: dict[tuple, list[int]] = {}
        for r, c in enumerate(coords):
            line = tuple(c[a] for a in names if a not in key)
            lines.setdefault(line, []).append(r)
        for members in lines.values():
            group = dist.new_group(members, timeout=timeout)
            if rank in members:
                groups[key[0] if len(key) == 1 else key] = group
    return groups


def layout_mesh(axes: dict, rank: int, device="meta") -> RankMesh:
    """Rank `rank`'s place in a named mesh without joining any group: a
    dry run's stand-in (launch/dryrun.peak_bytes of one rank's step on
    "meta" tensors, whose collectives move nothing)."""
    world = math.prod(dict(axes).values())
    return RankMesh(world=world, rank=rank, device=torch.device(device),
                    num_workers=world, backend="none",
                    timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S),
                    axes=axes)


def _env_int(name: str, given):
    if given is not None:
        return int(given)
    value = os.environ.get(name)
    return None if value is None else int(value)


def _rank_device(device, backend: str, local_rank: int,
                 local_world: int) -> torch.device:
    """The card (or the CPU) of this rank. "cuda" means cuda:<local_rank>;
    NCCL needs one card per rank on the host, checked here so that the
    error comes before init_process_group, not as a hang inside it."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("backend='nccl' moves CUDA tensors only; the "
                             "CPU's backend is 'gloo'")
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device={device!r}: must be 'cuda[:i]' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} with backend={backend!r}: "
                           "torch.cuda.is_available() is False")
    count = torch.cuda.device_count()
    dev = torch.device("cuda", local_rank if dev.index is None else dev.index)
    if backend == "nccl":
        if dev.index != local_rank or local_world > count:
            raise ValueError(
                f"backend='nccl' puts one rank on each card: {local_world} "
                f"ranks on this host and {count} card(s), local rank "
                f"{local_rank} on {dev} would share a card with another rank "
                "(NCCL refuses that); run at most one rank per card, or "
                "backend='gloo' with an explicit device for several ranks "
                "on one card")
    if dev.index >= count:
        raise ValueError(f"{dev} does not exist: {count} card(s) visible")
    return u32.resolve_device(dev)


def init_rank_mesh(num_workers: int, *, backend: str | None = None,
                   device="cuda", rank: int | None = None,
                   world: int | None = None, local_rank: int | None = None,
                   store_path: str | None = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S,
                   axes: dict | None = None) -> RankMesh:
    """Join the process group and return this rank's RankMesh.

    rank / world / local_rank default to torchrun's RANK / WORLD_SIZE /
    LOCAL_RANK. The rendezvous is a FileStore at `store_path` (every rank
    names the same file, which must not be left over from an earlier
    group) or, without one, torchrun's environment (MASTER_ADDR /
    MASTER_PORT). `backend` defaults to "nccl" on a card and "gloo" on
    the CPU; `timeout_s` bounds every collective, so a dead rank raises
    in the others instead of hanging them. `axes` ({"data": D, "model":
    M}, D * M = world) names the mesh's axes and builds their subgroups.
    """
    rank = _env_int("RANK", rank)
    world = _env_int("WORLD_SIZE", world)
    if rank is None or world is None:
        raise ValueError("rank and world are needed: pass them, or run "
                         "under torchrun (RANK, WORLD_SIZE)")
    if not 0 <= rank < world:
        raise ValueError(f"rank={rank} outside a world of {world}")
    local_rank = _env_int("LOCAL_RANK", local_rank)
    if local_rank is None:
        local_rank = rank  # one host: the spawned ranks
    local_world = _env_int("LOCAL_WORLD_SIZE", None) or world
    if backend is None:
        backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: must be 'nccl' or 'gloo'")
    dev = _rank_device(device, backend, local_rank, local_world)
    if num_workers % world:
        raise ValueError(f"num_workers={num_workers} must divide evenly "
                         f"over {world} ranks")
    if axes:
        axes = check_axes(axes, world)
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a process group")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend,
        init_method=(f"file://{os.path.abspath(store_path)}" if store_path
                     else "env://"),
        rank=rank, world_size=world, timeout=timeout, **kw)
    groups = _axis_groups(axes, rank, timeout) if axes else None
    return RankMesh(world=world, rank=rank, device=dev,
                    num_workers=num_workers, backend=backend, timeout=timeout,
                    axes=axes, groups=groups)


def under_torchrun() -> bool:
    """True in a process that torchrun started (RANK and WORLD_SIZE set)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def spawn_ranks(fn, world: int, *args) -> list:
    """Run `fn(rank, world, store_path, *args)` in `world` processes
    started with torch.multiprocessing's "spawn" method (CUDA forbids
    fork after init) and return their results in rank order. store_path
    is a fresh FileStore path for init_rank_mesh; `fn` and its results
    pickle. Each rank runs torch with an equal share of the host's cores
    as threads (the ranks share one host). A rank that raises makes this
    raise, with its traceback, after the others are stopped. `fn` and
    `args` reach the ranks through a file: pickled into each process's
    start-up pipe, arguments larger than the pipe's buffer would hold the
    parent until that child had started, one child after another."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        mp.start_processes(_spawned, args=(world, tmp), nprocs=world,
                           start_method="spawn", join=True)
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _spawned(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    with open(os.path.join(tmp, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    result = fn(rank, world, os.path.join(tmp, "rendezvous"), *args)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def make_test_mesh(num_workers: int = 8, *, store_path: str,
                   rank: int = 0, world: int = 1,
                   timeout_s: float = 60.0,
                   axes: dict | None = None) -> RankMesh:
    """A gloo mesh on the CPU, for tests: the counterpart of the
    reference's small host-device mesh."""
    return init_rank_mesh(num_workers, backend="gloo", device="cpu",
                          rank=rank, world=world, local_rank=rank,
                          store_path=store_path, timeout_s=timeout_s,
                          axes=axes)


def flat_axes_of(mesh: RankMesh) -> tuple[str, ...]:
    """The mesh's one axis: the sort treats every worker of every rank as
    one flat axis of W."""
    return ("workers",)


__all__ = ["AXIS_NAMES", "DEFAULT_TIMEOUT_S", "RankMesh", "check_axes",
           "flat_axes_of", "init_rank_mesh", "layout_mesh", "make_test_mesh",
           "parse_axes", "spawn_ranks", "under_torchrun"]
