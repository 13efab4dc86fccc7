"""Device meshes, sweep mesh specs, shardings and sharded event logs (port
of ``repro.launch.mesh``).

A :class:`Mesh` is a named grid of ``torch.device`` entries, row-major. A
device may appear more than once: several event shards then share one card
(their rows are views of one tensor and nothing moves between them), which
is how one H100 runs a 4-shard mesh and how the CPU tests run one
(``["cpu"] * 4``) — the port's counterpart of ``repro``'s
``--xla_force_host_platform_device_count`` fake devices. Where the entries
are different cards, each shard's rows live on its own card.

:class:`SweepMeshSpec` names how a scenario sweep maps onto a mesh: which
axes shard the event log (row-major in the given order: the shard of event
rank ``r`` holds global events ``[r * local_n, (r + 1) * local_n)``) and
which axis, if any, shards the scenario grid. :meth:`SweepMeshSpec.
for_processes` builds the multi-process mesh of a ``torch.distributed``
world (one event shard a rank); :func:`distributed_initialize` starts that
world's process group.

:func:`event_sharding` and :func:`replicated` are the shardings a
checkpoint restores onto (``repro_torch.checkpoint.restore_checkpoint(
shardings=)``); an event-sharded array is a :class:`ShardedLog`, its rows
split over the event ranks, each part on its rank's device.

:func:`make_production_mesh` is the dry run's mesh: a
:class:`LogicalMesh`, axis names and sizes with no devices (16×16
``("data", "model")``, or 2×16×16 with a leading ``"pod"`` axis, as in
``repro``), since the dry run counts work on the ``meta`` device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, pick_device


def _device(device: DeviceLike) -> torch.device:
    """``device`` as a ``torch.device``, a card always with its index (so
    that ``"cuda"`` and ``"cuda:0"`` name one mesh entry)."""
    dev = pick_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _device_list(devices: Optional[Sequence[DeviceLike]]) -> list:
    """The given devices as ``torch.device`` entries, or every visible CUDA
    card (none raises, as every entry point does without a card)."""
    if devices is not None:
        return [_device(d) for d in devices]
    pick_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named, row-major grid of devices: ``devices`` holds
    ``prod(shape)`` entries (repeats allowed), ``processes`` the
    ``torch.distributed`` rank that owns each entry (all 0 in one
    process)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    processes: Tuple[int, ...] = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(
                f"mesh axes {self.axis_names} do not match its shape "
                f"{self.sizes}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axis names repeat: {self.axis_names}")
        if len(self.devices) != math.prod(self.sizes):
            raise ValueError(
                f"a mesh of shape {self.sizes} needs {math.prod(self.sizes)} "
                f"devices, got {len(self.devices)}")
        if not self.processes:
            object.__setattr__(self, "processes", (0,) * len(self.devices))

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    def index(self, coords: dict) -> int:
        """The flat (row-major) index of the entry at ``coords`` (``{axis:
        index}``; an axis left out is at 0)."""
        flat = 0
        for name, size in zip(self.axis_names, self.sizes):
            flat = flat * size + int(coords.get(name, 0))
        return flat

    def device(self, coords: dict) -> torch.device:
        return self.devices[self.index(coords)]


def make_mesh(shape, axes, *, devices: Optional[Sequence[DeviceLike]] = None
              ) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over ``devices`` (every visible
    CUDA card by default), as ``repro``'s ``make_mesh``: the device count
    must be the product of the shape."""
    devs = _device_list(devices)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(devs) != math.prod(shape):
        raise ValueError(
            f"a mesh of shape {shape} needs {math.prod(shape)} devices, but "
            f"{len(devs)} are given")
    return Mesh(devices=tuple(devs), axis_names=axes, sizes=shape)


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """A named grid of ``prod(sizes)`` positions with no devices: what the
    partition rules read (``repro_torch.models.spec.partition_spec``) and
    what the dry run's collectives run over."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(
                f"mesh axes {self.axis_names} do not match its shape "
                f"{self.sizes}")

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """One pod, (16, 16) = 256 positions on ``("data", "model")``; two,
    (2, 16, 16) with a leading ``"pod"`` axis that is pure data-parallel
    (``repro.launch.mesh:39``)."""
    if multi_pod:
        return LogicalMesh(("pod", "data", "model"), (2, 16, 16))
    return LogicalMesh(("data", "model"), (16, 16))


def data_axes(mesh: Mesh) -> tuple:
    """The event/batch axes of a mesh (everything except ``"model"``)."""
    return tuple(a for a in mesh.axis_names if a != "model")


@dataclasses.dataclass(frozen=True)
class SweepMeshSpec:
    """How a scenario sweep maps onto a device mesh (``repro``'s
    ``SweepMeshSpec``).

    * ``event_axes`` — mesh axes that shard the event (leading) dimension
      of the (N, C) valuation matrix, row-major in the given order;
      campaign state stays replicated along them;
    * ``scenario_axis`` — optional mesh axis that shards the scenario grid:
      each slice of devices runs S / axis size scenarios, its own round
      loop. ``None`` keeps every scenario on every event shard.

    Build one with :meth:`for_devices` (the visible cards, or a device
    list such as ``["cpu"] * 4``), :meth:`for_processes` (a
    ``torch.distributed`` world) or from a :class:`Mesh`."""

    mesh: Mesh
    event_axes: Tuple[str, ...] = ("data",)
    scenario_axis: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "event_axes", tuple(self.event_axes))
        names = set(self.mesh.axis_names)
        missing = [a for a in (*self.event_axes,
                               *((self.scenario_axis,)
                                 if self.scenario_axis else ()))
                   if a not in names]
        if missing:
            raise ValueError(
                f"mesh has axes {self.mesh.axis_names}; spec names "
                f"unknown axes {missing}")
        if self.scenario_axis in self.event_axes:
            raise ValueError(
                f"scenario_axis {self.scenario_axis!r} cannot also shard "
                "events")

    @property
    def event_device_count(self) -> int:
        size = 1
        for a in self.event_axes:
            size *= self.mesh.shape[a]
        return size

    @property
    def scenario_device_count(self) -> int:
        return self.mesh.shape[self.scenario_axis] if self.scenario_axis \
            else 1

    def local_event_count(self, n_events: int) -> int:
        """Events per device under this spec (the quantity chunk sizes must
        divide for chunking × sharding)."""
        return n_events // self.event_device_count

    def event_coords(self, rank: int) -> dict:
        """The mesh coordinates of event rank ``rank`` (row-major over
        ``event_axes``, the first axis slowest)."""
        coords = {}
        for a in reversed(self.event_axes):
            rank, coords[a] = divmod(rank, self.mesh.shape[a])
        return coords

    def shard_device(self, rank: int, group: int = 0) -> torch.device:
        """The device holding event rank ``rank`` in scenario group
        ``group``."""
        coords = self.event_coords(rank)
        if self.scenario_axis is not None:
            coords[self.scenario_axis] = group
        return self.mesh.device(coords)

    @property
    def lead_device(self) -> torch.device:
        return self.shard_device(0)

    def plan(self, *, resolve: str = "auto", skip_retired: bool = True,
             chunks=None, scenario_chunks=None):
        """This mesh composed with the other execution axes into a
        :class:`repro_torch.core.executor.SweepPlan` (placement
        ``"sharded"``): ``chunks`` states chunking × sharding (each shard
        scans its own rows a chunk at a time; chunk sizes must divide
        :meth:`local_event_count` and hold whole canonical blocks),
        ``scenario_chunks`` the same on each scenario group's lanes."""
        from repro_torch.core.executor import SweepPlan
        return SweepPlan(placement="sharded", mesh=self, resolve=resolve,
                         skip_retired=skip_retired, chunks=chunks,
                         scenario_chunks=scenario_chunks)

    @property
    def is_multiprocess(self) -> bool:
        """Whether this spec's mesh spans more than one process."""
        return len(set(self.mesh.processes)) > 1

    @staticmethod
    def for_processes(device: DeviceLike = None) -> "SweepMeshSpec":
        """The multi-process sweep mesh: every rank of the
        ``torch.distributed`` world one event shard, in rank order, so rank
        ``r`` holds the ``r``-th contiguous row slice of the global log —
        the row-major placement a one-process mesh gives its shards, which
        makes the multihost sweep bit for bit the sharded one. ``device``
        is this rank's device (by default card ``rank % cards``; the CPU
        when the caller says so). Without a started process group it is a
        one-shard mesh of this process (:func:`distributed_initialize`
        starts one); scenario-axis process meshes are not supported."""
        dist = torch.distributed
        world = rank = 0
        if dist.is_available() and dist.is_initialized():
            world, rank = dist.get_world_size(), dist.get_rank()
        world = max(world, 1)
        if device is None:
            pick_device(None)
            device = torch.device("cuda", rank % torch.cuda.device_count())
        dev = _device(device)
        mesh = Mesh(devices=(dev,) * world, axis_names=("data",),
                    sizes=(world,), processes=tuple(range(world)))
        return SweepMeshSpec(mesh, event_axes=("data",))

    @staticmethod
    def for_devices(num_event_devices: Optional[int] = None,
                    num_scenario_devices: int = 1, *,
                    devices: Optional[Sequence[DeviceLike]] = None
                    ) -> "SweepMeshSpec":
        """A sweep mesh over ``devices`` (every visible CUDA card by
        default; a device may repeat). All of them shard events by default;
        ``num_scenario_devices > 1`` splits off a trailing ``"model"`` axis
        for the scenario grid (devices used = event × scenario), with
        ``repro``'s texts."""
        devs = _device_list(devices)
        n_total = len(devs)
        if num_scenario_devices < 1:
            raise ValueError(
                f"num_scenario_devices must be >= 1, got "
                f"{num_scenario_devices}")
        if num_event_devices is None:
            if n_total % num_scenario_devices != 0:
                raise ValueError(
                    f"{n_total} visible devices do not split into scenario "
                    f"groups of {num_scenario_devices}; pass "
                    "num_event_devices explicitly")
            num_event_devices = n_total // num_scenario_devices
        if num_event_devices < 1 or \
                num_event_devices * num_scenario_devices > n_total:
            raise ValueError(
                f"asked for {num_event_devices}×{num_scenario_devices} "
                f"devices but only {n_total} are visible")
        used = devs[:num_event_devices * num_scenario_devices]
        if num_scenario_devices > 1:
            mesh = make_mesh((num_event_devices, num_scenario_devices),
                             ("data", "model"), devices=used)
            return SweepMeshSpec(mesh, event_axes=("data",),
                                 scenario_axis="model")
        mesh = make_mesh((num_event_devices,), ("data",), devices=used)
        return SweepMeshSpec(mesh, event_axes=("data",))


def distributed_initialize(address: str, world_size: int, rank: int, *,
                           backend: Optional[str] = None,
                           device: DeviceLike = None) -> str:
    """Start this process's ``torch.distributed`` process group (the
    counterpart of ``repro.compat.distributed_initialize``): ``address``
    is ``tcp://host:port`` of rank 0. ``backend`` defaults to ``"nccl"``
    when this rank computes on a card and every rank can have a card of
    its own (``world_size`` at most the visible cards), and to ``"gloo"``
    otherwise: on the CPU, or with several ranks on one card, which NCCL
    refuses. Returns the backend."""
    if backend is None:
        dev = pick_device(device)
        backend = ("nccl" if dev.type == "cuda"
                   and world_size <= torch.cuda.device_count() else "gloo")
    torch.distributed.init_process_group(backend, init_method=address,
                                         world_size=world_size, rank=rank)
    return backend


# ---------------------------------------------------------------------------
# Shardings and sharded arrays
# ---------------------------------------------------------------------------

def ragged_shard_error(n_events: int, d_ev: int) -> ValueError:
    """``repro``'s ragged-shard text: N does not divide over the event
    ranks."""
    return ValueError(
        f"ragged shard: N={n_events} events over {d_ev} event-axis "
        f"devices leaves a remainder of {n_events % d_ev}. Pad the event "
        "log to a multiple of the event-device count (zero-valuation "
        "events never win, but they DO count toward rate denominators — "
        "pad the log upstream where that is accounted for) or use "
        "driver='batched'.")


@dataclasses.dataclass(frozen=True)
class ShardedLog:
    """An array split along its leading (event) axis over the event ranks
    of a mesh: ``shards[r]`` holds rows ``[offsets[r], offsets[r] +
    local_n)`` on rank ``r``'s device (scenario group 0). On one device
    the shards are views of one tensor."""

    shards: Tuple[torch.Tensor, ...]
    spec: SweepMeshSpec

    @property
    def local_n(self) -> int:
        return self.shards[0].shape[0]

    @property
    def offsets(self) -> Tuple[int, ...]:
        return tuple(r * self.local_n for r in range(len(self.shards)))

    @property
    def shape(self) -> tuple:
        return (self.local_n * len(self.shards),) + \
            tuple(self.shards[0].shape[1:])

    @property
    def device(self) -> torch.device:
        """The lead device (rank 0's)."""
        return self.shards[0].device

    def full(self, device: DeviceLike = None) -> torch.Tensor:
        """The whole array on ``device`` (the lead device by default): the
        shards concatenated in rank order."""
        dev = self.device if device is None else torch.device(device)
        return torch.cat([s.to(dev) for s in self.shards])


@dataclasses.dataclass(frozen=True)
class EventSharding:
    """Split the leading axis over a spec's event ranks
    (:func:`event_sharding`)."""

    spec: SweepMeshSpec

    def place(self, array) -> ShardedLog:
        """``array`` (a tensor or numpy array) as a :class:`ShardedLog` of
        this spec."""
        t = torch.as_tensor(array)
        d_ev = self.spec.event_device_count
        n = t.shape[0]
        if n % d_ev:
            raise ragged_shard_error(n, d_ev)
        local = n // d_ev
        return ShardedLog(
            shards=tuple(t[r * local:(r + 1) * local].to(
                self.spec.shard_device(r)) for r in range(d_ev)),
            spec=self.spec)


@dataclasses.dataclass(frozen=True)
class Replicated:
    """The whole array on the mesh's lead device (:func:`replicated`)."""

    spec: SweepMeshSpec

    def place(self, array) -> torch.Tensor:
        return torch.as_tensor(array).to(self.spec.lead_device)


def _as_spec(mesh, event_axes=("data",)) -> SweepMeshSpec:
    if isinstance(mesh, SweepMeshSpec):
        return mesh
    return SweepMeshSpec(mesh, event_axes=tuple(event_axes))


def event_sharding(mesh, event_axes: Sequence[str] = ("data",)
                   ) -> EventSharding:
    """The sharding of a per-event array: its leading axis split over
    ``event_axes`` of ``mesh`` (a :class:`Mesh` or a
    :class:`SweepMeshSpec`), row-major; the other axes kept whole."""
    return EventSharding(_as_spec(mesh, event_axes))


def replicated(mesh, event_axes: Sequence[str] = ("data",)) -> Replicated:
    """The sharding of an array every device reads whole (campaign state,
    budgets, designs): held once on the mesh's lead device."""
    return Replicated(_as_spec(mesh, event_axes))

