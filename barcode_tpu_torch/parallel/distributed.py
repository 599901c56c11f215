"""Process groups and the ('chains', 'grid') process layout.

Port of barcode_tpu/parallel/distributed.py:1-45.  The JAX package spreads
chains and grid slabs over a device mesh inside one program; here every
rank is one process with one device, joined by `torch.distributed`: NCCL
on the card, gloo on the CPU.  Rank r sits at row r // n_grid ('chains')
and column r % n_grid ('grid'), as a row-major (chains, grid) mesh, and
owns `chains_per_rank` chains of its row (the JAX package's local vmap
batch).  The sharded collectives run over the rank's `grid` subgroup; the
pooled adaptation gathers over its `chains` subgroup.

A process group is made once per process:
  * `initialize_multihost(coordinator, num_processes, process_id)` for an
    explicit `tcp://` rendezvous, or `env://` under torchrun;
  * otherwise the sharded entry points call `ensure_process_group`, which
    takes torchrun's environment when it is set and else makes a group of
    size 1, so that the collectives still go through `torch.distributed`.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from barcode_tpu_torch.device import resolve


def backend_for(device) -> str:
    """NCCL for the card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device=None) -> torch.device:
    """The device of this rank: cuda:LOCAL_RANK on the card (raises without
    one), the CPU when asked for."""
    dev = resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    return dev


def _init(device, **kwargs) -> None:
    dev = rank_device(device)
    if dev.type == "cuda":
        kwargs["device_id"] = dev
    dist.init_process_group(backend_for(dev), **kwargs)


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         device=None) -> None:
    """init_process_group with an explicit `tcp://coordinator` rendezvous,
    or `env://` (torchrun's MASTER_ADDR/PORT, RANK, WORLD_SIZE) when no
    coordinator is given."""
    if coordinator is None:
        _init(device, init_method="env://")
        return
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator needs --num-processes and "
                         "--process-id")
    _init(device, init_method=f"tcp://{coordinator}",
          world_size=int(num_processes), rank=int(process_id))


def ensure_process_group(device=None) -> None:
    """Make a process group if none exists: torchrun's (`env://`) when its
    environment is set, else one of size 1."""
    if dist.is_initialized():
        return
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        _init(device, init_method="env://")
    else:
        _init(device, store=dist.HashStore(), rank=0, world_size=1)


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place in the (chains, grid) process grid.

    rows x n_grid ranks; `grid_group` joins the ranks of this rank's row
    (the slabs of its chains), `chains_group` those of its column.
    `chains_per_rank` chains of the row live on each of its ranks."""

    rows: int
    n_grid: int
    chains_per_rank: int
    rank: int
    device: torch.device
    grid_group: object
    chains_group: object

    @property
    def row(self) -> int:
        return self.rank // self.n_grid

    @property
    def col(self) -> int:
        return self.rank % self.n_grid

    @property
    def n_chains(self) -> int:
        return self.rows * self.chains_per_rank

    @property
    def shape(self) -> dict:
        return {"chains": self.rows, "grid": self.n_grid}

    @property
    def chain_ids(self) -> range:
        """Global indices of this rank's chains."""
        c = self.chains_per_rank
        return range(self.row * c, (self.row + 1) * c)


def make_layout(rows: int, n_grid: int, chains_per_rank: int = 1,
                device=None) -> Layout:
    """The layout of rows x n_grid ranks over the current process group
    (made by `ensure_process_group` if none exists).  Every rank calls it:
    the subgroups are made collectively."""
    ensure_process_group(device)
    world = dist.get_world_size()
    if rows * n_grid != world:
        raise ValueError(f"a {rows} x {n_grid} layout needs {rows * n_grid} "
                         f"ranks, the process group has {world}")
    rank = dist.get_rank()
    grid_groups = [dist.new_group(list(range(r * n_grid, (r + 1) * n_grid)))
                   for r in range(rows)]
    chains_groups = [dist.new_group(list(range(c, world, n_grid)))
                     for c in range(n_grid)]
    return Layout(rows=rows, n_grid=n_grid, chains_per_rank=chains_per_rank,
                  rank=rank, device=rank_device(device),
                  grid_group=grid_groups[rank // n_grid],
                  chains_group=chains_groups[rank % n_grid])


def pod_chain_mesh(grid_axis: int = 1, device=None) -> Layout:
    """Every rank as (world / grid_axis) chain rows of grid_axis slabs, one
    chain per rank (the JAX package's ('chains',) or ('chains', 'grid')
    mesh over all devices)."""
    ensure_process_group(device)
    world = dist.get_world_size()
    if world % grid_axis:
        raise ValueError(f"{world} ranks do not split into slabs of "
                         f"{grid_axis}")
    return make_layout(world // grid_axis, grid_axis, device=device)


def default_mesh(n_chains: int, device=None) -> Layout:
    """All ranks as a (chains, grid) grid, the grid axis taking the rest;
    raises where the JAX package's default_mesh raises
    (sharded_runner.py:57-63)."""
    ensure_process_group(device)
    world = dist.get_world_size()
    if world % n_chains != 0:
        raise ValueError(f"{world} devices not divisible by "
                         f"{n_chains} chains")
    return make_layout(n_chains, world // n_chains, device=device)


def local_chain_count(n_chains_global: int) -> int:
    """Chains this process owns under even sharding."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    if n_chains_global % n_proc:
        raise ValueError(f"{n_chains_global} chains do not split over "
                         f"{n_proc} processes")
    return n_chains_global // n_proc
