"""The z-slab mesh and the sharded step, in one process.

Counterpart of ``gpufluidsimulation_tpu.parallel.sharding``. The JAX
package's mesh is single-controller: one process holds
``Mesh(jax.devices()[:n])`` and GSPMD partitions the jitted step over it.
The port keeps that shape without ``torch.distributed``: a ``Mesh`` is a
list of D devices, in which one device may repeat (``make_mesh(4,
devices=["cuda:0"] * 4)`` puts four slabs on one card; the CPU tests use
``["cpu"] * 8``). ``devices[0]`` is the mesh's home device.

What runs sharded: the stages the JAX package shards explicitly. The
BiMocq map marches and the lattice samples of the pull-backs and
accumulates go slab by slab through the kernels' slab modes
(``parallel/sharded_interp.py``, routed by ``EngineMode.sharded_sampling``),
and with ``halo_smoother`` the MG V-cycle's damped Jacobi runs on the
slabs with a one-plane halo exchange (``parallel/halo.py``,
``ShardedMGContext``). What does not: the port has no automatic
partitioner, so between those stages the state lives whole on the home
device, and the forces, the emitters, the spectral projection, the CG
reductions, the prefilter, the map statistics and every other operation
run there. Keeping the state in its slabs between stages is later work,
as is a multi-process runner over ``torch.distributed`` for several
cards.
"""

from __future__ import annotations

import dataclasses

import torch

from gpufluidsimulation_tpu_torch import config
from gpufluidsimulation_tpu_torch.ops import poisson
from gpufluidsimulation_tpu_torch.parallel import halo as _halo


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of devices along the grid's z axis; a device may
    repeat. ``home`` (devices[0]) holds the state between the sharded
    stages."""

    devices: tuple
    axis: str = "z"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]


def make_mesh(n_devices: int, axis: str = "z", devices=None) -> Mesh:
    """A mesh of `n_devices`: by default the first n visible cards (it
    raises, as the JAX package does, when there are fewer); or the first
    n of `devices`, which may repeat a device but not mix the CPU and
    cards. A card given without an index is the current one
    (``config.resolve_device``), so ``"cuda"`` and ``"cuda:0"`` make the
    same mesh."""
    if devices is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if avail < n_devices:
            raise RuntimeError(
                f"make_mesh: {n_devices} devices requested but only {avail} "
                "visible (cuda backend); pass devices= to place several "
                "slabs on one device")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devices = [torch.device(d) for d in devices]
    if n_devices < 1 or len(devices) < n_devices:
        raise RuntimeError(f"make_mesh: {n_devices} devices requested, "
                           f"{len(devices)} given")
    devices = devices[:n_devices]
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"make_mesh: the devices {devices} mix device "
                         "types; a mesh runs on the CPU or on cards")
    return Mesh(tuple(config.resolve_device(d) for d in devices), axis)


def check_placement(mesh: Mesh, device, what: str) -> None:
    """Raise unless `mesh` lives on `device` (the solver's and its
    state's): its home is `device` and every slab has its device type, so
    no slab copies a card's fields to the host for the plain versions,
    nor launches kernels for a CPU solver."""
    device = torch.device(device)
    if mesh.home != device or any(d.type != device.type
                                  for d in mesh.devices):
        raise ValueError(f"{what}: the mesh's devices {list(mesh.devices)} "
                         f"do not live on the solver's device {device}: "
                         "its home must be that device and every slab "
                         "of its type")


def _to(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _to(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)})
    return tree


def shard_state(state, mesh: Mesh):
    """The state placed for ``sharded_step``: every tensor on the mesh's
    home device, where the state lives whole between the sharded stages
    (the JAX package places each leaf's z-shards instead)."""
    return _to(state, mesh.home)


class ShardedMGContext(poisson.MGContext):
    """``poisson.MGContext`` whose V-cycles smooth with damped Jacobi:
    through the slab halo exchange (``halo.jacobi_smooth_sharded``) on
    every level whose z extent divides the mesh with at least 2 planes a
    slab, with ``poisson.jacobi_smooth`` on the others. Both equal the
    Jacobi of ``MGContext(rbgs=False)`` bit for bit, so a projection
    through this context equals one through that."""

    def __init__(self, shape, bc, mesh: Mesh):
        super().__init__(shape, bc, mesh.home, rbgs=False)
        self.mesh = mesh

    def _smooth(self, x, b, level, iters, omega, reverse=False):
        # `reverse` orders red-black sweeps; damped Jacobi has no order
        if x is None:       # the pre-smoother's exactly-zero guess
            x = torch.zeros_like(b)
        nz = self.shapes[level][2]
        D = self.mesh.size
        if nz % D == 0 and nz // D >= 2:
            return _halo.jacobi_smooth_sharded(x, b, self.mesh, self.bc,
                                               self.diags[level], iters,
                                               omega)
        return poisson.jacobi_smooth(x, b, self.bc, self.diags[level], iters,
                                     omega)


def sharded_step(solver, mesh: Mesh, halo_smoother: bool = True,
                 fast_sampling: bool | None = None, halo: int = 8):
    """The step of `solver` (a ``solvers.smoke3d.Smoke3D``, any scheme)
    over `mesh`: a function state -> state.

    With ``halo_smoother=True`` an open-box MG-PCG projection smooths
    through ``ShardedMGContext``; otherwise, and with solid boundaries
    (whose masked V-cycle keeps its own smoother), with the solver's own
    context.
    ``fast_sampling`` routes the BiMocq map marches and lattice samples
    through the z-slab kernels (the scoped ``EngineMode`` carries
    ``sharded_sampling=(mesh, halo)``, else ``()``); None means on when
    the mesh's devices are cards and off on the CPU, as the JAX package
    turns it on for accelerator backends. The state lives on the mesh's
    home device (``shard_state``), which must be the solver's. In the bf16
    mode (``EngineMode.interp_bf16``) the scoped mode rounds the slab
    paths alone (``config.SLABS``): the slab samplers and the forward
    march as ``parallel/sharded_interp.py`` says, every other sample in
    float32, as the JAX package's sharded step turns its single-device
    window samplers off."""
    from gpufluidsimulation_tpu_torch.solvers import smoke3d

    check_placement(mesh, solver.device, "sharded_step")
    step_fn = smoke3d._STEPS[solver.cfg.scheme]
    ctx = solver.ctx
    if halo_smoother and ctx is not None and not solver.cfg.boundaries:
        ctx = ShardedMGContext(solver.grid.shape_c, solver.cfg.bc, mesh)
    if fast_sampling is None:
        fast_sampling = all(d.type == "cuda" for d in mesh.devices)
    mode = solver.cfg.engine_mode or config.EngineMode()
    mode = dataclasses.replace(
        mode, sharded_sampling=(mesh, int(halo)) if fast_sampling else (),
        interp_bf16=config.SLABS if mode.slab_bf16 else mode.interp_bf16)
    cfg = dataclasses.replace(solver.cfg, engine_mode=mode)
    base = solver._base_flags

    def step(state):
        return step_fn(cfg, solver.grid, ctx, base, state)

    return step
