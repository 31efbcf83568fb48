"""Halo-exchange stencils on z-slabs: the sharded Laplacian and damped
Jacobi of the MG smoother.

Counterpart of ``gpufluidsimulation_tpu.parallel.halo``. There each
device of a ``shard_map`` holds one z-slab and trades its edge planes
with ``ppermute``. Here a field is split into the mesh's slabs, one on
each of its devices (``split_z``), and the exchange copies the planes
between slab tensors: between cards a peer copy, on one device a plain
copy. The neighbours are summed in the order of
``poisson._neighbor_sum`` (x, then y, then z, each lower plus upper), so
``laplacian_sharded`` and ``jacobi_smooth_sharded`` equal
``poisson.laplacian`` and ``poisson.jacobi_smooth`` bit for bit.
"""

from __future__ import annotations

import torch


def split_z(x, mesh, contiguous=False):
    """The mesh's z-slabs of `x` (last axis), slab d on
    ``mesh.devices[d]``: a view where it already lies there, else a copy;
    with `contiguous`, each in a contiguous buffer (a kernel's input). The
    extent must divide the mesh."""
    n = x.shape[-1]
    if n % mesh.size:
        raise ValueError(f"z extent {n} does not divide the {mesh.size}-"
                         "device mesh")
    nl = n // mesh.size
    slabs = [x[..., d * nl:(d + 1) * nl].to(dev)
             for d, dev in enumerate(mesh.devices)]
    return [s.contiguous() for s in slabs] if contiguous else slabs


def gather_z(slabs, device):
    """The whole field from its slabs, on `device`."""
    return torch.cat([s.to(device) for s in slabs], dim=-1)


def halo_exchange_z(slabs):
    """(left, right) halo planes of every slab from its z-neighbours, each
    on the slab's device. Non-periodic: the first slab's left halo and the
    last slab's right halo are zero planes (Dirichlet ghosts); callers
    overlay their own boundary handling."""
    D = len(slabs)
    out = []
    for d, s in enumerate(slabs):
        left = (torch.zeros_like(s[..., :1]) if d == 0
                else slabs[d - 1][..., -1:].to(s.device))
        right = (torch.zeros_like(s[..., :1]) if d == D - 1
                 else slabs[d + 1][..., :1].to(s.device))
        out.append((left, right))
    return out


def _shifts(p, axis, neumann):
    """(p[i-1], p[i+1]) along `axis`: edge-replicated for Neumann, zero
    for Dirichlet ghosts."""
    n = p.shape[axis]
    if neumann:
        lo, hi = p.narrow(axis, 0, 1), p.narrow(axis, n - 1, 1)
    else:
        lo = hi = torch.zeros_like(p.narrow(axis, 0, 1))
    pp = torch.cat([lo, p, hi], dim=axis)
    return pp.narrow(axis, 0, n), pp.narrow(axis, 2, n)


def _neighbor_sum_local(p, left_halo, right_halo, bc, first, last):
    """Neighbour sum of one slab with x and y local and the z halos
    supplied; at the global z edges (the `first` and `last` slab) a
    Neumann slab replicates its own edge plane."""
    neumann = bc == "neumann"
    total = torch.zeros_like(p)
    for axis in (0, 1):
        lo, hi = _shifts(p, axis, neumann)
        total = total + lo + hi
    if neumann and first:
        left_halo = p[..., :1]
    if neumann and last:
        right_halo = p[..., -1:]
    pz = torch.cat([left_halo, p, right_halo], dim=-1)
    n = p.shape[-1]
    return total + pz[..., :n] + pz[..., 2:]


def _laplacian_slabs(slabs, bc):
    D = len(slabs)
    return [6 * s - _neighbor_sum_local(s, lh, rh, bc, d == 0, d == D - 1)
            for d, (s, (lh, rh)) in enumerate(zip(slabs,
                                                  halo_exchange_z(slabs)))]


def laplacian_sharded(p, mesh, bc):
    """L p = 6p - neighbour sum through the slab halo exchange (equals
    ``poisson.laplacian``). Returns the whole field on p's device."""
    return gather_z(_laplacian_slabs(split_z(p, mesh), bc), p.device)


def jacobi_smooth_sharded(x, b, mesh, bc, diag, iters, omega=0.8):
    """Damped Jacobi x <- x + omega (b - L x) / diag with one halo
    exchange an iteration (equals ``poisson.jacobi_smooth``). Returns the
    whole field on x's device."""
    xs, bs, ds = (split_z(t, mesh) for t in (x, b, diag))
    for _ in range(int(iters)):
        xs = [xl + omega * (bl - lap) / dl
              for xl, bl, dl, lap in zip(xs, bs, ds,
                                         _laplacian_slabs(xs, bc))]
    return gather_z(xs, x.device)
