"""Clamped trilinear samplers — the plain PyTorch gather core of the port.

``sample3`` is the exact clamped-index trilinear of
``gpufluidsimulation_tpu.core.interp.sample3``: every corner index is
clamped to the field (the reference's ``boundedAt``), and the blend order
is x, then y, then z. ``trilerp_grid`` is the same sampler in grid units
(index coordinates on the field's own lattice); the CUDA kernels under
``csrc/`` evaluate exactly these operations in the same order.
``trilerp_grid_slab`` is the sampler of the kernels' slab modes (a z-slab
of the grid, addressed by an integer origin), ``sample3_cubic`` the
reference's tricubic sampler, which no solver calls.
"""

from __future__ import annotations

import torch

MAC_OFFS = ((-0.5, 0.0, 0.0), (0.0, -0.5, 0.0), (0.0, 0.0, -0.5))


def div_scalar(x, s: float):
    """x / s in IEEE division. PyTorch's CUDA division by a host scalar
    multiplies by the reciprocal instead, which can differ in the last
    bit from the kernels' division; a device 0-dim divisor keeps the
    plain versions bit-comparable on the card."""
    if x.is_cuda:
        return x / torch.full((), s, dtype=x.dtype, device=x.device)
    return x / s


def _axis_corners(g, n):
    i0f = torch.floor(g)
    f = g - i0f
    i0 = i0f.long()
    return i0.clamp(0, n - 1), (i0 + 1).clamp(0, n - 1), f


def corners_grid(field, gx, gy, gz):
    """The 8 clamped corner values of the trilinear cell around grid
    coordinates g, in the order of ``gpufluidsimulation_tpu.core.interp.
    _gather8_3d`` (x fastest: v000, v100, v010, v110, v001, ...), and the
    fractions (fx, fy, fz)."""
    nx, ny, nz = field.shape
    ia, ib, fx = _axis_corners(gx, nx)
    ja, jb, fy = _axis_corners(gy, ny)
    ka, kb, fz = _axis_corners(gz, nz)
    flat = field.reshape(-1)
    vals = [flat[(i * ny + j) * nz + k]
            for k in (ka, kb) for j in (ja, jb) for i in (ia, ib)]
    return vals, (fx, fy, fz)


def trilerp_grid(field, gx, gy, gz):
    """Trilinear sample of `field` at grid coordinates (index units on the
    field's lattice) with per-corner index clamping."""
    return _blend(*corners_grid(field, gx, gy, gz))


def trilerp_grid_slab(field, gx, gy, gz, z0, nz):
    """``trilerp_grid`` on a z slab: `field` holds planes z0 .. z0 +
    field.shape[2] - 1 of a grid of `nz` planes, and g is a global grid
    coordinate. Each z corner is clamped to [0, nz - 1], then taken to the
    slab by the integer origin z0 and clamped to it. Returns the sample
    and where a corner fell outside the slab."""
    nx, ny, nl = field.shape
    ia, ib, fx = _axis_corners(gx, nx)
    ja, jb, fy = _axis_corners(gy, ny)
    ka, kb, fz = _axis_corners(gz, nz)
    la, lb = (ka - z0).clamp(0, nl - 1), (kb - z0).clamp(0, nl - 1)
    outside = (la != ka - z0) | (lb != kb - z0)
    flat = field.reshape(-1)
    vals = [flat[(i * ny + j) * nl + k]
            for k in (la, lb) for j in (ja, jb) for i in (ia, ib)]
    return _blend(vals, (fx, fy, fz)), outside


def _blend(vals, fracs):
    """The x, then y, then z blend of the 8 corner values."""
    (v000, v100, v010, v110, v001, v101, v011, v111), (fx, fy, fz) = (
        vals, fracs)
    c00 = (1 - fx) * v000 + fx * v100
    c10 = (1 - fx) * v010 + fx * v110
    c01 = (1 - fx) * v001 + fx * v101
    c11 = (1 - fx) * v011 + fx * v111
    c0 = (1 - fy) * c00 + fy * c10
    c1 = (1 - fy) * c01 + fy * c11
    return (1 - fz) * c0 + fz * c1


def sample3(field, px, py, pz, h, off):
    """Trilinear sample at world positions; the field's lattice is
    (i + off)*h per axis (``off`` in units of h)."""
    return trilerp_grid(
        field,
        div_scalar(px, h) - off[0],
        div_scalar(py, h) - off[1],
        div_scalar(pz, h) - off[2],
    )


def mac_velocity_3d(u, v, w, px, py, pz, h):
    """The 3D MAC velocity at world positions (each component sampled on
    its own staggered lattice)."""
    return (sample3(u, px, py, pz, h, MAC_OFFS[0]),
            sample3(v, px, py, pz, h, MAC_OFFS[1]),
            sample3(w, px, py, pz, h, MAC_OFFS[2]))


def mac_velocity_grid(u, v, w, gx, gy, gz):
    """MAC velocity at cell-lattice grid coordinates (g = p/h): the
    staggered component of each field sits half a cell lower, so its own
    grid coordinate is g + 0.5 on that axis."""
    return (trilerp_grid(u, gx + 0.5, gy, gz),
            trilerp_grid(v, gx, gy + 0.5, gz),
            trilerp_grid(w, gx, gy, gz + 0.5))


def _cubic_weights(f):
    """Cubic interpolation weights (cubic_interp_weights,
    utils/util.h:354-361) at fraction f, for the taps -1, 0, 1, 2."""
    f2 = f * f
    f3 = f2 * f
    wm = -(1.0 / 3.0) * f + 0.5 * f2 - (1.0 / 6.0) * f3
    w0 = 1.0 - f2 + 0.5 * (f3 - f)
    w1 = f + 0.5 * (f2 - f3)
    w2 = (1.0 / 6.0) * (f3 - f)
    return wm, w0, w1, w2


def _gather3(field, i, j, k):
    """field[i, j, k] with each index clamped to the field (boundedAt)."""
    nx, ny, nz = field.shape
    i, j, k = i.clamp(0, nx - 1), j.clamp(0, ny - 1), k.clamp(0, nz - 1)
    return field.reshape(-1)[(i * ny + j) * nz + k]


def sample3_cubic(field, px, py, pz, h, off):
    """Tricubic sample (buffer3Df::sample_cubic, fluid_buffer3D.h:237-309):
    the separable 4-tap cubic per axis over the 64-point neighbourhood,
    corner indices clamped, summed x innermost, then y, then z as the JAX
    package sums them. No solver calls it, in either package; it is kept
    for the API and for high-order resampling."""
    gx = div_scalar(px, h) - off[0]
    gy = div_scalar(py, h) - off[1]
    gz = div_scalar(pz, h) - off[2]
    i0, j0, k0 = torch.floor(gx), torch.floor(gy), torch.floor(gz)
    wx = _cubic_weights(gx - i0)
    wy = _cubic_weights(gy - j0)
    wz = _cubic_weights(gz - k0)
    i0, j0, k0 = i0.long(), j0.long(), k0.long()
    out = torch.zeros_like(gx)
    for dk, wk in zip((-1, 0, 1, 2), wz):
        acc_y = torch.zeros_like(gx)
        for dj, wj in zip((-1, 0, 1, 2), wy):
            acc_x = torch.zeros_like(gx)
            for di, wi in zip((-1, 0, 1, 2), wx):
                acc_x = acc_x + wi * _gather3(field, i0 + di, j0 + dj,
                                              k0 + dk)
            acc_y = acc_y + wj * acc_x
        out = out + wk * acc_y
    return out


def mac_pack_3d(u, v, w):
    """The MAC triplet edge-padded to the common (ni+1, nj+1, nk+1) shape
    and stacked, so one C=3 sample with offsets ``MAC_OFFS`` evaluates the
    MAC velocity: clamped indices into the padded copy read the same
    values as clamped indices into each component."""
    shape = tuple(max(s) for s in zip(u.shape, v.shape, w.shape))
    out = []
    for f in (u, v, w):
        for axis in range(3):
            if f.shape[axis] < shape[axis]:
                f = torch.cat([f, f.narrow(axis, f.shape[axis] - 1, 1)],
                              dim=axis)
        out.append(f)
    return torch.stack(out)


def mac_velocity_at_c_3d(u, v, w):
    """MAC velocity at the cell-center lattice: static face averages."""
    return (0.5 * (u[:-1] + u[1:]),
            0.5 * (v[:, :-1] + v[:, 1:]),
            0.5 * (w[:, :, :-1] + w[:, :, 1:]))


def clamp_pos_3d(px, py, pz, h, ni, nj, nk, lo=1.0, hi=1.0):
    """Clamp world positions to [lo*h, L - hi*h] per axis."""
    return (
        px.clamp(lo * h, ni * h - hi * h),
        py.clamp(lo * h, nj * h - hi * h),
        pz.clamp(lo * h, nk * h - hi * h),
    )


def sample3_separable(field, dx, dy, dz, h):
    """Trilinear lookup of a voxel grid at a uniformly shifted lattice:
    each world offset varies along its own axis only (dx over x, dy over
    y, dz over z: ``Grid3D.axis_coords`` minus a position, or full grids),
    as in the voxel boundary and emitter lookups. The clamped corner
    indices of ``trilerp_grid`` and its x, y, z blend order, as one
    ``index_select`` of both corner planes an axis; a node far outside
    the grid reads the nearest edge value."""
    out = field
    for axis, d in enumerate((dx, dy, dz)):
        along = [0, 0, 0]
        along[axis] = slice(None)
        g = div_scalar(d[tuple(along)], h)
        n = field.shape[axis]
        i0f = torch.floor(g)
        f = g - i0f
        i0 = i0f.long()
        both = torch.cat([i0.clamp(0, n - 1), (i0 + 1).clamp(0, n - 1)])
        a0, a1 = out.index_select(axis, both).split(g.numel(), dim=axis)
        shape = [1, 1, 1]
        shape[axis] = g.numel()
        f = f.reshape(shape)
        out = (1 - f) * a0 + f * a1
    return out


# ---------------------------------------------------------------------------
# 2D: the 2D reference conventions (lattice (i + off)*h, offsets of
# ``Grid2D``), the samplers of gpufluidsimulation_tpu.core.interp
# ---------------------------------------------------------------------------

# u at (i, j + 0.5)h, v at (i + 0.5, j)h
MAC_OFFS_2D = ((0.0, 0.5), (0.5, 0.0))


def bilerp_grid(field, gx, gy):
    """Bilinear sample of a 2D `field` at grid coordinates with per-corner
    index clamping, blended as ``sample2`` blends: x first, then y."""
    nx, ny = field.shape
    ia, ib, fx = _axis_corners(gx, nx)
    ja, jb, fy = _axis_corners(gy, ny)
    flat = field.reshape(-1)
    v00, v10 = flat[ia * ny + ja], flat[ib * ny + ja]
    v01, v11 = flat[ia * ny + jb], flat[ib * ny + jb]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v10)
            + fy * ((1 - fx) * v01 + fx * v11))


def sample2(field, px, py, h, off):
    """Bilinear sample of `field` at world positions (px, py); the
    field's lattice is x = (i + off)*h per axis."""
    return bilerp_grid(field, div_scalar(px, h) - off[0],
                       div_scalar(py, h) - off[1])


def mac_velocity_2d(u, v, px, py, h):
    """The 2D MAC velocity (us, vs) at world positions: out-of-band
    samples are 0, not clamped. The bands, on the float floors of the grid
    coordinates: u for i0 in [0, ni-1], j0 in [0, nj-2]; v for i0 in
    [0, ni-2], j0 in [0, nj-1] (ni x nj cells)."""
    ni, nj = v.shape[0], u.shape[1]
    x, y = div_scalar(px, h), div_scalar(py, h)
    out = []
    for f, (ox, oy), (bx, by) in zip((u, v), MAC_OFFS_2D,
                                     ((ni - 1, nj - 2), (ni - 2, nj - 1))):
        gx, gy = x - ox, y - oy
        i0, j0 = torch.floor(gx), torch.floor(gy)
        valid = (i0 >= 0) & (i0 <= bx) & (j0 >= 0) & (j0 <= by)
        out.append(torch.where(valid, bilerp_grid(f, gx, gy), 0.0))
    return out[0], out[1]


def clamp_bounds_2d(h, ni, nj, eps=1.0):
    """The bounds ((lo, hi) in x, (lo, hi) in y) of ``clamp_pos_2d`` as
    host doubles, which torch.clamp rounds once to float32."""
    return ((eps * h, ni * h - eps * h), (eps * h, nj * h - eps * h))


def clamp_pos_2d(px, py, h, ni, nj, eps=1.0):
    """Clamp world positions to [eps*h, L - eps*h] per axis."""
    (lx, hx), (ly, hy) = clamp_bounds_2d(h, ni, nj, eps)
    return px.clamp(lx, hx), py.clamp(ly, hy)


def sample2_lattice(field, px, py, h, off, bf16=False):
    """``sample2`` through the ``bilerp_sample`` kernel: on a CUDA tensor
    one launch, on a CPU tensor its plain version. `bf16` samples the
    field's bfloat16 rounding (a field-value sample in the bf16 mode, as
    the JAX package's ``values=True``)."""
    return sample2_lattice_multi([field], px, py, h, (off,), bf16)[0]


def sample2_lattice_multi(fields, px, py, h, offs, bf16=False):
    """``sample2`` of C <= 4 same-shape fields at the same positions, one
    ``bilerp_sample`` launch that reads each field in place (with `bf16`
    its bfloat16 rounding): (C, *px.shape)."""
    from gpufluidsimulation_tpu_torch.ops import interp_fast

    fields = [(f.to(interp_fast.BF16) if bf16 else f).contiguous()
              for f in fields]
    return interp_fast.bilerp_sample(fields, px, py, h, tuple(offs))


def mac_velocity_2d_lattice(u, v, px, py, h):
    """``mac_velocity_2d`` through the ``bilerp_sample`` kernel's mac
    mode: one launch for both components."""
    from gpufluidsimulation_tpu_torch.ops import interp_fast

    out = interp_fast.bilerp_sample_mac(u, v, px, py, h)
    return out[0], out[1]
