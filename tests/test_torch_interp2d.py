"""The port's 2D grid and samplers against the JAX package on the CPU.

``bilerp_sample`` and ``bilerp_sample_mac`` take their plain versions on
CPU tensors (the CUDA kernel repeats their operations in the same order;
chip_smoke.py holds the two together on the card, bit for bit). They are
held here against ``interp.sample2`` and ``interp.mac_velocity_2d`` of
the JAX package (its exact gathers, the CPU default) within 1e-6 of the
sampled field's scale, at positions that wander up to 3 cells off their
nodes and past the domain's edge, on a (24, 40) grid and on the 5-point
volume stencil's (5, nx, ny) position batches; and against the lifted
Pallas sampler they replace on the accelerator (``sample2_fast``,
``mac2_fast``, interpret mode) within its window's round-off, at
positions inside its reach.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu.core import grids as jgrids
from gpufluidsimulation_tpu.core import interp as jinterp
from gpufluidsimulation_tpu.ops import interp_fast as jfast
from gpufluidsimulation_tpu_torch.core import grids, interp
from gpufluidsimulation_tpu_torch.ops import interp_fast

NI, NJ = 24, 40
H = 1.0 / NI


def _smooth(shape, seed, amp):
    rng = np.random.default_rng(seed)
    idx = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                      indexing="ij")
    f = np.zeros(shape)
    for _ in range(2):
        k = rng.uniform(0.5, 2.0, len(shape)) * 2 * np.pi / np.array(shape)
        f += np.sin(sum(kk * ii for kk, ii in zip(k, idx))
                    + rng.uniform(0, 2 * np.pi))
    return (amp * f / 2).astype(np.float32)


def _grids():
    return jgrids.Grid2D(NI, NJ, H), grids.Grid2D(NI, NJ, H)


def _t(a):
    return torch.from_numpy(np.array(a))


def _positions(kind, seed, amp_cells, batch=False):
    """`kind`'s node lattice displaced smoothly by up to amp_cells; with
    `batch` five such displacements stacked (5, nx, ny)."""
    jg, _ = _grids()
    px, py = (np.asarray(p) for p in jg.node_coords(kind))
    reps = 5 if batch else 1
    out = []
    for i, p in enumerate((px, py)):
        q = np.stack([p + _smooth(p.shape, seed + 10 * r + i, amp_cells * H)
                      for r in range(reps)]).astype(np.float32)
        out.append(q if batch else q[0])
    return out


@pytest.mark.parametrize("kind", ["c", "u", "v"])
def test_grid2d_matches_jax(kind):
    jg, tg = _grids()
    for a, b in zip(jg.node_coords(kind), tg.node_coords(kind)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert b.is_contiguous()
    assert tuple(tg.zeros(kind).shape) == np.asarray(jg.zeros(kind)).shape
    assert tg.off_of(kind) == jg.off_of(kind)
    assert tg.shape_of(kind) == getattr(jg, f"shape_{kind}")
    assert tg.shape_curl == jg.shape_curl


@pytest.mark.parametrize("kind", ["c", "u", "v"])
@pytest.mark.parametrize("channels", [1, 2, 4])
@pytest.mark.parametrize("batch", [False, True])
def test_bilerp_sample_matches_sample2(kind, channels, batch):
    """C stacked fields at shared positions, per-channel offsets (the
    last channel of a 4-stack on another lattice's offset, so the kernel's
    shared floors are left and taken again)."""
    jg, _ = _grids()
    shape = np.asarray(jg.node_coords(kind)[0]).shape
    fields = np.stack([_smooth(shape, 10 + c, 1.0 + 10 * c)
                       for c in range(channels)])
    offs = [jg.off_of(kind)] * channels
    if channels == 4:
        offs[3] = (0.5, 0.0) if kind != "v" else (0.0, 0.5)
    pos = _positions(kind, 20, 3.0, batch)
    got = interp_fast.bilerp_sample(_t(fields), *map(_t, pos), H,
                                    tuple(offs)).numpy()
    assert got.shape == (channels,) + pos[0].shape
    for c in range(channels):
        want = jinterp.sample2(jnp.asarray(fields[c]),
                               *(jnp.asarray(p) for p in pos), H, offs[c])
        scale = float(np.abs(fields[c]).max())
        np.testing.assert_allclose(got[c], np.asarray(want), rtol=0,
                                   atol=1e-6 * scale)
        np.testing.assert_array_equal(
            got[c], interp.sample2(_t(fields[c]), *map(_t, pos), H,
                                   offs[c]).numpy())


@pytest.mark.parametrize("amp_cells", [0.6, 3.0])
def test_mac_velocity_2d_matches_jax(amp_cells):
    """Both components of the MAC velocity, zero outside their bands."""
    jg, _ = _grids()
    u = _smooth(jg.shape_u, 1, 0.2)
    v = _smooth(jg.shape_v, 2, 0.2)
    pos = _positions("c", 30, amp_cells, batch=True)
    want = jinterp.mac_velocity_2d(jnp.asarray(u), jnp.asarray(v),
                                   *(jnp.asarray(p) for p in pos), H)
    got = interp_fast.bilerp_sample_mac(_t(u), _t(v), *map(_t, pos), H)
    lat = interp.mac_velocity_2d_lattice(_t(u), _t(v), *map(_t, pos), H)
    for c, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6 * 0.2)
        np.testing.assert_array_equal((a.numpy() == 0), (b == 0))
        np.testing.assert_array_equal(lat[c].numpy(), a.numpy())
    # the edge rows sit on the band's edge: some samples leave it
    assert sum(int((np.asarray(b) == 0).sum()) for b in want) > 0


def test_clamp_pos_2d_matches_jax():
    pos = _positions("c", 40, 3.0)
    for eps in (1.0, 0.001):
        want = jinterp.clamp_pos_2d(*(jnp.asarray(p) for p in pos), H, NI, NJ,
                                    eps=eps)
        got = interp.clamp_pos_2d(*map(_t, pos), H, NI, NJ, eps=eps)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_lattice_dispatchers_launch_nothing_on_cpu():
    jg, _ = _grids()
    f = _t(_smooth(jg.shape_c, 3, 1.0))
    pos = [_t(p) for p in _positions("c", 50, 1.0)]
    before = (interp_fast.bilerp_sample.launches,
              interp_fast.bilerp_sample_mac.launches)
    a = interp.sample2_lattice(f, *pos, H, jg.OFF_C)
    b = interp.sample2_lattice_multi([f, 2 * f], *pos, H,
                                     (jg.OFF_C, jg.OFF_C))
    np.testing.assert_array_equal(a.numpy(), b[0].numpy())
    np.testing.assert_array_equal(b[1].numpy(),
                                  interp.sample2(2 * f, *pos, H,
                                                 jg.OFF_C).numpy())
    assert (interp_fast.bilerp_sample.launches,
            interp_fast.bilerp_sample_mac.launches) == before == (0, 0)


@pytest.mark.parametrize("kind", ["c", "u"])
def test_bilerp_matches_the_lifted_pallas_sampler(kind):
    """The TPU kernel that bilerp_sample replaces: sample2_fast and
    mac2_fast (the 3D window sampler on a singleton x axis, interpret
    mode) at positions within its reach. Its taps are hat weights in
    window-local coordinates, renormalized by their coverage: other
    roundings than the clamped bilinear's."""
    jg, _ = _grids()
    shape = np.asarray(jg.node_coords(kind)[0]).shape
    f = _smooth(shape, 60, 2.0)
    pos = _positions(kind, 70, 1.0, batch=True)
    jpos = [jnp.asarray(p) for p in pos]
    want = np.asarray(jfast.sample2_fast(jnp.asarray(f), *jpos, H,
                                         jg.off_of(kind), interpret=True))
    got = interp_fast.bilerp_sample(_t(f)[None], *map(_t, pos), H,
                                    (jg.off_of(kind),))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 2.0)
    u = _smooth(jg.shape_u, 61, 0.2)
    v = _smooth(jg.shape_v, 62, 0.2)
    want = jfast.mac2_fast(jnp.asarray(u), jnp.asarray(v), *jpos, H,
                           interpret=True)
    got = interp_fast.bilerp_sample_mac(_t(u), _t(v), *map(_t, pos), H)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5 * 0.2)
