"""The port's corner min/max (``minmax_sample``) against the JAX package.

``minmax_sample_plain`` computes the MacCormack trace clamp bounds of the
JAX package's exact path (``advect.maccormack_multi_3d`` off the fast
path: floor, the 8 corners clipped per axis as ``core.interp._gather8_3d``
clips them, min and max). It must equal a numpy 8-corner gather exactly,
positions up to 2 cells outside the domain included (the midpoint
backtrace is not clamped into the domain, so index clipping is the
semantics there).

Against the TPU kernel ``interp_fast.minmax3_fast`` (Pallas, interpret
mode) it agrees to 1e-6 away from two places where that kernel differs by
design: it drops a corner whose hat weight rounds to 0 (positions within
an ulp of a lattice plane), and at the window rim its padded cells are not
the clipped corners (the JAX package's own test compares the interior).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu.ops import interp_fast as jfast
from gpufluidsimulation_tpu_torch.core.grids import Grid3D
from gpufluidsimulation_tpu_torch.ops import interp_fast

H = 0.1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU work in these tests is small tensors, and under the
    tier-1 suite's six workers torch's intra-op pool spends more CPU
    waiting for its threads than computing: one thread for each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _positions(shape, off, rng, max_disp):
    """Lattice positions of `shape` on the (i + off)*h lattice, displaced
    smoothly by up to `max_disp` cells per axis."""
    idx = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                      indexing="ij")
    out = []
    for a in range(3):
        k = rng.uniform(0.5, 2.0, 3) * 2 * np.pi / np.array(shape)
        d = max_disp * np.sin(sum(kk * ii for kk, ii in zip(k, idx))
                              + rng.uniform(0, 2 * np.pi))
        out.append(((idx[a] + off[a] + d) * H).astype(np.float32))
    return out


def _gather_minmax(field, px, py, pz, off):
    """numpy 8-corner gather with per-axis clipped indices."""
    g = [np.float32(p) / np.float32(H) - np.float32(o)
         for p, o in zip((px, py, pz), off)]
    i0 = [np.floor(a).astype(np.int64) for a in g]
    mn = np.full(px.shape, np.inf, np.float32)
    mx = np.full(px.shape, -np.inf, np.float32)
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                v = field[np.clip(i0[0] + a, 0, field.shape[0] - 1),
                          np.clip(i0[1] + b, 0, field.shape[1] - 1),
                          np.clip(i0[2] + c, 0, field.shape[2] - 1)]
                mn = np.minimum(mn, v)
                mx = np.maximum(mx, v)
    return mn, mx


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("kind", ["c", "u", "v", "w"])
def test_minmax_plain_equals_corner_gather(kind, channels):
    rng = np.random.default_rng(7)
    g = Grid3D(16, 20, 24, H)
    off = g.off_of(kind)
    fields = rng.standard_normal((channels,) + g.shape_of(kind)).astype(
        np.float32)
    # cell-lattice positions displaced by up to 2.5 cells: every face of
    # the domain has positions up to 2 cells outside it
    px, py, pz = _positions(g.shape_c, (0.0, 0.0, 0.0), rng, 2.5)
    outside = ((px < -H) | (px > 16 * H) | (pz < -H) | (pz > 24 * H))
    assert outside.sum() > 50
    mn, mx = interp_fast.minmax_sample_plain(
        torch.from_numpy(fields), *(torch.from_numpy(p) for p in (px, py, pz)),
        H, (off,) * channels)
    assert mn.shape == mx.shape == (channels,) + g.shape_c
    for c in range(channels):
        want_mn, want_mx = _gather_minmax(fields[c], px, py, pz, off)
        np.testing.assert_array_equal(mn[c].numpy(), want_mn)
        np.testing.assert_array_equal(mx[c].numpy(), want_mx)
    assert bool((mn <= mx).all())


def test_minmax_plain_matches_pallas_kernel():
    rng = np.random.default_rng(3)
    shape = (16, 16, 128)
    off = (0.0, 0.0, 0.0)
    fields = rng.standard_normal((2,) + shape).astype(np.float32)
    px, py, pz = _positions(shape, off, rng, 1.5)
    mn, mx = interp_fast.minmax_sample_plain(
        torch.from_numpy(fields), *(torch.from_numpy(p) for p in (px, py, pz)),
        H, (off, off))
    # positions within ~an ulp of a lattice plane: the Pallas kernel drops
    # the far corner there (hat weight 0)
    g = np.stack([p / np.float32(H) for p in (px, py, pz)])
    frac = g - np.floor(g)
    away = ((frac > 1e-5) & (frac < 1 - 1e-5)).all(axis=0)
    keep = np.zeros(shape, bool)
    keep[2:-2, 2:-2, 2:-2] = True       # the window rim
    keep &= away
    assert keep.mean() > 0.5
    for c in range(2):
        jmn, jmx = jfast.minmax3_fast(
            jnp.asarray(fields[c]), jnp.asarray(px), jnp.asarray(py),
            jnp.asarray(pz), H, off, Rr=2, interpret=True)
        np.testing.assert_allclose(mn[c].numpy()[keep], np.asarray(jmn)[keep],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(mx[c].numpy()[keep], np.asarray(jmx)[keep],
                                   rtol=0, atol=1e-6)


def test_minmax_wrapper_takes_plain_path_on_cpu():
    rng = np.random.default_rng(5)
    fields = torch.from_numpy(rng.standard_normal((2, 8, 9, 10)).astype(
        np.float32))
    px, py, pz = (torch.from_numpy(p) for p in _positions((8, 9, 10),
                                                          (0, 0, 0), rng, 1.0))
    before = interp_fast.minmax_sample.launches
    mn, mx = interp_fast.minmax_sample(fields, px, py, pz, H,
                                       ((0.0, 0.0, 0.0),) * 2)
    want = interp_fast.minmax_sample_plain(fields, px, py, pz, H,
                                           ((0.0, 0.0, 0.0),) * 2)
    assert torch.equal(mn, want[0]) and torch.equal(mx, want[1])
    # a launch is counted only where the kernel launches: never on the CPU
    assert interp_fast.minmax_sample.launches == before
    meta = torch.empty(1, 4, 4, 4, device="meta")
    p = torch.empty(4, 4, 4, device="meta")
    with pytest.raises(ValueError):
        interp_fast.minmax_sample(meta, p, p, p, H, ((0.0, 0.0, 0.0),))
