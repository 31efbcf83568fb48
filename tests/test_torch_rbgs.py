"""The port's red-black Gauss-Seidel smoothers against the Pallas kernels.

The same numpy-seeded arrays go through ``pallas_kernels.rbgs_smooth`` /
``masked_rbgs_smooth`` in interpret mode (as tests/test_pallas.py runs
them) and through the port's wrappers on CPU tensors, which take the plain
versions. One shape is a multiple of nothing (20x17x24).

Tolerance: both sides do the same float32 operations in the same order
(neighbour sum, + b, true division), so they agree to an ulp of the
iterate: measured max error 1.8e-7 of the iterate's scale for the plain
smoother and exactly 0 for the masked one. The bound is 1e-5 of the
iterate's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu.ops import pallas_kernels as jk
from gpufluidsimulation_tpu.ops import poisson as jpoisson
from gpufluidsimulation_tpu_torch.ops import poisson, stencil_kernels
from tests import torch_threads  # noqa: F401 (one CPU torch thread)

SHAPES = [(16, 16, 16), (20, 17, 24)]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flags(shape, seed):
    """Walls, an open top, a solid ball and a few random air cells."""
    rng = np.random.default_rng(seed)
    f = np.zeros(shape, np.int32)
    f[:1] = f[-1:] = poisson.SOLID
    f[:, :1] = poisson.SOLID
    f[:, -1:] = poisson.AIR
    f[:, :, :1] = f[:, :, -1:] = poisson.SOLID
    ii, jj, kk = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    c = [n // 2 for n in shape]
    f[(ii - c[0]) ** 2 + (jj - c[1]) ** 2 + (kk - c[2]) ** 2 < 12] = \
        poisson.OBJECT
    f[rng.random(shape) < 0.02] = poisson.AIR
    return f


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bc", ["dirichlet", "neumann"])
@pytest.mark.parametrize("iters,reverse,from_zero", [
    (1, False, False), (2, False, True), (2, True, False), (3, False, False),
    (3, True, True)])
def test_rbgs_matches_pallas(shape, bc, iters, reverse, from_zero):
    b = _rand(shape, 1)
    x = None if from_zero else _rand(shape, 2)
    want = np.asarray(jk.rbgs_smooth(
        None if x is None else jnp.asarray(x), jnp.asarray(b), bc=bc,
        iters=iters, interpret=True, reverse=reverse))
    before = stencil_kernels.rbgs_smooth.launches
    got = stencil_kernels.rbgs_smooth(None if x is None else _t(x), _t(b),
                                      bc, iters, reverse=reverse)
    assert stencil_kernels.rbgs_smooth.launches == before == 0
    _close(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("iters,reverse,from_zero", [
    (1, False, False), (2, False, True), (2, True, False), (3, True, True)])
def test_masked_rbgs_matches_pallas(shape, iters, reverse, from_zero):
    b = _rand(shape, 3)
    flags = _flags(shape, 4)
    # a guess that is nonzero on non-fluid cells too: the smoother must
    # force those to 0 before the first sweep
    x = None if from_zero else _rand(shape, 5)
    want = np.asarray(jk.masked_rbgs_smooth(
        None if x is None else jnp.asarray(x), jnp.asarray(b),
        jnp.asarray(flags), iters=iters, interpret=True, reverse=reverse))
    before = stencil_kernels.masked_rbgs_smooth.launches
    got = stencil_kernels.masked_rbgs_smooth(
        None if x is None else _t(x), _t(b), _t(flags).to(torch.uint8),
        iters, reverse=reverse)
    assert stencil_kernels.masked_rbgs_smooth.launches == before == 0
    _close(got.numpy(), want)
    assert np.all(got.numpy()[flags != poisson.FLUID] == 0.0)


@pytest.mark.parametrize("bc", ["dirichlet", "neumann"])
def test_from_zero_is_bitwise_explicit_zeros(bc):
    shape = SHAPES[1]
    b = _t(_rand(shape, 6))
    a = stencil_kernels.rbgs_smooth(torch.zeros(shape), b, bc, 3)
    c = stencil_kernels.rbgs_smooth(None, b, bc, 3)
    assert torch.equal(a, c)
    flags = _t(_flags(shape, 7)).to(torch.uint8)
    a = stencil_kernels.masked_rbgs_smooth(torch.zeros(shape), b, flags, 3)
    c = stencil_kernels.masked_rbgs_smooth(None, b, flags, 3)
    assert torch.equal(a, c)


def test_rbgs_is_gauss_seidel_by_hand():
    """One red+black sweep against a cell-by-cell loop, and the reverse
    order against the loop run black first."""
    shape = (5, 4, 6)
    b = _rand(shape, 8)
    x0 = _rand(shape, 9)
    for reverse in (False, True):
        x = x0.copy()
        for colour in ((1, 0) if reverse else (0, 1)):
            new = x.copy()
            for i, j, k in np.ndindex(shape):
                if (i + j + k) % 2 != colour:
                    continue
                nb = np.float32(0)
                for di, dj, dk in ((1, 0, 0), (-1, 0, 0), (0, 1, 0),
                                   (0, -1, 0), (0, 0, 1), (0, 0, -1)):
                    a, c, d = i + di, j + dj, k + dk
                    if 0 <= a < shape[0] and 0 <= c < shape[1] \
                            and 0 <= d < shape[2]:
                        nb = np.float32(nb + x[a, c, d])
                new[i, j, k] = np.float32(nb + b[i, j, k]) / np.float32(6)
            x = new
        got = stencil_kernels.rbgs_smooth(_t(x0), _t(b), "dirichlet", 1,
                                          reverse=reverse).numpy()
        np.testing.assert_allclose(got, x, rtol=0, atol=1e-6)


def test_masked_diag_matches_jax():
    flags = _flags(SHAPES[1], 10)
    want = np.asarray(jpoisson._masked_diag(jnp.asarray(flags)))
    got = poisson._masked_diag(_t(flags)).numpy()
    np.testing.assert_array_equal(got, want)
    fluid = flags == poisson.FLUID
    np.testing.assert_array_equal(
        stencil_kernels.masked_diag(_t(flags)).numpy()[fluid], want[fluid])


def test_wrappers_validate_arguments():
    b = torch.zeros(4, 4, 4)
    with pytest.raises(ValueError):
        stencil_kernels.rbgs_smooth(None, b, "periodic", 1)
    with pytest.raises(ValueError):
        stencil_kernels.rbgs_smooth(None, b, "dirichlet", 0)
    with pytest.raises(ValueError):
        stencil_kernels.masked_rbgs_smooth(None, b, b.to(torch.uint8), 0)
    meta = torch.empty(4, 4, 4, device="meta")
    with pytest.raises(ValueError):
        stencil_kernels.rbgs_smooth(None, meta, "dirichlet", 1)
    with pytest.raises(ValueError):
        stencil_kernels.masked_rbgs_smooth(None, meta, meta, 1)
