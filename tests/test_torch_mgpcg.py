"""The port's multigrid, CG family and masked projection against JAX.

The same numpy-seeded arrays go through ``gpufluidsimulation_tpu.ops.
poisson`` under ``EngineMode(rbgs=True, interp_interpret=True,
spectral_poisson=False)`` (its Pallas smoothers in interpret mode, the
production V-cycle) and through the port on CPU tensors (the smoothers'
plain versions).

Tolerances. Transfer operators and level data are compared exactly or to
float32 ulps (1e-6). A V-cycle output agrees to 1e-5 of its scale
(measured 3.3e-7). The solvers must take the SAME number of iterations,
with the residual history equal entry by entry to 2% of the entry plus
1e-7 (the entries span decades; measured relative difference <= 3e-4, from
another summation order in the dots) and the pressure within 1e-4 of its
scale (measured <= 1.2e-6). Right-hand sides are chosen so that no residual
sits near the exit threshold. At the odd shape 20x17x24 the JAX V-cycle is
not a symmetric preconditioner (edge-padded restriction against clamped
prolongation) and its MG-PCG stalls near 2e-4; the port reproduces that
history to 5 digits, and the odd-shape cases therefore stop at 3e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu import config
from gpufluidsimulation_tpu.ops import poisson as jpoisson
from gpufluidsimulation_tpu_torch.ops import poisson
from tests import torch_threads  # noqa: F401 (one CPU torch thread)

MODE = config.EngineMode(rbgs=True, interp_interpret=True,
                         spectral_poisson=False)
ODD = (20, 17, 24)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * scale)


def _same_history(hist, jhist, iters):
    hist, jhist = hist.numpy(), np.asarray(jhist)
    assert np.all(hist[iters:] == -1.0) and np.all(jhist[iters:] == -1.0)
    np.testing.assert_allclose(hist[:iters], jhist[:iters], rtol=2e-2,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# Level data and transfer operators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 128, 128), (256, 256, 256), ODD,
                                   (100, 200, 200)])
def test_level_shapes_match_jax(shape):
    assert poisson.mg_shapes(shape) == jpoisson.mg_shapes(shape)
    assert poisson._coarse_shape(shape) == jpoisson._coarse_shape(shape)


@pytest.mark.parametrize("bc", ["dirichlet", "neumann"])
def test_context_matches_jax(bc):
    jctx = jpoisson.MGContext(ODD, bc)
    ctx = poisson.MGContext(ODD, bc, "cpu")
    assert ctx.shapes == jctx.shapes
    for a, b in zip(ctx.diags, jctx.diags):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(poisson._diag(ODD, bc),
                                  jpoisson._diag(ODD, bc))
    for mine, theirs in ((ctx.rmats, jctx.rmats), (ctx.pmats, jctx.pmats)):
        for level, jlevel in zip(mine, theirs):
            for a, b in zip(level, jlevel):
                np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("fine", [(25, 17, 24), (16, 16, 16)])
def test_transfer_operators_match_jax(fine):
    """Odd sizes (25 -> 13, 17 -> 9) exercise the edge padding of the
    restriction and the edge clamp of the linear resize."""
    coarse = jpoisson._coarse_shape(fine)
    r = _rand(fine, 1)
    want = jpoisson.restrict_full(jnp.asarray(r), coarse)
    _close(poisson.restrict_full(_t(r), coarse).numpy(), want, 1e-6)
    e = _rand(coarse, 2)
    want = jax.image.resize(jnp.asarray(e), fine, method="linear")
    # the resize builds its weights in float32, the matrix in float64
    _close(poisson.prolong_linear(_t(e), fine).numpy(), want, 3e-6)
    np.testing.assert_array_equal(np.asarray(want),
                                  np.asarray(jpoisson.prolong_linear(
                                      jnp.asarray(e), fine)))
    rm = [_t(jpoisson._restrict_matrix(f, c)) for f, c in zip(fine, coarse)]
    want = jpoisson._apply_axis_mats(jnp.asarray(r),
                                     [m.numpy() for m in rm])
    _close(poisson._apply_axis_mats(_t(r), rm).numpy(), want, 1e-6)


@pytest.mark.parametrize("bc", ["dirichlet", "neumann"])
def test_jacobi_smooth_and_solve_match_jax(bc):
    b = _rand(ODD, 3)
    x = _rand(ODD, 4)
    diag = jpoisson._diag(ODD, bc)
    want = jpoisson.jacobi_smooth(jnp.asarray(x), jnp.asarray(b), bc, diag, 5)
    got = poisson.jacobi_smooth(_t(x), _t(b), bc, _t(diag), 5)
    _close(got.numpy(), want, 1e-5)
    _close(poisson.jacobi_solve(_t(b), bc, 30).numpy(),
           jpoisson.jacobi_solve(jnp.asarray(b), bc, 30), 1e-5)


# ---------------------------------------------------------------------------
# V-cycle and the CG family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bc", ["dirichlet", "neumann"])
@pytest.mark.parametrize("shape", [(32, 32, 32), ODD])
def test_v_cycle_matches_jax(bc, shape):
    r = _rand(shape, 5)
    if bc == "neumann":
        r = r - r.mean()
    with config.engine_mode_scope(MODE):
        want = jpoisson.MGContext(shape, bc).v_cycle(jnp.asarray(r))
    got = poisson.MGContext(shape, bc, "cpu").v_cycle(_t(r))
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("bc", ["dirichlet", "neumann"])
@pytest.mark.parametrize("shape,tol", [((32, 32, 32), 1e-5), (ODD, 3e-3)])
def test_mgpcg_matches_jax(bc, shape, tol):
    b = _rand(shape, 6)
    with config.engine_mode_scope(MODE):
        jp, jit, jres, jhist = jpoisson.mgpcg(
            jnp.asarray(b), jpoisson.MGContext(shape, bc), tol, 40)
    p, it, res, hist = poisson.mgpcg(_t(b), poisson.MGContext(shape, bc),
                                     tol, 40)
    assert isinstance(it, int) and it == int(jit) and 0 < it < 40
    assert float(res) <= tol
    _same_history(hist, jhist, it)
    np.testing.assert_allclose(float(res), float(jres), rtol=2e-2)
    _close(p.numpy(), jp, 1e-4)


def test_mgpcg_stops_at_max_iters_like_jax():
    b = _rand((16, 16, 16), 7)
    with config.engine_mode_scope(MODE):
        _, jit, _, jhist = jpoisson.mgpcg(
            jnp.asarray(b), jpoisson.MGContext(b.shape, "dirichlet"),
            1e-12, 3)
    _, it, _, hist = poisson.mgpcg(
        _t(b), poisson.MGContext(b.shape, "dirichlet"), 1e-12, 3)
    assert it == int(jit) == 3
    _same_history(hist, jhist, 3)


@pytest.mark.parametrize("bc", ["dirichlet", "neumann"])
def test_cg_matches_jax(bc):
    b = _rand((16, 16, 16), 8)
    jp, jit, jres = jpoisson.cg(jnp.asarray(b), bc, 1e-4, 200)
    p, it, res = poisson.cg(_t(b), bc, 1e-4, 200)
    assert it == int(jit) and 0 < it < 200
    np.testing.assert_allclose(float(res), float(jres), rtol=5e-2)
    _close(p.numpy(), jp, 1e-4)


@pytest.mark.parametrize("bc", ["dirichlet", "neumann"])
def test_pcg_matches_jax(bc):
    b = _rand((16, 16, 16), 9)
    jp, jit, jres = jpoisson.pcg(jnp.asarray(b), bc, 1e-4, 200)
    p, it, res = poisson.pcg(_t(b), bc, 1e-4, 200)
    assert it == int(jit) and 0 < it < 200
    np.testing.assert_allclose(float(res), float(jres), rtol=5e-2)
    _close(p.numpy(), jp, 1e-4)


@pytest.mark.parametrize("bc", ["dirichlet", "neumann"])
def test_project_3d_with_mgpcg_matches_jax(bc):
    ni, nj, nk = shape = ODD
    u, v, w = (_rand((ni + 1, nj, nk), 10, 0.05),
               _rand((ni, nj + 1, nk), 11, 0.05),
               _rand((ni, nj, nk + 1), 12, 0.05))
    with config.engine_mode_scope(MODE):
        ju, jv, jw, jp, jit, jres, jhist = jpoisson.project_3d(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(w),
            jpoisson.MGContext(shape, bc), 3e-3, 30)
    tu, tv, tw, tp, it, res, hist = poisson.project_3d(
        _t(u), _t(v), _t(w), bc, 3e-3, 30,
        ctx=poisson.MGContext(shape, bc))
    assert it == int(jit) and 1 < it < 30
    _same_history(hist, jhist, it)
    for a, b in ((tu, ju), (tv, jv), (tw, jw), (tp, jp)):
        _close(a.numpy(), b, 1e-4)
    with pytest.raises(ValueError):
        poisson.project_3d(_t(u), _t(v), _t(w), "neumann", 1e-4, 30,
                           ctx=poisson.MGContext(shape, "dirichlet"))


# ---------------------------------------------------------------------------
# Masked operator and projection
# ---------------------------------------------------------------------------


def _box_flags(n):
    flags = np.zeros((n, n, n), np.int32)
    flags[:1] = flags[-1:] = poisson.SOLID
    flags[:, :1] = poisson.SOLID
    flags[:, -1:] = poisson.AIR
    flags[:, :, :1] = flags[:, :, -1:] = poisson.SOLID
    return flags


def _ball_flags():
    """The flags of tests/test_boundary3d.py's solid-ball case, 16^3."""
    flags = _box_flags(16)
    ii, jj, kk = np.meshgrid(*[np.arange(16)] * 3, indexing="ij")
    flags[(ii - 8) ** 2 + (jj - 8) ** 2 + (kk - 8) ** 2 < 9] = poisson.OBJECT
    return flags


def _block_flags():
    """The ~30%-solid block case of tests/test_boundary3d.py, 24^3."""
    flags = _box_flags(24)
    flags[6:18, 6:18, 6:18] = poisson.OBJECT
    return flags


FLAG_CASES = {"ball16": _ball_flags, "block24": _block_flags}


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_masked_operator_matches_jax(case):
    flags = FLAG_CASES[case]()
    shape = flags.shape
    p = _rand(shape, 13)
    want = jpoisson.masked_laplacian(jnp.asarray(p), jnp.asarray(flags))
    _close(poisson.masked_laplacian(_t(p), _t(flags)).numpy(), want, 1e-6)
    shapes = jpoisson.mg_shapes(shape)
    jflags, jdiags = jpoisson.build_masked_hierarchy(jnp.asarray(flags),
                                                     shapes)
    tflags, tdiags, tcounts = poisson.build_masked_hierarchy(
        _t(flags).to(torch.uint8), shapes)
    for a, b in zip(tflags, jflags):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tdiags, jdiags):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    odd = np.pad(flags, ((0, 1), (0, 0), (0, 1)), mode="edge")   # 17 or 25
    coarse = jpoisson._coarse_shape(odd.shape)
    np.testing.assert_array_equal(
        poisson.coarsen_flags(_t(odd), coarse).numpy(),
        np.asarray(jpoisson.coarsen_flags(jnp.asarray(odd), coarse)))


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_masked_divergence_matches_jax(case):
    flags = FLAG_CASES[case]()
    ni, nj, nk = flags.shape
    vel = (_rand((ni + 1, nj, nk), 14), _rand((ni, nj + 1, nk), 15),
           _rand((ni, nj, nk + 1), 16))
    sol = (_rand((ni + 1, nj, nk), 17), _rand((ni, nj + 1, nk), 18),
           _rand((ni, nj, nk + 1), 19))
    want = jpoisson.masked_divergence_3d(
        *[jnp.asarray(a) for a in vel], jnp.asarray(flags),
        *[jnp.asarray(a) for a in sol])
    got = poisson.masked_divergence_3d(*[_t(a) for a in vel], _t(flags),
                                       *[_t(a) for a in sol])
    for a, b in zip(got, want):
        _close(a.numpy(), b, 1e-6)


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_masked_v_cycle_matches_jax(case):
    flags = FLAG_CASES[case]()
    shape = flags.shape
    r = _rand(shape, 20)
    jctx = jpoisson.MGContext(shape, "dirichlet")
    with config.engine_mode_scope(MODE):
        jfl, jdi = jpoisson.build_masked_hierarchy(jnp.asarray(flags),
                                                   jctx.shapes)
        want = jpoisson.masked_v_cycle(jnp.asarray(r), jfl, jdi, jctx.shapes)
    ctx = poisson.MGContext(shape, "dirichlet")
    hier = poisson.build_masked_hierarchy(_t(flags).to(torch.uint8),
                                          ctx.shapes)
    got = poisson.masked_v_cycle(_t(r), hier, ctx)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("case,tol", [("ball16", 1e-6), ("block24", 1e-5)])
def test_project_masked_matches_jax(case, tol):
    """The two cases of tests/test_boundary3d.py with their tolerances;
    the solid velocities are nonzero here so that the overwrite shows."""
    flags = FLAG_CASES[case]()
    ni, nj, nk = shape = flags.shape
    vel = (_rand((ni + 1, nj, nk), 21), _rand((ni, nj + 1, nk), 22),
           _rand((ni, nj, nk + 1), 23))
    sol = (np.full((ni + 1, nj, nk), 0.25, np.float32),
           np.zeros((ni, nj + 1, nk), np.float32),
           np.full((ni, nj, nk + 1), -0.5, np.float32))
    with config.engine_mode_scope(MODE):
        ju, jv, jw, jp, jit, jres, jhist = jpoisson.project_masked_3d(
            *[jnp.asarray(a) for a in vel], jnp.asarray(flags),
            *[jnp.asarray(a) for a in sol],
            jpoisson.MGContext(shape, "dirichlet"), tol, 100)
    tu, tv, tw, tp, it, res, hist = poisson.project_masked_3d(
        *[_t(a) for a in vel], _t(flags), *[_t(a) for a in sol],
        poisson.MGContext(shape, "dirichlet"), tol, 100)
    assert it == int(jit) and 1 < it <= 30
    assert float(res) <= tol
    _same_history(hist, jhist, it)
    for a, b in ((tu, ju), (tv, jv), (tw, jw), (tp, jp)):
        _close(a.numpy(), b, 1e-4)
    fluid = flags == poisson.FLUID
    div = poisson.divergence_3d(tu, tv, tw).numpy()
    assert np.abs(div[fluid]).max() < 100 * tol
    assert np.all(tp.numpy()[~fluid] == 0.0)
