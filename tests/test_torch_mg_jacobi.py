"""The Jacobi-smoothed V-cycle (``EngineMode(rbgs=False)``) against the
JAX package's with ``EngineMode(rbgs=False)``.

The port's ``MGContext(..., rbgs=False)`` V-cycle and masked V-cycle, its
MG-PCG solve and its masked projection, on the CPU, against the JAX
package's under ``EngineMode(rbgs=False, spectral_poisson=False)``, at
16^3 and at the odd 20x17x24. At the odd shape the JAX V-cycle is not a
symmetric preconditioner (ROADMAP §3 item 3(b)) and its MG-PCG stalls; the
port must stall with it, iteration for iteration. The masked cases use
walls on five faces, an open top and a solid sphere. The JAX references
come from two child processes shared by the workers (tests/jax_oracle.
shared; the V-cycles and the solves), the port's red-black smoother is made to raise, so that no level
can take it, and the tolerances are: V-cycles 1e-5 of scale, the solves
the same iteration count, the residual history entry by entry to 2% of
the entry plus 1e-7, and the solution within 1e-5 of scale.
"""

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch import convert
from gpufluidsimulation_tpu_torch.config import EngineMode
from gpufluidsimulation_tpu_torch.ops import poisson, stencil_kernels
from gpufluidsimulation_tpu_torch.scenes import scenes3d
from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
from tests import jax_oracle

SHAPES = {"cube": (16, 16, 16), "odd": (20, 17, 24)}
BCS = ("dirichlet", "neumann")
TOL = 1e-5
MAX_ITERS = 30


@pytest.fixture(autouse=True)
def _no_red_black(monkeypatch):
    """One torch thread, and no red-black smoother on any level."""
    def refuse(*args, **kwargs):
        raise AssertionError("a red-black smoother ran under rbgs=False")

    monkeypatch.setattr(stencil_kernels, "rbgs_smooth", refuse)
    monkeypatch.setattr(stencil_kernels, "masked_rbgs_smooth", refuse)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cycles(tmp_path_factory):
    return jax_oracle.shared(tmp_path_factory, __file__, "cycles")["cycles"]


@pytest.fixture(scope="module")
def solves(tmp_path_factory):
    return jax_oracle.shared(tmp_path_factory, __file__, "solves")["solves"]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _flags(shape):
    """Cell flags: walls (2) on the x and z faces and the floor, an open
    top (1), a sphere object (3) of radius 0.3 of the box, fluid (0)."""
    ni, nj, nk = shape
    ii, jj, kk = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    f = np.zeros(shape, np.int32)
    f[(ii < 1) | (kk < 1) | (ii >= ni - 1) | (kk >= nk - 1) | (jj < 1)] = 2
    f[jj >= nj - 1] = 1
    r = np.sqrt((ii - ni / 2) ** 2 + (jj - nj / 2) ** 2 + (kk - nk / 2) ** 2)
    f[r < 0.3 * min(shape)] = 3
    return f


def _rhs(name, bc, seed):
    b = _rand(SHAPES[name], seed)
    return b - b.mean() if bc == "neumann" else b


def _faces(shape, seed):
    ni, nj, nk = shape
    return (_rand((ni + 1, nj, nk), seed, 0.05),
            _rand((ni, nj + 1, nk), seed + 1, 0.05),
            _rand((ni, nj, nk + 1), seed + 2, 0.05))


def _jax_run(name):
    import jax.numpy as jnp

    from gpufluidsimulation_tpu import config
    from gpufluidsimulation_tpu.ops import poisson as jp

    out = {}
    with config.engine_mode_scope(config.EngineMode(
            rbgs=False, spectral_poisson=False)):
        assert not config.use_rbgs()
        for sname, shape in SHAPES.items():
            flags = jnp.asarray(_flags(shape))
            if name == "cycles":
                for bc in BCS:
                    out[f"vcycle_{sname}_{bc}"] = np.asarray(
                        jp.MGContext(shape, bc).v_cycle(
                            jnp.asarray(_rhs(sname, bc, 1))))
                fl, dl = jp.build_masked_hierarchy(flags,
                                                   jp.mg_shapes(shape))
                out[f"masked_vcycle_{sname}"] = np.asarray(
                    jp.masked_v_cycle(jnp.asarray(_rand(shape, 3)), fl, dl,
                                      jp.mg_shapes(shape)))
                continue
            assert name == "solves"
            for bc in BCS:
                p, it, res, hist = jp.mgpcg(jnp.asarray(_rhs(sname, bc, 2)),
                                            jp.MGContext(shape, bc), TOL,
                                            MAX_ITERS)
                for key, val in (("p", p), ("iters", it), ("res", res),
                                 ("hist", hist)):
                    out[f"mgpcg_{sname}_{bc}_{key}"] = np.asarray(val)
            zero = [jnp.zeros_like(jnp.asarray(a)) for a in _faces(shape, 4)]
            got = jp.project_masked_3d(
                *(jnp.asarray(a) for a in _faces(shape, 4)), flags, *zero,
                jp.MGContext(shape, "dirichlet"), TOL, MAX_ITERS)
            for key, val in zip(("u", "v", "w", "p", "iters", "res", "hist"),
                                got):
                out[f"masked_{sname}_{key}"] = np.asarray(val)
    return out


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * scale, (err, scale)


def _same_solve(iters, hist, want, prefix):
    assert iters == int(want[f"{prefix}_iters"]), (iters,
                                                   want[f"{prefix}_iters"])
    jhist = want[f"{prefix}_hist"]
    hist = hist.numpy()
    assert np.all(hist[iters:] == -1.0) and np.all(jhist[iters:] == -1.0)
    np.testing.assert_allclose(hist[:iters], jhist[:iters], rtol=2e-2,
                               atol=1e-7)


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("name", list(SHAPES))
def test_jacobi_v_cycle_matches_jax(cycles, name, bc):
    ctx = poisson.MGContext(SHAPES[name], bc, "cpu", rbgs=False)
    got = ctx.v_cycle(torch.from_numpy(_rhs(name, bc, 1)))
    _close(got.numpy(), cycles[f"vcycle_{name}_{bc}"], 1e-5)


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("name", list(SHAPES))
def test_jacobi_mgpcg_matches_jax(solves, name, bc):
    ctx = poisson.MGContext(SHAPES[name], bc, "cpu", rbgs=False)
    p, it, res, hist = poisson.mgpcg(torch.from_numpy(_rhs(name, bc, 2)),
                                     ctx, TOL, MAX_ITERS)
    prefix = f"mgpcg_{name}_{bc}"
    _same_solve(it, hist, solves, prefix)
    if name == "odd":       # the JAX V-cycle's stall, reproduced
        assert it == MAX_ITERS and float(res) > TOL
    else:
        assert 0 < it < MAX_ITERS and float(res) <= TOL
    _close(p.numpy(), solves[f"{prefix}_p"], 1e-5)


@pytest.mark.parametrize("name", list(SHAPES))
def test_jacobi_masked_v_cycle_matches_jax(cycles, name):
    shape = SHAPES[name]
    ctx = poisson.MGContext(shape, "dirichlet", "cpu", rbgs=False)
    flags = torch.from_numpy(_flags(shape)).to(torch.uint8)
    hierarchy = poisson.build_masked_hierarchy(flags, ctx.shapes)
    got = poisson.masked_v_cycle(torch.from_numpy(_rand(shape, 3)),
                                 hierarchy, ctx)
    _close(got.numpy(), cycles[f"masked_vcycle_{name}"], 1e-5)


@pytest.mark.parametrize("name", list(SHAPES))
def test_jacobi_masked_projection_matches_jax(solves, name):
    shape = SHAPES[name]
    ctx = poisson.MGContext(shape, "dirichlet", "cpu", rbgs=False)
    faces = [torch.from_numpy(a) for a in _faces(shape, 4)]
    got = poisson.project_masked_3d(
        *faces, torch.from_numpy(_flags(shape)),
        *(torch.zeros_like(f) for f in faces), ctx, TOL, MAX_ITERS)
    prefix = f"masked_{name}"
    _same_solve(got[4], got[6], solves, prefix)
    assert got[4] > 1
    for key, val in zip("uvwp", got[:4]):
        _close(val.numpy(), solves[f"{prefix}_{key}"], 1e-5)


def test_rbgs_mode_across_and_in_the_solver():
    def port_mode(**kw):
        return convert._engine_mode(dict(kw))

    assert port_mode(fast_interp=False).rbgs is False
    assert port_mode(fast_interp=False, rbgs=True).rbgs is None
    assert port_mode(fast_interp=True, rbgs=False).rbgs is False
    assert port_mode(fast_interp=True).rbgs is None
    for mode, rbgs in ((EngineMode(spectral_poisson=False), True),
                       (EngineMode(spectral_poisson=False, rbgs=False),
                        False)):
        solver, state = scenes3d.make_vortex_collision(
            scheme=Scheme.BIMOCQ, ni=16, nj=32, nk=32, dt=0.08,
            device="cpu", engine_mode=mode)
        assert solver.ctx.rbgs is rbgs
    # a whole step through the Jacobi-smoothed projection (the fixture
    # refuses the red-black smoothers)
    state = solver.step(solver.step(state))
    assert 1 < state.proj_iters < solver.cfg.proj_max_iters
    assert bool(torch.isfinite(state.u).all())


if __name__ == "__main__":
    jax_oracle.serve(_jax_run)
