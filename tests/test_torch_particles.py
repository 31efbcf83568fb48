"""The port's 2D particle schemes (FLIP, APIC, PolyPIC) against the JAX
package, stage by stage and in whole steps.

Stages at 24x40 (h = 1/24) with 4 x 4 particles a cell (15,360): the
seeding and the bin sort exactly equal to JAX's, the order included; the
P2G transfers (FLIP, APIC, PolyPIC, sorted and unsorted), G2P and
``update_cp_all`` within 1e-6 of each output's scale. The particles come
from a seeded numpy draw in [h, (n-1)h] with rows exactly on h and (n-1)h
on both axes and a pile-up of 500 particles at one position, as the
step's clamp makes them.

Whole steps: FLIP, APIC and POLYPIC with the spectral projection and
FLIP with MG-PCG, with Dirichlet and with pure Neumann walls (each CG
exit test of that case at least 5% from ``proj_tol``, where the two
packages' residuals agree to ~1e-5 of themselves), 3 steps each at
24x40 (dt 0.5: CFL near 2.4, 3 substeps), buoyancy on, from seeded
smooth fields whose particles are
sampled from the grid as the JAX CLI bootstraps them. The JAX steps run
with ``EngineMode(fast_interp=False, particle_dense=False)`` op by op
(``jax.disable_jit``): jitted, XLA divides positions by h as a product
with 1/h, whose floors take the other cell for particles on a lattice
line (the clamp ring), so the sort order and APIC's and PolyPIC's
polynomials differ there while the grid agrees (ROADMAP §3 item 3(h)).
The port starts every step from JAX's state before it (ROADMAP §3 item
2's caution); grid fields and particle columns within 1e-4 of scale, the
same CG iterations, ``interp_overflow`` 0.

The accelerator default: one FLIP step against JAX's dense-binned path
(``particle_dense=True``, jitted), whose ``interp_overflow`` must be 0.
The dense path keeps the seeding order, the port the bin order, so the
particles carry their index in C_x[:, 0], which FLIP only permutes, and
each package's columns are compared in that order.

All JAX references come from one child process that the pytest-xdist
workers share (tests/jax_oracle.shared), each whole-step oracle feeding
one test function.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch import convert
from gpufluidsimulation_tpu_torch.core.grids import Grid2D
from gpufluidsimulation_tpu_torch.ops import poisson
from gpufluidsimulation_tpu_torch.solvers import particles as part
from gpufluidsimulation_tpu_torch.solvers import smoke2d
from tests import jax_oracle
from tests.test_torch_smoke2d import _flatten, _smooth

NI, NJ, N = 24, 40, 4
H = 1.0 / NI
DT = 0.5
STEPS = 3
COLUMNS = ("pos", "vel", "rho", "T", "C_x", "C_y", "C_rho", "C_T")
# (scheme, projection): "mgpcg-neumann" is MG-PCG with pure Neumann walls
CASES = (("flip", "spectral"), ("apic", "spectral"), ("polypic", "spectral"),
         ("flip", "mgpcg"), ("flip", "mgpcg-neumann"))
SCHEME_OF = {"flip": 4, "apic": 5, "polypic": 6}
GRID_KEYS = ("u", "v", "rho", "T")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _particles():
    """Particles in [h, (n-1)h], seeded, with rows exactly on h and (n-1)h
    on each axis, a pile-up of 500 at one position, and random columns."""
    rng = np.random.default_rng(7)
    P = NI * NJ * N * N
    lo, hi = np.float32(H), (np.float32(np.float64((NI - 1) * H)),
                             np.float32(np.float64((NJ - 1) * H)))
    pos = np.stack([rng.uniform(H, (NI - 1) * H, P),
                    rng.uniform(H, (NJ - 1) * H, P)], -1).astype(np.float32)
    pos[:60, 0], pos[60:120, 0] = lo, hi[0]
    pos[120:180, 1], pos[180:240, 1] = lo, hi[1]
    pos[240:740] = pos[1000]
    cols = dict(pos=pos, vel=rng.normal(0, 0.2, (P, 2)),
                rho=rng.uniform(0, 2, P), T=rng.normal(0, 1, P))
    for key in COLUMNS[4:]:
        cols[key] = rng.normal(0, 1, (P, 4))
    return {k: np.asarray(v, np.float32) for k, v in cols.items()}


def _fields():
    rng = np.random.default_rng(11)
    return [rng.normal(0, 1, s).astype(np.float32)
            for s in ((NI + 1, NJ), (NI, NJ + 1), (NI, NJ), (NI, NJ))]


def _start():
    return dict(u=_smooth((NI + 1, NJ), 1, 0.2), v=_smooth((NI, NJ + 1), 2,
                                                           0.2),
                rho=np.abs(_smooth((NI, NJ), 3, 2.0)),
                T=_smooth((NI, NJ), 4, 1.0))


def _cfg_fields(name, proj="spectral"):
    return dict(ni=NI, nj=NJ, L=1.0, scheme=SCHEME_OF[name], alpha=0.2,
                beta=0.05, proj_tol=1e-5, proj_max_iters=60,
                pure_neumann=proj == "mgpcg-neumann")


def _mode(proj, dense=False):
    return dict(fast_interp=False,
                spectral_poisson=not proj.startswith("mgpcg"),
                particle_dense=dense)


# ---------------------------------------------------------------------------
# The JAX child
# ---------------------------------------------------------------------------


def _jax_stages():
    import jax.numpy as jnp

    from gpufluidsimulation_tpu.core.grids import Grid2D as JGrid
    from gpufluidsimulation_tpu.solvers import particles as jp

    g = JGrid(NI, NJ, H)
    out = {"seed#pos": np.array(jp.seed_particles(g, N).pos)}
    src = jp.ParticleState(**{k: jnp.asarray(v)
                              for k, v in _particles().items()})
    srt = jp.bin_sort(g, src)
    out.update({f"sorted#{k}": np.array(getattr(srt, k)) for k in COLUMNS})
    for sorted_bins, p in ((True, srt), (False, src)):
        tag = "sorted" if sorted_bins else "unsorted"
        res = jp.p2g_flip(g, p, sorted_bins=sorted_bins)
        out.update({f"p2g#flip#{tag}#{i}": np.array(r)
                    for i, r in enumerate(res)})
        for order in ("apic", "polypic"):
            res = jp.p2g_poly(g, p, order, sorted_bins=sorted_bins)
            out.update({f"p2g#{order}#{tag}#{i}": np.array(r)
                        for i, r in enumerate(res)})
    fields = [jnp.asarray(f) for f in _fields()]
    res = jp.g2p_sample(g, *fields, srt.pos)
    out.update({f"g2p#{i}": np.array(r) for i, r in enumerate(res)})
    cp = jp.update_cp_all(g, srt, *fields)
    out.update({f"cp#{k}": np.array(getattr(cp, k)) for k in COLUMNS[4:]})
    return out


def _jax_solver(name, proj, dense=False):
    from gpufluidsimulation_tpu import config as jconfig
    from gpufluidsimulation_tpu.solvers import smoke2d as js
    from gpufluidsimulation_tpu.solvers.schemes import Scheme as JScheme

    d = _cfg_fields(name, proj)
    d["scheme"] = JScheme(d["scheme"])
    return js.Smoke2D(js.Smoke2DConfig(
        **d, engine_mode=jconfig.EngineMode(**_mode(proj, dense))))


def _jax_start(solver):
    import jax
    import jax.numpy as jnp

    st = solver.init_state()
    st = st.replace(**{k: jnp.asarray(v) for k, v in _start().items()})
    with jax.disable_jit():
        return solver.sample_particles_from_grid(st)


def _jax_steps():
    """States 0..3 of every whole-step case, op by op; and the dense
    path's first step from the FLIP state 0 tagged with each particle's
    index in C_x[:, 0]."""
    import jax
    import jax.numpy as jnp

    out = {}
    for name, proj in CASES:
        solver = _jax_solver(name, proj)
        st = _jax_start(solver)
        for k in range(STEPS + 1):
            out.update({f"{name}-{proj}#{k}#{key}": v
                        for key, v in _flatten(st).items()})
            if k < STEPS:
                with jax.disable_jit():
                    st = solver.step(st, DT)
    solver = _jax_solver("flip", "spectral", dense=True)
    st = _jax_start(solver)
    p = st.particles
    st = st.replace(particles=p.replace(C_x=p.C_x.at[:, 0].set(
        jnp.arange(p.C_x.shape[0], dtype=jnp.float32))))
    out.update({f"dense#0#{key}": v for key, v in _flatten(st).items()})
    st = solver.step(st, DT)
    out.update({f"dense#1#{key}": v for key, v in _flatten(st).items()})
    return out


def _jax_run(name):
    out = {f"stage#{k}": v for k, v in _jax_stages().items()}
    out.update(_jax_steps())
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_oracle.shared(tmp_path_factory, __file__,
                             "particles")["particles"]


def _close(label, got, want, tol):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, (label, got.shape, want.shape)
    if want.size == 0:
        return 0.0
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert np.isfinite(err) and err <= tol * scale, (label, err, scale)
    return err / scale


def _state(ref, prefix):
    return {key[len(prefix):]: v for key, v in ref.items()
            if key.startswith(prefix)}


def _port_particles():
    return part.ParticleState(**{k: torch.from_numpy(v)
                                 for k, v in _particles().items()})


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


def test_seed_and_bin_sort_match_jax_exactly(ref):
    g = Grid2D(NI, NJ, H)
    seeded = part.seed_particles(g, N)
    np.testing.assert_array_equal(seeded.pos.numpy(), ref["stage#seed#pos"])
    assert seeded.vel.shape == (NI * NJ * N * N, 2)
    assert all(float(getattr(seeded, k).abs().max()) == 0.0
               for k in COLUMNS[1:])
    srt, keys = part.bin_sort(g, _port_particles(), return_keys=True)
    for key in COLUMNS:
        np.testing.assert_array_equal(getattr(srt, key).numpy(),
                                      ref[f"stage#sorted#{key}"],
                                      err_msg=key)
    assert bool((keys[1:] >= keys[:-1]).all())
    assert torch.equal(keys, part.bin_keys(g, srt.pos))
    # the pile-up sits in one bin
    pile = (srt.pos == torch.from_numpy(_particles()["pos"][1000])).all(1)
    assert int(pile.sum()) == 501 and int(keys[pile].unique().numel()) == 1


@pytest.mark.parametrize("sorted_bins", [True, False],
                         ids=["sorted", "unsorted"])
@pytest.mark.parametrize("order", ["flip", "apic", "polypic"])
def test_p2g_matches_jax(ref, order, sorted_bins):
    g = Grid2D(NI, NJ, H)
    p = _port_particles()
    if sorted_bins:
        p = part.bin_sort(g, p)
    tag = "sorted" if sorted_bins else "unsorted"
    if order == "flip":
        got = part.p2g_flip(g, p, sorted_bins=sorted_bins)
    else:
        got = part.p2g_poly(g, p, order, sorted_bins=sorted_bins)
    for i, (a, shape) in enumerate(zip(got, (g.shape_u, g.shape_v,
                                             g.shape_c, g.shape_c))):
        assert tuple(a.shape) == shape
        _close(f"{order} {tag} {i}", a, ref[f"stage#p2g#{order}#{tag}#{i}"],
               1e-6)


def test_g2p_and_update_cp_match_jax(ref):
    g = Grid2D(NI, NJ, H)
    p = part.bin_sort(g, _port_particles())
    fields = [torch.from_numpy(f) for f in _fields()]
    for i, a in enumerate(part.g2p_sample(g, *fields, p.pos)):
        _close(f"g2p {i}", a, ref[f"stage#g2p#{i}"], 1e-6)
    cp = part.update_cp_all(g, p, *fields)
    for key in COLUMNS[4:]:
        _close(key, getattr(cp, key), ref[f"stage#cp#{key}"], 1e-6)
    # calculateCp alone, field by field, is the same function
    for f, off, band, key in zip(fields, (g.OFF_U, g.OFF_V, g.OFF_C,
                                          g.OFF_C), part.cp_bands(g),
                                 COLUMNS[4:]):
        assert torch.equal(part.calculate_cp(f, p.pos, H, off, *band),
                           getattr(cp, key))


# ---------------------------------------------------------------------------
# Whole steps
# ---------------------------------------------------------------------------


def _port_solver(name, proj, dense=False):
    cfg = convert.config_2d_from_dict(dict(_cfg_fields(name, proj),
                                           engine_mode=_mode(proj, dense)))
    return cfg, smoke2d.Smoke2D(cfg, device="cpu")


@pytest.mark.parametrize("name,proj", CASES)
def test_whole_steps_match_jax(ref, name, proj, monkeypatch):
    cfg, solver = _port_solver(name, proj)
    states = [_state(ref, f"{name}-{proj}#{k}#") for k in range(STEPS + 1)]
    # every CG exit test of the pure-Neumann case sits clear of proj_tol
    # (ROADMAP §3 item 2): each residual of the history at least 5% from
    # it, where the two packages' residuals agree to ~1e-5 of themselves
    histories = []
    loop = poisson._pcg_loop

    def recorded(*args, **kwargs):
        out = loop(*args, **kwargs)
        histories.append(out[3][:out[1]].clone())
        return out

    monkeypatch.setattr(poisson, "_pcg_loop", recorded)
    assert states[0]["particles.pos"].shape == (NI * NJ * N * N, 2)
    for k in range(1, STEPS + 1):
        state = solver.step(convert.state_from_numpy(states[k - 1], cfg,
                                                     "cpu"), DT)
        got = convert.state_to_numpy(state)
        want = states[k]
        for key in GRID_KEYS + tuple(f"particles.{c}" for c in COLUMNS):
            _close(f"{name}/{proj} step {k} {key}", got[key], want[key],
                   1e-4)
        for key in ("frame", "proj_iters", "interp_overflow"):
            assert int(got[key]) == int(want[key]), (k, key)
        np.testing.assert_allclose(got["cfl"], want["cfl"], rtol=1e-5)
        assert state.interp_overflow == 0 and state.substeps >= 2
    if proj == "mgpcg-neumann":
        assert len(histories) == STEPS
        for hist in histories:
            margin = (hist / cfg.proj_tol - 1.0).abs()
            assert bool((margin >= 0.05).all()), hist


def test_flip_step_against_the_dense_accelerator_path(ref):
    """One FLIP step against JAX's particle_dense path (jitted, its
    accelerator default) from the same tagged state: JAX counts no
    overflow, the grid agrees within 1e-4 of scale, and every particle's
    columns, matched by the index it carries in C_x[:, 0], too."""
    want = _state(ref, "dense#1#")
    assert int(want["interp_overflow"]) == 0
    cfg, solver = _port_solver("flip", "spectral", dense=True)
    state = solver.step(convert.state_from_numpy(_state(ref, "dense#0#"),
                                                 cfg, "cpu"), DT)
    got = convert.state_to_numpy(state)
    for key in GRID_KEYS:
        _close(f"dense {key}", got[key], want[key], 1e-4)
    assert int(got["proj_iters"]) == int(want["proj_iters"])
    ids = got["particles.C_x"][:, 0]
    P = NI * NJ * N * N
    np.testing.assert_array_equal(np.sort(ids), np.arange(P))
    np.testing.assert_array_equal(want["particles.C_x"][:, 0], np.arange(P))
    back = np.argsort(ids, kind="stable")
    assert not np.array_equal(back, np.arange(P))   # the bin order
    for c in COLUMNS:
        _close(f"dense particles.{c}", got[f"particles.{c}"][back],
               want[f"particles.{c}"], 1e-4)


def test_flip_state_round_trips_through_convert(ref):
    """A JAX FLIP state with its 15,360 particles carried across and back
    gives every array unchanged; a port state through numpy and back is
    the same state."""
    cfg = convert.config_2d_from_dict(_cfg_fields("flip"))
    want = _state(ref, "flip-spectral#2#")
    state = convert.state_from_numpy(want, cfg, "cpu")
    assert state.particles.pos.shape == (NI * NJ * N * N, 2)
    got = convert.state_to_numpy(state)
    assert [k for k in got if k != "substeps"] == list(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)
    mine = smoke2d.Smoke2D(cfg, device="cpu").step(state, DT)
    arrays = convert.state_to_numpy(mine)
    again = convert.state_to_numpy(convert.state_from_numpy(arrays, cfg,
                                                            "cpu"))
    for key, val in arrays.items():
        np.testing.assert_array_equal(again[key], val, err_msg=key)
    assert dataclasses.is_dataclass(mine.particles)


if __name__ == "__main__":
    jax_oracle.serve(_jax_run)
