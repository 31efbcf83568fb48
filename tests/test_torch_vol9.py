"""The port's vol9 volume form against the JAX package.

vol9 is the dual volume form with a sparse exact fixup: on every decision
block (16 x 16 x 128 cell-lattice nodes here) and channel where the dual
form is not provably within tol * max|f| of the exact 9-position
composition, the exact composition replaces it.

* ``vol9_fixup_plain`` on a 40x32x24 grid (3 x 2 x 1 decision blocks),
  kinds c (two channels), u, v and w with the clamp pairs of
  tests/test_volume_prefilter.py (c and v deciding on the bands of a
  pull-back stage, u and w on every node), against JAX ``sample3_vol9`` in
  interpret mode at three tolerances: tol = 0 equals the port's exact
  form bit for bit, tol = 1e9 the dual ``trilerp_sample``, and at the
  default tol the per-block flags equal JAX's. Values agree with JAX
  within rtol 3e-5, atol 3e-6 (the tolerance of the JAX package's own
  test against its exact form). The (exact, total) block counts equal
  JAX's.
* The vol9 form of ``bimocq_advect_3d`` (kinds v and c) against the JAX
  function under ``EngineMode(fast_interp=True, interp_interpret=True,
  volume_vol9=True)`` at tol = 0 and at the default tol (the JAX child
  sets its ``_VOL9_TOL``): every stage's flags equal, values within 1e-5
  of scale.
* One whole-step run: adaptive BiMocq, blend 0.5, vol9, 3 steps at 16^3,
  within 1e-4 of each field's scale with equal ``proj_iters`` and reinit
  counters, and every fixup's flags equal JAX's, call by call.

Every vol9 decision is checked to hold at tol * (1 -+ 1e-3) in both
packages (the same flags), and every adaptive reinit decision to sit
more than 1e-3 from its limit, so no rounding can flip one. The
stage-level JAX references come from six child processes, each run once
per test session and shared by the workers (tests/jax_oracle.shared);
the whole-step run has a child of its own, which runs the JAX step
outside jit so that each fixup's flags can be read.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gpufluidsimulation_tpu import config
from gpufluidsimulation_tpu.bimocq import mapping as jmp
from gpufluidsimulation_tpu.core import grids as jgrids
from gpufluidsimulation_tpu.ops import interp_fast as jif
from gpufluidsimulation_tpu_torch.bimocq import mapping as mp
from gpufluidsimulation_tpu_torch.core import grids
from gpufluidsimulation_tpu_torch.ops import interp_fast
from tests import jax_oracle
from tests import test_torch_bimocq_full as full

VOL9 = config.EngineMode(fast_interp=True, interp_interpret=True,
                         volume_vol9=True)
SHAPE = (40, 32, 24)
H = 0.2 / SHAPE[0]
# (kind, clamp_lo, clamp_hi, channels, band): c decides on the advect
# stage's band and v on the error stage's (the vol9 form of
# bimocq_advect_3d below takes the same decisions, and the JAX child
# compiles each once), u and w on every node
KINDS = [("c", 1.0, 1.0, 2, (2, 2, 2, 3)), ("u", 0.0, 0.0, 1, None),
         ("v", 0.0, 0.0, 1, (1, 2, 1, 2)), ("w", 1.0, 1.0, 1, None)]
TOLS = {"exact": 0.0, "dual": 1e9, "default": None}
ADVECT_KINDS = ("v", "c")
# whole steps: (reinit, blend, steps, dt)
STEP_RUN = ("adaptive", 0.5, 3, 0.25)
# the stage-level JAX references, each one child per test session
STAGES = tuple(f"fixups_{k[0]}" for k in KINDS) + ("advect_exact",
                                                   "advect_default")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def port_flags(monkeypatch):
    """Every vol9 decision the port takes in the test, each checked to
    give the same flags at tol * (1 -+ 1e-3)."""
    calls = []
    flags_of = interp_fast.vol9_flags

    def spy(*args, tol=None, **kw):
        tol = interp_fast.VOL9_TOL if tol is None else tol
        flags = flags_of(*args, tol=tol, **kw)
        if tol > 0:
            for f in (1.0 - 1e-3, 1.0 + 1e-3):
                assert torch.equal(flags_of(*args, tol=tol * f, **kw),
                                   flags), "a vol9 decision sits on its edge"
        calls.append(flags.numpy())
        return flags

    monkeypatch.setattr(interp_fast, "vol9_flags", spy)
    return calls


def _fields(kind, C, seed):
    """C fields of `kind`: a constant with a rough patch (channel 0 at the
    high-x end, channel 1, scale 50, at the low-x end), so that some
    decision blocks are flat and keep the dual form."""
    shape = grids.Grid3D(*SHAPE, H).shape_of(kind)
    rng = np.random.default_rng(seed)
    out = []
    for c in range(C):
        f = np.full(shape, (1.0, 50.0)[c], np.float32)
        patch = (slice(34, None) if c == 0 else slice(0, 6), slice(4, 20),
                 slice(3, 21))
        f[patch] += (1.0, 50.0)[c] * rng.random(f[patch].shape).astype(
            np.float32)
        out.append(f)
    return np.stack(out)


def _stage_maps():
    return [full._maps_at(SHAPE, H, s, amp=0.8) for s in (50, 60)]


def _spy_jax_fixups(calls):
    """Record each JAX fixup launch's flags (code > 0), whether they hold
    at tol * (1 -+ 1e-3), and its exact block count."""
    fixup = jif._vol9_fixup_padded

    def spy(maps_packed, fields_packed, gx, gy, gz, fields, dev_blk, **kw):
        out = fixup(maps_packed, fields_packed, gx, gy, gz, fields, dev_blk,
                    **kw)
        flags = np.asarray(out[1]) > 0
        held = True
        if kw["tol"] > 0:
            Rr, out_shape = kw["Rr"], kw["out_shape"]
            nb = (out_shape[0] // jif.BX, out_shape[1] // jif._by(Rr),
                  out_shape[2] // jif._vol9_bz(out_shape[2]))
            for f in (1.0 - 1e-3, 1.0 + 1e-3):
                codes = jif._origins_vol9(
                    (gx, gy, gz), fields, dev_blk, kw["dim"], kw["clamp"],
                    kw["grid_n"], fields_packed.shape[1:], Rr=Rr, P=Rr + 2,
                    nb=nb, tol=kw["tol"] * f, nt=jif._vol9_nt(Rr),
                    out_shape=out_shape, band=kw["band"])[1]
                held = held and np.array_equal(np.asarray(codes) > 0, flags)
        calls.append((flags, held, int(out[3])))
        return out

    jif._vol9_fixup_padded = spy


def _pack_calls(calls):
    out = {f"flags_{i}": f for i, (f, _, _) in enumerate(calls)}
    out["held"] = np.array([h for _, h, _ in calls])
    out["n_exact"] = np.array([n for _, _, n in calls])
    return out


def _check_flags(port_calls, jax_run):
    """The port's fixups took JAX's decisions, call by call, and every
    JAX decision held at tol * (1 -+ 1e-3)."""
    assert jax_run["held"].all()
    assert len(port_calls) == len(jax_run["held"])
    for i, flags in enumerate(port_calls):
        np.testing.assert_array_equal(flags, jax_run[f"flags_{i}"],
                                      err_msg=f"fixup call {i}")


# ---------------------------------------------------------------------------
# The JAX side (run in the child process)
# ---------------------------------------------------------------------------


def _jax_stage(name):
    calls = []
    _spy_jax_fixups(calls)
    jg = jgrids.Grid3D(*SHAPE, H)
    gn = (jg.ni, jg.nj, jg.nk)
    bwd, fwd = (jnp.asarray(m) for m in _stage_maps())
    out = {}
    if name.startswith("fixups_"):
        kind, clo, chi, C, band = next(k for k in KINDS
                                       if k[0] == name[len("fixups_"):])
        for label, tol in TOLS.items():
            got = jif.sample3_vol9(
                jnp.asarray(_fields(kind, C, 1)), bwd, jg.dim_of(kind), H,
                gn, clo, chi, Rr=2, interpret=True, tol=tol, band=band)
            out[label] = np.asarray(got)
            out.update({f"{label}_{k}": v
                        for k, v in _pack_calls(calls[-1:]).items()})
        assert len(calls) == len(TOLS)
        return out
    tol = jif._VOL9_TOL
    if name == "advect_exact":
        jif._VOL9_TOL = 0.0
    for kind in ADVECT_KINDS:
        C = 2 if kind == "c" else 1
        cur, init = _fields(kind, C, 2), _fields(kind, C, 3)
        with config.engine_mode_scope(VOL9):
            assert jmp._volume_mode() == "vol9"
            got = jmp.bimocq_advect_3d(
                jg, kind, list(jnp.asarray(cur)), list(jnp.asarray(init)),
                [None] * C, bwd, None, fwd, None)
        for c, g in enumerate(got):
            out[f"{kind}_{c}"] = np.asarray(g)
    jif._VOL9_TOL = tol
    out.update(_pack_calls(calls))
    return out


def _jax_run(name):
    if name in STAGES:
        return _jax_stage(name)
    calls = []
    _spy_jax_fixups(calls)
    out = full._jax_states(VOL9, *STEP_RUN, eager=True)
    out.update(_pack_calls(calls))
    return out


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


# the whole-step test first: it is the file's longest, and the workers
# take tests in file order
def test_bimocq_vol9_adaptive_step_matches_jax(tmp_path, port_flags):
    """Adaptive reinit, blend 0.5, vol9: 3 whole steps at 16^3."""
    run = jax_oracle.run(__file__, tmp_path, "steps")["steps"]
    interp_fast.reset_vol9_block_counts()
    cfg, states = full._compare_states(run, VOL9, *STEP_RUN)
    assert cfg.engine_mode.volume_mode == "vol9"
    _check_flags(port_flags, run)
    exact, total = interp_fast.vol9_block_counts()
    assert exact == int(run["n_exact"].sum()) and total > 0
    # 12 pull-back stages and 4 accumulates per step
    assert len(port_flags) == 16 * STEP_RUN[2]


def _port_fixup(tg, kind, clo, chi, fields, maps, band, tol):
    """The port's counterpart of JAX sample3_vol9: the dual sample at the
    map's lattice values, then vol9_fixup_plain."""
    p1 = mp.map_at_lattice_3d(tg, maps, kind, clo, chi)
    duals = interp_fast.trilerp_sample(fields, *p1, tg.h,
                                       (tg.off_of(kind),) * fields.shape[0],
                                       dual=True)
    stats = interp_fast.vol9_map_stats(maps, tg.h, tg.shape_c)
    return duals, interp_fast.vol9_fixup_plain(duals, fields, stats, maps, p1,
                                               tg, kind, clo, chi, band=band,
                                               tol=tol)


def _port_exact(tg, kind, clo, chi, fields, maps):
    """The exact volume form as the mapping module evaluates it."""

    def ev(px, py, pz):
        m = mp._map_sample_3d(tg, maps, px, py, pz, clo, chi)
        return torch.stack(mp._sample_fields_at(tg, kind, list(fields),
                                                m)).transpose(0, 1)

    return interp_fast.volume_eval_3d(tg, kind, ev, fields.device)


@pytest.mark.parametrize("kind,clo,chi,C,band", KINDS,
                         ids=[k[0] for k in KINDS])
@pytest.mark.parametrize("label", list(TOLS))
def test_vol9_fixup_matches_jax(tmp_path_factory, port_flags, kind, clo,
                                chi, C, band, label):
    want = jax_oracle.shared(tmp_path_factory, __file__,
                             f"fixups_{kind}")[f"fixups_{kind}"]
    tg = grids.Grid3D(*SHAPE, H)
    fields = torch.from_numpy(_fields(kind, C, 1))
    maps = torch.from_numpy(_stage_maps()[0])
    duals, got = _port_fixup(tg, kind, clo, chi, fields, maps, band,
                             TOLS[label])
    (flags,) = port_flags
    _check_flags(port_flags, {k[len(label) + 1:]: v for k, v in want.items()
                              if k.startswith(label + "_")})
    # staggered kinds: a last face plane past the block lattice keeps the
    # dual form (in JAX too)
    inner = tuple(slice(0, min(s, o)) for s, o in zip(
        fields.shape[1:], interp_fast.vol9_blocks(tg.shape_c)[0]))
    if label == "exact":
        assert flags.all()
        exact = _port_exact(tg, kind, clo, chi, fields, maps)
        np.testing.assert_array_equal(got[(slice(None),) + inner].numpy(),
                                      exact[(slice(None),) + inner].numpy())
    elif label == "dual":
        assert not flags.any()
        assert torch.equal(got, duals)
    else:
        # the default tol keeps the dual form on some blocks and not others
        assert flags.any() and not flags.all()
    np.testing.assert_allclose(got.numpy(), want[label],
                               rtol=3e-5, atol=3e-6)
    # the wrapper on the CPU: the same values, counts, no launch
    interp_fast.reset_vol9_block_counts()
    launches = interp_fast.vol9_fixup.launches
    p1 = mp.map_at_lattice_3d(tg, maps, kind, clo, chi)
    wrapped = interp_fast.vol9_fixup(
        duals, fields, interp_fast.vol9_map_stats(maps, tg.h, tg.shape_c),
        maps, p1, tg, kind, clo, chi, band=band, tol=TOLS[label])
    assert torch.equal(wrapped, got)
    assert interp_fast.vol9_fixup.launches == launches
    assert interp_fast.vol9_block_counts() == (
        int(want[f"{label}_n_exact"][0]), flags.size)


@pytest.mark.parametrize("label", ["exact", "default"])
def test_vol9_bimocq_advect_matches_jax(tmp_path_factory, port_flags,
                                        monkeypatch, label):
    want = jax_oracle.shared(tmp_path_factory, __file__,
                             f"advect_{label}")[f"advect_{label}"]
    if label == "exact":
        monkeypatch.setattr(interp_fast, "VOL9_TOL", 0.0)
    tg = grids.Grid3D(*SHAPE, H)
    bwd, fwd = (torch.from_numpy(m) for m in _stage_maps())
    stats = tuple(interp_fast.vol9_map_stats(m, tg.h, tg.shape_c)
                  for m in (bwd, fwd))
    for kind in ADVECT_KINDS:
        C = 2 if kind == "c" else 1
        cur, init = _fields(kind, C, 2), _fields(kind, C, 3)
        got = mp.bimocq_advect_3d(
            tg, kind, list(torch.from_numpy(cur)),
            list(torch.from_numpy(init)), [None] * C, bwd, None, fwd, None,
            mode="vol9", map_stats=stats)
        for c in range(C):
            scale = float(np.abs(init[c]).max())
            np.testing.assert_allclose(got[c].numpy(), want[f"{kind}_{c}"],
                                       rtol=0, atol=1e-5 * scale,
                                       err_msg=f"{kind} {c}")
    _check_flags(port_flags, want)
    if label == "default":
        flags = np.concatenate([f.reshape(-1) for f in port_flags])
        assert flags.any() and not flags.all()


if __name__ == "__main__":
    jax_oracle.serve(_jax_run)
