"""The port's ``sim2d`` CLI on the CPU (``--device cpu``) and its 2D
writers.

* ``sim2d 7 0 --frames 1`` (BiMocq, the Taylor vortex at 256^2, dt
  0.025) writes ``vort_0000.bmp`` under ``<out>/2D_Taylor_vortex/BiMocq``,
  byte for byte what the JAX package's colormap and BMP writer make of
  the vorticity of one ``Smoke2D`` step of the same scene here.
* ``sim2d 7 3 --frames 1`` (BiMocq, the Zalesak disk at 200^2, a
  level set stepped at CFL 0.75 through a frame of 2.0) writes
  ``levelset_0000.txt``, the rho of the same substeps run here.
* The BMP writers and the colormap against the JAX package's, byte for
  byte; a particle scheme, an unknown example and a run without a card
  exit non-zero and write nothing.
"""

import math

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch import cli
from gpufluidsimulation_tpu_torch.io_utils import bmp, colormap, volume
from gpufluidsimulation_tpu_torch.ops import forces
from gpufluidsimulation_tpu_torch.scenes import scenes2d
from gpufluidsimulation_tpu_torch.solvers import smoke2d
from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(example):
    scene = scenes2d.make_scene_2d(example, Scheme.BIMOCQ)
    solver = smoke2d.Smoke2D(scene.cfg, device="cpu")
    return scene, solver, scene.init(solver, solver.init_state())


def test_sim2d_taylor_vortex_frame(tmp_path, capsys):
    from gpufluidsimulation_tpu.io_utils import bmp as jbmp
    from gpufluidsimulation_tpu.io_utils import colormap as jcolormap

    assert cli.main(["sim2d", "7", "0", "--frames", "1", "--device", "cpu",
                     "--out", str(tmp_path)]) == 0
    printed = capsys.readouterr().out
    assert "BiMocq frame 0 done" in printed
    assert "[Bimocq GPU Time:" in printed and "proj_iters=" in printed
    out = tmp_path / "2D_Taylor_vortex" / "BiMocq"
    assert sorted(p.name for p in out.iterdir()) == ["vort_0000.bmp"]
    scene, solver, state = _scene(0)
    state = solver.step(state, scene.dt)
    g = solver.grid
    curl = forces.curl_2d(state.u, state.v, g.h).numpy()
    assert np.isfinite(curl).all() and np.abs(curl).max() > 1.0
    jbmp.write_bmp_rgb(str(tmp_path / "want.bmp"),
                       jcolormap.render_vorticity(curl, g.ni, g.nj))
    assert ((out / "vort_0000.bmp").read_bytes()
            == (tmp_path / "want.bmp").read_bytes())


def test_sim2d_zalesak_levelset_frame(tmp_path, capsys):
    assert cli.main(["sim2d", "7", "3", "--frames", "1", "--device", "cpu",
                     "--out", str(tmp_path)]) == 0
    assert "BiMocq frame 0 done" in capsys.readouterr().out
    out = tmp_path / "2D_Zalesak" / "BiMocq"
    assert sorted(p.name for p in out.iterdir()) == ["levelset_0000.txt"]
    got = np.loadtxt(out / "levelset_0000.txt")
    scene, solver, state = _scene(3)
    t, subs = 0.0, 0
    while t < scene.frame_dt:
        mv = float(smoke2d.max_vel(state.u, state.v))
        sub = min(scene.cfl_number * solver.grid.h / mv, scene.frame_dt - t)
        state = solver.step(state, sub)
        t += sub
        subs += 1
    assert subs == 3 and state.frame == 3
    rho = state.rho.numpy()
    assert got.shape == rho.shape and np.isfinite(got).all()
    # the file holds %g values: 6 significant digits
    np.testing.assert_allclose(got, rho, rtol=1e-5, atol=1e-7)
    want = volume.write_levelset_txt(str(tmp_path / "want"), 0, state.rho)
    assert (out / "levelset_0000.txt").read_bytes() == open(want,
                                                            "rb").read()


@pytest.mark.parametrize("seed", [0, 1])
def test_bmp_and_colormap_match_jax(tmp_path, seed):
    from gpufluidsimulation_tpu.io_utils import bmp as jbmp
    from gpufluidsimulation_tpu.io_utils import colormap as jcolormap

    rng = np.random.default_rng(seed)
    ni, nj = 37, 29                 # odd widths: padded BMP rows
    a = rng.uniform(-0.2, 1.2, (ni, nj)).astype(np.float32)
    b = rng.uniform(-0.2, 1.2, (ni, nj)).astype(np.float32)
    curl = rng.normal(0, 8, (ni + 1, nj + 1)).astype(np.float32)
    np.testing.assert_array_equal(colormap.vorticity_to_rgb(curl),
                                  jcolormap.vorticity_to_rgb(curl))
    rgb = colormap.render_vorticity(torch.from_numpy(curl), ni, nj)
    np.testing.assert_array_equal(rgb,
                                  jcolormap.render_vorticity(curl, ni, nj))
    for name, mine, theirs, args in (
            ("gray", bmp.write_bmp, jbmp.write_bmp, (a,)),
            ("color", bmp.write_bmp_color, jbmp.write_bmp_color, (a, b)),
            ("rgb", bmp.write_bmp_rgb, jbmp.write_bmp_rgb, (rgb,))):
        mine(str(tmp_path / f"{name}_port.bmp"),
             *(torch.from_numpy(np.array(x)) for x in args))
        theirs(str(tmp_path / f"{name}_jax.bmp"), *args)
        assert ((tmp_path / f"{name}_port.bmp").read_bytes()
                == (tmp_path / f"{name}_jax.bmp").read_bytes()), name


def test_curl_and_buoyancy_match_jax():
    import jax.numpy as jnp

    from gpufluidsimulation_tpu.ops import forces as jforces

    rng = np.random.default_rng(3)
    ni, nj, h = 24, 40, 1.0 / 24
    u = rng.normal(0, 0.1, (ni + 1, nj)).astype(np.float32)
    v = rng.normal(0, 0.1, (ni, nj + 1)).astype(np.float32)
    rho = rng.uniform(0, 1, (ni, nj)).astype(np.float32)
    T = rng.uniform(0, 1, (ni, nj)).astype(np.float32)
    got = forces.curl_2d(torch.from_numpy(u), torch.from_numpy(v), h)
    want = np.asarray(jforces.curl_2d(jnp.asarray(u), jnp.asarray(v), h))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    for dt in (0.01, np.float32(0.5) * np.float32(0.025)):
        got = forces.buoyancy_2d(torch.from_numpy(v), torch.from_numpy(rho),
                                 torch.from_numpy(T), 0.2, 0.05, dt)
        want = np.asarray(jforces.buoyancy_2d(
            jnp.asarray(v), jnp.asarray(rho), jnp.asarray(T), 0.2, 0.05,
            jnp.float32(dt)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


def test_sim2d_refusals(tmp_path, capsys, monkeypatch):
    for argv, msg in ((["sim2d", "4", "0"], "particles slice"),
                      (["sim2d", "7", "9"], "unknown 2D example 9"),
                      (["sim2d", "9", "0"], "is not a valid Scheme"),
                      (["sim2d", "4", "3"], "levelset is not supported")):
        assert cli.main(argv + ["--device", "cpu",
                                "--out", str(tmp_path)]) == 2
        assert msg in capsys.readouterr().err, argv
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["sim2d", "7", "0", "--frames", "1",
                     "--out", str(tmp_path)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())
    assert scenes2d.make_scene_2d(0, Scheme.BIMOCQ).cfg.L == 2 * math.pi
