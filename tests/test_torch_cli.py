"""The port's ``sim3d`` CLI on the CPU (``--device cpu``), the slice as a
whole.

* ``sim3d 0 --res 16 --frames 3 --checkpoint-every 1`` (16x32x32, the
  vortex collision under BiMocq) writes ``0001.vdb`` .. ``0003.vdb`` and
  ``ckpt_0000.npz`` .. ``ckpt_0002.npz`` under ``<out>/0-BiMocq-Gpu``.
  Each volume reads back equal to that frame's rho above the 1e-4
  threshold, rho taken by stepping the same scene through ``Smoke3D``
  here. ``0001.vdb`` also matches, within 1e-4 of scale, one step of the
  scene that the JAX CLI builds from the same argv, run as the JAX CLI
  runs it (``step_checked``, the JAX package's CPU defaults), in one
  child process shared by the workers (tests/jax_oracle.shared). At
  ni = 16 the emitter's axis lies on the lattice in float32, so the
  jitted JAX emitter computes what the eager one does.
* ``--resume ckpt_0000.npz`` writes frames 1-2 bit-identical to the
  uninterrupted run.
* ``--residual-trace`` prints the MG-PCG residual trace on the obstacle
  scene; ``step_checked`` is ``step``; an unknown scheme exits 2; without
  ``--device`` and without CUDA the CLI exits non-zero and writes
  nothing, for ``sim3d`` and ``sim2d`` alike.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch import cli, convert
from gpufluidsimulation_tpu_torch.io_utils import checkpoint, volume
from gpufluidsimulation_tpu_torch.scenes import scenes3d
from gpufluidsimulation_tpu_torch.solvers.schemes import (
    SCHEME_3D_ARGV, Scheme)
from tests import jax_oracle

RES = 16
ARGV = ["sim3d", "0", "--res", str(RES), "--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return jax_oracle.shared(tmp_path_factory, __file__, "cli_scene")


def _jax_run(name):
    """One step of the scene the JAX CLI builds for ``sim3d 0 --res 16``
    (cli.py:136-138), stepped as its frame loop steps it."""
    from gpufluidsimulation_tpu.scenes import scenes3d as jscenes
    from gpufluidsimulation_tpu.solvers.schemes import (
        SCHEME_3D_ARGV as JARGV)

    assert name == "cli_scene"
    solver, state = jscenes.SCENES_3D.get(0, jscenes.make_vortex_collision)(
        scheme=JARGV[0], ni=RES, nj=2 * RES, nk=2 * RES, dt=0.08)
    state, retried = solver.step_checked(state)
    return dict(rho=np.asarray(state.rho), frame=np.asarray(state.frame),
                retried=np.asarray(retried))


def _frames(out):
    return Path(out) / "0-BiMocq-Gpu"


def _readback(path, shape):
    """A vdb reads back to the extent of its 8^3 leaves: the grid's part
    of it, zero-padded to `shape`, after checking that the rest is
    background."""
    dense, vox = volume.read_volume(str(path))
    assert vox == pytest.approx(0.2 / RES)
    inside = tuple(slice(0, n) for n in shape)
    rest = dense.copy()
    rest[inside] = 0.0
    assert not rest.any()
    out = np.zeros(shape, np.float32)
    part = dense[inside]
    out[tuple(slice(0, n) for n in part.shape)] = part
    return out


def test_cli_frames_match_the_port_and_the_jax_step(tmp_path, capsys,
                                                    oracle):
    assert cli.main(ARGV + ["--frames", "3", "--checkpoint-every", "1",
                            "--out", str(tmp_path)]) == 0
    printed = capsys.readouterr().out
    assert len(re.findall(r"\[Bimocq GPU Time: [0-9.]+ ms\]", printed)) == 3
    assert "Frame 2 Starts !!!" in printed and "CFL number" in printed
    d = _frames(tmp_path)
    assert sorted(p.name for p in d.iterdir()) == [
        "0001.vdb", "0002.vdb", "0003.vdb",
        "ckpt_0000.npz", "ckpt_0001.npz", "ckpt_0002.npz"]
    solver, state = scenes3d.make_vortex_collision(
        scheme=Scheme.BIMOCQ, ni=RES, nj=2 * RES, nk=2 * RES, dt=0.08,
        device="cpu")
    for frame in range(3):
        state = solver.step(state)
        rho = state.rho.numpy()
        got = _readback(d / f"{frame + 1:04d}.vdb", rho.shape)
        np.testing.assert_array_equal(got, np.where(rho > 1e-4, rho, 0.0))
        ck = checkpoint.load_state(str(d / f"ckpt_{frame:04d}.npz"),
                                   solver.init_state())
        assert ck.frame == frame + 1
        assert torch.equal(ck.rho, state.rho) and torch.equal(ck.u, state.u)
    want = oracle["cli_scene"]
    assert int(want["frame"]) == 1 and not bool(want["retried"])
    jrho = want["rho"]
    got = _readback(d / "0001.vdb", jrho.shape)
    err = float(np.abs(got - np.where(jrho > 1e-4, jrho, 0.0)).max())
    assert jrho.max() > 0.5 and err <= 1e-4 * float(jrho.max()), err


def test_cli_resume_is_bit_identical(tmp_path, capsys):
    full, part = tmp_path / "full", tmp_path / "resumed"
    assert cli.main(ARGV + ["--frames", "3", "--checkpoint-every", "1",
                            "--out", str(full)]) == 0
    ckpt = _frames(full) / "ckpt_0000.npz"
    assert cli.main(ARGV + ["--frames", "3", "--resume", str(ckpt),
                            "--out", str(part)]) == 0
    assert f"resumed from {ckpt} at frame 1" in capsys.readouterr().out
    assert sorted(p.name for p in _frames(part).iterdir()) == [
        "0002.vdb", "0003.vdb"]
    for name in ("0002.vdb", "0003.vdb"):
        assert ((_frames(part) / name).read_bytes()
                == (_frames(full) / name).read_bytes()), name


def test_cli_residual_trace_on_the_obstacle_scene(tmp_path, capsys):
    assert cli.main(["sim3d", "0", "--example", "1", "--res", "8",
                     "--frames", "1", "--residual-trace", "--device", "cpu",
                     "--out", str(tmp_path)]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Residual: ")]
    assert len(lines) == 1
    values = [float(x) for x in lines[0].split()[1:]]
    assert len(values) > 1 and values[-1] < values[0]
    assert (_frames(tmp_path) / "0001.vdb").exists()


def test_step_checked_is_step():
    solver, state = scenes3d.make_vortex_collision(
        scheme=Scheme.BIMOCQ, ni=8, nj=8, nk=8, dt=0.5, device="cpu")
    state = solver.step(state)
    a = solver.step(state)
    b, retried = solver.step_checked(state)
    assert retried is False
    for key, val in convert.state_to_numpy(a).items():
        np.testing.assert_array_equal(convert.state_to_numpy(b)[key], val)
    assert b.frame == a.frame == 2


def test_cli_refusals(tmp_path, capsys, monkeypatch):
    assert cli.main(["sim3d", "7", "--out", str(tmp_path)]) == 2
    assert "unknown 3D scheme 7" in capsys.readouterr().err
    assert set(SCHEME_3D_ARGV) == {0, 1, 2, 3}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["sim3d", "0", "--res", "8", "--frames", "1",
                     "--out", str(tmp_path)]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert cli.main(["sim3d", "0", "--res", "8", "--frames", "1",
                     "--device", "cuda", "--out", str(tmp_path)]) != 0
    assert not any(tmp_path.iterdir())
    assert cli.main(["sim2d", "0", "0", "--out", str(tmp_path)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


jax_oracle.prefetch(__file__, "cli_scene")


if __name__ == "__main__":
    jax_oracle.serve(_jax_run)
