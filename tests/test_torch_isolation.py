"""The port stands alone: no JAX, no import of the JAX package, and its
kernel wrappers take the plain path on CPU tensors without launching."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gpufluidsimulation_tpu_torch.core.grids import Grid3D
from gpufluidsimulation_tpu_torch.ops import _build, interp_fast
from gpufluidsimulation_tpu_torch.ops import stencil_kernels
from tests import torch_threads  # noqa: F401 (one CPU torch thread)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "gpufluidsimulation_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "gpufluidsimulation_tpu")
WRAPPERS = (interp_fast.trilerp_sample, interp_fast.minmax_sample,
            interp_fast.rk3_substep,
            interp_fast.dmc_substep, stencil_kernels.jacobi_diffuse,
            stencil_kernels.rbgs_smooth, stencil_kernels.masked_rbgs_smooth,
            interp_fast.volume_prefilter, interp_fast.vol9_fixup,
            interp_fast.pullback_sample, interp_fast.bilerp_sample,
            interp_fast.bilerp_sample_mac, interp_fast.bilerp_sample_cp,
            interp_fast.p2g_splat)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_port_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "from gpufluidsimulation_tpu_torch.scenes.scenes3d import "
        "vortex_collision_config, moving_obstacle_config\n"
        "from gpufluidsimulation_tpu_torch.solvers.smoke3d import Smoke3D\n"
        "from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme\n"
        "from gpufluidsimulation_tpu_torch import convert\n"
        "from gpufluidsimulation_tpu_torch import cli\n"
        "from gpufluidsimulation_tpu_torch.scenes import scenes2d\n"
        "from gpufluidsimulation_tpu_torch.solvers.smoke2d import Smoke2D\n"
        "s2 = Smoke2D(scenes2d.make_scene_2d(3, Scheme.BIMOCQ).cfg, "
        "device='cpu')\n"
        "assert s2.step(s2.init_state(), 0.1).frame == 1\n"
        "from gpufluidsimulation_tpu_torch.solvers.smoke2d import "
        "Smoke2DConfig\n"
        "for sch in (Scheme.FLIP, Scheme.POLYPIC):\n"
        "    sp = Smoke2D(Smoke2DConfig(ni=8, nj=8, L=1.0, scheme=sch), "
        "device='cpu')\n"
        "    assert sp.step(sp.init_state(), 0.1).particles.pos.shape == "
        "(1024, 2)\n"
        "cfg = vortex_collision_config(ni=8, nj=8, nk=8, "
        "scheme=Scheme.BIMOCQ, dt=1.0)\n"
        "s = Smoke3D(cfg, device='cpu')\n"
        "st = s.step(s.init_state())\n"
        "o = Smoke3D(moving_obstacle_config(ni=8, nj=8, nk=8), device='cpu')\n"
        "assert o.step(o.init_state()).proj_iters > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok', st.frame)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok 1"


def test_native_writer_builds_only_the_ports_source(tmp_path):
    """The port's writer compiles its own gfs_io.c into _build/ and loads
    it as its own module; nothing of gpufluidsimulation_tpu/native/ is
    imported, built or touched."""
    theirs = REPO / "gpufluidsimulation_tpu" / "native"
    code = (
        "import os, sys\n"
        "import numpy as np\n"
        f"theirs = {str(theirs)!r}\n"
        "def listing():\n"
        "    return sorted((n, os.stat(os.path.join(theirs, n)).st_mtime_ns)\n"
        "                  for n in os.listdir(theirs))\n"
        "before = listing()\n"
        "from gpufluidsimulation_tpu_torch import native\n"
        "from gpufluidsimulation_tpu_torch.io_utils import volume\n"
        f"out = volume.write_volume(1, {str(tmp_path)!r}, 0.01, "
        "np.ones((4, 4, 4), np.float32), fmt='gfsvol')\n"
        "assert volume.flush_volumes() == 0 and os.path.exists(out)\n"
        "mod = native.loaded()\n"
        "assert mod.__name__ == 'gpufluidsimulation_tpu_torch.native.gfs_io'\n"
        "assert os.path.dirname(mod.__file__) == str(native.BUILD_DIR)\n"
        "assert native.SOURCE.parent == native.BUILD_DIR.parent / 'native'\n"
        "assert listing() == before\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert not (PORT / "native" / "gfs_io.c").is_symlink()


def test_wrappers_take_plain_path_on_cpu():
    n = 8
    u = torch.rand(n + 1, n, n) * 0.1
    v = torch.rand(n, n + 1, n) * 0.1
    w = torch.rand(n, n, n + 1) * 0.1
    grid = torch.stack(torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32)] * 3, indexing="ij"))
    before = [fn.launches for fn in WRAPPERS]
    h = 0.2 / n
    out = interp_fast.trilerp_sample(u[None], *(grid * h), h,
                                     ((0.0, 0.0, 0.0),), dual=True)
    assert out.shape == (1, n, n, n)
    mn, mx = interp_fast.minmax_sample(u[None], *(grid * h), h,
                                       ((-0.5, 0.0, 0.0),))
    assert mn.shape == mx.shape == (1, n, n, n)
    out = interp_fast.rk3_substep(u, v, w, grid, 0.5,
                                  (1.0, n - 1.0) * 3)
    assert out.shape == grid.shape
    out = interp_fast.dmc_substep(u, v, w, grid * h, 0.5, 1e-6)
    assert out.shape == grid.shape
    out = stencil_kernels.jacobi_diffuse(u, u, 3, 0.1)
    assert out.shape == u.shape
    out = stencil_kernels.rbgs_smooth(None, u, "dirichlet", 2)
    assert out.shape == u.shape
    flags = (torch.rand(u.shape) < 0.2).to(torch.uint8) * 2
    out = stencil_kernels.masked_rbgs_smooth(u, u, flags, 2, reverse=True)
    assert out.shape == u.shape
    out = interp_fast.volume_prefilter(u[None])
    assert out.shape == (1,) + u.shape
    g = Grid3D(n, n, n, h)
    maps = grid * h
    out = interp_fast.vol9_fixup(
        u[None], u[None], interp_fast.vol9_map_stats(maps, h, g.shape_c),
        maps, g.node_coords("u"), g, "u", 0.0, 0.0, tol=0.0)
    assert out.shape == (1,) + u.shape
    out = interp_fast.pullback_sample(
        maps, [u, v, w, u[:-1]], [g.dim_of(k) for k in "uvwc"], h, g.shape_c,
        1.0, 1.0)
    assert out.shape == (4, n + 1, n + 1, n + 1)   # the block grid's extent
    u2, v2 = u[:, :, 0].contiguous(), v[:, :, 0].contiguous()
    out = interp_fast.bilerp_sample(u2[None], *(grid[:2, :, :, 0] * h), h,
                                    ((0.0, 0.5),))
    assert out.shape == (1, n, n)
    out = interp_fast.bilerp_sample_mac(u2[:, :n - 1], v2[:n - 1],
                                        *(grid[:2, :, :, 0] * h), h)
    assert out.shape == (2, n, n)
    out = interp_fast.bilerp_sample_cp([u2[:, :n - 1], v2[:n - 1]],
                                       *(grid[:2, :, :, 0] * h), h,
                                       ((0.0, 0.5), (0.5, 0.0)),
                                       ((n - 1, n - 3), (n - 3, n - 1)))
    assert out.shape == (2, n, n, 4)
    pos = torch.rand(64, 2) * (n - 3) * h + h
    out = interp_fast.p2g_splat(pos, (pos[:, 0], pos[:, 1], pos[:, 0],
                                      pos[:, 1]), h, n - 1, n - 1, None)
    assert [tuple(o.shape) for o in out] == [(n, n - 1), (n - 1, n),
                                             (n - 1, n - 1), (n - 1, n - 1)]
    assert [fn.launches for fn in WRAPPERS] == before == [0] * len(WRAPPERS)


def test_wrappers_refuse_other_devices():
    t = torch.empty(1, 4, 4, 4, device="meta")
    p = torch.empty(4, 4, 4, device="meta")
    with pytest.raises(ValueError):
        interp_fast.trilerp_sample(t, p, p, p, 1.0, ((0.0, 0.0, 0.0),))
    with pytest.raises(ValueError):
        stencil_kernels.jacobi_diffuse(p, p, 1, 0.1)
    with pytest.raises(ValueError):
        stencil_kernels.rbgs_smooth(p, p, "neumann", 1)
    with pytest.raises(ValueError):
        stencil_kernels.masked_rbgs_smooth(None, p, p, 1)
    with pytest.raises(ValueError):
        interp_fast.volume_prefilter(t)
    with pytest.raises(ValueError):
        interp_fast.pullback_sample(torch.empty(3, 4, 4, 4, device="meta"),
                                    [p], [(0, 0, 0)], 1.0, (4, 4, 4), 0.0,
                                    0.0)
    with pytest.raises(ValueError):
        interp_fast.bilerp_sample(torch.empty(1, 4, 4, device="meta"),
                                  p[0], p[0], 1.0, ((0.5, 0.5),))
    with pytest.raises(ValueError):
        interp_fast.p2g_splat(torch.empty(4, 2, device="meta"),
                              [p[0, 0]] * 4, 1.0, 4, 4, None)
    with pytest.raises(ValueError):
        _build.require(torch.zeros(3), "x")


def test_build_flags_and_sources():
    """Every kernel source exists and is built for sm_90a without fast
    math; the library name follows the source contents."""
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert set(_build.SOURCES) >= {"rbgs_smooth", "masked_rbgs_smooth",
                                   "minmax_sample", "volume_prefilter",
                                   "vol9_fixup", "pullback_sample"}
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(
        _build.SOURCES)
    for name in _build.SOURCES:
        src = _build.CSRC / f"{name}.cu"
        assert src.exists()
        assert "Replaces the TPU kernel" in src.read_text()
        assert _build.lib_path(name).name.startswith(name + "-")
