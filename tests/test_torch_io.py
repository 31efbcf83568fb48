"""The port's volume, mesh and native IO against the JAX package's, with no
JAX step.

* ``pack_vdb`` gives the same bytes; ``write_volume`` the same file bytes
  for ``vdb`` and ``gfsvol`` (each after ``flush_volumes()``) and the same
  arrays for ``npz``; ``read_volume`` reads back what was written, in all
  three formats, for a tensor and for an array.
* ``mesh_to_sdf`` gives the same arrays on an octasphere built here;
  ``read_obj`` / ``write_obj`` round-trip and write the JAX package's
  bytes.
* ``sample3_separable`` matches the JAX function to 1 ulp of the level
  set's values at offsets inside, on and far outside the voxel grid.
* The native writer builds from the port's own ``gfs_io.c`` into
  ``_build/``, a failed build raises with the compiler's message, and
  ``GFS_VOLUME_FORMAT=npz`` builds nothing.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu.core import interp as jinterp
from gpufluidsimulation_tpu.io_utils import mesh as jmesh
from gpufluidsimulation_tpu.io_utils import vdb as jvdb
from gpufluidsimulation_tpu.io_utils import volume as jvolume
from gpufluidsimulation_tpu_torch import native
from gpufluidsimulation_tpu_torch.core.grids import Grid3D
from gpufluidsimulation_tpu_torch.core.interp import sample3_separable
from gpufluidsimulation_tpu_torch.io_utils import mesh, vdb, volume
from tests import torch_threads  # noqa: F401 (one CPU torch thread)

REPO = Path(__file__).resolve().parent.parent
SHAPE = (20, 17, 24)
VOXEL = 0.2 / 20


def _density(seed, shape=SHAPE):
    """A sparse density: a blob above the 1e-4 threshold in part, values
    just around the threshold, and zeros."""
    rng = np.random.default_rng(seed)
    x, y, z = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape],
                          indexing="ij")
    blob = np.exp(-4.0 * (x ** 2 + 2 * y ** 2 + z ** 2))
    noise = rng.uniform(0.0, 2e-4, shape)
    d = np.where(blob > 0.2, blob, noise).astype(np.float32)
    d[0] = 0.0
    return d


def _octasphere(r, sub=2):
    """An icosphere-like mesh of radius r: the octahedron subdivided `sub`
    times with its vertices pushed onto the sphere."""
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], float)
    faces = [[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
             [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]]
    for _ in range(sub):
        vl = verts.tolist()
        cache = {}

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = (np.array(vl[i]) + np.array(vl[j])) / 2
                m = m / np.linalg.norm(m)
                cache[key] = len(vl)
                vl.append(m.tolist())
            return cache[key]

        nf = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        faces = nf
        verts = np.array(vl)
    return (verts * r).astype(np.float32), np.asarray(faces, np.int32)


def _crop(dense, shape):
    """A vdb reads back to whole 8^3 leaves: the part of `shape`, after
    checking that the rest is background."""
    inside = tuple(slice(0, n) for n in shape)
    rest = dense.copy()
    rest[inside] = 0.0
    assert not rest.any()
    return dense[inside]


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_vdb_same_bytes(seed):
    d = _density(seed)
    want = jvdb.pack_vdb(d, VOXEL, name="density", threshold=1e-4)
    got = vdb.pack_vdb(d, VOXEL, name="density", threshold=1e-4)
    assert got == want
    dense, vox = vdb.read_vdb(got)
    np.testing.assert_array_equal(_crop(dense, d.shape),
                                  np.where(d > 1e-4, d, 0.0))
    assert vox == pytest.approx(VOXEL)


@pytest.mark.parametrize("fmt", ["vdb", "gfsvol", "npz"])
def test_write_volume_matches_jax_and_reads_back(tmp_path, fmt):
    d = _density(2)
    want = jvolume.write_volume(3, str(tmp_path / "jax"), VOXEL, d, fmt=fmt)
    jvolume.flush_volumes()
    before = volume.flush_volumes()
    got = volume.write_volume(3, str(tmp_path / "port"), VOXEL,
                              torch.from_numpy(d), fmt=fmt)
    assert volume.flush_volumes() == before
    assert Path(got).name == Path(want).name == f"0003.{fmt}"
    if fmt == "npz":
        with np.load(got) as a, np.load(want) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key])
    else:
        assert Path(got).read_bytes() == Path(want).read_bytes()
    dense, vox = volume.read_volume(got)
    np.testing.assert_array_equal(_crop(dense, d.shape),
                                  np.where(d > 1e-4, d, 0.0))
    assert vox == pytest.approx(VOXEL)
    jdense, _ = jvolume.read_volume(got)
    np.testing.assert_array_equal(jdense, dense)


def test_write_volume_takes_a_numpy_array_and_env_format(tmp_path,
                                                         monkeypatch):
    d = _density(3)
    monkeypatch.setenv("GFS_VOLUME_FORMAT", "gfsvol")
    before = volume.flush_volumes()
    out = volume.write_volume(0, str(tmp_path), VOXEL, d)
    assert out.endswith("0000.gfsvol") and volume.flush_volumes() == before
    np.testing.assert_array_equal(volume.read_volume(out)[0],
                                  np.where(d > 1e-4, d, 0.0))
    with pytest.raises(ValueError, match="format"):
        volume.write_volume(0, str(tmp_path), VOXEL, d, fmt="exr")


def test_levelset_txt_same_bytes(tmp_path):
    sdf = np.random.default_rng(5).standard_normal((6, 9)).astype(
        np.float32)
    got = volume.write_levelset_txt(str(tmp_path / "port"), 2,
                                    torch.from_numpy(sdf))
    want = jvolume.write_levelset_txt(str(tmp_path / "jax"), 2, sdf)
    assert Path(got).name == Path(want).name == "levelset_0002.txt"
    assert Path(got).read_bytes() == Path(want).read_bytes()


def test_flush_counts_failed_writes(tmp_path):
    """A write that cannot land is counted by every later flush."""
    d = _density(4)
    volume.write_volume(0, str(tmp_path), VOXEL, d, fmt="vdb")
    before = volume.flush_volumes()
    native.load().async_write(str(tmp_path / "missing" / "x.vdb"), b"x")
    assert volume.flush_volumes() == before + 1
    volume.write_volume(1, str(tmp_path), VOXEL, d, fmt="vdb")
    assert volume.flush_volumes() == before + 1


def test_mesh_to_sdf_matches_jax():
    v, f = _octasphere(0.05, sub=2)
    n = 16
    h = 0.2 / n
    for shape, origin in (((n, n, n), (0.0, 0.0, 0.0)),
                          ((10, 12, 9), (0.01, -0.02, 0.0))):
        want = jmesh.mesh_to_sdf(v + 0.08, f, shape, h, origin=origin)
        got = mesh.mesh_to_sdf(v + 0.08, f, shape, h, origin=origin)
        assert got.dtype == want.dtype and got.shape == want.shape == shape
        np.testing.assert_array_equal(got, want)
        assert (got < 0).any() and (got > 0).any()


def test_obj_roundtrip_and_bytes(tmp_path):
    v, f = _octasphere(0.05, sub=1)
    got = mesh.write_obj(str(tmp_path / "port.obj"), v, f)
    want = jmesh.write_obj(str(tmp_path / "jax.obj"), v, f)
    assert Path(got).read_bytes() == Path(want).read_bytes()
    v2, f2 = mesh.read_obj(got)
    np.testing.assert_allclose(v2, v, atol=1e-5)
    np.testing.assert_array_equal(f2, f)
    rv, rt = mesh.sdf_to_mesh(mesh.mesh_to_sdf(v + 0.1, f, (20, 20, 20),
                                               0.01), 0.01)
    jv, jt = jmesh.sdf_to_mesh(jmesh.mesh_to_sdf(v + 0.1, f, (20, 20, 20),
                                                 0.01), 0.01)
    np.testing.assert_array_equal(rv, jv)
    np.testing.assert_array_equal(rt, jt)


@pytest.mark.parametrize("where", ["inside", "on_lattice", "far_outside"])
def test_sample3_separable_matches_jax(where):
    """A 10x8x12 level set looked up at every node of a 16x20x24 grid
    shifted by one position: inside the voxel grid, exactly on its
    lattice, and so far off that most nodes clamp to its edges."""
    rng = np.random.default_rng(5)
    h = 0.2 / 16
    sdf = rng.standard_normal((10, 8, 12)).astype(np.float32)
    pos = {"inside": (0.013, 0.0071, 0.0202),
           "on_lattice": (3 * h, 2 * h, 5 * h),
           "far_outside": (-0.3, 0.45, 0.11)}[where]
    g = Grid3D(16, 20, 24, h)
    for kind in ("c", "u", "v", "w"):
        ax = g.axis_coords(kind)
        got = sample3_separable(torch.from_numpy(sdf), ax[0] - pos[0],
                                ax[1] - pos[1], ax[2] - pos[2], h).numpy()
        full = [np.broadcast_to(a.numpy(), g.shape_of(kind)) for a in ax]
        want = np.asarray(jinterp.sample3_separable(
            jnp.asarray(sdf), *(jnp.asarray(c) - p for c, p in zip(
                full, pos)), h))
        assert got.shape == want.shape == g.shape_of(kind)
        ulp = np.spacing(np.maximum(np.abs(want), np.abs(sdf).max()))
        assert (np.abs(got - want) <= ulp).all(), (kind, where)
        full_got = sample3_separable(
            torch.from_numpy(sdf), *(torch.from_numpy(np.ascontiguousarray(
                c)) - p for c, p in zip(full, pos)), h).numpy()
        np.testing.assert_array_equal(full_got, got)


def test_native_builds_from_the_ports_source(tmp_path):
    port = REPO / "gpufluidsimulation_tpu_torch"
    assert native.SOURCE == port / "native" / "gfs_io.c"
    assert native.lib_path().parent == port / "_build"
    assert native.lib_path().name.startswith("gfs_io-")
    cmd = native._command(tmp_path / "x.so")
    assert str(native.SOURCE) in cmd
    assert not any("gpufluidsimulation_tpu/" in c for c in cmd)
    mod = native.load()
    assert mod.__name__ == "gpufluidsimulation_tpu_torch.native.gfs_io"
    assert Path(mod.__file__).parent == port / "_build"


def test_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "gfs_io.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="gfs_io.c"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_npz_format_builds_nothing(tmp_path):
    code = (
        "import numpy as np, sys\n"
        "from gpufluidsimulation_tpu_torch import native\n"
        "from gpufluidsimulation_tpu_torch.io_utils import volume\n"
        f"out = volume.write_volume(1, {str(tmp_path)!r}, 0.01, "
        "np.ones((4, 4, 4), np.float32))\n"
        "assert out.endswith('0001.npz'), out\n"
        "assert volume.flush_volumes() == 0\n"
        "assert native.loaded() is None\n"
        "assert 'gpufluidsimulation_tpu_torch.native.gfs_io' not in "
        "sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), GFS_VOLUME_FORMAT="npz")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
