"""Carry solver state and configuration across from plain numpy values.

The port never sees a JAX object: callers flatten the JAX package's state
into numpy arrays under flat keys (``u``, ``rho``, ``vel_map.fwd``,
``vel_map.bwd``, ``frame``, ...; the 2D state's particle columns as
``particles.pos`` .. ``particles.C_T``) and its config into plain field
values. The same functions carry the 3D state (``Smoke3DState``) and the
2D one (``Smoke2DState``); ``config_from_dict`` builds a
``Smoke3DConfig``, ``config_2d_from_dict`` a ``Smoke2DConfig``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpufluidsimulation_tpu_torch import config
from gpufluidsimulation_tpu_torch.bimocq.mapping import MappingState
from gpufluidsimulation_tpu_torch.solvers import smoke2d
from gpufluidsimulation_tpu_torch.solvers.particles import ParticleState
from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
from gpufluidsimulation_tpu_torch.solvers.smoke3d import (
    Boundary3D,
    Emitter3D,
    Smoke3DConfig,
    init_state,
)

# the state's nested records, flattened as "<field>.<subfield>"
_NESTED = (MappingState, ParticleState)


def _tensor(a, device):
    """float32 tensor of `a` with its shape (0-d arrays stay 0-d)."""
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        device)


def state_leaves(state):
    """(flat key, value) of every non-None leaf of `state` in field order:
    tensors, host ints and the float ``cfl``; a nested record's leaves
    (a mapping's ``fwd``, ``bwd``, ``bwd_prev`` and ``reinit_count``, the
    particle columns) are ``<field>.<subfield>``."""
    for f in dataclasses.fields(state):
        val = getattr(state, f.name)
        if isinstance(val, _NESTED):
            for g in dataclasses.fields(val):
                sub = getattr(val, g.name)
                if sub is not None:
                    yield f"{f.name}.{g.name}", sub
        elif val is not None:
            yield f.name, val


def _leaf(value, cur):
    """A flat numpy value as the template leaf `cur` holds it: a tensor
    on its device, a host int or a host float."""
    if isinstance(cur, torch.Tensor):
        return _tensor(value, cur.device)
    if isinstance(cur, float):
        return float(value)
    return int(value)


def fill_state(template, arrays: dict):
    """`template` with the leaves that `arrays` names replaced by its flat
    numpy values, each tensor on its template leaf's device; keys the dict
    lacks keep the template's values, and ``None`` leaves stay ``None``."""
    kw = {}
    for f in dataclasses.fields(template):
        name = f.name
        cur = getattr(template, name)
        if isinstance(cur, _NESTED):
            kw[name] = dataclasses.replace(cur, **{
                g.name: _leaf(arrays[f"{name}.{g.name}"], getattr(cur, g.name))
                for g in dataclasses.fields(cur)
                if f"{name}.{g.name}" in arrays
                and getattr(cur, g.name) is not None})
        elif name in arrays and cur is not None:
            kw[name] = _leaf(arrays[name], cur)
    return dataclasses.replace(template, **kw)


def state_from_numpy(arrays: dict, cfg, device):
    """Build a state from flat numpy arrays (``fill_state`` of the
    configuration's initial state on `device`): a ``Smoke3DState`` for a
    ``Smoke3DConfig``, a ``Smoke2DState`` for a ``Smoke2DConfig``."""
    if isinstance(cfg, smoke2d.Smoke2DConfig):
        return fill_state(smoke2d.init_state(cfg, device), arrays)
    return fill_state(init_state(cfg, device), arrays)


def state_to_numpy(state) -> dict:
    """Flat numpy arrays of every non-None leaf of `state`: float32 arrays
    for tensors and ``cfl``, int32 for the counters."""
    out = {}
    for key, val in state_leaves(state):
        if isinstance(val, torch.Tensor):
            out[key] = val.detach().cpu().numpy()
        elif isinstance(val, float):
            out[key] = np.float32(val)
        else:
            out[key] = np.int32(val)
    return out


_EMITTER_KEYS = {f.name for f in dataclasses.fields(Emitter3D)}
_BOUNDARY_KEYS = {f.name for f in dataclasses.fields(Boundary3D)}


def _callable(d, key, mine, what):
    """Replace field `key` of `d` (a callable of the JAX package, a
    closure over ``jax.numpy``, never carried across) by the port's own
    `mine`; with `mine` None the field must be None."""
    if d.pop(key, None) is not None and mine is None:
        raise ValueError(f"{what} {key} is a callable of the other package: "
                         f"pass the port's own through {what}_{key}")
    d[key] = mine


def _voxel_grid(d):
    """A voxel level set crosses as a float32 numpy array."""
    if d.get("sdf_grid") is not None:
        d["sdf_grid"] = np.array(d["sdf_grid"], dtype=np.float32)


def _emitter(e, trans=None, emit_velocity=None) -> Emitter3D:
    """An emitter from its plain field values; `trans` and `emit_velocity`
    are the port's own callables for the JAX emitter's."""
    d = dict(e) if isinstance(e, dict) else dict(vars(e))
    _callable(d, "trans", trans, "emitter")
    _callable(d, "emit_velocity", emit_velocity, "emitter")
    _voxel_grid(d)
    unknown = set(d) - _EMITTER_KEYS
    if unknown:
        raise ValueError(f"unknown emitter fields {sorted(unknown)}")
    d["center"] = tuple(float(c) for c in d["center"])
    return Emitter3D(**d)


def _boundary(b, trans=None) -> Boundary3D:
    """A boundary from its plain field values; `trans` is the port's own
    callable for the JAX boundary's."""
    d = dict(b) if isinstance(b, dict) else dict(vars(b))
    _callable(d, "trans", trans, "boundary")
    _voxel_grid(d)
    unknown = set(d) - _BOUNDARY_KEYS
    if unknown:
        raise ValueError(f"unknown boundary fields {sorted(unknown)}")
    for key in ("center", "velocity", "half_extents"):
        if key in d:
            d[key] = tuple(float(c) for c in d[key])
    return Boundary3D(**d)


# EngineMode fields of the JAX package whose value changes nothing the port
# computes: interpret mode, the Pallas-vs-XLA viscosity (one function), the
# window sampler's geometry (the kernels gather exactly), and the dense
# binned particle transfer (TPU window geometry that computes the flat
# transfer's function inside its slot contract and counts what falls
# outside it; the port computes the exact flat transfer, with no slot cap).
_MODE_IGNORED = ("interp_interpret", "pallas_diffuse", "interp_rr",
                 "particle_dense")


def _sharded_sampling(ss):
    """The JAX mode's ``sharded_sampling`` in the port: None and ``()``
    as they are; ``(mesh, halo)`` becomes ``(mesh.size, halo)``, a mesh of
    as many slabs on the device of the solver that runs the config
    (``EngineMode.sharded_sampling``), with the same halo. A mesh whose
    size the port cannot build raises."""
    if not ss:
        return ss
    mesh, halo = ss
    size = getattr(mesh, "size", None)
    if not isinstance(size, (int, np.integer)) or size < 1:
        raise NotImplementedError(
            f"engine_mode.sharded_sampling: a mesh of size {size!r} cannot "
            "be built")
    return int(size), int(halo)


def _engine_mode(m, sharded=True):
    """The port's EngineMode from the JAX mode's plain fields: carries
    ``spectral_poisson``, ``volume_dual``, ``volume_vol9`` and ``rbgs``
    across, maps the JAX package's exact volume form (``fast_interp=False``
    or ``volume_exact=True``; under a mesh only the latter) to
    ``volume_exact=True``, its red-black
    smoother off (``rbgs=False``, which ``fast_interp=False`` implies
    unless ``rbgs`` is given) to the Jacobi-smoothed V-cycle
    (``rbgs=False``) and its window sampler without adaptive taps
    (``interp_adaptive=False``, which leaves the JAX package the prefilter
    form) to ``volume_dual=False``, carries ``sharded_sampling`` across
    as its mesh's size (``_sharded_sampling``; with ``sharded=False``,
    for the 2D solver, which has no sharded stage, it is dropped), carries
    ``interp_bf16`` across where the JAX package honours it (its window
    samplers run: ``fast_interp`` not False, or under a mesh; with
    ``fast_interp=False`` the exact engine rounds nothing and the port's
    mode gets None), and accepts fields that do not change the result."""
    if m is None or isinstance(m, config.EngineMode):
        return m
    d = dict(m) if isinstance(m, dict) else dict(vars(m))
    spectral = d.pop("spectral_poisson", None)
    fast = d.pop("fast_interp", None)
    ss = d.pop("sharded_sampling", None)
    # under a mesh the JAX package samples with its window kernels even
    # with fast_interp off (mapping._use_prefilter): not the exact form
    exact = bool(d.pop("volume_exact", None)) or (fast is False and not ss)
    rbgs = d.pop("rbgs", None)
    if rbgs is None and fast is False:
        rbgs = False
    for key in _MODE_IGNORED:
        d.pop(key, None)
    dual = d.pop("volume_dual", None)
    vol9 = d.pop("volume_vol9", None)
    if d.pop("interp_adaptive", None) is False:
        dual = False
    if exact:      # the volume form is exact whatever these say
        dual = vol9 = None
    bf16 = d.pop("interp_bf16", None)
    if fast is False and not ss:
        bf16 = None
    ss = _sharded_sampling(ss) if sharded else None
    if d:
        raise ValueError(f"unknown engine_mode fields {sorted(d)}")
    return config.EngineMode(spectral_poisson=spectral,
                             volume_exact=True if exact else None,
                             volume_dual=dual, volume_vol9=vol9,
                             rbgs=False if rbgs is False else None,
                             sharded_sampling=ss,
                             interp_bf16=None if bf16 is None else bool(bf16))


def _per_item(callables, n):
    return tuple(callables) + (None,) * n


def config_from_dict(d: dict, boundary_trans=(), emitter_trans=(),
                     emitter_emit_velocity=()) -> Smoke3DConfig:
    """The port's config from the JAX config's plain field values
    (``dataclasses.asdict`` of it, or the same keys by hand).
    ``engine_mode`` keeps its projection, its smoother and its volume
    form; voxel level sets (``sdf_grid``) cross as numpy arrays. The
    callables of the JAX config are not carried across: `boundary_trans`
    gives the port's own ``trans(frame)`` for each boundary,
    `emitter_trans` and `emitter_emit_velocity` the port's own
    ``trans(frame)`` and ``emit_velocity(X, Y, Z)`` for each emitter
    (None where the JAX field is None). A sharded engine mode's mesh
    becomes as many slabs on the device of the solver built from the
    config (``_sharded_sampling``)."""
    d = dict(d)
    d["engine_mode"] = _engine_mode(d.get("engine_mode"))
    known = {f.name for f in dataclasses.fields(Smoke3DConfig)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown config fields {sorted(unknown)}")
    if "scheme" in d:
        d["scheme"] = Scheme(int(d["scheme"]))
    if "emitters" in d:
        n = len(d["emitters"])
        d["emitters"] = tuple(
            _emitter(e, t, v) for e, t, v in zip(
                d["emitters"], _per_item(emitter_trans, n),
                _per_item(emitter_emit_velocity, n)))
    if "boundaries" in d:
        n = len(d["boundaries"])
        d["boundaries"] = tuple(
            _boundary(b, t) for b, t in zip(d["boundaries"],
                                            _per_item(boundary_trans, n)))
    return Smoke3DConfig(**d)


def config_2d_from_dict(d: dict) -> smoke2d.Smoke2DConfig:
    """The port's 2D config from the JAX 2D config's plain field values
    (``dataclasses.asdict`` of it). ``engine_mode`` keeps its projection
    (``spectral_poisson``); its other fields change nothing a 2D step
    computes here."""
    d = dict(d)
    d["engine_mode"] = _engine_mode(d.get("engine_mode"), sharded=False)
    known = {f.name for f in dataclasses.fields(smoke2d.Smoke2DConfig)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown 2D config fields {sorted(unknown)}")
    if "scheme" in d:
        d["scheme"] = Scheme(int(d["scheme"]))
    return smoke2d.Smoke2DConfig(**d)
