"""Device and dtype resolution for the port, and its one engine mode.

There are no process-wide engine modes and no environment switches: the
port runs the accelerator defaults of the JAX package (exact gathers in
the kernels, dual volume form, red-black Gauss-Seidel smoothing), every
entry point takes an explicit ``device``, and the choices a solver can
make are carried by its configuration's ``EngineMode``.
"""

from __future__ import annotations

import dataclasses

import torch

DTYPE = torch.float32
# EngineMode.interp_bf16's value for the bf16 windows of the slab paths
# alone (the JAX package's sharded step)
SLABS = "slabs"


@dataclasses.dataclass(frozen=True)
class EngineMode:
    """Per-solver engine mode. ``spectral_poisson``: None or True solves
    the unmasked full-box pressure system directly in the DST/DCT
    eigenbasis (the accelerator default), False with MG-PCG. Projections
    with solid boundaries always use MG-PCG.

    The BiMocq volume average, with the JAX package's precedence
    (``mapping._volume_mode``): ``volume_exact=True`` evaluates it as the
    reference's exact 9-point composition field(M(p + d)) (the JAX
    package's exact-gather mode), whatever the other two say;
    ``volume_dual=False`` takes the source-prefilter form and turns vol9
    off with the dual form; ``volume_vol9=True`` (with the dual form)
    adds the sparse exact fixup to every dual stage. Otherwise the dual
    form (the accelerator default).

    ``rbgs``: None or True smooths the fine levels of every MG V-cycle
    (plain and masked) with the red-black Gauss-Seidel kernels (the
    accelerator default); False smooths every level with damped Jacobi
    in plain torch, as the JAX package computes it with ``use_rbgs`` off
    (its CPU default).

    ``sharded_sampling``: ``(mesh, halo)`` (a ``parallel.sharding.Mesh``
    and the halo in planes) routes the BiMocq map marches and the
    full-lattice samples whose z extent the mesh divides through the
    z-slab kernels of ``parallel/sharded_interp.py``; ``(n, halo)`` with
    an int n does so on a mesh of n slabs on the solver's own device;
    ``()`` or None turns that off (``parallel.sharding.sharded_step``
    sets it). A mesh must live on the solver's device: its home is that
    device and every slab has its device type (the solver raises
    otherwise). Under a mesh the volume forms keep their precedence, but
    vol9 raises: its fixup launch is not sharded.

    ``interp_bf16``: True rounds every field value that the JAX package's
    window samplers read to bfloat16 (its bf16 field windows), and the
    samplers widen it back to float32 at the load: the MAC faces that the
    traces, the map marches' substeps after an identity peel and
    MacCormack's midpoint read (rounded once a step), and the fields that
    the pull-backs (the vol9 fixup's composition too), accumulates and
    semi-Lagrangian and MacCormack samples read. Maps, positions and
    everything else stay float32, the identity peels' first stage and the
    vol9 decision included, as in JAX. Under a mesh the slab samplers and
    the forward march read bf16 (every stage: the JAX sharded march has no
    peel), the backward march and the z-staggered kind's whole samples
    float32. In 2D every field sample rounds, the velocity, map and
    corner min/max samples and the particle transfers do not. ``SLABS``
    ("slabs"): only the slab samplers and the sharded forward march
    round, every other sample reads float32, as in the JAX package's
    sharded step, which turns its single-device window samplers off
    (``parallel.sharding.sharded_step`` sets it). None or False:
    float32."""

    spectral_poisson: bool | None = None
    volume_exact: bool | None = None
    volume_dual: bool | None = None
    volume_vol9: bool | None = None
    rbgs: bool | None = None
    sharded_sampling: tuple | None = None
    interp_bf16: bool | None = None

    @property
    def sharded(self):
        """(mesh, halo) when sharded sampling is on, else None."""
        return self.sharded_sampling or None

    @property
    def volume_mode(self) -> str:
        """'exact', 'prefilter', 'vol9' or 'dual'."""
        if self.volume_exact:
            return "exact"
        if self.volume_dual is False:
            return "prefilter"
        if self.volume_vol9 and self.sharded is not None:
            raise ValueError(
                "volume_vol9=True requested under a sharded mesh: the vol9 "
                "fixup launch is not sharded. Use volume_exact=True (the "
                "exact composition, sampled whole on the home device) or "
                "leave vol9 off for the dual form.")
        return "vol9" if self.volume_vol9 else "dual"

    def __post_init__(self):
        if self.interp_bf16 not in (None, False, True, SLABS):
            raise ValueError(f"interp_bf16={self.interp_bf16!r}: None, False, "
                             f"True or {SLABS!r}")

    @property
    def bf16(self) -> bool:
        """True where the single-device samplers round (``interp_bf16``
        True)."""
        return bool(self.interp_bf16) and self.interp_bf16 != SLABS

    @property
    def slab_bf16(self) -> bool:
        """True where the slab samplers and the sharded forward march
        round (``interp_bf16`` True or ``SLABS``)."""
        return bool(self.interp_bf16)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: it raises when no CUDA device exists and
    never falls back to the CPU. Pass ``"cpu"`` to run the plain versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type == "cuda" and dev.index is None:
        # 'cuda' is the current card, and compares equal to its 'cuda:i'
        return torch.device("cuda", torch.cuda.current_device())
    return dev
