"""Advection scheme enum (same values as ``gpufluidsimulation_tpu``)."""

import enum


class Scheme(enum.IntEnum):
    SEMILAG = 0
    MACCORMACK = 1
    BFECC = 2
    MAC_REFLECTION = 3
    FLIP = 4
    APIC = 5
    POLYPIC = 6
    BIMOCQ = 7

    def display_name(self) -> str:
        return {
            Scheme.SEMILAG: "Semilag",
            Scheme.MACCORMACK: "MacCormack",
            Scheme.BFECC: "BFECC",
            Scheme.MAC_REFLECTION: "Reflection",
            Scheme.FLIP: "FLIP",
            Scheme.APIC: "APIC",
            Scheme.POLYPIC: "PolyPIC",
            Scheme.BIMOCQ: "BiMocq",
        }[self]


# argv[1] of the 3D executable (bimocq3D/BimocqSolver.h:29)
SCHEME_3D_ARGV = {
    0: Scheme.BIMOCQ,
    1: Scheme.SEMILAG,
    2: Scheme.MACCORMACK,
    3: Scheme.MAC_REFLECTION,
}
