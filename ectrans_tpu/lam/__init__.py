"""Limited-area model (LAM) bi-Fourier transforms — the etrans variant.

A JAX re-design of the reference's ``src/etrans`` layer (SURVEY.md
§2.8): on a biperiodic plane both transform directions are Fourier
transforms, so the spherical-harmonic Legendre stage is replaced by a
meridional DFT (reference ELEINV/ELEDIR, ``eledir_mod.F90:72-101``) and the
elliptic-truncation spectral space of ELLIPS (``ellips.F90``).
"""

from .api import LamTransform
from .sharded import ShardedLamTransform
from .geometry import LamGrid, ellips, make_lam_grid
from .resolution import LamResolution, setup_lam
from .transform import LamInvFlags, dir_trans_lam, inv_trans_lam
from .biper import biperiodicize
from .norms import especnorm, egpnorm
from .adjoint import dir_trans_lam_adj, inv_trans_lam_adj

__all__ = [
    "LamGrid",
    "LamInvFlags",
    "LamTransform",
    "ShardedLamTransform",
    "LamResolution",
    "biperiodicize",
    "dir_trans_lam",
    "dir_trans_lam_adj",
    "egpnorm",
    "ellips",
    "especnorm",
    "inv_trans_lam",
    "inv_trans_lam_adj",
    "make_lam_grid",
    "setup_lam",
]
