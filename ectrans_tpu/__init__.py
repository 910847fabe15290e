"""ectrans_tpu: a JAX spherical-harmonic spectral transform engine.

Brand-new JAX/XLA implementation of the capabilities of ECMWF's
ecTrans (the IFS spectral transform library): direct/inverse spherical
harmonic transforms on full and reduced Gaussian grids, vorticity/divergence
to wind conversion, horizontal derivatives, adjoints, spectral/grid-point
norms, distributed (sharded) transforms over device meshes, and the
limited-area bi-Fourier (LAM) path.
"""

from .grids import GridSpec, full_gaussian_grid, make_grid, octahedral_grid
from .resolution import Resolution, setup
from .transform import InvFlags, dir_trans, inv_trans, num_inv_output_fields

__version__ = "0.1.0"

__all__ = [
    "GridSpec",
    "InvFlags",
    "Resolution",
    "SpectralTransform",
    "dir_trans",
    "full_gaussian_grid",
    "inv_trans",
    "make_grid",
    "num_inv_output_fields",
    "octahedral_grid",
    "setup",
]


def __getattr__(name):
    # lazy: avoid importing jax-heavy modules at package import
    if name == "SpectralTransform":
        from .api import SpectralTransform

        return SpectralTransform
    raise AttributeError(name)
