"""Field checksums for decomposition-invariance testing.

The reference asserts bit-identical CRC64 checksums of transform outputs
across every MPI x OpenMP decomposition (``tests/compare_checksums.py``,
``tests/CMakeLists.txt:232-241``).  The analogue here compares 1-device vs
N-virtual-device runs; this helper provides the stable digest.
"""

from __future__ import annotations

import hashlib

import numpy as np


def field_checksum(arr) -> str:
    """Deterministic digest of an array's exact bits (dtype + shape + data)."""
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(repr(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]
