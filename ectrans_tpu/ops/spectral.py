"""Spectral-space operators on the dense (nfld, 2, M, NP) layout.

Batched, all-m-at-once re-implementations of the reference's per-m loops:

* ``vordiv_to_uv``  — VDTUV (``vdtuv_mod.F90:110-145``): winds from
  vorticity/divergence via the eps recurrence + inverse Laplacian.
* ``uv_to_vordiv``  — UVTVD (``uvtvd_mod.F90:103-139``): the mirror map used
  by the direct transform.
* ``ns_derivative`` — SPNSDE (``spnsde_mod.F90``): spectral coefficients of
  cos^2(theta) d/dmu.

The dense absolute-n layout makes the n±1 couplings plain shifts along the
last axis, identical for every m — ideal for the VPU.  Coefficient tables
(functions of (m, n) only) are precomputed once per resolution, in float64
on host, then cast; they are returned as *numpy* arrays so callers decide
device placement (the sharded path shards them over the mesh, the
single-device path device_puts them once).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _shift_down(x):
    """y[..., n] = x[..., n-1] (zero at n=0): shift toward higher n index."""
    return jnp.pad(x[..., :-1], [(0, 0)] * (x.ndim - 1) + [(1, 0)])


def _shift_up(x):
    """y[..., n] = x[..., n+1] (zero at last)."""
    return jnp.pad(x[..., 1:], [(0, 0)] * (x.ndim - 1) + [(0, 1)])


def vordiv_coeff_tables(res, dtype=np.float32):
    """Host-precomputed (M, NP) tables for vordiv_to_uv.

    Returns dict of jnp arrays:
      a[m,n] = (n-1) * eps(n,m) * rlapin(n-1)    (coupling to n-1)
      b[m,n] = (n+2) * eps(n+1,m) * rlapin(n+1)  (coupling to n+1)
      c[m,n] = m * rlapin(n)                     (i*m inverse-Laplacian term)
      valid[m,n] = 1 where m <= n <= nsmax+1
    """
    M, NP = res.M, res.NP
    n = np.arange(NP, dtype=np.float64)[None, :]
    m = np.arange(M, dtype=np.float64)[:, None]
    eps = res.eps  # (M, NP+2)
    rl = res.rlapin  # (NP+1,)
    rl_m1 = np.concatenate([[0.0], rl[:-1]])  # rlapin(n-1)
    a = (n - 1.0) * eps[:, :NP] * rl_m1[None, :NP]
    b = (n + 2.0) * eps[:, 1 : NP + 1] * rl[None, 1 : NP + 1]
    c = m * rl[None, :NP]
    valid = (n >= m) & (n <= res.nsmax + 1)
    z = lambda x: np.asarray(x, dtype=dtype)
    return dict(a=z(a), b=z(b), c=z(c), valid=z(valid.astype(np.float64)))


def vordiv_to_uv(vor, div, t):
    """U, V spectra (of a*u*cos(theta)-type quantities) from vor/div.

    vor/div: (nfld, 2, M, NP) dense; returns (u, v) same shape with
    coefficients at n = m..nsmax+1.  Mirrors VDTUV exactly:
      U(n) = i m lapin(n) D(n) + (n-1) eps(n) lapin(n-1) Z(n-1)
                                 - (n+2) eps(n+1) lapin(n+1) Z(n+1)
      V(n) = i m lapin(n) Z(n) - (n-1) eps(n) lapin(n-1) D(n-1)
                                 + (n+2) eps(n+1) lapin(n+1) D(n+1)
    """
    a, b, c, valid = t["a"], t["b"], t["c"], t["valid"]
    # i * X: (re, im) -> (-im, re)
    idiv = jnp.stack([-div[:, 1], div[:, 0]], axis=1)
    ivor = jnp.stack([-vor[:, 1], vor[:, 0]], axis=1)
    u = c * idiv + a * _shift_down(vor) - b * _shift_up(vor)
    v = c * ivor - a * _shift_down(div) + b * _shift_up(div)
    return u * valid, v * valid


def uvtvd_coeff_tables(res, dtype=np.float32):
    """Tables for uv_to_vordiv (UVTVD):
      p[m,n] = n * eps(n+1,m)        (coupling to n+1)
      q[m,n] = (n+1) * eps(n,m)      (coupling to n-1)
      r[m,n] = m
      valid[m,n] = 1 where m <= n <= nsmax   (vor/div truncated at nsmax)
    """
    M, NP = res.M, res.NP
    n = np.arange(NP, dtype=np.float64)[None, :]
    m = np.arange(M, dtype=np.float64)[:, None]
    eps = res.eps
    p = n * eps[:, 1 : NP + 1]
    q = (n + 1.0) * eps[:, :NP]
    r = m * np.ones((1, NP))
    valid = (n >= m) & (n <= res.nsmax)
    z = lambda x: np.asarray(x, dtype=dtype)
    return dict(p=z(p), q=z(q), r=z(r), valid=z(valid.astype(np.float64)))


def uv_to_vordiv(u, v, t):
    """Vor/div spectra from U, V spectra (direct-transform path, UVTVD):
      Z(n) = i m V(n) - n eps(n+1) U(n+1) + (n+1) eps(n) U(n-1)
      D(n) = i m U(n) + n eps(n+1) V(n+1) - (n+1) eps(n) V(n-1)
    """
    p, q, r, valid = t["p"], t["q"], t["r"], t["valid"]
    iu = jnp.stack([-u[:, 1], u[:, 0]], axis=1)
    iv = jnp.stack([-v[:, 1], v[:, 0]], axis=1)
    vor = r * iv - p * _shift_up(u) + q * _shift_down(u)
    div = r * iu + p * _shift_up(v) - q * _shift_down(v)
    return vor * valid, div * valid


def nsder_coeff_tables(res, dtype=np.float32):
    """Tables for ns_derivative (SPNSDE):
      a[m,n] = (n-1) eps(n,m)      (coupling to n-1)
      b[m,n] = (n+2) eps(n+1,m)    (coupling to n+1)
      valid as in vordiv (extends to nsmax+1)
    """
    M, NP = res.M, res.NP
    n = np.arange(NP, dtype=np.float64)[None, :]
    m = np.arange(M, dtype=np.float64)[:, None]
    eps = res.eps
    a = (n - 1.0) * eps[:, :NP]
    b = (n + 2.0) * eps[:, 1 : NP + 1]
    valid = (n >= m) & (n <= res.nsmax + 1)
    z = lambda x: np.asarray(x, dtype=dtype)
    return dict(a=z(a), b=z(b), valid=z(valid.astype(np.float64)))


def ns_derivative(f, t):
    """Spectral coefficients of cos^2(theta) * df/dmu (SPNSDE):
      NSD(n) = -(n-1) eps(n) F(n-1) + (n+2) eps(n+1) F(n+1)
    """
    a, b, valid = t["a"], t["b"], t["valid"]
    return (-a * _shift_down(f) + b * _shift_up(f)) * valid
