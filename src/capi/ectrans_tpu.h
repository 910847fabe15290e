/*
 * ectrans_tpu C API — the transi-equivalent surface (reference
 * src/transi/transi.h) for C/C++/Fortran callers of the JAX
 * spectral transform framework.
 *
 * The library embeds a Python interpreter and drives the JAX/XLA engine
 * through ectrans_tpu.capi_bridge; all arrays are double precision,
 * spectral coefficients in the ecTrans packed (NASM0) layout and
 * grid-point values flat over the reduced grid, latitude-major (the
 * trans_invtrans/trans_dirtrans conventions of transi.h:293-491).
 *
 * All functions return 0 on success, negative on error
 * (ECTRANS_TPU_ERR_*).  Not thread-safe (one embedded interpreter).
 */

#ifndef ECTRANS_TPU_H
#define ECTRANS_TPU_H

#ifdef __cplusplus
extern "C" {
#endif

#define ECTRANS_TPU_SUCCESS 0
#define ECTRANS_TPU_ERR_INIT -1
#define ECTRANS_TPU_ERR_SETUP -2
#define ECTRANS_TPU_ERR_TRANS -3
#define ECTRANS_TPU_ERR_HANDLE -4

/* Start the embedded interpreter and import the framework.
 * (trans_init, transi.h:190) */
int ectrans_tpu_init(void);

/* Set up one resolution: grid spec string ("O48", "F24", "TCO159", ...)
 * and triangular truncation (-1 = grid default).  Returns a non-negative
 * resolution handle, or a negative error.  (trans_setup, transi.h:221) */
int ectrans_tpu_setup(const char *grid, int nsmax);

/* Global planet-radius override for subsequent setups; call before
 * ectrans_tpu_setup.  (trans_set_radius, transi.h:131) */
int ectrans_tpu_set_radius(double radius);

/* Setup with explicit per-resolution options: radius (<=0 = default /
 * set_radius value) and Schmidt stretching factor (<=0 or 1 = unstretched;
 * reference SETUP_TRANS PSTRET). */
int ectrans_tpu_setup_ex(const char *grid, int nsmax, double radius,
                         double stretch);

/* Inquiry (TRANS_INQ / trans_inquire): fills any non-NULL pointer. */
int ectrans_tpu_inquire(int handle, int *nspec2, int *ngptot, int *ndgl,
                        int *ndlon, int *nsmax);

/* Per-latitude longitude counts (ndgl entries). */
int ectrans_tpu_nloen(int handle, int *nloen);

/* Inverse transform, scalar fields: spec (nfld, nspec2) row-major ->
 * gp (nfld, ngptot) reduced-grid lat-major.  (trans_invtrans) */
int ectrans_tpu_invtrans(int handle, int nfld, const double *spec,
                         double *gp);

/* Direct transform, scalar fields: gp (nfld, ngptot) -> spec (nfld, nspec2).
 * (trans_dirtrans) */
int ectrans_tpu_dirtrans(int handle, int nfld, const double *gp,
                         double *spec);

/* Inverse transform of vorticity/divergence to winds:
 * spvor/spdiv (nfld, nspec2) -> u, v (nfld, ngptot) each. */
int ectrans_tpu_invtrans_vordiv(int handle, int nfld, const double *spvor,
                                const double *spdiv, double *u, double *v);

/* Direct transform of winds to vorticity/divergence. */
int ectrans_tpu_dirtrans_vordiv(int handle, int nfld, const double *u,
                                const double *v, double *spvor,
                                double *spdiv);

/* Full-option inverse transform with the reference InvTrans_t derivative
 * flags (transi.h:1014-1016).  Inputs: spvor/spdiv (nvordiv, nspec2) and/or
 * spscalar (nscalar, nspec2); NULL with the matching count 0 to omit.
 * Output gp rows follow the reference PGP ordering (inv_trans.F90:58-106):
 *   [vor, div (if lvordivgp)] u, v, scalars,
 *   [N-S scalar derivs (lscalarders)],
 *   [E-W u, v derivs (luvder_ew)], [E-W scalar derivs (lscalarders)].
 * Returns nfld_out (>= 0) or a negative error code. */
int ectrans_tpu_invtrans_full(int handle, int nvordiv, int nscalar,
                              const double *spvor, const double *spdiv,
                              const double *spscalar, int lscalarders,
                              int luvder_ew, int lvordivgp, double *gp);

/* Combined direct transform: gp rows ordered U, V, scalars (the reference
 * DirTrans_t contract) -> spectral vor/div + scalars. */
int ectrans_tpu_dirtrans_full(int handle, int nvordiv, int nscalar,
                              const double *gp, double *spvor, double *spdiv,
                              double *spscalar);

/* Adjoint of the inverse transform (trans_invtrans_adj): grid cotangent
 * (nfld, ngptot) -> spectral cotangent (nfld, nspec2), scalar fields. */
int ectrans_tpu_invtrans_adj(int handle, int nfld, const double *gp_ad,
                             double *spec_ad);

/* Adjoint of the direct transform (trans_dirtrans_adj): spectral cotangent
 * -> grid cotangent, scalar fields. */
int ectrans_tpu_dirtrans_adj(int handle, int nfld, const double *spec_ad,
                             double *gp_ad);

/* Spectral norms: spec (nfld, nspec2) -> norms (nfld).  (trans_specnorm) */
int ectrans_tpu_specnorm(int handle, int nfld, const double *spec,
                         double *norms);

/* Spectral vor/div -> spectral U,V winds, no grid transform
 * (trans_vordiv_to_UV, transi.h:648). */
int ectrans_tpu_vordiv_to_uv(int handle, int nfld, const double *spvor,
                             const double *spdiv, double *u, double *v);

/* Grid-point norms: gp (nfld, ngptot) -> out (nfld, 3) = [ave, min, max]
 * with the reference's area weights (GPNORM_TRANS). */
int ectrans_tpu_gpnorm(int handle, int nfld, const double *gp, double *out);

/* Inverse transform onto a regular lat-lon grid (the LDLL /
 * trans_set_resol_lonlat mode, transi.h:869): gp (nfld, nlat, nlon). */
int ectrans_tpu_invtrans_lonlat(int handle, int nlat, int nlon, int nfld,
                                const double *spec, double *gp);

/* Distribution (trans_distgrid/gathgrid/distspec/gathspec,
 * transi.h:520-616).  Single-controller semantics: the owner view is the
 * global array (transi with TRANS_USE_MPI=0 behaves the same way). */
int ectrans_tpu_distgrid(int handle, int nfld, const double *global_gp,
                         double *local_gp);
int ectrans_tpu_gathgrid(int handle, int nfld, const double *local_gp,
                         double *global_gp);
int ectrans_tpu_distspec(int handle, int nfld, const double *global_sp,
                         double *local_sp);
int ectrans_tpu_gathspec(int handle, int nfld, const double *local_sp,
                         double *global_sp);

/* Single-precision scalar transforms (the reference trans_sp build /
 * the _32 API family). */
int ectrans_tpu_invtrans_f(int handle, int nfld, const float *spec,
                           float *gp);
int ectrans_tpu_dirtrans_f(int handle, int nfld, const float *gp,
                           float *spec);

/* Legendre-table disk cache directory (trans_set_cache/read/write,
 * transi.h:192-194); "" disables caching. */
int ectrans_tpu_set_legpol_dir(const char *path);

/* --- LAM (etrans) surface: bi-Fourier limited-area transforms --- */

/* Set up a LAM resolution: nx x ny extended domain, nxux x nyux C+I zone,
 * elliptic truncation msmax/nsmax (-1 = linear default), grid spacings.
 * Returns a LAM handle.  (the ESETUP_TRANS / trans_set_resol_lam role) */
int ectrans_tpu_setup_lam(int nx, int ny, int nxux, int nyux, int msmax,
                          int nsmax, double dx, double dy);

/* LAM inquiry: spectral size, gridpoint count, nx, ny. */
int ectrans_tpu_inquire_lam(int handle, int *nspec2, int *ngptot, int *nx,
                            int *ny);

/* LAM scalar transforms: spec (nfld, nspec2) <-> gp (nfld, ny, nx). */
int ectrans_tpu_invtrans_lam(int handle, int nfld, const double *spec,
                             double *gp);
int ectrans_tpu_dirtrans_lam(int handle, int nfld, const double *gp,
                             double *spec);

int ectrans_tpu_release_lam(int handle);

/* Release one resolution (trans_delete) / shut the interpreter down
 * (trans_finalize). */
int ectrans_tpu_release(int handle);
int ectrans_tpu_finalize(void);

#ifdef __cplusplus
}
#endif

#endif /* ECTRANS_TPU_H */
