/* C-caller smoke test for the dlaf_jax C API (dlaf_jax_c.h): builds an SPD
 * matrix in ScaLAPACK column-major layout, runs pdpotrf and pdsyevd through
 * the embedded-runtime shim, and checks residuals in plain C — the analog
 * of the reference's C API tests (test/unit/c_api). Compiled and executed
 * by tests/test_c_api.py. */
#include "dlaf_jax_c.h"

#include <math.h>
#include <stdio.h>
#include <stdlib.h>

#define N 64
#define NB 16
#define AT(a, i, j) (a)[(size_t)(j) * N + (i)] /* column-major, lld = N */

int main(void) {
  static double g[N * N], a[N * N], a0[N * N], l[N * N];
  static double w[N], z[N * N];
  int desca[9] = {1, 0, N, N, NB, NB, 0, 0, N};
  unsigned long long seed = 42ull;
  int i, j, k;

  for (j = 0; j < N; ++j)
    for (i = 0; i < N; ++i) {
      seed = seed * 6364136223846793005ull + 1442695040888963407ull;
      AT(g, i, j) = (double)((seed >> 33) & 0xffff) / 65536.0 - 0.5;
    }
  /* a = g g^T + N I (SPD), symmetric by construction */
  for (j = 0; j < N; ++j)
    for (i = 0; i < N; ++i) {
      double s = (i == j) ? (double)N : 0.0;
      for (k = 0; k < N; ++k) s += AT(g, i, k) * AT(g, j, k);
      AT(a, i, j) = s;
      AT(a0, i, j) = s;
    }

  if (dlaf_initialize() != 0) return 1;
  int ctx = dlaf_create_grid(2, 2);
  if (ctx < 0) return 2;

  if (dlaf_pdpotrf('L', N, a, 1, 1, desca, ctx) != 0) return 3;
  /* residual ||L L^T - A||_max */
  double res = 0.0;
  for (j = 0; j < N; ++j)
    for (i = 0; i < N; ++i) AT(l, i, j) = (i >= j) ? AT(a, i, j) : 0.0;
  for (j = 0; j < N; ++j)
    for (i = 0; i < N; ++i) {
      double s = 0.0;
      for (k = 0; k < N; ++k) s += AT(l, i, k) * AT(l, j, k);
      double d = fabs(s - AT(a0, i, j));
      if (d > res) res = d;
    }
  if (res > 1e-8 * N) {
    fprintf(stderr, "potrf residual %g\n", res);
    return 4;
  }

  if (dlaf_pdsyevd('L', N, a0, desca, w, z, ctx) != 0) return 5;
  /* residual ||A z_0 - w_0 z_0||_max on a few eigenpairs */
  double rese = 0.0;
  for (int c = 0; c < N; c += 17) {
    for (i = 0; i < N; ++i) {
      double s = 0.0;
      for (k = 0; k < N; ++k) s += AT(a0, i, k) * AT(z, k, c);
      double d = fabs(s - w[c] * AT(z, i, c));
      if (d > rese) rese = d;
    }
  }
  if (rese > 1e-8 * N * N) {
    fprintf(stderr, "syevd residual %g\n", rese);
    return 6;
  }
  for (i = 1; i < N; ++i)
    if (w[i] < w[i - 1]) return 7; /* ascending eigenvalues */

  /* lld > n (padded ScaLAPACK storage): same eigenvalues, and z must be
   * written COMPACT n x n per the header contract (no lld striding) */
  {
    enum { LLD = N + 8 };
    static double ap[(size_t)LLD * N], wp[N], zp[N * N];
    int descp[9] = {1, 0, N, N, NB, NB, 0, 0, LLD};
    for (j = 0; j < N; ++j)
      for (i = 0; i < N; ++i) ap[(size_t)j * LLD + i] = AT(a0, i, j);
    if (dlaf_pdsyevd('L', N, ap, descp, wp, zp, ctx) != 0) return 11;
    for (i = 0; i < N; ++i)
      if (fabs(wp[i] - w[i]) > 1e-9 * N) return 12;
    /* z written compact: column 1 starts at zp[N], residual on col 1 */
    double r1 = 0.0;
    for (i = 0; i < N; ++i) {
      double s = 0.0;
      for (k = 0; k < N; ++k) s += AT(a0, i, k) * zp[(size_t)N + k];
      double d = fabs(s - wp[1] * zp[(size_t)N + i]);
      if (d > r1) r1 = d;
    }
    if (r1 > 1e-8 * N * N) {
      fprintf(stderr, "lld>n syevd residual %g\n", r1);
      return 13;
    }
  }

  /* complex (z) hermitian eigensolver through the same shim: interleaved
   * (re, im) doubles, hermitian by construction */
  {
    static double h[2 * N * N], wz[N], zz[2 * N * N];
    for (j = 0; j < N; ++j)
      for (i = 0; i < N; ++i) {
        double re = AT(a0, i, j);
        double im = (i > j) ? 0.25 * AT(g, i, j)
                            : (i < j ? -0.25 * AT(g, j, i) : 0.0);
        h[2 * ((size_t)j * N + i)] = re;
        h[2 * ((size_t)j * N + i) + 1] = im;
      }
    if (dlaf_pzheevd('L', N, h, desca, wz, zz, ctx) != 0) return 8;
    for (i = 1; i < N; ++i)
      if (wz[i] < wz[i - 1]) return 9;
    /* probe: ||H z_0 - w_0 z_0|| on column 0 (complex arithmetic) */
    double rz = 0.0;
    for (i = 0; i < N; ++i) {
      double sre = 0.0, sim = 0.0;
      for (k = 0; k < N; ++k) {
        double hre = h[2 * ((size_t)k * N + i)];
        double him = h[2 * ((size_t)k * N + i) + 1];
        double zre = zz[2 * ((size_t)0 * N + k)];
        double zim = zz[2 * ((size_t)0 * N + k) + 1];
        sre += hre * zre - him * zim;
        sim += hre * zim + him * zre;
      }
      double dre = sre - wz[0] * zz[2 * (size_t)i];
      double dim = sim - wz[0] * zz[2 * (size_t)i + 1];
      double d = sqrt(dre * dre + dim * dim);
      if (d > rz) rz = d;
    }
    if (rz > 1e-8 * N * N) {
      fprintf(stderr, "zheevd residual %g\n", rz);
      return 10;
    }
    printf("c_api: zheevd res %.2e\n", rz);
  }

  /* descriptor-based entries (reference non-ScaLAPACK typed surface):
   * dlaf_cholesky_factorization_d must reproduce dlaf_pdpotrf, and
   * dlaf_symmetric_eigensolver_d must reproduce dlaf_pdsyevd */
  {
    static double ad[N * N], wd[N], zd[N * N];
    struct DLAF_descriptor da = make_dlaf_descriptor(N, N, 0, 0, desca);
    for (j = 0; j < N; ++j)
      for (i = 0; i < N; ++i) AT(ad, i, j) = AT(a0, i, j);
    if (dlaf_cholesky_factorization_d(ctx, 'L', ad, da) != 0) return 14;
    for (j = 0; j < N; ++j)
      for (i = j; i < N; ++i) /* lower triangle must match pdpotrf's */
        if (fabs(AT(ad, i, j) - AT(a, i, j)) > 1e-10 * N) return 15;
    for (j = 0; j < N; ++j)
      for (i = 0; i < N; ++i) AT(ad, i, j) = AT(a0, i, j);
    if (dlaf_symmetric_eigensolver_d(ctx, 'L', ad, da, wd, zd, da) != 0)
      return 16;
    for (i = 0; i < N; ++i)
      if (fabs(wd[i] - w[i]) > 1e-9 * N) return 17;
  }

  /* generalized eigensolver with B = 2 I: eigenvalues must be w / 2
   * (A z = lambda B z), both through the ScaLAPACK-style entry and the
   * factorized path (chol(2I) = sqrt(2) I) */
  {
    static double ag[N * N], bg[N * N], wg[N], zg[N * N];
    for (j = 0; j < N; ++j)
      for (i = 0; i < N; ++i) {
        AT(ag, i, j) = AT(a0, i, j);
        AT(bg, i, j) = (i == j) ? 2.0 : 0.0;
      }
    if (dlaf_pdsygvd('L', N, ag, 1, 1, desca, bg, 1, 1, desca, wg, zg,
                     ctx) != 0)
      return 18;
    for (i = 0; i < N; ++i)
      if (fabs(wg[i] - 0.5 * w[i]) > 1e-8 * N) {
        fprintf(stderr, "sygvd w[%d]=%g vs %g\n", i, wg[i], 0.5 * w[i]);
        return 19;
      }
    /* residual ||A z_0 - w_0 B z_0||_max on column 0 (B = 2I) */
    double rg = 0.0;
    for (i = 0; i < N; ++i) {
      double s = 0.0;
      for (k = 0; k < N; ++k) s += AT(a0, i, k) * AT(zg, k, 0);
      double d = fabs(s - wg[0] * 2.0 * AT(zg, i, 0));
      if (d > rg) rg = d;
    }
    if (rg > 1e-8 * N * N) {
      fprintf(stderr, "sygvd residual %g\n", rg);
      return 20;
    }
    for (j = 0; j < N; ++j)
      for (i = 0; i < N; ++i) {
        AT(ag, i, j) = AT(a0, i, j);
        AT(bg, i, j) = (i == j) ? sqrt(2.0) : 0.0; /* chol(2I) */
      }
    if (dlaf_pdsygvd_factorized('L', N, ag, 1, 1, desca, bg, 1, 1, desca,
                                wg, zg, ctx) != 0)
      return 21;
    for (i = 0; i < N; ++i)
      if (fabs(wg[i] - 0.5 * w[i]) > 1e-8 * N) return 22;
    /* descriptor-based generalized entry agrees */
    {
      struct DLAF_descriptor da = make_dlaf_descriptor(N, N, 0, 0, desca);
      static double wg2[N], zg2[N * N];
      for (j = 0; j < N; ++j)
        for (i = 0; i < N; ++i) {
          AT(ag, i, j) = AT(a0, i, j);
          AT(bg, i, j) = (i == j) ? 2.0 : 0.0;
        }
      if (dlaf_symmetric_generalized_eigensolver_d(ctx, 'L', ag, da, bg, da,
                                                   wg2, zg2, da) != 0)
        return 23;
      for (i = 0; i < N; ++i)
        if (fabs(wg2[i] - wg[i]) > 1e-9 * N) return 24;
    }
    printf("c_api: sygvd OK\n");
  }

  dlaf_free_grid(ctx);
  printf("c_api: potrf res %.2e, syevd res %.2e OK\n", res, rese);
  return 0;
}
