// McMurchie-Davidson Gaussian integrals (C++ host engine).
//
// Native analogue of the libcint layer the reference delegates to via PySCF
// (SURVEY.md §2.3 rows 2-3). Computes contracted spherical AO integrals
// (overlap, kinetic, nuclear/point-charge attraction, dipole, full ERI with
// 8-fold symmetry) from shell tables prepared by the Python layer (which
// owns normalisation and cart->sph coefficients). Used as the fast host
// backend: it avoids per-molecule XLA tracing and feeds device arrays.
//
// Build: g++ -O3 -shared -fPIC md_integrals.cpp -o libnbed_md.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int LMAX = 4;           // max angular momentum per shell
constexpr int EMAX = 2 * LMAX + 3;

inline int ncart(int l) { return (l + 1) * (l + 2) / 2; }

// cartesian component powers, matching chem.molecule.cartesian_components
inline void cart_powers(int l, int comp, int* p) {
  int idx = 0;
  for (int i = 0; i <= l; ++i) {
    for (int j = 0; j <= i; ++j) {
      if (idx == comp) { p[0] = l - i; p[1] = i - j; p[2] = j; return; }
      ++idx;
    }
  }
}

// Boys functions F_0..F_m at t.
void boys(int mmax, double t, double* f) {
  if (t < 1e-13) {
    for (int m = 0; m <= mmax; ++m) f[m] = 1.0 / (2 * m + 1);
    return;
  }
  if (t < 40.0) {
    // series F_m(t) = e^-t * sum_k (2t)^k / ((2m+1)(2m+3)...(2m+2k+1)),
    // then exact downward recursion
    double term = 1.0 / (2.0 * mmax + 1.0);
    double sum = term;
    for (int k = 1; k < 500; ++k) {
      term *= 2.0 * t / (2.0 * mmax + 2.0 * k + 1.0);
      sum += term;
      if (term < 1e-17 * sum) break;
    }
    double expt = std::exp(-t);
    f[mmax] = expt * sum;
    for (int m = mmax; m > 0; --m)
      f[m - 1] = (2.0 * t * f[m] + expt) / (2.0 * m - 1.0);
  } else {
    // asymptotic F_0 + stable upward recursion
    double expt = std::exp(-t);
    f[0] = 0.5 * std::sqrt(M_PI / t) * std::erf(std::sqrt(t));
    for (int m = 0; m < mmax; ++m)
      f[m + 1] = ((2.0 * m + 1.0) * f[m] - expt) / (2.0 * t);
  }
}

// Hermite expansion coefficients E_t^{ij} for one dimension.
// No memset: every read below stays within the entries the recursion has
// already written (reads of E_t with t outside [0, i+j] are guarded).
struct ETable {
  double e[EMAX][EMAX][2 * EMAX];  // [i][j][t]
  void build(int la, int lb, double a, double b, double ab) {
    double p = a + b;
    double mu = a * b / p;
    double inv2p = 0.5 / p;
    double pa = -b / p * ab;
    double pb = a / p * ab;
    e[0][0][0] = std::exp(-mu * ab * ab);
    for (int i = 0; i <= la; ++i) {
      for (int j = 0; j <= lb; ++j) {
        if (i == 0 && j == 0) continue;
        for (int t = 0; t <= i + j; ++t) {
          double val = 0.0;
          if (j == 0) {
            if (t >= 1) val += inv2p * e[i - 1][j][t - 1];
            if (t <= i - 1 + j) val += pa * e[i - 1][j][t];
            if (t + 1 <= i - 1 + j) val += (t + 1) * e[i - 1][j][t + 1];
          } else {
            if (t >= 1) val += inv2p * e[i][j - 1][t - 1];
            if (t <= i + j - 1) val += pb * e[i][j - 1][t];
            if (t + 1 <= i + j - 1) val += (t + 1) * e[i][j - 1][t + 1];
          }
          e[i][j][t] = val;
        }
      }
    }
  }
  // value with out-of-range t treated as zero (for generic consumers)
  inline double at(int i, int j, int t) const {
    return (t < 0 || t > i + j) ? 0.0 : e[i][j][t];
  }
};

// Hermite Coulomb integrals R_{tuv} for t+u+v <= lmax.
// omega > 0 selects the long-range erf(omega*r)/r kernel: every Boys order
// is attenuated, F_n(T) -> kappa^(2n+1) F_n(kappa^2 T) with
// kappa^2 = omega^2 / (p + omega^2) (range-separated hybrids).
struct RTable {
  double r[2 * EMAX][2 * EMAX][2 * EMAX];
  void build(int lmax, double p, const double* pq, double omega = 0.0) {
    double t_arg = p * (pq[0] * pq[0] + pq[1] * pq[1] + pq[2] * pq[2]);
    double f[4 * LMAX + 4];
    if (omega > 0.0) {
      double kappa2 = omega * omega / (p + omega * omega);
      boys(lmax, kappa2 * t_arg, f);
      double fac = std::sqrt(kappa2);
      for (int n = 0; n <= lmax; ++n) { f[n] *= fac; fac *= kappa2; }
    } else {
      boys(lmax, t_arg, f);
    }
    double powm2p[4 * LMAX + 4];
    powm2p[0] = 1.0;
    for (int n = 1; n <= lmax; ++n) powm2p[n] = powm2p[n - 1] * (-2.0 * p);
    // r_n[t][u][v] built by downward recursion in n
    static thread_local double rn[4 * LMAX + 4][2 * EMAX][2 * EMAX][2 * EMAX];
    for (int n = lmax; n >= 0; --n) {
      rn[n][0][0][0] = powm2p[n] * f[n];
      int rem = lmax - n;
      for (int tot = 1; tot <= rem; ++tot) {
        for (int t = 0; t <= tot; ++t) {
          for (int u = 0; u <= tot - t; ++u) {
            int v = tot - t - u;
            double val;
            if (t >= 1) {
              val = pq[0] * rn[n + 1][t - 1][u][v];
              if (t >= 2) val += (t - 1) * rn[n + 1][t - 2][u][v];
            } else if (u >= 1) {
              val = pq[1] * rn[n + 1][t][u - 1][v];
              if (u >= 2) val += (u - 1) * rn[n + 1][t][u - 2][v];
            } else {
              val = pq[2] * rn[n + 1][t][u][v - 1];
              if (v >= 2) val += (v - 1) * rn[n + 1][t][u][v - 2];
            }
            rn[n][t][u][v] = val;
          }
        }
      }
    }
    for (int t = 0; t <= lmax; ++t)
      for (int u = 0; u <= lmax - t; ++u)
        for (int v = 0; v <= lmax - t - u; ++v) r[t][u][v] = rn[0][t][u][v];
  }
};

struct Shell {
  int l, nprim, atom, ao_offset;
  const double* exps;
  const double* coefs;
  const double* c2s;  // (ncart, nsph) row-major
};

struct Mol {
  std::vector<Shell> shells;
  const double* coords;  // (natm, 3)
  int nao;
};

Mol unpack(int n_shells, const int32_t* meta, const double* exps,
           const double* coefs, const double* c2s, const double* coords) {
  // meta per shell: l, nprim, atom, ao_offset, exp_offset, c2s_offset
  Mol mol;
  mol.coords = coords;
  mol.nao = 0;
  for (int s = 0; s < n_shells; ++s) {
    const int32_t* m = meta + 6 * s;
    Shell sh;
    sh.l = m[0]; sh.nprim = m[1]; sh.atom = m[2]; sh.ao_offset = m[3];
    sh.exps = exps + m[4];
    sh.coefs = coefs + m[4];
    sh.c2s = c2s + m[5];
    mol.shells.push_back(sh);
    int top = sh.ao_offset + 2 * sh.l + 1;
    if (top > mol.nao) mol.nao = top;
  }
  return mol;
}

// contracted cartesian blocks -> spherical, scattered into the AO matrix
void scatter_block(const Mol& mol, const Shell& sa, const Shell& sb,
                   const double* cart, double* out, bool symmetrize) {
  int nca = ncart(sa.l), ncb = ncart(sb.l);
  int nsa = 2 * sa.l + 1, nsb = 2 * sb.l + 1;
  for (int p = 0; p < nsa; ++p) {
    for (int q = 0; q < nsb; ++q) {
      double val = 0.0;
      for (int ca = 0; ca < nca; ++ca)
        for (int cb = 0; cb < ncb; ++cb)
          val += sa.c2s[ca * nsa + p] * sb.c2s[cb * nsb + q] *
                 cart[ca * ncb + cb];
      int row = sa.ao_offset + p, col = sb.ao_offset + q;
      out[row * mol.nao + col] = val;
      if (symmetrize) out[col * mol.nao + row] = val;
    }
  }
}

}  // namespace

extern "C" {

// One-electron integrals: S, T, V (over nuclei+optional extra charges).
void nbed_one_electron(int n_shells, const int32_t* meta, const double* exps,
                       const double* coefs, const double* c2s,
                       const double* coords, int natm, const double* charges,
                       int n_extra, const double* extra_centers,
                       const double* extra_charges, const double* extra_etas,
                       double* s_out, double* t_out, double* v_out) {
  Mol mol = unpack(n_shells, meta, exps, coefs, c2s, coords);
  int nao = mol.nao;
  std::memset(s_out, 0, sizeof(double) * nao * nao);
  std::memset(t_out, 0, sizeof(double) * nao * nao);
  std::memset(v_out, 0, sizeof(double) * nao * nao);

  double cart_s[256], cart_t[256], cart_v[256];
  int pa[3], pb[3];

  for (size_t ia = 0; ia < mol.shells.size(); ++ia) {
    for (size_t ib = ia; ib < mol.shells.size(); ++ib) {
      const Shell& sa = mol.shells[ia];
      const Shell& sb = mol.shells[ib];
      const double* ra = mol.coords + 3 * sa.atom;
      const double* rb = mol.coords + 3 * sb.atom;
      double ab[3] = {ra[0] - rb[0], ra[1] - rb[1], ra[2] - rb[2]};
      int nca = ncart(sa.l), ncb = ncart(sb.l);
      std::memset(cart_s, 0, sizeof(cart_s));
      std::memset(cart_t, 0, sizeof(cart_t));
      std::memset(cart_v, 0, sizeof(cart_v));

      for (int i = 0; i < sa.nprim; ++i) {
        for (int j = 0; j < sb.nprim; ++j) {
          double a = sa.exps[i], b = sb.exps[j];
          double cc = sa.coefs[i] * sb.coefs[j];
          double p = a + b;
          ETable ex, ey, ez;
          // extended j for kinetic (j+2)
          ex.build(sa.l, sb.l + 2, a, b, ab[0]);
          ey.build(sa.l, sb.l + 2, a, b, ab[1]);
          ez.build(sa.l, sb.l + 2, a, b, ab[2]);
          double sq = std::sqrt(M_PI / p);
          double bp[3] = {(a * ra[0] + b * rb[0]) / p,
                          (a * ra[1] + b * rb[1]) / p,
                          (a * ra[2] + b * rb[2]) / p};
          int lmax = sa.l + sb.l;

          for (int ca = 0; ca < nca; ++ca) {
            cart_powers(sa.l, ca, pa);
            for (int cb = 0; cb < ncb; ++cb) {
              cart_powers(sb.l, cb, pb);
              const ETable* es[3] = {&ex, &ey, &ez};
              double s1[3], t1[3];
              for (int d = 0; d < 3; ++d) {
                int i_p = pa[d], j_p = pb[d];
                double sij = es[d]->e[i_p][j_p][0] * sq;
                double sijp2 = es[d]->e[i_p][j_p + 2][0] * sq;
                double sijm2 =
                    (j_p >= 2) ? es[d]->e[i_p][j_p - 2][0] * sq : 0.0;
                s1[d] = sij;
                t1[d] = b * (2 * j_p + 1) * sij - 2.0 * b * b * sijp2 -
                        0.5 * j_p * (j_p - 1) * sijm2;
              }
              cart_s[ca * ncb + cb] += cc * s1[0] * s1[1] * s1[2];
              cart_t[ca * ncb + cb] +=
                  cc * (t1[0] * s1[1] * s1[2] + s1[0] * t1[1] * s1[2] +
                        s1[0] * s1[1] * t1[2]);
            }
          }

          // nuclear attraction: one Hermite-R build per charge center
          RTable rt;
          for (int c = 0; c < natm + n_extra; ++c) {
            const double* rc;
            double z, eta = -1.0;
            if (c < natm) {
              rc = mol.coords + 3 * c;
              z = charges[c];
            } else {
              rc = extra_centers + 3 * (c - natm);
              z = extra_charges[c - natm];
              if (extra_etas) eta = extra_etas[c - natm];
            }
            double pc[3] = {bp[0] - rc[0], bp[1] - rc[1], bp[2] - rc[2]};
            double alpha = p, pref = 2.0 * M_PI / p;
            if (eta > 0.0) {  // gaussian-smeared charge
              alpha = p * eta / (p + eta);
              pref *= std::sqrt(eta / (p + eta));
            }
            rt.build(lmax, alpha, pc);
            for (int ca = 0; ca < nca; ++ca) {
              cart_powers(sa.l, ca, pa);
              for (int cb = 0; cb < ncb; ++cb) {
                cart_powers(sb.l, cb, pb);
                double acc = 0.0;
                for (int t = 0; t <= pa[0] + pb[0]; ++t)
                  for (int u = 0; u <= pa[1] + pb[1]; ++u)
                    for (int v = 0; v <= pa[2] + pb[2]; ++v)
                      acc += ex.e[pa[0]][pb[0]][t] * ey.e[pa[1]][pb[1]][u] *
                             ez.e[pa[2]][pb[2]][v] * rt.r[t][u][v];
                cart_v[ca * ncb + cb] += -z * pref * cc * acc;
              }
            }
          }
        }
      }
      scatter_block(mol, sa, sb, cart_s, s_out, true);
      scatter_block(mol, sa, sb, cart_t, t_out, true);
      scatter_block(mol, sa, sb, cart_v, v_out, true);
    }
  }
}

namespace {

// Contracted cartesian ERI block (na*nb*nc*nd) for one shell quartet.
void eri_quartet_cart(const Mol& mol, const Shell& A, const Shell& B,
                      const Shell& C, const Shell& D,
                      std::vector<double>& cart, double omega = 0.0) {
  int pa[3], pb[3], pc[3], pd[3];
  const double* ra = mol.coords + 3 * A.atom;
  const double* rb = mol.coords + 3 * B.atom;
  const double* rc = mol.coords + 3 * C.atom;
  const double* rd = mol.coords + 3 * D.atom;
  int na = ncart(A.l), nb = ncart(B.l), nc = ncart(C.l), nd = ncart(D.l);
  int lmax = A.l + B.l + C.l + D.l;
  cart.assign((size_t)na * nb * nc * nd, 0.0);

  double abv[3] = {ra[0] - rb[0], ra[1] - rb[1], ra[2] - rb[2]};
  double cdv[3] = {rc[0] - rd[0], rc[1] - rd[1], rc[2] - rd[2]};
  static const double two_pi_25 = 2.0 * std::pow(M_PI, 2.5);

  // hoist the ket-pair Hermite tables out of the bra-primitive loops
  struct KetPrim {
    double q, ccd, bq[3];
    ETable ex, ey, ez;
  };
  static thread_local std::vector<KetPrim> kets;
  kets.resize((size_t)C.nprim * D.nprim);
  {
    size_t ki = 0;
    for (int k = 0; k < C.nprim; ++k)
      for (int m = 0; m < D.nprim; ++m, ++ki) {
        double c = C.exps[k], d = D.exps[m];
        KetPrim& kp = kets[ki];
        kp.q = c + d;
        kp.ccd = C.coefs[k] * D.coefs[m];
        for (int x = 0; x < 3; ++x)
          kp.bq[x] = (c * rc[x] + d * rd[x]) / kp.q;
        kp.ex.build(C.l, D.l, c, d, cdv[0]);
        kp.ey.build(C.l, D.l, c, d, cdv[1]);
        kp.ez.build(C.l, D.l, c, d, cdv[2]);
      }
  }

  for (int i = 0; i < A.nprim; ++i)
  for (int j = 0; j < B.nprim; ++j) {
    double a = A.exps[i], b = B.exps[j];
    double p = a + b;
    double bp[3] = {(a * ra[0] + b * rb[0]) / p, (a * ra[1] + b * rb[1]) / p,
                    (a * ra[2] + b * rb[2]) / p};
    ETable exab, eyab, ezab;
    exab.build(A.l, B.l, a, b, abv[0]);
    eyab.build(A.l, B.l, a, b, abv[1]);
    ezab.build(A.l, B.l, a, b, abv[2]);
    double cab = A.coefs[i] * B.coefs[j];

    for (size_t ki = 0; ki < kets.size(); ++ki) {
      const KetPrim& kp = kets[ki];
      const ETable& excd = kp.ex;
      const ETable& eycd = kp.ey;
      const ETable& ezcd = kp.ez;
      double q = kp.q;
      double ccd = kp.ccd;
      double alpha = p * q / (p + q);
      double pref = two_pi_25 / (p * q * std::sqrt(p + q)) * cab * ccd;
      double pq[3] = {bp[0] - kp.bq[0], bp[1] - kp.bq[1], bp[2] - kp.bq[2]};
      RTable rt;
      rt.build(lmax, alpha, pq, omega);

      size_t idx = 0;
      for (int ca = 0; ca < na; ++ca) {
        cart_powers(A.l, ca, pa);
        for (int cb = 0; cb < nb; ++cb) {
          cart_powers(B.l, cb, pb);
          for (int cc2 = 0; cc2 < nc; ++cc2) {
            cart_powers(C.l, cc2, pc);
            for (int cd2 = 0; cd2 < nd; ++cd2, ++idx) {
              cart_powers(D.l, cd2, pd);
              double acc = 0.0;
              for (int t = 0; t <= pa[0] + pb[0]; ++t)
              for (int u = 0; u <= pa[1] + pb[1]; ++u)
              for (int v = 0; v <= pa[2] + pb[2]; ++v) {
                double eab = exab.e[pa[0]][pb[0]][t] *
                             eyab.e[pa[1]][pb[1]][u] *
                             ezab.e[pa[2]][pb[2]][v];
                if (eab == 0.0) continue;
                double inner = 0.0;
                for (int tt = 0; tt <= pc[0] + pd[0]; ++tt)
                for (int uu = 0; uu <= pc[1] + pd[1]; ++uu)
                for (int vv = 0; vv <= pc[2] + pd[2]; ++vv) {
                  double ecd = excd.e[pc[0]][pd[0]][tt] *
                               eycd.e[pc[1]][pd[1]][uu] *
                               ezcd.e[pc[2]][pd[2]][vv];
                  double sign = ((tt + uu + vv) & 1) ? -1.0 : 1.0;
                  inner += sign * ecd * rt.r[t + tt][u + uu][v + vv];
                }
                acc += eab * inner;
              }
              cart[idx] += pref * acc;
            }
          }
        }
      }
    }
  }
}

}  // namespace

// Full ERI tensor (nao^4), chemist notation, 8-fold symmetry, with
// Cauchy-Schwarz screening |(ab|cd)| <= sqrt((ab|ab)) sqrt((cd|cd)).
// omega > 0 computes the long-range erf(omega*r12)/r12 integrals instead
// (the erf kernel is positive definite, so the Schwarz bound still holds
// with attenuated diagonal factors). Only the unique quartets whose first
// shell index lies in [ia_lo, ia_hi) are computed and scattered: calls on
// disjoint ranges write disjoint elements of eri_out, so they may run on
// concurrent threads; [0, n_shells) is the whole tensor.
void nbed_eri(int n_shells, const int32_t* meta, const double* exps,
              const double* coefs, const double* c2s, const double* coords,
              double* eri_out, double omega, int ia_lo, int ia_hi) {
  Mol mol = unpack(n_shells, meta, exps, coefs, c2s, coords);
  const int nao = mol.nao;
  const size_t n2 = (size_t)nao * nao;
  const size_t n3 = n2 * nao;
  const double screen_tol = 1e-14;

  int pa[3], pb[3], pc[3], pd[3];
  std::vector<double> cart;
  std::vector<double> sph;

  size_t n_sh = mol.shells.size();

  // Schwarz factors q_ab = sqrt(max |(ab|ab)|) per shell pair
  std::vector<double> schwarz(n_sh * n_sh, 0.0);
  for (size_t ia = 0; ia < n_sh; ++ia)
    for (size_t ib = 0; ib <= ia; ++ib) {
      const Shell& A = mol.shells[ia];
      const Shell& B = mol.shells[ib];
      eri_quartet_cart(mol, A, B, A, B, cart, omega);
      int na = ncart(A.l), nb = ncart(B.l);
      double mx = 0.0;
      for (int ca = 0; ca < na; ++ca)
        for (int cb = 0; cb < nb; ++cb) {
          double v = cart[((size_t)(ca * nb + cb) * na + ca) * nb + cb];
          if (std::fabs(v) > mx) mx = std::fabs(v);
        }
      schwarz[ia * n_sh + ib] = schwarz[ib * n_sh + ia] = std::sqrt(mx);
    }

  for (size_t ia = (size_t)ia_lo; ia < (size_t)ia_hi && ia < n_sh; ++ia)
  for (size_t ib = 0; ib <= ia; ++ib)
  for (size_t ic = 0; ic <= ia; ++ic)
  for (size_t id = 0; id <= (ic == ia ? ib : ic); ++id) {
    if (schwarz[ia * n_sh + ib] * schwarz[ic * n_sh + id] < screen_tol)
      continue;
    const Shell& A = mol.shells[ia];
    const Shell& B = mol.shells[ib];
    const Shell& C = mol.shells[ic];
    const Shell& D = mol.shells[id];
    int na = ncart(A.l), nb = ncart(B.l), nc = ncart(C.l), nd = ncart(D.l);
    eri_quartet_cart(mol, A, B, C, D, cart, omega);

    // cart -> sph
    int sa = 2 * A.l + 1, sb = 2 * B.l + 1, sc = 2 * C.l + 1, sd = 2 * D.l + 1;
    sph.assign((size_t)sa * sb * sc * sd, 0.0);
    for (int ca = 0; ca < na; ++ca)
    for (int cb = 0; cb < nb; ++cb)
    for (int cc2 = 0; cc2 < nc; ++cc2)
    for (int cd2 = 0; cd2 < nd; ++cd2) {
      double val = cart[((size_t)(ca * nb + cb) * nc + cc2) * nd + cd2];
      if (val == 0.0) continue;
      for (int ps = 0; ps < sa; ++ps)
      for (int qs = 0; qs < sb; ++qs)
      for (int rs = 0; rs < sc; ++rs)
      for (int ss = 0; ss < sd; ++ss)
        sph[((size_t)(ps * sb + qs) * sc + rs) * sd + ss] +=
            A.c2s[ca * sa + ps] * B.c2s[cb * sb + qs] *
            C.c2s[cc2 * sc + rs] * D.c2s[cd2 * sd + ss] * val;
    }

    // scatter with 8-fold symmetry
    for (int ps = 0; ps < sa; ++ps)
    for (int qs = 0; qs < sb; ++qs)
    for (int rs = 0; rs < sc; ++rs)
    for (int ss = 0; ss < sd; ++ss) {
      double val = sph[((size_t)(ps * sb + qs) * sc + rs) * sd + ss];
      size_t pi = A.ao_offset + ps, qi = B.ao_offset + qs;
      size_t ri = C.ao_offset + rs, si = D.ao_offset + ss;
      eri_out[pi * n3 + qi * n2 + ri * nao + si] = val;
      eri_out[qi * n3 + pi * n2 + ri * nao + si] = val;
      eri_out[pi * n3 + qi * n2 + si * nao + ri] = val;
      eri_out[qi * n3 + pi * n2 + si * nao + ri] = val;
      eri_out[ri * n3 + si * n2 + pi * nao + qi] = val;
      eri_out[si * n3 + ri * n2 + pi * nao + qi] = val;
      eri_out[ri * n3 + si * n2 + qi * nao + pi] = val;
      eri_out[si * n3 + ri * n2 + qi * nao + pi] = val;
    }
  }
}

// Three-centre integrals (ab|P) for density fitting: the ket pair is
// (aux shell, dummy zero-exponent s-function), for which the 4-centre
// McMurchie-Davidson expression reduces exactly to the 3-centre one.
void nbed_eri_3c(int n_shells, const int32_t* meta, const double* exps,
                 const double* coefs, const double* c2s, const double* coords,
                 int n_aux_shells, const int32_t* aux_meta,
                 const double* aux_exps, const double* aux_coefs,
                 const double* aux_c2s, double* out /* (nao, nao, naux) */,
                 double omega) {
  Mol mol = unpack(n_shells, meta, exps, coefs, c2s, coords);
  Mol aux = unpack(n_aux_shells, aux_meta, aux_exps, aux_coefs, aux_c2s,
                   coords);
  const int nao = mol.nao;
  const int naux = aux.nao;
  const double dummy_exp = 0.0;
  const double dummy_coef = 1.0;
  const double dummy_c2s = 1.0;
  std::vector<double> cart;
  std::vector<double> sph;

  for (size_t ia = 0; ia < mol.shells.size(); ++ia)
  for (size_t ib = 0; ib <= ia; ++ib)
  for (size_t ip = 0; ip < aux.shells.size(); ++ip) {
    const Shell& A = mol.shells[ia];
    const Shell& B = mol.shells[ib];
    const Shell& P = aux.shells[ip];
    Shell dummy;
    dummy.l = 0; dummy.nprim = 1; dummy.atom = P.atom; dummy.ao_offset = 0;
    dummy.exps = &dummy_exp; dummy.coefs = &dummy_coef; dummy.c2s = &dummy_c2s;
    int na = ncart(A.l), nb = ncart(B.l), np = ncart(P.l);
    eri_quartet_cart(mol, A, B, P, dummy, cart, omega);

    int sa = 2 * A.l + 1, sb = 2 * B.l + 1, sp = 2 * P.l + 1;
    sph.assign((size_t)sa * sb * sp, 0.0);
    for (int ca = 0; ca < na; ++ca)
    for (int cb = 0; cb < nb; ++cb)
    for (int cp = 0; cp < np; ++cp) {
      double val = cart[((size_t)(ca * nb + cb) * np + cp)];
      if (val == 0.0) continue;
      for (int ps = 0; ps < sa; ++ps)
      for (int qs = 0; qs < sb; ++qs)
      for (int rs = 0; rs < sp; ++rs)
        sph[((size_t)(ps * sb + qs) * sp + rs)] +=
            A.c2s[ca * sa + ps] * B.c2s[cb * sb + qs] *
            P.c2s[cp * sp + rs] * val;
    }
    for (int ps = 0; ps < sa; ++ps)
    for (int qs = 0; qs < sb; ++qs)
    for (int rs = 0; rs < sp; ++rs) {
      double val = sph[((size_t)(ps * sb + qs) * sp + rs)];
      size_t pi = A.ao_offset + ps, qi = B.ao_offset + qs;
      size_t ri = P.ao_offset + rs;
      out[(pi * nao + qi) * naux + ri] = val;
      out[(qi * nao + pi) * naux + ri] = val;
    }
  }
}

// Two-centre Coulomb metric (P|Q) for density fitting.
void nbed_eri_2c(int n_aux_shells, const int32_t* aux_meta,
                 const double* aux_exps, const double* aux_coefs,
                 const double* aux_c2s, const double* coords,
                 double* out /* (naux, naux) */, double omega) {
  Mol aux = unpack(n_aux_shells, aux_meta, aux_exps, aux_coefs, aux_c2s,
                   coords);
  const int naux = aux.nao;
  const double dummy_exp = 0.0;
  const double dummy_coef = 1.0;
  const double dummy_c2s = 1.0;
  std::vector<double> cart;
  std::vector<double> sph;

  for (size_t ip = 0; ip < aux.shells.size(); ++ip)
  for (size_t iq = 0; iq <= ip; ++iq) {
    const Shell& P = aux.shells[ip];
    const Shell& Q = aux.shells[iq];
    Shell dp, dq;
    dp.l = 0; dp.nprim = 1; dp.atom = P.atom; dp.ao_offset = 0;
    dp.exps = &dummy_exp; dp.coefs = &dummy_coef; dp.c2s = &dummy_c2s;
    dq = dp; dq.atom = Q.atom;
    int npc = ncart(P.l), nqc = ncart(Q.l);
    eri_quartet_cart(aux, P, dp, Q, dq, cart, omega);

    int sp = 2 * P.l + 1, sq = 2 * Q.l + 1;
    sph.assign((size_t)sp * sq, 0.0);
    for (int cp = 0; cp < npc; ++cp)
    for (int cq = 0; cq < nqc; ++cq) {
      double val = cart[(size_t)cp * nqc + cq];
      if (val == 0.0) continue;
      for (int ps = 0; ps < sp; ++ps)
      for (int qs = 0; qs < sq; ++qs)
        sph[(size_t)ps * sq + qs] +=
            P.c2s[cp * sp + ps] * Q.c2s[cq * sq + qs] * val;
    }
    for (int ps = 0; ps < sp; ++ps)
    for (int qs = 0; qs < sq; ++qs) {
      double val = sph[(size_t)ps * sq + qs];
      size_t pi = P.ao_offset + ps, qi = Q.ao_offset + qs;
      out[pi * naux + qi] = val;
      out[qi * naux + pi] = val;
    }
  }
}

}  // extern "C"
