// The full float64 ERI tensor (ab|cd), chemist notation, of B geometries of
// one molecule on the card (sm_90a): McMurchie-Davidson, as the host engine
// csrc/md_integrals.cpp computes it (eri_quartet_cart, nbed_eri), with the
// same erf-attenuated option (omega > 0: erf(omega r12) / r12).
//
// Not a port of a TPU kernel: the reference computes the ERIs on the host
// (nbed_tpu/native/md_integrals.cpp) or in XLA (nbed_tpu/integrals/eri.py).
// It replaces the host engine's ~60 ms a request for acetonitrile/STO-3G,
// during which the card waits, and the plain-PyTorch McMurchie-Davidson of
// integrals/eri.py (thousands of small launches) for lanes of geometries.
//
// Two launches on the caller's stream, no host read, no allocation (the
// wrapper, ops/eri.py, allocates the output and the scratch with torch), so a
// CUDA graph captures them:
//   1. md_eri_pairs: one thread per (lane, primitive pair of a shell pair
//      a >= b, axis): the Hermite expansion coefficients E_t^{ij} of its axis,
//      and on the x thread p = a + b, P and the contraction coefficient
//      c_a c_b, into the scratch.
//   2. md_eri_quartets: one block per (canonical shell quartet a >= b, c >= d,
//      pair(ab) >= pair(cd); lane). It copies the E tables of its primitive
//      pairs to shared memory, then covers its primitive quartets a tile at a
//      time: each thread evaluates the Boys function and the Hermite R
//      integrals of one into shared memory; then each thread owns fixed
//      elements of the cartesian block and adds E_bra . R . E_ket over the
//      tile's primitive quartets in their order (the host's order: bra
//      primitive pairs outer, ket inner). A block of fewer elements than
//      threads gives each element several threads, each a fixed slice of the
//      primitive quartets, and adds the slices in order: every launch sums
//      alike. The block turns its block spherical (cart2sph, four passes in
//      shared memory) and writes each value's permutation images that it
//      owns.
//
// Ownership (every element of the output has exactly one writer): an element
// (i, j, k, l) of shells (si, sj, sk, sl) belongs to the canonical quartet
// reached by swapping i, j where si < sj, k, l where sk < sl, and the pairs
// where (si, sj) < (sk, sl), lexicographically: a tie swaps nothing. The
// block element at that canonical position writes it; an element lists its
// eight images and writes those that map back onto itself, each once.
// ops/eri.py::owners is the same rule in numpy, which the CPU tests hold.
//
// Bound: operations. Acetonitrile/STO-3G has 3,081 canonical quartets of 81
// primitive quartets each and writes 18^4 float64 (0.8 MB): the E . R . E
// contraction and the Boys series are float64 arithmetic on the scalar units
// (34 TFLOP/s on the H100; the tensor cores do not fit a contraction of this
// shape), and the bytes are negligible. In practice it is latency-bound: a
// (pp|pp) block's 81 elements each run a chain of ~1,000 dependent
// shared-memory loads and multiply-adds, and at one geometry those few
// blocks set the kernel's time. The design keeps the R and E tables in shared
// memory, gives a block 256 threads so that each element's sum splits into
// slices (three for (pp|pp); an (ss|ss) block has one cartesian element),
// and fills the card with one block per quartet and lane, heaviest quartets
// first. Shells up to d (l <= 2, L <= 8); the wrapper sends a molecule with a
// higher shell elsewhere.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (nbed_tpu_torch/ops/eri.py does this at first use).
// The entry point returns 0 or 10000 + a cudaError_t.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kCudaBase = 10000;
constexpr int kThreads = 256;
constexpr int kLmax = 2;                 // highest l of a shell
constexpr int kLsum = 4 * kLmax;         // highest L = la + lb + lc + ld
constexpr int kNR = (kLsum + 1) * (kLsum + 2) * (kLsum + 3) / 6;  // R_tuv, t+u+v <= L
constexpr int kET = 2 * kLmax + 1;       // t of E_t^{ij}: 0..i+j
constexpr int kE = (kLmax + 1) * (kLmax + 1) * kET;  // E_t^{ij} of one axis
constexpr int kPairWords = 5 + 3 * kE;   // p, P (3), c_a c_b, E of x, y, z
constexpr double kPi = 3.14159265358979323846;

// the tables of ops/eri.py (device pointers) and the launch's sizes; mirrored
// by ops/eri.py::_PlanC
struct Plan {
  const int* shells;      // (nsh, 6): l, nprim, atom, ao_offset, first prim, first c2s
  const double* exps;     // primitive exponents
  const double* coefs;    // primitive-normalised contraction coefficients
  const double* c2s;      // each shell's (ncart, nsph) cart2sph, row-major
  const int* pairs;       // (npair, 3): a, b (a >= b), first primitive pair
  const int* prim_pairs;  // (npp, 3): pair, i, j
  const int* quartets;    // (nq, 2): bra pair, ket pair (bra >= ket)
  int64_t n_prim_pairs;
  int64_t n_quartets;
  int natm;
  int nao;
  int batch;
  int tile;       // primitive quartets of one R tile
  int nr;         // R_tuv per primitive quartet in shared memory: (Lmax+1)(Lmax+2)(Lmax+3)/6
  int cart_max;   // words of a cartesian block buffer
  int smem_bytes; // 8 * (2 cart_max + tile (nr + 1) + e_words)
};

__device__ __forceinline__ int ncart(int l) { return (l + 1) * (l + 2) / 2; }

// cartesian component powers, as csrc/md_integrals.cpp's cart_powers
__device__ __forceinline__ void cart_powers(int l, int comp, int* p) {
  int idx = 0;
  for (int i = 0; i <= l; ++i) {
    for (int j = 0; j <= i; ++j) {
      if (idx == comp) { p[0] = l - i; p[1] = i - j; p[2] = j; return; }
      ++idx;
    }
  }
}

// R_tuv's place: by total N = t+u+v, then s = u+v, then v
__device__ __forceinline__ int r_index(int t, int u, int v) {
  const int n = t + u + v, s = u + v;
  return n * (n + 1) * (n + 2) / 6 + s * (s + 1) / 2 + v;
}

__device__ __forceinline__ int e_index(int i, int j, int t) { return (i * (kLmax + 1) + j) * kET + t; }

// Boys functions F_0..F_m at t: csrc/md_integrals.cpp's boys
__device__ void boys(int mmax, double t, double* f) {
  if (t < 1e-13) {
    for (int m = 0; m <= mmax; ++m) f[m] = 1.0 / (2 * m + 1);
    return;
  }
  if (t < 40.0) {
    double term = 1.0 / (2.0 * mmax + 1.0);
    double sum = term;
    for (int k = 1; k < 500; ++k) {
      term *= 2.0 * t / (2.0 * mmax + 2.0 * k + 1.0);
      sum += term;
      if (term < 1e-17 * sum) break;
    }
    const double expt = exp(-t);
    f[mmax] = expt * sum;
    for (int m = mmax; m > 0; --m) f[m - 1] = (2.0 * t * f[m] + expt) / (2.0 * m - 1.0);
  } else {
    const double expt = exp(-t);
    f[0] = 0.5 * sqrt(kPi / t) * erf(sqrt(t));
    for (int m = 0; m < mmax; ++m) f[m + 1] = ((2.0 * m + 1.0) * f[m] - expt) / (2.0 * t);
  }
}

// E_t^{ij} of one axis for i <= la, j <= lb (ETable::build); entries
// outside t <= i + j are zero
__device__ void e_table(int la, int lb, double a, double b, double ab, double* e) {
  for (int k = 0; k < kE; ++k) e[k] = 0.0;
  const double p = a + b, mu = a * b / p, inv2p = 0.5 / p;
  const double pa = -b / p * ab, pb = a / p * ab;
  e[e_index(0, 0, 0)] = exp(-mu * ab * ab);
  for (int i = 0; i <= la; ++i) {
    for (int j = 0; j <= lb; ++j) {
      if (i == 0 && j == 0) continue;
      for (int t = 0; t <= i + j; ++t) {
        double val = 0.0;
        if (j == 0) {
          if (t >= 1) val += inv2p * e[e_index(i - 1, j, t - 1)];
          if (t <= i - 1 + j) val += pa * e[e_index(i - 1, j, t)];
          if (t + 1 <= i - 1 + j) val += (t + 1) * e[e_index(i - 1, j, t + 1)];
        } else {
          if (t >= 1) val += inv2p * e[e_index(i, j - 1, t - 1)];
          if (t <= i + j - 1) val += pb * e[e_index(i, j - 1, t)];
          if (t + 1 <= i + j - 1) val += (t + 1) * e[e_index(i, j - 1, t + 1)];
        }
        e[e_index(i, j, t)] = val;
      }
    }
  }
}

// Hermite Coulomb integrals R_tuv, t+u+v <= lsum, into r (RTable::build):
// downward recursion in the Boys order n, two levels in local memory, level
// 0 written to r
__device__ void hermite_r(int lsum, double alpha, const double* pq, double omega, double* r) {
  double f[kLsum + 1];
  const double t_arg = alpha * (pq[0] * pq[0] + pq[1] * pq[1] + pq[2] * pq[2]);
  if (omega > 0.0) {
    const double kappa2 = omega * omega / (alpha + omega * omega);
    boys(lsum, kappa2 * t_arg, f);
    double fac = sqrt(kappa2);
    for (int n = 0; n <= lsum; ++n) { f[n] *= fac; fac *= kappa2; }
  } else {
    boys(lsum, t_arg, f);
  }
  double pw[kLsum + 1];
  pw[0] = 1.0;
  for (int n = 1; n <= lsum; ++n) pw[n] = pw[n - 1] * (-2.0 * alpha);
  double level[2][kNR];
  for (int n = lsum; n >= 0; --n) {
    double* cur = n == 0 ? r : level[n & 1];
    const double* up = level[(n + 1) & 1];
    cur[0] = pw[n] * f[n];
    const int rem = lsum - n;
    for (int tot = 1; tot <= rem; ++tot) {
      for (int t = 0; t <= tot; ++t) {
        for (int u = 0; u <= tot - t; ++u) {
          const int v = tot - t - u;
          double val;
          if (t >= 1) {
            val = pq[0] * up[r_index(t - 1, u, v)];
            if (t >= 2) val += (t - 1) * up[r_index(t - 2, u, v)];
          } else if (u >= 1) {
            val = pq[1] * up[r_index(t, u - 1, v)];
            if (u >= 2) val += (u - 1) * up[r_index(t, u - 2, v)];
          } else {
            val = pq[2] * up[r_index(t, u, v - 1)];
            if (v >= 2) val += (v - 1) * up[r_index(t, u, v - 2)];
          }
          cur[r_index(t, u, v)] = val;
        }
      }
    }
  }
}

// E_t^{ij} of one axis of a shell pair (la, lb) kept compactly in shared
// memory: (i, j) blocks in i-major order, each of its i + j + 1 values of t
__device__ __forceinline__ int e_compact(int lb, int i, int j) {
  return (lb + 1) * i * (i + 1) / 2 + i * lb * (lb + 1) / 2 + j * (i + 1) + j * (j - 1) / 2;
}

__device__ __forceinline__ int e_compact_size(int la, int lb) { return e_compact(lb, la + 1, 0); }

// copy the E tables of n primitive pairs of shells (la, lb) from the scratch
// (kPairWords apart, full layout) to dst (3 * e_compact_size apart)
__device__ void stage_e(const double* src, int n, int la, int lb, double* dst) {
  const int per_axis = e_compact_size(la, lb);
  const int span = (la + 1) * (lb + 1) * kET;
  for (int x = threadIdx.x; x < n * 3 * span; x += kThreads) {
    const int t = x % kET, j = x / kET % (lb + 1), i = x / (kET * (lb + 1)) % (la + 1);
    const int axis = x / span % 3, p = x / (3 * span);
    if (t > i + j) continue;
    dst[(p * 3 + axis) * per_axis + e_compact(lb, i, j) + t] =
        src[p * kPairWords + 5 + axis * kE + e_index(i, j, t)];
  }
}

// where one cartesian element of a block reads its E values: for each axis
// of the bra and of the ket, the offset of its (i, j) in a primitive pair's
// compact E, and the highest t
struct Element {
  int off[2][3];
  int top[2][3];
};

__device__ __forceinline__ Element element(int e, const int* l, const int* nc) {
  int pw[4][3];
  for (int k = 3; k >= 0; --k) {
    cart_powers(l[k], e % nc[k], pw[k]);
    e /= nc[k];
  }
  Element el;
  for (int side = 0; side < 2; ++side) {
    const int la = l[2 * side], lb = l[2 * side + 1];
    for (int x = 0; x < 3; ++x) {
      const int i = pw[2 * side][x], j = pw[2 * side + 1][x];
      el.off[side][x] = x * e_compact_size(la, lb) + e_compact(lb, i, j);
      el.top[side][x] = i + j;
    }
  }
  return el;
}

// one cartesian element's E_bra . R . E_ket of one primitive quartet
// (eri_quartet_cart's inner loops): eb and ek the compact E of its bra and
// ket primitive pairs, r its R_tuv
__device__ __forceinline__ double contract(const Element& el, const double* eb, const double* ek,
                                           const double* r) {
  double sum = 0.0;
  for (int t = 0; t <= el.top[0][0]; ++t)
  for (int u = 0; u <= el.top[0][1]; ++u)
  for (int v = 0; v <= el.top[0][2]; ++v) {
    const double eab = eb[el.off[0][0] + t] * eb[el.off[0][1] + u] * eb[el.off[0][2] + v];
    if (eab == 0.0) continue;
    double inner = 0.0;
    for (int tt = 0; tt <= el.top[1][0]; ++tt)
    for (int uu = 0; uu <= el.top[1][1]; ++uu)
    for (int vv = 0; vv <= el.top[1][2]; ++vv) {
      const double ecd = ek[el.off[1][0] + tt] * ek[el.off[1][1] + uu] * ek[el.off[1][2] + vv];
      const double sign = ((tt + uu + vv) & 1) ? -1.0 : 1.0;
      inner += sign * ecd * r[r_index(t + tt, u + uu, v + vv)];
    }
    sum += eab * inner;
  }
  return sum;
}

// one thread per (lane, primitive pair, axis): small blocks, so that the few
// hundred threads of one geometry spread over many SMs
constexpr int kPairThreads = 64;

__global__ void __launch_bounds__(kPairThreads)
md_eri_pairs(Plan plan, const double* __restrict__ coords, double* __restrict__ pair_data) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kPairThreads + threadIdx.x;
  if (g >= 3 * plan.batch * plan.n_prim_pairs) return;
  const int axis = static_cast<int>(g % 3);
  const int64_t lane = g / 3 / plan.n_prim_pairs, pp = g / 3 % plan.n_prim_pairs;
  const int* prim = plan.prim_pairs + 3 * pp;
  const int* pair = plan.pairs + 3 * prim[0];
  const int* sa = plan.shells + 6 * pair[0];
  const int* sb = plan.shells + 6 * pair[1];
  const double a = plan.exps[sa[4] + prim[1]], b = plan.exps[sb[4] + prim[2]];
  const double* ra = coords + (lane * plan.natm + sa[2]) * 3;
  const double* rb = coords + (lane * plan.natm + sb[2]) * 3;
  const double p = a + b;
  double* out = pair_data + (g / 3) * kPairWords;
  if (axis == 0) {
    out[0] = p;
    for (int x = 0; x < 3; ++x) out[1 + x] = (a * ra[x] + b * rb[x]) / p;
    out[4] = plan.coefs[sa[4] + prim[1]] * plan.coefs[sb[4] + prim[2]];
  }
  double e[kE];  // the recursion reads back what it wrote: in local memory, not the scratch
  e_table(sa[0], sb[0], a, b, ra[axis] - rb[axis], e);
  for (int k = 0; k < kE; ++k) out[5 + axis * kE + k] = e[k];
}

// one axis of a block (dims n[4]) from cartesian to spherical: out has
// n[axis] = nsph, in has n[axis] = ncart(l)
__device__ void to_spherical(const double* in, double* out, const int* n, int axis, int ncar,
                             const double* c2s) {
  int m[4] = {n[0], n[1], n[2], n[3]};
  const int nsph = m[axis];
  const int total = m[0] * m[1] * m[2] * m[3];
  int stride = 1;
  for (int k = 3; k > axis; --k) stride *= m[k];
  for (int o = threadIdx.x; o < total; o += kThreads) {
    const int outer = o / (stride * nsph), s = o / stride % nsph, inner = o % stride;
    const double* src = in + outer * ncar * stride + inner;
    double acc = 0.0;
    for (int c = 0; c < ncar; ++c) acc += c2s[c * nsph + s] * src[c * stride];
    out[o] = acc;
  }
}

__constant__ int kPerms[8][4] = {{0, 1, 2, 3}, {1, 0, 2, 3}, {0, 1, 3, 2}, {1, 0, 3, 2},
                                 {2, 3, 0, 1}, {3, 2, 0, 1}, {2, 3, 1, 0}, {3, 2, 1, 0}};

__global__ void __launch_bounds__(kThreads)
md_eri_quartets(Plan plan, const double* __restrict__ pair_data, double omega,
                double* __restrict__ out) {
  extern __shared__ double smem[];
  const int64_t q = blockIdx.x;
  const int64_t lane = blockIdx.y;
  const int* bra_pair = plan.pairs + 3 * plan.quartets[2 * q];
  const int* ket_pair = plan.pairs + 3 * plan.quartets[2 * q + 1];
  const int sh[4] = {bra_pair[0], bra_pair[1], ket_pair[0], ket_pair[1]};
  const int* s[4];
  int l[4], nc[4];
  for (int k = 0; k < 4; ++k) {
    s[k] = plan.shells + 6 * sh[k];
    l[k] = s[k][0];
    nc[k] = ncart(l[k]);
  }
  const int lsum = l[0] + l[1] + l[2] + l[3];
  const int n_bra = s[0][1] * s[1][1], n_ket = s[2][1] * s[3][1];
  const int n_prim = n_bra * n_ket;
  const int n_cart = nc[0] * nc[1] * nc[2] * nc[3];
  const double* bra = pair_data + (lane * plan.n_prim_pairs + bra_pair[2]) * kPairWords;
  const double* ket = pair_data + (lane * plan.n_prim_pairs + ket_pair[2]) * kPairWords;

  double* cart = smem;
  double* work = cart + plan.cart_max;
  double* rt = work + plan.cart_max;
  double* pref = rt + plan.tile * plan.nr;
  // the E tables of the quartet's bra and ket primitive pairs, compact
  const int eb_words = 3 * e_compact_size(l[0], l[1]), ek_words = 3 * e_compact_size(l[2], l[3]);
  double* eb_s = pref + plan.tile;
  double* ek_s = eb_s + n_bra * eb_words;
  stage_e(bra, n_bra, l[0], l[1], eb_s);
  stage_e(ket, n_ket, l[2], l[3], ek_s);
  for (int e = threadIdx.x; e < n_cart; e += kThreads) cart[e] = 0.0;
  const double two_pi_25 = 2.0 * kPi * kPi * sqrt(kPi);
  // a block of fewer cartesian elements than threads sums each element in
  // `ways` fixed slices of its primitive quartets (quartet index mod ways),
  // one thread a slice, in a register
  const int ways = n_cart >= kThreads ? 1 : min(kThreads / n_cart, n_prim);
  const int slice = threadIdx.x / n_cart;
  const Element mine = element(threadIdx.x % n_cart, l, nc);
  double part = 0.0;

  for (int base = 0; base < n_prim; base += plan.tile) {
    const int count = min(plan.tile, n_prim - base);
    __syncthreads();  // the previous tile's R is read
    for (int k = threadIdx.x; k < count; k += kThreads) {
      const double* pb = bra + ((base + k) / n_ket) * kPairWords;
      const double* pk = ket + ((base + k) % n_ket) * kPairWords;
      const double p = pb[0], qq = pk[0];
      const double alpha = p * qq / (p + qq);
      pref[k] = two_pi_25 / (p * qq * sqrt(p + qq)) * pb[4] * pk[4];
      const double pq[3] = {pb[1] - pk[1], pb[2] - pk[2], pb[3] - pk[3]};
      hermite_r(lsum, alpha, pq, omega, rt + k * plan.nr);
    }
    __syncthreads();
    if (ways == 1) {
      for (int e = threadIdx.x; e < n_cart; e += kThreads) {
        const Element el = element(e, l, nc);
        double sum = cart[e];
        for (int k = 0; k < count; ++k)
          sum += pref[k] * contract(el, eb_s + ((base + k) / n_ket) * eb_words,
                                    ek_s + ((base + k) % n_ket) * ek_words, rt + k * plan.nr);
        cart[e] = sum;
      }
    } else if (threadIdx.x < n_cart * ways) {
      for (int k = (slice - base % ways + ways) % ways; k < count; k += ways)
        part += pref[k] * contract(mine, eb_s + ((base + k) / n_ket) * eb_words,
                                   ek_s + ((base + k) % n_ket) * ek_words, rt + k * plan.nr);
    }
  }
  if (ways > 1) {  // the slices' partial sums, added in slice order
    __syncthreads();
    if (threadIdx.x < n_cart * ways) rt[threadIdx.x] = part;
    __syncthreads();
    for (int e = threadIdx.x; e < n_cart; e += kThreads) {
      double sum = 0.0;
      for (int g = 0; g < ways; ++g) sum += rt[g * n_cart + e];
      cart[e] = sum;
    }
  }

  // cart2sph, one axis a pass: cart -> work -> cart -> work -> cart
  int dims[4] = {nc[0], nc[1], nc[2], nc[3]};
  double* from = cart;
  double* to = work;
  for (int k = 0; k < 4; ++k) {
    __syncthreads();
    dims[k] = 2 * l[k] + 1;
    to_spherical(from, to, dims, k, nc[k], plan.c2s + s[k][5]);
    double* swap = from;
    from = to;
    to = swap;
  }
  __syncthreads();

  // the owned images of each spherical value
  const int64_t n = plan.nao;
  double* dst = out + lane * n * n * n * n;
  const int n_sph = dims[0] * dims[1] * dims[2] * dims[3];
  for (int e = threadIdx.x; e < n_sph; e += kThreads) {
    int idx[4];
    int rest = e;
    for (int k = 3; k >= 0; --k) {
      idx[k] = s[k][3] + rest % dims[k];
      rest /= dims[k];
    }
    const double val = from[e];
    int64_t written[8];
    int n_written = 0;
    for (int m = 0; m < 8; ++m) {
      int img[4], ish[4];
      for (int k = 0; k < 4; ++k) {
        img[k] = idx[kPerms[m][k]];
        ish[k] = sh[kPerms[m][k]];
      }
      int c[4] = {img[0], img[1], img[2], img[3]};
      int cs[4] = {ish[0], ish[1], ish[2], ish[3]};
      if (cs[0] < cs[1]) { int x = c[0]; c[0] = c[1]; c[1] = x; x = cs[0]; cs[0] = cs[1]; cs[1] = x; }
      if (cs[2] < cs[3]) { int x = c[2]; c[2] = c[3]; c[3] = x; x = cs[2]; cs[2] = cs[3]; cs[3] = x; }
      if (cs[0] < cs[2] || (cs[0] == cs[2] && cs[1] < cs[3])) {
        int x = c[0]; c[0] = c[2]; c[2] = x; x = c[1]; c[1] = c[3]; c[3] = x;
      }
      if (c[0] != idx[0] || c[1] != idx[1] || c[2] != idx[2] || c[3] != idx[3]) continue;
      const int64_t at = ((img[0] * n + img[1]) * n + img[2]) * n + img[3];
      bool seen = false;
      for (int w = 0; w < n_written; ++w) seen = seen || written[w] == at;
      if (seen) continue;
      written[n_written++] = at;
      dst[at] = val;
    }
  }
}

int status() {
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : kCudaBase + static_cast<int>(err);
}

}  // namespace

// Let a quartet block take smem_bytes of dynamic shared memory (above the
// default 48 KB: d shells of long contractions) on the current device.
extern "C" int nbed_md_eri_init(int smem_bytes) {
  cudaFuncSetAttribute(md_eri_quartets, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  return status();
}

// The (batch, nao, nao, nao, nao) ERI tensor of coords (batch, natm, 3) into
// out, through pair_data (batch * n_prim_pairs * 140 float64 of scratch); all
// on the device, on `stream`.
extern "C" int nbed_md_eri(const void* plan_ptr, const void* coords, void* pair_data, void* out,
                           double omega, void* stream) {
  const Plan plan = *static_cast<const Plan*>(plan_ptr);
  if (plan.batch <= 0 || plan.n_quartets <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t threads = 3 * plan.batch * plan.n_prim_pairs;
  md_eri_pairs<<<static_cast<unsigned>((threads + kPairThreads - 1) / kPairThreads), kPairThreads,
                 0, st>>>(
      plan, static_cast<const double*>(coords), static_cast<double*>(pair_data));
  const int err = status();
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(plan.n_quartets), static_cast<unsigned>(plan.batch));
  md_eri_quartets<<<grid, kThreads, plan.smem_bytes, st>>>(
      plan, static_cast<const double*>(pair_data), omega, static_cast<double*>(out));
  return status();
}
