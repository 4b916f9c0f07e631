// The dense Hamiltonian of a fixed-(n_alpha, n_beta) determinant sector, for
// the embedded FCI (sm_90a).
//
// Not a port of a TPU kernel: the reference builds this matrix on the host
// with numpy (nbed_tpu/solvers/fci.py::sector_hamiltonian), one vectorised
// pass over the determinant basis per nonzero Hamiltonian term, and so does
// the port's host route. For the small sectors of an embedded active space
// (water's mu sector: 10 spin orbitals, (3, 3), dimension 100) that is
// hundreds of Python-level passes for 10^4 matrix elements; here one launch
// writes them all from the h1 and h2 tensors where HamiltonianBuilder
// left them on the card, and cuSOLVER diagonalises the result
// (nbed_tpu_torch/solvers/fci.py::run_fci).
//
// Operator: H = constant + sum_pq h1[p,q] a+_p a_q
//                        + sum_pqrs h2[p,q,r,s] a+_p a+_q a_r a_s
// over n <= 64 interleaved spin orbitals (h2 is HamiltonianBuilder's 0.5-scaled
// tensor). Neither symmetry of h1 nor antisymmetry of h2 is assumed: every
// operator string that takes |J> to |I> is summed, as the host sums them.
//
// One thread per element H[I, J] (row I, column J, row-major). The
// excitation degree popcount(I ^ J) selects the strings that connect them:
// with X the modes annihilated and created again (spectators, X within I & J),
// a two-body string annihilates (J & ~I) + X and creates (I & ~J) + X, so
//   degree 0: X = {k, l}, both orderings of (r, s) and of (p, q), plus
//             h1[k, k], over the occupied modes (and the constant);
//   degree 2: X = {k}, k in I & J, the four orderings, plus h1[i, j];
//   degree 4: X = {}, the four orderings of (p, q) and (r, s);
//   higher:   0.
// Each string's sign is taken by applying it to J's bitstring in the host's
// order (annihilate s, then r, create q, then p; a one-body string
// annihilates q, then creates p), each step's sign (-1)^(occupied modes below
// the index) from __popcll, so the phase convention is the host's by
// construction. Terms the host drops at |h| <= 1e-14 are kept here.
//
// Bound: the output, D^2 float64 written once (D = 100: 80 kB, 0.024 us at
// 3.35 TB/s); h1 and h2 (n^4 * 8 bytes, 80 kB at n = 10) are read from L2.
// At these sizes a launch is latency-bound, not bandwidth-bound; the design
// keeps it to one launch with nothing staged on the host.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (nbed_tpu_torch/ops/fci_hamiltonian.py does this at
//        first use). The entry point returns 0 or 10000 + a cudaError_t.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kCudaBase = 10000;
constexpr int kThreads = 256;

using u64 = unsigned long long;

// (-1)^(number of occupied modes of x below m), applied to sign
__device__ __forceinline__ double below(u64 x, int m, double sign) {
  return (__popcll(x & ((1ull << m) - 1ull)) & 1) ? -sign : sign;
}

// <I| a+_p a+_q a_r a_s |x> sign, applied in the host's order, or 0 where a
// step meets an empty (annihilate) or occupied (create) mode
__device__ __forceinline__ double two_body_sign(u64 x, int p, int q, int r, int s) {
  double sign = 1.0;
  if (!((x >> s) & 1ull)) return 0.0;
  sign = below(x, s, sign);
  x ^= 1ull << s;
  if (!((x >> r) & 1ull)) return 0.0;
  sign = below(x, r, sign);
  x ^= 1ull << r;
  if ((x >> q) & 1ull) return 0.0;
  sign = below(x, q, sign);
  x |= 1ull << q;
  if ((x >> p) & 1ull) return 0.0;
  return below(x, p, sign);
}

// <I| a+_p a_q |x> sign: annihilate q, then create p
__device__ __forceinline__ double one_body_sign(u64 x, int p, int q) {
  if (!((x >> q) & 1ull)) return 0.0;
  double sign = below(x, q, 1.0);
  x ^= 1ull << q;
  if ((x >> p) & 1ull) return 0.0;
  return below(x, p, sign);
}

__device__ __forceinline__ int lowest(u64 x) { return __ffsll(static_cast<long long>(x)) - 1; }

__global__ void __launch_bounds__(kThreads)
fci_hamiltonian_kernel(const long long* __restrict__ basis, int64_t dim, int n,
                       const double* __restrict__ h1, const double* __restrict__ h2,
                       double constant, double* __restrict__ out) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= dim * dim) return;
  const int64_t row = idx / dim, col = idx - row * dim;
  const u64 bi = static_cast<u64>(basis[row]);
  const u64 bj = static_cast<u64>(basis[col]);
  const int64_t n2 = static_cast<int64_t>(n) * n;
  auto h2_at = [&](int p, int q, int r, int s) {
    return h2[(static_cast<int64_t>(p) * n + q) * n2 + static_cast<int64_t>(r) * n + s];
  };
  double acc = 0.0;
  switch (__popcll(bi ^ bj)) {
    case 0: {
      acc = constant;
      for (u64 a = bj; a; a &= a - 1) {
        const int k = lowest(a);
        acc += h1[static_cast<int64_t>(k) * n + k] * one_body_sign(bj, k, k);
        for (u64 b = bj; b; b &= b - 1) {
          const int l = lowest(b);
          if (l == k) continue;
          // (r, s) = (k, l); (p, q) both orderings
          acc += h2_at(k, l, k, l) * two_body_sign(bj, k, l, k, l);
          acc += h2_at(l, k, k, l) * two_body_sign(bj, l, k, k, l);
        }
      }
      break;
    }
    case 2: {
      const int i = lowest(bi & ~bj), j = lowest(bj & ~bi);
      acc = h1[static_cast<int64_t>(i) * n + j] * one_body_sign(bj, i, j);
      for (u64 a = bi & bj; a; a &= a - 1) {
        const int k = lowest(a);
        acc += h2_at(i, k, j, k) * two_body_sign(bj, i, k, j, k);
        acc += h2_at(k, i, j, k) * two_body_sign(bj, k, i, j, k);
        acc += h2_at(i, k, k, j) * two_body_sign(bj, i, k, k, j);
        acc += h2_at(k, i, k, j) * two_body_sign(bj, k, i, k, j);
      }
      break;
    }
    case 4: {
      const u64 created = bi & ~bj, annihilated = bj & ~bi;
      const int i1 = lowest(created), i2 = lowest(created & (created - 1));
      const int j1 = lowest(annihilated), j2 = lowest(annihilated & (annihilated - 1));
      acc = h2_at(i1, i2, j1, j2) * two_body_sign(bj, i1, i2, j1, j2)
          + h2_at(i2, i1, j1, j2) * two_body_sign(bj, i2, i1, j1, j2)
          + h2_at(i1, i2, j2, j1) * two_body_sign(bj, i1, i2, j2, j1)
          + h2_at(i2, i1, j2, j1) * two_body_sign(bj, i2, i1, j2, j1);
      break;
    }
    default:
      break;
  }
  out[idx] = acc;
}

}  // namespace

// Write the (dim, dim) row-major float64 matrix `out` of the sector whose
// determinants are the int64 bitstrings `basis` (dim, device memory), from
// h1 (n, n) and h2 (n, n, n, n), row-major float64 on the device, on
// `stream`.
extern "C" int nbed_fci_hamiltonian(const void* basis, int64_t dim, int n, const void* h1,
                                    const void* h2, double constant, void* out, void* stream) {
  if (dim <= 0) return 0;
  const int64_t blocks = (dim * dim + kThreads - 1) / kThreads;
  fci_hamiltonian_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(basis), dim, n, static_cast<const double*>(h1),
      static_cast<const double*>(h2), constant, static_cast<double*>(out));
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : kCudaBase + static_cast<int>(err);
}
