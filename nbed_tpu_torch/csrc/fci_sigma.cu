// The two memory-bound steps of the matrix-free FCI product sigma = H c in
// the alpha/beta string factorisation, for the embedded FCI of sectors too
// large for a dense matrix (sm_90a).
//
// Not a port of a TPU kernel: the reference diagonalises a sparse sector
// matrix on the host (nbed_tpu/solvers/fci.py::run_fci). Above about 10^5
// determinants neither that nor the dense card route
// (csrc/fci_hamiltonian.cu) fits: acetonitrile's published 28-qubit
// embedded sector, 7 alpha and 7 beta electrons in 14 orbitals, has 3432^2 =
// 11,778,624 determinants, ~4e10 nonzeros and a 2.2 PB dense matrix.
//
// The wavefunction is C[Ia, Ib] (alpha strings by rows, beta strings by
// columns, row-major). The same-spin parts of H are two dense string
// Hamiltonians applied as GEMMs; the alpha-beta part
//   sigma[Ia, Ib] += sum_{ps,qr} V[ps, qr] <Ia|Ea_ps|Ja> <Ib|Eb_qr|Jb> C[Ja, Jb]
// runs in blocks of source alpha rows Ja in [lo, lo + b), three steps each
// (nbed_tpu_torch/solvers/fci_direct.py):
//   1. gather  Y[j, qr, Ib] = sum_Jb <Ib|Eb_qr|Jb> C[lo + j, Jb]     (here)
//   2. cuBLAS  Z[j, k, :]   = V[pair(lo + j, k), :] @ Y[j]            (torch.bmm)
//   3. scatter sigma[Ia, Ib] += sum over the (Ja, k) that reach Ia of
//              sign * Z[Ja - lo, k, Ib]                                (here)
// where k runs over the single replacements E_ps |Ja> != 0 of Ja (56 for 7
// electrons in 14 orbitals), so Z holds only the rows of (ps, Ja) that
// reach some Ia: 56 of the 196 pairs.
//
// Tables (int32, built once per sector on the host; sign folded into the
// entry as (index + 1) * sign, 0 for none):
//   table_b[qr, Ib]: the beta string Jb with <Ib|Eb_qr|Jb> != 0 (at most one);
//   table_a[Ia, m]:  the m-th flat source Ja * nlink + k of Ia, ascending,
//                    so a thread walks them in one order (no atomics: each
//                    thread owns one sigma[Ia, Ib], and its sum is the same
//                    in every run).
//
// Bound: bytes. Step 1 writes b * npair * nb float64 and reads the b rows of
// C and the table; step 3 reads b * nlink * nb float64 of Z, the table and
// sigma, and writes sigma. Neither does more than one add per element moved,
// so neither approaches a compute bound; the design keeps every device-memory
// access of both coalesced along Ib (neighbouring threads on neighbouring
// columns), with C's row and the tables' rows read from L1/L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (nbed_tpu_torch/ops/fci_sigma.py does this at first
//        use). The entry points return 0 or 10000 + a cudaError_t.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kCudaBase = 10000;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fci_sigma_gather_kernel(const double* __restrict__ c, int64_t nb, int64_t lo, int npair,
                        const int* __restrict__ table_b, double* __restrict__ y) {
  const int64_t ib = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (ib >= nb) return;
  const int64_t pair = blockIdx.y, j = blockIdx.z;
  const int v = table_b[pair * nb + ib];
  double out = 0.0;
  if (v != 0) {
    const double x = c[(lo + j) * nb + (v > 0 ? v : -v) - 1];
    out = v > 0 ? x : -x;
  }
  y[(j * npair + pair) * nb + ib] = out;
}

__global__ void __launch_bounds__(kThreads)
fci_sigma_scatter_kernel(const double* __restrict__ z, int64_t nb, int64_t lo, int64_t hi,
                         int nlink, const int* __restrict__ table_a,
                         double* __restrict__ sigma) {
  const int64_t ib = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (ib >= nb) return;
  const int64_t ia = blockIdx.y;
  const int* row = table_a + ia * nlink;
  const int64_t first = lo * nlink, last = hi * nlink;
  double acc = 0.0;
  for (int m = 0; m < nlink; ++m) {
    const int v = row[m];
    const int64_t flat = static_cast<int64_t>(v > 0 ? v : -v) - 1;
    if (flat < first) continue;
    if (flat >= last) break;  // ascending: the rest lie in later blocks
    const double x = z[(flat - first) * nb + ib];
    acc += v > 0 ? x : -x;
  }
  sigma[ia * nb + ib] += acc;
}

int status() {
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : kCudaBase + static_cast<int>(err);
}

}  // namespace

// Y (b, npair, nb) of source alpha rows [lo, lo + b) of C (na, nb), from
// table_b (npair, nb); all row-major on the device, on `stream`.
extern "C" int nbed_fci_sigma_gather(const void* c, int64_t nb, int64_t lo, int64_t b,
                                     int npair, const void* table_b, void* y, void* stream) {
  if (nb <= 0 || b <= 0 || npair <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((nb + kThreads - 1) / kThreads),
                  static_cast<unsigned>(npair), static_cast<unsigned>(b));
  fci_sigma_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(c), nb, lo, npair, static_cast<const int*>(table_b),
      static_cast<double*>(y));
  return status();
}

// sigma (na, nb) += the block's Z (hi - lo, nlink, nb) through table_a
// (na, nlink); all row-major on the device, on `stream`.
extern "C" int nbed_fci_sigma_scatter(const void* z, int64_t na, int64_t nb, int64_t lo,
                                      int64_t hi, int nlink, const void* table_a, void* sigma,
                                      void* stream) {
  if (na <= 0 || nb <= 0 || hi <= lo || nlink <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((nb + kThreads - 1) / kThreads),
                  static_cast<unsigned>(na));
  fci_sigma_scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(z), nb, lo, hi, nlink, static_cast<const int*>(table_a),
      static_cast<double*>(sigma));
  return status();
}
