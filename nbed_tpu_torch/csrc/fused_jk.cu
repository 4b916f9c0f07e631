// Fused Coulomb/exchange build for the SCF Fock matrix, hand-written for
// Hopper (sm_90a).
//
// Replaces nbed_tpu/ops/pallas_jk.py::fused_jk (Pallas TPU kernel, body
// _kernel). It computes the same function in one pass over the two ERI
// supermatrices, M = nao^2:
//
//     out[0, r] = sum_c G_J[r, c] * (D_a + D_b)[c]     (J)
//     out[1, r] = sum_c G_K[r, c] * D_a[c]             (K alpha)
//     out[2, r] = sum_c G_K[r, c] * D_b[c]             (K beta)
//
// What bounds it on the card: it reads 2 * M^2 * sizeof(T) bytes of G and
// does 6 * M^2 flops, 0.375 flop/byte in float64, far below the H100's
// ridge point, so it is bound by device-memory bandwidth. The design reads
// every G element exactly once and each G_K element once for both spins.
//
// Design (simple and correct first):
//   - one warp per output row r; lanes walk the columns with stride 32, so
//     the 32 loads of a warp are neighbouring addresses (coalesced);
//   - the three density vectors are staged through shared memory in chunks
//     of kChunk columns (3 * M * 8 bytes exceeds shared memory once
//     nao > ~95), all warps of the block sharing each staged chunk;
//   - each lane keeps three partial sums in registers, reduced across the
//     warp with shuffles; lane 0 writes the row's three results;
//   - no atomics: every output element has one writer, so the sums are
//     deterministic from run to run.
// The TPU kernel carried its sums across a sequential grid axis; blocks on
// Hopper run in no order, so the column loop lives inside the warp instead.
// Tiling the G stream through shared memory with TMA and a ring of stages
// (and vectorised 16-byte loads) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (nbed_tpu_torch/ops/jk.py does this at first use).
// Each C entry point launches on the given stream and returns
// cudaGetLastError(), which the Python wrapper turns into an exception.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kChunk = 1024;  // columns staged per pass: 24 KB in float64

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_jk_kernel(const T* __restrict__ g_j, const T* __restrict__ g_k,
                const T* __restrict__ dm, T* __restrict__ out, int64_t m) {
  __shared__ T s_tot[kChunk];
  __shared__ T s_a[kChunk];
  __shared__ T s_b[kChunk];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  const bool active = row < m;
  const T* gj_row = g_j + (active ? row : 0) * m;
  const T* gk_row = g_k + (active ? row : 0) * m;
  const T* d_a = dm;
  const T* d_b = dm + m;

  T acc_j = T(0), acc_ka = T(0), acc_kb = T(0);
  for (int64_t c0 = 0; c0 < m; c0 += kChunk) {
    const int width = static_cast<int>(m - c0 < kChunk ? m - c0 : kChunk);
    for (int i = threadIdx.x; i < width; i += kThreads) {
      const T a = d_a[c0 + i];
      const T b = d_b[c0 + i];
      s_a[i] = a;
      s_b[i] = b;
      s_tot[i] = a + b;
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int i = lane; i < width; i += 32) {
        const T gj = gj_row[c0 + i];
        const T gk = gk_row[c0 + i];
        acc_j += gj * s_tot[i];
        acc_ka += gk * s_a[i];
        acc_kb += gk * s_b[i];
      }
    }
    __syncthreads();
  }
  acc_j = warp_sum(acc_j);
  acc_ka = warp_sum(acc_ka);
  acc_kb = warp_sum(acc_kb);
  if (active && lane == 0) {
    out[row] = acc_j;
    out[m + row] = acc_ka;
    out[2 * m + row] = acc_kb;
  }
}

template <typename T>
int launch(const void* g_j, const void* g_k, const void* dm, void* out,
           int64_t m, void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  fused_jk_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g_j), static_cast<const T*>(g_k),
      static_cast<const T*>(dm), static_cast<T*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g_j, g_k: (m, m) row-major; dm: (2, m) spin densities; out: (3, m).
extern "C" int nbed_fused_jk_f64(const void* g_j, const void* g_k,
                                 const void* dm, void* out, int64_t m,
                                 void* stream) {
  return launch<double>(g_j, g_k, dm, out, m, stream);
}

extern "C" int nbed_fused_jk_f32(const void* g_j, const void* g_k,
                                 const void* dm, void* out, int64_t m,
                                 void* stream) {
  return launch<float>(g_j, g_k, dm, out, m, stream);
}
