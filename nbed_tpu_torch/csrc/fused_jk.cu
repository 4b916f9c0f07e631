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
// over B lanes and R rows: G_J and G_K are (B, R, M), the densities
// (B, 2, M) and out (B, 3, R), each contiguous. B = 1, R = M is one SCF's
// build; B > 1 is a batch of conformers (one launch per SCF cycle for the
// whole batch); R < M is a row slab of a supermatrix split over devices.
// Row i of the flattened (B * R, M) matrix is lane i / R, row i % R, so
// the alignment split below follows i; B = 1, R = M runs the same
// arithmetic in the same order as the single build.
//
// What bounds it on the card: it reads 2 * M^2 words of G and does 6 * M^2
// flops, 0.375 flop/byte in float64, far below the H100's ridge point, so
// device-memory bytes bound it. Tensor cores do not help: wgmma has no
// float64 form, the right-hand side has 3 columns (an f64 mma.sync would
// pad them to 8), and neither reads one byte less. The design is about
// keeping enough bytes in flight and reading each byte once:
//
//   - every G element is read exactly once, each G_K element once for both
//     spins; D_a + D_b is formed on the fly;
//   - a row of G starts at r * M words, so for odd M (f64) or M % 4 != 0
//     (f32) most rows are not 16-byte aligned: each row (or column chunk
//     of a row) splits into a scalar head up to the first 16-byte boundary,
//     a body of whole 16-byte vectors and a scalar tail (split() below;
//     nbed_tpu_torch/ops/jk.py::split is its host mirror, tested on the CPU);
//   - small M (path 0, fused_jk_vec_kernel): one warp per row, 16-byte
//     vector loads straight from device memory, densities read through the
//     read-only cache, several rows per block and persistent warps; the
//     head and tail are loaded before the body and used after it; the
//     warps walk the B * R rows of all lanes, the lane folded into the
//     row index (fused_jk_vec_lanes_kernel); the float64 single build
//     (B = 1, R = M) has a kernel of its own without the lane index
//     (fused_jk_vec_kernel);
//   - large M (path 1, fused_jk_ring_kernel): one persistent block per SM
//     walks rows r = blockIdx.x + i * gridDim.x. The densities are staged
//     into dynamic shared memory once per block. One producer thread streams
//     the rows' bodies through a ring of shared-memory stages with
//     Hopper's 1-D bulk copies (cp.async.bulk), which complete on
//     mbarriers; eight consumer warps multiply out of shared memory and
//     release each stage on an "empty" mbarrier. Where the densities do
//     not fit beside the ring, they are staged in column chunks and a
//     block adds each chunk's partial sums into its own rows of out; for
//     B > 1 each block loops over the lanes, staging each lane's
//     densities in turn (one launch for the batch, not one per lane);
//   - no atomics: every output element has one writer and the summation
//     order is fixed, so results are bitwise reproducible from run to run.
//
// The launch plan (path, grid, warps, stages, stage size, density chunk,
// dynamic shared memory) is made in Python (ops/jk.py::plan) and passed in
// a Plan struct. nbed_jk_init() raises the ring kernels' dynamic shared
// memory limit once per device.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (nbed_tpu_torch/ops/jk.py does this at first use).
// Each C entry point launches on the given stream and returns
// cudaGetLastError(), which the Python wrapper turns into an exception.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kSmemMax = 232448;     // dynamic shared memory a block may use
constexpr int kRingOffset = 1024;    // barriers and reduction scratch come first
constexpr int kMaxStages = 8;
constexpr int kMaxConsumerWarps = 8;
constexpr int kVecThreads = 256;
constexpr int kStageUnroll = 8;      // path 1: density loads in flight per thread
constexpr int kRingThreads = (kMaxConsumerWarps + 1) * 32;

// Mirrors ops/jk.py::_PlanC.
struct Plan {
  int64_t m;           // columns of G (nao^2)
  int64_t rows;        // rows of G per lane (m, or a slab's rows)
  int32_t path;        // 0: vector loads from device memory; 1: bulk-copy ring
  int32_t grid;        // blocks
  int32_t warps;       // warps per block (path 1: consumer warps; one more produces)
  int32_t stages;      // path 1: ring stages
  int32_t seg_elems;   // path 1: G elements per stage and matrix (128-byte multiple)
  int32_t chunk_cols;  // path 1: density columns resident at once (m when all fit)
  int32_t smem_bytes;  // dynamic shared memory
  int32_t batch;       // lanes
};

template <typename T> struct Vec;
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

// Columns [c0, c1) of row r: `head` scalars up to the first 16-byte
// boundary, then `body` columns of whole vectors of vw words; the rest is
// the scalar tail. G's base address is 16-byte aligned (checked by the
// wrapper), so the boundary follows from the element offset alone.
__device__ __forceinline__ void split(int64_t r, int64_t m, int64_t c0, int64_t c1,
                                      int vw, int64_t& head, int64_t& body) {
  const int64_t start = r * m + c0;
  const int64_t width = c1 - c0;
  int64_t h = (vw - start % vw) % vw;
  if (h > width) h = width;
  head = h;
  body = (width - h) / vw * vw;
}

// ------------------------------------------------------------- path 0

// One lane with R = M (the float64 single build). This kernel and the lane
// kernel below keep their row body apart: one body shared by both (an
// inlined function, or a compile-time lane flag in one kernel) measured
// 0.9 us slower per launch at M = 324, float64, than either kept alone
// (nvcc 12.9, H100); this one is the single build's kernel from before
// lanes were added, without the lane index, whose division cost the single
// build 0.11-0.12 us at M = 49 and 324.
template <typename T>
__global__ void __launch_bounds__(kVecThreads)
fused_jk_vec_kernel(const T* __restrict__ g_j, const T* __restrict__ g_k,
                    const T* __restrict__ dm, T* __restrict__ out, int64_t m) {
  using V = typename Vec<T>::type;
  constexpr int vw = Vec<T>::n;
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  const T* d_a = dm;
  const T* d_b = dm + m;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
       r < m; r += warps) {
    const T* gj = g_j + r * m;
    const T* gk = g_k + r * m;
    int64_t head, body;
    split(r, m, 0, m, vw, head, body);
    const int64_t tail0 = head + body;
    // the head and tail scalars (lane < head, lane < tail) are loaded first
    // and used last, so their latency overlaps the body's loads
    T sc_j = T(0), sc_k = T(0), sc_a = T(0), sc_b = T(0);
    T tl_j = T(0), tl_k = T(0), tl_a = T(0), tl_b = T(0);
    if (lane < head) {
      sc_j = __ldg(gj + lane);
      sc_k = __ldg(gk + lane);
      sc_a = __ldg(d_a + lane);
      sc_b = __ldg(d_b + lane);
    }
    if (lane < m - tail0) {
      const int64_t c = tail0 + lane;
      tl_j = __ldg(gj + c);
      tl_k = __ldg(gk + c);
      tl_a = __ldg(d_a + c);
      tl_b = __ldg(d_b + c);
    }
    T acc_j = T(0), acc_ka = T(0), acc_kb = T(0);
    const V* vj = reinterpret_cast<const V*>(gj + head);
    const V* vk = reinterpret_cast<const V*>(gk + head);
    const int64_t nv = body / vw;
    // one vector of each matrix a lane per step: at the main path's shapes
    // (M <= 324, L2-resident) deeper unrolling measured slower
#pragma unroll 1
    for (int64_t i = lane; i < nv; i += 32) {
      const V va = __ldg(vj + i);
      const V vb = __ldg(vk + i);
      const T* ea = reinterpret_cast<const T*>(&va);
      const T* eb = reinterpret_cast<const T*>(&vb);
      const int64_t c = head + i * vw;
#pragma unroll
      for (int e = 0; e < vw; ++e) {
        const T da = __ldg(d_a + c + e), db = __ldg(d_b + c + e);
        acc_j += ea[e] * (da + db);
        acc_ka += eb[e] * da;
        acc_kb += eb[e] * db;
      }
    }
    acc_j += sc_j * (sc_a + sc_b) + tl_j * (tl_a + tl_b);
    acc_ka += sc_k * sc_a + tl_k * tl_a;
    acc_kb += sc_k * sc_b + tl_k * tl_b;
    acc_j = warp_sum(acc_j);
    acc_ka = warp_sum(acc_ka);
    acc_kb = warp_sum(acc_kb);
    if (lane == 0) {
      out[r] = acc_j;
      out[m + r] = acc_ka;
      out[2 * m + r] = acc_kb;
    }
  }
}

// B lanes of R rows (B > 1, or a slab R < M): the warps walk the B * R rows
// of all lanes, the lane folded into the row index; for B = 1, R = M it
// runs the single kernel's arithmetic in the same order (bitwise equal).
template <typename T>
__global__ void __launch_bounds__(kVecThreads)
fused_jk_vec_lanes_kernel(const T* __restrict__ g_j, const T* __restrict__ g_k,
                          const T* __restrict__ dm, T* __restrict__ out, int64_t m,
                          int64_t rows, int64_t batch) {
  using V = typename Vec<T>::type;
  constexpr int vw = Vec<T>::n;
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  const int64_t total = batch * rows;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
       i < total; i += warps) {
    const int64_t b = i / rows;  // the lane
    const int64_t r = i - b * rows;
    const T* d_a = dm + b * 2 * m;
    const T* d_b = d_a + m;
    T* o = out + b * 3 * rows;
    const T* gj = g_j + i * m;
    const T* gk = g_k + i * m;
    int64_t head, body;
    split(i, m, 0, m, vw, head, body);
    const int64_t tail0 = head + body;
    T sc_j = T(0), sc_k = T(0), sc_a = T(0), sc_b = T(0);
    T tl_j = T(0), tl_k = T(0), tl_a = T(0), tl_b = T(0);
    if (lane < head) {
      sc_j = __ldg(gj + lane);
      sc_k = __ldg(gk + lane);
      sc_a = __ldg(d_a + lane);
      sc_b = __ldg(d_b + lane);
    }
    if (lane < m - tail0) {
      const int64_t c = tail0 + lane;
      tl_j = __ldg(gj + c);
      tl_k = __ldg(gk + c);
      tl_a = __ldg(d_a + c);
      tl_b = __ldg(d_b + c);
    }
    T acc_j = T(0), acc_ka = T(0), acc_kb = T(0);
    const V* vj = reinterpret_cast<const V*>(gj + head);
    const V* vk = reinterpret_cast<const V*>(gk + head);
    const int64_t nv = body / vw;
#pragma unroll 1
    for (int64_t i = lane; i < nv; i += 32) {
      const V va = __ldg(vj + i);
      const V vb = __ldg(vk + i);
      const T* ea = reinterpret_cast<const T*>(&va);
      const T* eb = reinterpret_cast<const T*>(&vb);
      const int64_t c = head + i * vw;
#pragma unroll
      for (int e = 0; e < vw; ++e) {
        const T da = __ldg(d_a + c + e), db = __ldg(d_b + c + e);
        acc_j += ea[e] * (da + db);
        acc_ka += eb[e] * da;
        acc_kb += eb[e] * db;
      }
    }
    acc_j += sc_j * (sc_a + sc_b) + tl_j * (tl_a + tl_b);
    acc_ka += sc_k * sc_a + tl_k * tl_a;
    acc_kb += sc_k * sc_b + tl_k * tl_b;
    acc_j = warp_sum(acc_j);
    acc_ka = warp_sum(acc_ka);
    acc_kb = warp_sum(acc_kb);
    if (lane == 0) {
      o[r] = acc_j;
      o[rows + r] = acc_ka;
      o[2 * rows + r] = acc_kb;
    }
  }
}

// ------------------------------------------------------------- path 1

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 state;\n\t"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}"
               :: "r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// 1-D bulk copy device memory -> shared memory, completing `bytes` of
// transaction count on `bar`. Addresses and size are 16-byte multiples.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// Barrier among the consumer warps only (the producer never joins).
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;" :: "r"(threads) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kRingThreads, 1)
fused_jk_ring_kernel(const T* __restrict__ g_j, const T* __restrict__ g_k,
                     const T* __restrict__ dm, T* __restrict__ out, const Plan p) {
  constexpr int vw = Vec<T>::n;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  T* red = reinterpret_cast<T*>(smem + 2 * kMaxStages * sizeof(uint64_t));  // [2][warps][3]
  T* ring = reinterpret_cast<T*>(smem + kRingOffset);  // [stages][2][seg_elems]
  T* s_da = ring + static_cast<int64_t>(p.stages) * 2 * p.seg_elems;
  T* s_db = s_da + p.chunk_cols;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nc = p.warps;
  const int64_t m = p.m;
  const int64_t rows = p.rows;
  const int64_t seg = p.seg_elems;
  const int ns = p.stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], nc);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == nc) {  // the producer: one thread keeps the ring full
    if (lane != 0) return;
    int64_t k = 0;
    for (int64_t b = 0; b < p.batch; ++b) {
    for (int64_t c0 = 0; c0 < m; c0 += p.chunk_cols) {
      const int64_t c1 = c0 + p.chunk_cols < m ? c0 + p.chunk_cols : m;
      for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
        const int64_t gr = b * rows + r;  // row of the flattened (B * R, M) matrix
        int64_t head, body;
        split(gr, m, c0, c1, vw, head, body);
        const T* src_j = g_j + gr * m + c0 + head;
        const T* src_k = g_k + gr * m + c0 + head;
        for (int64_t off = 0; off < body; off += seg, ++k) {
          const int s = static_cast<int>(k % ns);
          mbar_wait(&empty[s], static_cast<uint32_t>((k / ns) & 1) ^ 1u);
          const uint32_t bytes =
              static_cast<uint32_t>((body - off < seg ? body - off : seg) * sizeof(T));
          T* dst = ring + static_cast<int64_t>(s) * 2 * seg;
          mbar_expect_tx(&full[s], 2 * bytes);
          bulk_load(dst, src_j + off, bytes, &full[s]);
          bulk_load(dst + seg, src_k + off, bytes, &full[s]);
        }
      }
    }
    }
    return;
  }

  // the consumers
  const int tid = threadIdx.x;
  const int nthreads = nc * 32;
  int64_t k = 0;
  int64_t rows_done = 0;
  for (int64_t b = 0; b < p.batch; ++b) {
  const T* dml = dm + b * 2 * m;  // this lane's densities and output
  T* o = out + b * 3 * rows;
  for (int64_t c0 = 0; c0 < m; c0 += p.chunk_cols) {
    const int64_t c1 = c0 + p.chunk_cols < m ? c0 + p.chunk_cols : m;
    const int64_t width = c1 - c0;
    // the previous chunk (or lane) is no longer read
    if (b > 0 || c0 > 0) consumer_sync(nthreads);
    // stage the chunk's densities, kStageUnroll loads in flight per thread
    for (int64_t i0 = 0; i0 < width; i0 += kStageUnroll * nthreads) {
      T a[kStageUnroll], bb[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int64_t i = i0 + u * nthreads + tid;
        a[u] = i < width ? __ldg(dml + c0 + i) : T(0);
        bb[u] = i < width ? __ldg(dml + m + c0 + i) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int64_t i = i0 + u * nthreads + tid;
        if (i < width) {
          s_da[i] = a[u];
          s_db[i] = bb[u];
        }
      }
    }
    consumer_sync(nthreads);
    for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
      const int64_t gr = b * rows + r;
      int64_t head, body;
      split(gr, m, c0, c1, vw, head, body);
      const T* gj = g_j + gr * m + c0;
      const T* gk = g_k + gr * m + c0;
      // the head and tail scalars come from device memory: loaded now,
      // used after the stages, so their latency never holds a stage back
      const int64_t tail0 = head + body;
      const bool in_head = tid < head, in_tail = tid < width - tail0;
      const int64_t ct = tail0 + tid;
      const T hj = in_head ? __ldg(gj + tid) : T(0), hk = in_head ? __ldg(gk + tid) : T(0);
      const T tj = in_tail ? __ldg(gj + ct) : T(0), tk = in_tail ? __ldg(gk + ct) : T(0);
      // a later column chunk adds to the row's earlier sums (written by this
      // same thread), loaded now for the same reason
      const bool add = tid == 0 && c0 > 0;
      const T prev_j = add ? o[r] : T(0), prev_ka = add ? o[rows + r] : T(0),
              prev_kb = add ? o[2 * rows + r] : T(0);
      T acc_j = T(0), acc_ka = T(0), acc_kb = T(0);
      for (int64_t off = 0; off < body; off += seg, ++k) {
        const int s = static_cast<int>(k % ns);
        mbar_wait(&full[s], static_cast<uint32_t>((k / ns) & 1));
        // scalar reads of the stage: neighbouring threads on neighbouring
        // words of G and of the densities, free of bank conflicts at any
        // offset (the densities' offset follows the row's head)
        const int n = static_cast<int>(body - off < seg ? body - off : seg);
        const T* sj = ring + static_cast<int64_t>(s) * 2 * seg;
        const T* sk = sj + seg;
        const T* da_s = s_da + head + off;
        const T* db_s = s_db + head + off;
#pragma unroll 4
        for (int i = tid; i < n; i += nthreads) {
          const T da = da_s[i], db = db_s[i];
          acc_j += sj[i] * (da + db);
          acc_ka += sk[i] * da;
          acc_kb += sk[i] * db;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      if (in_head) {
        const T da = s_da[tid], db = s_db[tid];
        acc_j += hj * (da + db);
        acc_ka += hk * da;
        acc_kb += hk * db;
      }
      if (in_tail) {
        const T da = s_da[ct], db = s_db[ct];
        acc_j += tj * (da + db);
        acc_ka += tk * da;
        acc_kb += tk * db;
      }
      // the row's sums: shuffles, then the warps' partials in a fixed order;
      // the scratch alternates between rows, so one barrier per row suffices
      acc_j = warp_sum(acc_j);
      acc_ka = warp_sum(acc_ka);
      acc_kb = warp_sum(acc_kb);
      T* rb = red + (rows_done & 1) * 3 * kMaxConsumerWarps;
      if (lane == 0) {
        rb[3 * warp] = acc_j;
        rb[3 * warp + 1] = acc_ka;
        rb[3 * warp + 2] = acc_kb;
      }
      consumer_sync(nthreads);
      if (tid == 0) {  // this block owns row r: no other writer
        T sj = T(0), ska = T(0), skb = T(0);
        for (int w = 0; w < nc; ++w) {
          sj += rb[3 * w];
          ska += rb[3 * w + 1];
          skb += rb[3 * w + 2];
        }
        o[r] = prev_j + sj;
        o[rows + r] = prev_ka + ska;
        o[2 * rows + r] = prev_kb + skb;
      }
      ++rows_done;
    }
  }
  }
}

template <typename T>
int launch(const void* g_j, const void* g_k, const void* dm, void* out, const Plan* p,
           void* stream) {
  if (p->m <= 0 || p->rows <= 0 || p->batch <= 0 || p->grid <= 0 || p->warps <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* gj = static_cast<const T*>(g_j);
  const T* gk = static_cast<const T*>(g_k);
  const T* d = static_cast<const T*>(dm);
  T* o = static_cast<T*>(out);
  if (p->path == 0) {
    if (p->warps * 32 > kVecThreads) return static_cast<int>(cudaErrorInvalidValue);
    // the single build's own kernel in float64 only: in float32 the lane
    // kernel measured 0.3-0.6 us faster at M = 324 and 576 (H100)
    if (sizeof(T) == 8 && p->batch == 1 && p->rows == p->m) {
      fused_jk_vec_kernel<T><<<p->grid, p->warps * 32, 0, st>>>(gj, gk, d, o, p->m);
    } else {
      fused_jk_vec_lanes_kernel<T><<<p->grid, p->warps * 32, 0, st>>>(gj, gk, d, o, p->m,
                                                                      p->rows, p->batch);
    }
  } else {
    if (p->warps > kMaxConsumerWarps || p->stages < 1 || p->stages > kMaxStages ||
        p->seg_elems <= 0 || p->chunk_cols <= 0 || p->smem_bytes > kSmemMax) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    fused_jk_ring_kernel<T><<<p->grid, (p->warps + 1) * 32, p->smem_bytes, st>>>(
        gj, gk, d, o, *p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Raise the ring kernels' dynamic shared memory limit on the current device.
extern "C" int nbed_jk_init(void) {
  cudaError_t err = cudaFuncSetAttribute(fused_jk_ring_kernel<double>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemMax);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fused_jk_ring_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  }
  return static_cast<int>(err);
}

// g_j, g_k: (batch, rows, m) row-major, 16-byte aligned; dm: (batch, 2, m)
// spin densities; out: (batch, 3, rows); plan: the launch plan of
// ops/jk.py::plan.
extern "C" int nbed_jk_f64(const void* g_j, const void* g_k, const void* dm, void* out,
                           const void* plan, void* stream) {
  return launch<double>(g_j, g_k, dm, out, static_cast<const Plan*>(plan), stream);
}

extern "C" int nbed_jk_f32(const void* g_j, const void* g_k, const void* dm, void* out,
                           const void* plan, void* stream) {
  return launch<float>(g_j, g_k, dm, out, static_cast<const Plan*>(plan), stream);
}
