// Symmetric eigendecomposition of a batch of small matrices through
// cuSOLVER, in a form that a CUDA graph can capture (sm_90a).
//
// Not a port of a TPU kernel: the reference's eigh is XLA work
// (nbed_tpu/scf/hf.py::eigh_refined), and torch.linalg.eigh is its plain
// counterpart. torch.linalg.eigh checks its `info` output on the host after
// every call (a device-to-host read), which a stream capture refuses, so the
// graphed SCF (nbed_tpu_torch/ops/eigh.py) calls cuSOLVER through this file.
// The handle, its parameters, the workspaces and the device `info` array are
// made once, when a caller prepares a (dtype, n, batch) problem; a call only
// sets the handle's stream and enqueues the solver. `info` is written on the
// device and never read here: the caller reads it after the work has run
// (after a graph replay) and raises where it is nonzero.
//
// The routine is cusolverDnXsyevBatched (cuSOLVER >= 11.7.1, CUDA 12.6.2):
// the whole batch in one call. On the H100 with CUDA 12.9 it captures and
// its replays are bitwise equal to its eager calls; cusolverDnXsyevd and
// cusolverDnDsyevj, one matrix at a time, invalidate the capture, as
// torch.linalg.eigh does.
//
// Layout: cuSOLVER reads column-major, so a row-major symmetric matrix is
// the same matrix and its row-major lower triangle is the column-major upper
// one, which is the triangle asked for here (torch.linalg.eigh reads the
// row-major lower one). On return the buffer holds the eigenvectors as
// columns, i.e. row i of the row-major buffer is eigenvector i, and w holds
// the eigenvalues in ascending order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC ... -lcusolver (nbed_tpu_torch/ops/eigh.py does this
//        at first use). Every entry point returns 0 or an error code: a
//        cusolverStatus_t, or 10000 + a cudaError_t.

#include <cuda_runtime.h>
#include <cusolverDn.h>
#include <cstdint>
#include <new>

#if !defined(CUSOLVER_VERSION) || CUSOLVER_VERSION < 11701
#error "csrc/eigh.cu needs cusolverDnXsyevBatched (cuSOLVER 11.7.1, CUDA 12.6.2 or later)"
#endif

namespace {

struct Handle {
  cusolverDnHandle_t solver = nullptr;
  cusolverDnParams_t params = nullptr;
};

constexpr int kCudaBase = 10000;

cudaDataType data_type(int dtype) { return dtype == 0 ? CUDA_R_64F : CUDA_R_32F; }

}  // namespace

extern "C" int nbed_eigh_create(void** out) {
  Handle* h = new (std::nothrow) Handle();
  if (h == nullptr) return kCudaBase + static_cast<int>(cudaErrorMemoryAllocation);
  int st = static_cast<int>(cusolverDnCreate(&h->solver));
  if (st == 0) st = static_cast<int>(cusolverDnCreateParams(&h->params));
  if (st != 0) {
    if (h->params) cusolverDnDestroyParams(h->params);
    if (h->solver) cusolverDnDestroy(h->solver);
    delete h;
    return st;
  }
  *out = h;
  return 0;
}

extern "C" int nbed_eigh_destroy(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  if (h == nullptr) return 0;
  cusolverDnDestroyParams(h->params);
  const int st = static_cast<int>(cusolverDnDestroy(h->solver));
  delete h;
  return st;
}

// Device and host workspace bytes of one call on `batch` matrices of order
// n; dtype 0 is float64, 1 float32.
extern "C" int nbed_eigh_workspace(void* handle, int dtype, int64_t n, int64_t batch,
                                   size_t* dev_bytes, size_t* host_bytes) {
  Handle* h = static_cast<Handle*>(handle);
  const cudaDataType t = data_type(dtype);
  *dev_bytes = 0;
  *host_bytes = 0;
  return static_cast<int>(cusolverDnXsyevBatched_bufferSize(
      h->solver, h->params, CUSOLVER_EIG_MODE_VECTOR, CUBLAS_FILL_MODE_UPPER, n, t, nullptr, n,
      t, nullptr, t, dev_bytes, host_bytes, batch));
}

// Overwrite the `batch` (n, n) matrices at `a` with their eigenvectors and
// write the eigenvalues to `w` (batch, n) and a status per matrix to `info`
// (batch ints, device memory), on `stream`.
extern "C" int nbed_eigh_run(void* handle, int dtype, int64_t n, int64_t batch, void* a,
                             void* w, void* work, size_t dev_bytes, void* host_work,
                             size_t host_bytes, int* info, void* stream) {
  Handle* h = static_cast<Handle*>(handle);
  const cudaDataType t = data_type(dtype);
  int st = static_cast<int>(cusolverDnSetStream(h->solver, static_cast<cudaStream_t>(stream)));
  if (st == 0) {
    st = static_cast<int>(cusolverDnXsyevBatched(
        h->solver, h->params, CUSOLVER_EIG_MODE_VECTOR, CUBLAS_FILL_MODE_UPPER, n, t, a, n, t,
        w, t, work, dev_bytes, host_work, host_bytes, info, batch));
  }
  if (st != 0) return st;
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : kCudaBase + static_cast<int>(err);
}
