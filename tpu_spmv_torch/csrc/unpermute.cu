// K2: the row unpermute of leveled plans, out[t*128 + j] = y[t*128 + lam[t,j]].
//
// Replaces the Pallas kernel tpu_spmv/kernels/window_ell.py::_build_unpermute
// (pallas_call at window_ell.py:1475, driven by _unpermute_tiles at
// :1491-1501): row→lane leveling permutes rows within each 128-row tile,
// and this gather restores the original row order.
//
// One thread per output row, over the first num_rows rows only (the trim),
// reading y directly: a source past the end of y reads as 0, which is the
// zero padding _unpermute_tiles materializes.  It is bound by bytes: 12 B
// per row (read y and lam, write out), all coalesced except the y read,
// which stays inside the row's 512-byte tile.  Left on the table: fusing
// it into K1's epilogue would skip writing and re-reading the output.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void unpermute_kernel(const float* __restrict__ y, int64_t n_y,
                                 const int32_t* __restrict__ lam,
                                 float* __restrict__ out, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t src = (i & ~int64_t(127)) + lam[i];
  out[i] = src < n_y ? y[src] : 0.f;
}

}  // namespace

// y: n_y floats (a multiple of 128); lam: at least n values in [0, 128);
// out: n floats.  Returns the CUDA error of the launch (0 = launched).
extern "C" int tsp_unpermute(const void* y, int64_t n_y, const void* lam,
                             void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  unpermute_kernel<<<dim3(static_cast<unsigned>(blocks)), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), n_y, static_cast<const int32_t*>(lam),
      static_cast<float*>(out), n);
  return int(cudaGetLastError());
}
