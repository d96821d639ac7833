// K2: the SpMV's final epilogue, out[t*128 + j] = y[t*128 + lam[t,j]].
//
// Replaces the Pallas kernel tpu_spmv/kernels/window_ell.py::_build_unpermute
// (pallas_call at window_ell.py:1475, driven by _unpermute_tiles at
// :1491-1501): row→lane leveling permutes rows within each 128-row tile,
// and this gather restores the original row order.  Without lam (an
// unleveled plan) the map is the identity.
//
// It also ends K1's last section: where that section split a superblock
// (split_of_tile[t] = j >= 0), the value of row j of tile t is the sum,
// from zero and in chunk order, of the superblock's partial tiles
// split_ptr[j] .. split_ptr[j+1]-1 at the same column, the section
// epilogue's additions in its order; elsewhere it is y's.  So the last
// section needs no reduce launch and y is not written back.
//
// One thread per output row, over the first num_rows rows only (the trim),
// reading y directly: a source past the end of y reads as 0, which is the
// zero padding _unpermute_tiles materializes.  It is bound by bytes: 12 B
// per row (read y and lam, write out; on a split tile 4 B of each of its
// superblock's partial tiles in place of y), all coalesced except the y read,
// which stays inside the row's 512-byte tile (a partial tile's read stays
// inside its 512-byte row the same way).  It is launched with programmatic
// dependent launch (epilogue.cuh): it reads lam, split_of_tile and the split
// ranges, and waits for the fold only before it reads y and the partial
// tiles.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "epilogue.cuh"

namespace {

__global__ void unpermute_kernel(const float* __restrict__ y, int64_t n_y,
                                 const int32_t* __restrict__ lam,
                                 const float* __restrict__ partial,
                                 const int32_t* __restrict__ split_ptr,
                                 const int32_t* __restrict__ split_base,
                                 const int32_t* __restrict__ split_of_tile,
                                 int64_t split_tiles, int n_tb,
                                 float* __restrict__ out, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t t = i >> 7;
  const int l = lam ? lam[i] : int(i & 127);
  const int j = t < split_tiles ? split_of_tile[t] : -1;
  int c0 = 0, c1 = 0;
  int64_t col = 0;
  if (j >= 0) {
    c0 = split_ptr[j];
    c1 = split_ptr[j + 1];
    col = (t - split_base[j]) * 128 + l;
  }
  const int64_t row = int64_t(n_tb) * 128;
  grid_dependency_wait();
  float v;
  if (j >= 0) {
    v = 0.f;
    const float* p = partial + int64_t(c0) * row + col;
#pragma unroll 4
    for (int c = c0; c < c1; ++c, p += row) v += *p;
  } else {
    const int64_t src = t * 128 + l;
    v = src < n_y ? y[src] : 0.f;
  }
  out[i] = v;
}

// The argument block of tsp_unpermute (epilogue.cuh): the last section's
// SplitTiles (n_split 0, or all zeros: read y alone), then this launch's
// fields.
struct UnpermuteArgs {
  SplitTiles split;
  const float* partial;        // the workspace, n_tb*128 floats a row
  int64_t n_tb;
  const float* y;              // n_y floats (a multiple of 128)
  int64_t n_y;
  const int32_t* lam;          // at least n values in [0, 128); null: identity
  float* out;                  // n floats
  int64_t n;
  void* stream;                // cudaStream_t
};
static_assert(sizeof(UnpermuteArgs) == 13 * 8, "8-byte fields");

}  // namespace

// Returns the CUDA error of the launch (0 = launched).
extern "C" int tsp_unpermute(const void* block) {
  UnpermuteArgs a;
  memcpy(&a, block, sizeof a);
  if (a.n <= 0) return 0;
  const SplitTiles& sp = a.split;
  constexpr int kThreads = 256;
  const int64_t blocks = (a.n + kThreads - 1) / kThreads;
  const cudaError_t err = launch_after(
      unpermute_kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads),
      static_cast<cudaStream_t>(a.stream), a.y, a.n_y, a.lam, a.partial,
      sp.split_ptr, sp.split_base, sp.split_of_tile,
      sp.n_split > 0 ? sp.n_tiles : int64_t(0), int(a.n_tb), a.out, a.n);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}
