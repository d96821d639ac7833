// K2: the SpMV's final epilogue,
//   out[i] = y[t*128 + lam[t*128 + (i & 127)]],  t = tile_src[i >> 7].
//
// Replaces the Pallas kernel tpu_spmv/kernels/window_ell.py::_build_unpermute
// (pallas_call at window_ell.py:1475, driven by _unpermute_tiles at
// :1491-1501): row→lane leveling permutes rows within each 128-row tile,
// and this gather restores the original row order.  Without lam (an
// unleveled plan) the lane map is the identity.
//
// It also takes the y side of block reordering (K3's second pass on the
// TPU, tpu_spmv/kernels/reorder.py:327-328) as a tile map: output tile
// i >> 7 reads the plan's tile tile_src[i >> 7] (null: the identity), so a
// reordered SpMV writes its natural-order rows once, trimmed, with no
// permute pass after.  A tile_src entry outside the plan's n_src/128 tiles
// reads as 0, as a chunk past the end does in the permute.
//
// It also ends K1's last section: where that section split a superblock
// (split_of_tile[t] = j >= 0), the value of row l of tile t is the sum,
// from zero and in chunk order, of the superblock's partial tiles
// split_ptr[j] .. split_ptr[j+1]-1 at the same column, the section
// epilogue's additions in its order; elsewhere it is y's.  So the last
// section needs no reduce launch and y is not written back.
//
// One thread per output row, over the first n rows only (the trim),
// reading y directly: a source past the end of y reads as 0, which is the
// zero padding _unpermute_tiles materializes.  It is bound by bytes: 12 B
// per row (read y and lam, write out; on a split tile 4 B of each of its
// superblock's partial tiles in place of y) and 4 B of tile_src per tile,
// all coalesced except the y read, which stays inside the source tile's
// 512 bytes (a partial tile's read stays inside its 512-byte row the same
// way), and the tile_src read, one address a tile.  It is launched with
// programmatic dependent launch (epilogue.cuh): it reads tile_src, lam,
// split_of_tile and the split ranges, and waits for the fold only before
// it reads y and the partial tiles.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "epilogue.cuh"

namespace {

__global__ void unpermute_kernel(const float* __restrict__ y, int64_t n_y,
                                 const int32_t* __restrict__ lam,
                                 const int32_t* __restrict__ tile_src,
                                 int64_t src_tiles,
                                 const float* __restrict__ partial,
                                 const int32_t* __restrict__ split_ptr,
                                 const int32_t* __restrict__ split_base,
                                 const int32_t* __restrict__ split_of_tile,
                                 int64_t split_tiles, int n_tb,
                                 float* __restrict__ out, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int e = int(i & 127);
  const int64_t t = tile_src ? int64_t(tile_src[i >> 7]) : i >> 7;
  const bool live = t >= 0 && t < src_tiles;
  int l = e, j = -1, c0 = 0, c1 = 0;
  int64_t col = 0;
  if (live) {
    if (lam) l = lam[t * 128 + e];
    j = t < split_tiles ? split_of_tile[t] : -1;
    if (j >= 0) {
      c0 = split_ptr[j];
      c1 = split_ptr[j + 1];
      col = (t - split_base[j]) * 128 + l;
    }
  }
  const int64_t row = int64_t(n_tb) * 128;
  grid_dependency_wait();
  float v = 0.f;
  if (j >= 0) {
    const float* p = partial + int64_t(c0) * row + col;
#pragma unroll 4
    for (int c = c0; c < c1; ++c, p += row) v += *p;
  } else if (live) {
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
  const int32_t* lam;          // n_src values in [0, 128); null: identity
  const int32_t* tile_src;     // ceil(n/128) plan tiles; null: identity
  int64_t n_src;               // the plan's rows: lam's, or y's without lam
  float* out;                  // n floats
  int64_t n;
  void* stream;                // cudaStream_t
};
static_assert(sizeof(UnpermuteArgs) == 15 * 8, "8-byte fields");

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
      static_cast<cudaStream_t>(a.stream), a.y, a.n_y, a.lam, a.tile_src,
      a.n_src / 128, a.partial, sp.split_ptr, sp.split_base,
      sp.split_of_tile, sp.n_split > 0 ? sp.n_tiles : int64_t(0),
      int(a.n_tb), a.out, a.n);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}
