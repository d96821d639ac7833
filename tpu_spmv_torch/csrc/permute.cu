// K3: the 128-element chunk gather of block reordering, as the set-up of
// K1's gather table:
//   out[j*128 + e] = x[src[j]*128 + e]   for j*128 + e < out_len,
//   out[k]         = 0                   for out_len <= k < n_out,
// src null meaning the identity (out[k] = x[k] below out_len).
//
// Replaces the Pallas kernel tpu_spmv/kernels/reorder.py::_build_permute
// (pallas_call at reorder.py:252, driven by permute_chunks at :260-271),
// which a reordered SpMV runs twice on the TPU: on x, into the plan's
// permuted column space, and on the plan's output, back to the natural
// rows.  Here neither is a pass of its own.  The x side is the first kernel
// of every SpMV: it writes the whole gather table (cols_pad + e8*128
// floats) in one pass, x's chunks in the plan's block order (in order on a
// plan that was not reordered), then zeros for the padding columns and for
// the extras-total slots the section epilogues publish into.  So the table
// is written once: no zero-fill, no copy, no permuted x in between.  The y
// side is composed into K2's tile map (csrc/unpermute.cu, tile_src).  The
// public permute_chunks launches this kernel with n_out = out_len.
//
// The TPU kernel holds all of x in VMEM and reads one aligned (8, 128) tile
// plus a sublane gather per output chunk.  Here one warp moves one output
// chunk: 32 lanes × float4 = 512 B read and 512 B written, both coalesced;
// src[j] is read once by lane 0 and broadcast, and not at all for a chunk
// at or past out_len, which is stored as zeros.  A source chunk at or past
// ceil(n_x/128) (or negative), and elements past n_x inside the last chunk,
// read as 0: that bounds test stands for the zero padding permute_chunks
// materializes on the TPU, so x is never copied into a padded buffer.  It
// is bound by bytes: x read once, the table written once, 4 B of src per
// chunk.  The float4 path needs x and out 16-byte aligned; the launcher
// checks both pointers and otherwise takes the per-element path (lane
// e + 32k) for the whole call.  Partial quads at the end of x, of the
// gathered part or of the output take per-element loads and stores.
//
// The table is stored with the default policy (write-back through L2): at
// 1-5 MB it stays in the 50 MB L2, where K1's first section gathers from
// it.  The kernel is launched without programmatic dependent launch: it is
// the first kernel of a call, and the kernel before it on the stream (a
// PageRank update, say) may have written its x.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kLane = 128;
constexpr int kWarpsPerBlock = 8;

template <bool kVec>
__global__ void permute_chunks_kernel(const float* __restrict__ x,
                                      int64_t n_x,
                                      const int32_t* __restrict__ src,
                                      float* __restrict__ out,
                                      int64_t out_len, int64_t n_out) {
  const int64_t j = int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int64_t ob = j * kLane;
  if (ob >= n_out) return;  // uniform across the warp
  // the source chunk; `live` is false for a chunk stored as zeros
  bool live = false;
  int64_t ib = 0;
  if (ob < out_len) {  // uniform across the warp
    int64_t s = j;
    if (src) {
      int32_t v = 0;
      if (lane == 0) v = src[j];
      s = __shfl_sync(0xffffffffu, v, 0);
    }
    live = s >= 0 && s < (n_x + kLane - 1) / kLane;
    ib = s * kLane;
  }
  if (kVec) {
    const int64_t e = lane * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (live && ib + e + 4 <= n_x && ob + e + 4 <= out_len) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(x + ib + e));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else if (live) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (ib + e + k < n_x && ob + e + k < out_len) v[k] = x[ib + e + k];
    }
    if (ob + e + 4 <= n_out) {
      *reinterpret_cast<float4*>(out + ob + e) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (ob + e + k < n_out) out[ob + e + k] = v[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t e = lane + 32 * k;
      if (ob + e < n_out)
        out[ob + e] =
            live && ib + e < n_x && ob + e < out_len ? x[ib + e] : 0.f;
    }
  }
}

// The argument block of tsp_permute_chunks: 8-byte fields, packed by the
// wrapper (kernels/window_ell.py, ARG_BLOCKS) as the epilogues' are
// (epilogue.cuh).
struct PermuteArgs {
  const float* x;      // n_x floats
  int64_t n_x;
  const int32_t* src;  // ceil(out_len/128) chunk indices; null: identity
  float* out;          // n_out floats, every one written
  int64_t out_len;     // gathered positions, at most n_out
  int64_t n_out;
  void* stream;        // cudaStream_t
};
static_assert(sizeof(PermuteArgs) == 7 * 8, "8-byte fields");

}  // namespace

// Returns the CUDA error of the launch (0 = launched).
extern "C" int tsp_permute_chunks(const void* block) {
  PermuteArgs a;
  memcpy(&a, block, sizeof a);
  if (a.n_out <= 0) return 0;
  const int64_t n_chunks = (a.n_out + kLane - 1) / kLane;
  const int64_t blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const bool vec = ((reinterpret_cast<uintptr_t>(a.x) |
                     reinterpret_cast<uintptr_t>(a.out)) & 15) == 0;
  const dim3 grid(static_cast<unsigned>(blocks));
  const cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  if (vec)
    permute_chunks_kernel<true><<<grid, 32 * kWarpsPerBlock, 0, st>>>(
        a.x, a.n_x, a.src, a.out, a.out_len, a.n_out);
  else
    permute_chunks_kernel<false><<<grid, 32 * kWarpsPerBlock, 0, st>>>(
        a.x, a.n_x, a.src, a.out, a.out_len, a.n_out);
  return int(cudaGetLastError());
}
