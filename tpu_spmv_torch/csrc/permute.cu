// K3: the 128-element chunk gather of block reordering,
// out[j*128 + e] = x[src[j]*128 + e] for the first out_len elements.
//
// Replaces the Pallas kernel tpu_spmv/kernels/reorder.py::_build_permute
// (pallas_call at reorder.py:252, driven by permute_chunks at :260-271).  A
// reordered SpMV calls it twice: on x (src = the block order, into the
// plan's permuted column space) and on the plan's output (src = the inverse
// order, back to the natural rows).
//
// The TPU kernel holds all of x in VMEM and reads one aligned (8, 128) tile
// plus a sublane gather per output chunk.  Here one warp moves one output
// chunk: 32 lanes × float4 = 512 B read and 512 B written, both coalesced,
// and src[j] is read once by lane 0 and broadcast.  A source chunk at or
// past ceil(n_x/128) (or negative), and elements past n_x inside the last
// chunk, read as 0: that bounds test stands for the zero padding
// permute_chunks materializes on the TPU, so x is never copied into a padded
// buffer.  Only the out_len elements kept are written.  It is bound by bytes:
// 8 B per element plus 4 B of src per 128.  The float4 path needs x and out
// 16-byte aligned; the launcher checks both pointers and otherwise takes the
// scalar path (lane e + 32k) for the whole call.  Partial quads at the end
// of x or of the output take per-element loads and stores.  Left on the
// table: folding the x gather into K1's table set-up and the output gather
// into K2 would skip one write and one read of each vector.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLane = 128;
constexpr int kWarpsPerBlock = 8;

template <bool kVec>
__global__ void permute_chunks_kernel(const float* __restrict__ x,
                                      int64_t n_x,
                                      const int32_t* __restrict__ src,
                                      float* __restrict__ out,
                                      int64_t out_len, int64_t n_chunks) {
  const int64_t j = int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= n_chunks) return;  // uniform across the warp
  int32_t s = 0;
  if (lane == 0) s = src[j];
  s = __shfl_sync(0xffffffffu, s, 0);
  const int64_t n_src = (n_x + kLane - 1) / kLane;
  const bool live = s >= 0 && int64_t(s) < n_src;
  const int64_t ib = int64_t(s) * kLane;
  const int64_t ob = j * kLane;
  if (kVec) {
    const int64_t e = lane * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (live && ib + e + 4 <= n_x) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(x + ib + e));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else if (live) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (ib + e + k < n_x) v[k] = x[ib + e + k];
    }
    if (ob + e + 4 <= out_len) {
      *reinterpret_cast<float4*>(out + ob + e) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (ob + e + k < out_len) out[ob + e + k] = v[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t e = lane + 32 * k;
      if (ob + e < out_len)
        out[ob + e] = live && ib + e < n_x ? x[ib + e] : 0.f;
    }
  }
}

}  // namespace

// x: n_x floats; src: at least ceil(out_len/128) int32 chunk indices;
// out: out_len floats.  Returns the CUDA error of the launch (0 = launched).
extern "C" int tsp_permute_chunks(const void* x, int64_t n_x, const void* src,
                                  void* out, int64_t out_len, void* stream) {
  if (out_len <= 0) return 0;
  const int64_t n_chunks = (out_len + kLane - 1) / kLane;
  const int64_t blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const dim3 grid(static_cast<unsigned>(blocks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int32_t* sp = static_cast<const int32_t*>(src);
  float* of = static_cast<float*>(out);
  if (vec)
    permute_chunks_kernel<true><<<grid, 32 * kWarpsPerBlock, 0, st>>>(
        xf, n_x, sp, of, out_len, n_chunks);
  else
    permute_chunks_kernel<false><<<grid, 32 * kWarpsPerBlock, 0, st>>>(
        xf, n_x, sp, of, out_len, n_chunks);
  return int(cudaGetLastError());
}
