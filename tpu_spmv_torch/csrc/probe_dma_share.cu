// P5: does re-reading a streamed block cost anything (port of the Pallas
// probe benchmarks/profile_dma_share.py::build, pallas_call at
// profile_dma_share.py:48).
//
// Step i sums block b = blk[i] (b = i with `direct`) of S (8, 128) tiles,
// vals rows (b*S + t)*8 + s, into an (8, 128) sum for output block oi[i].
// The Pallas kernel zeroes the output block whenever oi changes; oi is
// non-decreasing, so out[o] = the sum over the steps with oi[i] == o.  On
// the TPU the question was whether Pallas skips the input DMA when
// consecutive steps name the same block; on the card it is whether a block
// read again by the next steps' CTAs comes from the 50 MB L2 (the 134 MB of
// values do not fit, a 512 KB block read again right away should).
//
// Design: one CTA per step, 256 threads, each summing 4 lanes of one
// sublane down the block's S tiles with float4 loads (16 B per thread,
// neighbouring threads on neighbouring addresses); the step's sum is
// written as a partial and sum_step_partials adds each output block's
// partials in step order.  No atomics.  Bound: HBM, vals read once per
// distinct block (plus 4 KB of partials per step).

#include "probe_common.cuh"

namespace {

constexpr int kQuads = kTile / 4;  // float4s per (8, 128) tile

template <bool DIRECT>
__global__ void __launch_bounds__(kQuads)
block_sums(const float4* __restrict__ vals, const int32_t* __restrict__ blk,
           int S, float4* __restrict__ part) {
  const int64_t i = blockIdx.x;
  const int64_t b = DIRECT ? i : int64_t(blk[i]);
  const float4* __restrict__ v = vals + b * S * kQuads + threadIdx.x;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int t = 0; t < S; ++t) {
    const float4 q = v[int64_t(t) * kQuads];
    acc.x += q.x;
    acc.y += q.y;
    acc.z += q.z;
    acc.w += q.w;
  }
  part[i * kQuads + threadIdx.x] = acc;
}

}  // namespace

// One probe call: n_steps block sums into `part` (n_steps x 8 x 128
// floats), then the per-output-block sum into `out` (n_out x 8 x 128).
// vals must be 16-byte aligned (the wrapper checks it).  Returns the CUDA
// error of the launches (0 = launched); launches on `stream`, does not
// synchronize.
extern "C" int tsp_probe_dma_share(const void* vals, const void* blk,
                                   const void* oi, int n_steps, int S,
                                   int n_out, int direct, void* part,
                                   void* out, void* stream) {
  if (n_steps <= 0 || S <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const float4*>(vals);
  const auto* b = static_cast<const int32_t*>(blk);
  auto* p = static_cast<float4*>(part);
  if (direct) {
    block_sums<true><<<n_steps, kQuads, 0, st>>>(v, b, S, p);
  } else {
    block_sums<false><<<n_steps, kQuads, 0, st>>>(v, b, S, p);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return int(launch_sum_step_partials(
      static_cast<const float*>(part), static_cast<const int32_t*>(oi),
      n_steps, n_out, static_cast<float*>(out), st));
}
