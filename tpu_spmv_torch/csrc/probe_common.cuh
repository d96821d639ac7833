// Device code shared by the benchmark-probe kernels (probe_*.cu), which
// include this header: the window gather of one slot, the per-block sum of
// per-step partials (P4 and P5), and the wide 128-target masked sum (P2's
// `w128` and P3's `msum128`, the same computation).  Everything here has
// internal linkage, so each including source compiles its own copy.
//
// Layouts are the Pallas probes': a slot stream is (G*8, 128), the slots of
// group g in rows g*8 .. g*8+8; the gather table x2d is (cols8, 128), and
// slot (g, s, l) reads x2d[wg[g]*8 + s, lo[g*8+s, l]]: the lane index picks
// within the same sublane row (take_along_axis along the lanes).  A run is
// the 8 groups r*8 .. r*8+8 (the probes' TB half of a T = 16 sub-tile).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLane = 128;
constexpr int kChunks = 8;
constexpr int kTile = kChunks * kLane;  // one (8, 128) tile
constexpr int kRun = 8;                 // groups per scatter run
constexpr int kWide = 128;              // targets of the wide masked sum

// x2d[w*8 + s, lane]; x2d in global or shared memory.
__device__ __forceinline__ float window_gather(const float* x2d, int w, int s,
                                               int lane) {
  return x2d[(w * kChunks + s) * kLane + lane];
}

// out[b] = the sum of part[i] over the steps i with idx[i] == b, in step
// order; 0 where no step names b.  idx is non-decreasing (the wrappers check
// it when the inputs are made), so a block's steps are one range, found by
// binary search.  One CTA per output block, one thread per (sublane, lane).
__global__ void __launch_bounds__(kTile)
sum_step_partials(const float* __restrict__ part,
                  const int32_t* __restrict__ idx, int n_steps,
                  float* __restrict__ out) {
  const int b = blockIdx.x;
  int first = 0, end = n_steps;
  while (first < end) {
    const int mid = (first + end) / 2;
    if (idx[mid] < b) {
      first = mid + 1;
    } else {
      end = mid;
    }
  }
  float acc = 0.f;
  for (int i = first; i < n_steps && idx[i] == b; ++i) {
    acc += part[int64_t(i) * kTile + threadIdx.x];
  }
  out[int64_t(b) * kTile + threadIdx.x] = acc;
}

inline cudaError_t launch_sum_step_partials(const float* part,
                                            const int32_t* idx, int n_steps,
                                            int n_out, float* out,
                                            cudaStream_t stream) {
  if (n_out <= 0) return cudaSuccess;
  sum_step_partials<<<n_out, kTile, 0, stream>>>(part, idx, n_steps, out);
  return cudaGetLastError();
}

// The wide masked sum: per run, a lane's 64 products summed into 128
// targets by sb (0..127, checked when the inputs are made), then added into
// output rows base[r]*128 .. base[r]*128 + 128.  One CTA per run, one thread
// per lane; the targets are the thread's column of shared memory (64 KB per
// CTA), as K1's fold_shared keeps them at n_tb 128.  The runs of many CTAs
// add into the same rows, which the Pallas grid did in order in VMEM, so
// the adds are atomic (red.global.add.f32 into the L2-resident output): the
// sum order, and so the last bits, change from run to run.
__global__ void __launch_bounds__(kLane)
masked_sum_wide(const float* __restrict__ x2d,
                const float* __restrict__ vals,
                const int8_t* __restrict__ lo, const int8_t* __restrict__ sb,
                const int32_t* __restrict__ wg,
                const int32_t* __restrict__ base, float* __restrict__ out) {
  extern __shared__ float run_sum[];  // [kWide][kLane]
  const int l = threadIdx.x;
  const int64_t r = blockIdx.x;
  for (int k = 0; k < kWide; ++k) run_sum[k * kLane + l] = 0.f;
  for (int t = 0; t < kRun; ++t) {
    const int64_t g = r * kRun + t;
    const int w = wg[g];
#pragma unroll
    for (int s = 0; s < kChunks; ++s) {
      const int64_t i = (g * kChunks + s) * kLane + l;
      run_sum[sb[i] * kLane + l] += vals[i] * window_gather(x2d, w, s, lo[i]);
    }
  }
  float* __restrict__ o = out + int64_t(base[r]) * kWide * kLane + l;
  for (int k = 0; k < kWide; ++k) {
    atomicAdd(o + k * kLane, run_sum[k * kLane + l]);
  }
}

inline cudaError_t launch_masked_sum_wide(int n_runs, cudaStream_t stream,
                                          const float* x2d, const float* vals,
                                          const int8_t* lo, const int8_t* sb,
                                          const int32_t* wg,
                                          const int32_t* base, float* out) {
  if (n_runs <= 0) return cudaSuccess;
  const int smem = kWide * kLane * int(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      masked_sum_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  masked_sum_wide<<<n_runs, kLane, smem, stream>>>(x2d, vals, lo, sb, wg, base,
                                                   out);
  return cudaGetLastError();
}

}  // namespace
