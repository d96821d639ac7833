// P4: K1's cost split by stage (port of the Pallas probe
// benchmarks/profile_kernel.py::build, pallas_call at profile_kernel.py:94).
//
// The fold of K1 (window_ell.cu, fold_registers at n_tb = 8) on a synthetic,
// fully dense plan, ablated one stage at a time.  Step i owns the S groups
// i*S .. i*S + S and forms an (8, 128) sum; per slot (g, s, l), with
// p = vals * x2d[wg[g]*8 + s, lo]:
//
//   stream     acc[s] += vals
//   +lo        acc[s] += vals + lo
//   +gather    acc[s] += p
//   +select    acc[sbg[g]] += sum over s of p        (group-level sublane)
//   +scatterN  rows[k] = sum over s of p where sb == k, k < N; then
//              acc[k] += rows[k % N]                 (per-slot sublane)
//
// The step's sum goes to output superblock sup[i].  The Pallas kernel zeroes
// its output at step 0 only, so its later superblocks start from whatever
// the buffer holds; here every superblock starts from zero: each step
// writes its sum as a partial, and sum_step_partials adds a superblock's
// partials in step order (sup is non-decreasing).  No atomics.
//
// Design: one CTA per step, K1's layout: four slices of 128 threads, a
// thread owning one lane of the 8 sublanes, slice w walking groups w, w+4,
// ...; the slices' sums are added in slice order at the end, so the result
// is deterministic.  The 16 KB x2d is staged in shared memory (the VMEM
// table of the Pallas kernel) in the modes that gather.  Bound: the slot
// streams, 5 B/slot (vals + lo, 6 with sb); the stages above stream add the
// gather, the select ladder and the masked sums one at a time, which is
// the breakdown the probe measures.

#include "probe_common.cuh"

namespace {

enum Stage : int {
  kStream = 0,
  kPlusLo = 1,
  kGather = 2,
  kSelect = 3,
  kScatter = 4,
};
constexpr int kSlices = 4;

template <int STAGE, int NT>
__global__ void __launch_bounds__(kLane * kSlices)
stage_sums(const float* __restrict__ x2d, int cols8,
           const float* __restrict__ vals, const int8_t* __restrict__ lo,
           const int8_t* __restrict__ sb, const int32_t* __restrict__ wg,
           const int32_t* __restrict__ sbg, int S,
           float* __restrict__ part) {
  extern __shared__ float table[];  // x2d, in the modes that gather
  __shared__ float slice_acc[kSlices - 1][kChunks][kLane];
  const int l = threadIdx.x % kLane;
  const int w = threadIdx.x / kLane;
  const int64_t step = blockIdx.x;
  if (STAGE >= kGather) {
    for (int k = threadIdx.x; k < cols8 * kLane; k += blockDim.x) {
      table[k] = x2d[k];
    }
    __syncthreads();
  }
  float acc[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) acc[k] = 0.f;
  for (int t = w; t < S; t += kSlices) {
    const int64_t g = step * S + t;
    const int win = STAGE >= kGather ? wg[g] : 0;
    float group_sum = 0.f;
    float rows[NT];
#pragma unroll
    for (int k = 0; k < NT; ++k) rows[k] = 0.f;
#pragma unroll
    for (int s = 0; s < kChunks; ++s) {
      const int64_t i = (g * kChunks + s) * kLane + l;
      const float v = vals[i];
      if (STAGE == kStream) {
        acc[s] += v;
      } else if (STAGE == kPlusLo) {
        acc[s] += v + float(lo[i]);
      } else {
        const float p = v * window_gather(table, win, s, lo[i]);
        if (STAGE == kGather) {
          acc[s] += p;
        } else if (STAGE == kSelect) {
          group_sum += p;
        } else {
          const int target = sb[i];
#pragma unroll
          for (int k = 0; k < NT; ++k) rows[k] += (target == k) ? p : 0.f;
        }
      }
    }
    if (STAGE == kSelect) {
      const int target = sbg[g];
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        acc[k] += (target == k) ? group_sum : 0.f;
      }
    } else if (STAGE == kScatter) {
#pragma unroll
      for (int k = 0; k < kChunks; ++k) acc[k] += rows[k % NT];
    }
  }
  if (w > 0) {
#pragma unroll
    for (int k = 0; k < kChunks; ++k) slice_acc[w - 1][k][l] = acc[k];
  }
  __syncthreads();
  if (w > 0) return;
  for (int v = 0; v < kSlices - 1; ++v) {
#pragma unroll
    for (int k = 0; k < kChunks; ++k) acc[k] += slice_acc[v][k][l];
  }
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    part[(step * kChunks + k) * kLane + l] = acc[k];
  }
}

template <int STAGE, int NT>
cudaError_t launch_stage(int n_steps, int S, int cols8, cudaStream_t stream,
                         const float* x2d, const float* vals,
                         const int8_t* lo, const int8_t* sb,
                         const int32_t* wg, const int32_t* sbg, float* part) {
  const int smem = STAGE >= kGather ? cols8 * kLane * int(sizeof(float)) : 0;
  stage_sums<STAGE, NT><<<n_steps, kLane * kSlices, smem, stream>>>(
      x2d, cols8, vals, lo, sb, wg, sbg, S, part);
  return cudaGetLastError();
}

}  // namespace

// One probe call: the stage kernel over n_steps steps of S groups into
// `part` (n_steps x 8 x 128 floats), then the per-superblock sum into `out`
// (n_sup x 8 x 128).  stage: 0 stream, 1 +lo, 2 +gather, 3 +select,
// 4 +scatterN with n_t = N in {1, 2, 4, 8}.  cols8 is at most 64 (the
// wrapper checks it), so the table and the slice sums fit the 48 KB of
// shared memory a CTA gets without opting in.  Returns the CUDA error of
// the launches (0 = launched); launches on `stream`, does not synchronize.
extern "C" int tsp_probe_profile_kernel(
    const void* x2d, int cols8, const void* vals, const void* lo,
    const void* sb, const void* wg, const void* sbg, const void* sup,
    int n_steps, int S, int n_sup, int stage, int n_t, void* part, void* out,
    void* stream) {
  if (n_steps <= 0 || S <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(x2d);
  const auto* v = static_cast<const float*>(vals);
  const auto* lo8 = static_cast<const int8_t*>(lo);
  const auto* sb8 = static_cast<const int8_t*>(sb);
  const auto* wg32 = static_cast<const int32_t*>(wg);
  const auto* sbg32 = static_cast<const int32_t*>(sbg);
  auto* p = static_cast<float*>(part);
  cudaError_t err = cudaErrorInvalidValue;
  if (stage == kStream) {
    err = launch_stage<kStream, 1>(n_steps, S, cols8, st, x, v, lo8, sb8,
                                   wg32, sbg32, p);
  } else if (stage == kPlusLo) {
    err = launch_stage<kPlusLo, 1>(n_steps, S, cols8, st, x, v, lo8, sb8,
                                   wg32, sbg32, p);
  } else if (stage == kGather) {
    err = launch_stage<kGather, 1>(n_steps, S, cols8, st, x, v, lo8, sb8,
                                   wg32, sbg32, p);
  } else if (stage == kSelect) {
    err = launch_stage<kSelect, 1>(n_steps, S, cols8, st, x, v, lo8, sb8,
                                   wg32, sbg32, p);
  } else if (stage == kScatter && n_t == 1) {
    err = launch_stage<kScatter, 1>(n_steps, S, cols8, st, x, v, lo8, sb8,
                                    wg32, sbg32, p);
  } else if (stage == kScatter && n_t == 2) {
    err = launch_stage<kScatter, 2>(n_steps, S, cols8, st, x, v, lo8, sb8,
                                    wg32, sbg32, p);
  } else if (stage == kScatter && n_t == 4) {
    err = launch_stage<kScatter, 4>(n_steps, S, cols8, st, x, v, lo8, sb8,
                                    wg32, sbg32, p);
  } else if (stage == kScatter && n_t == 8) {
    err = launch_stage<kScatter, 8>(n_steps, S, cols8, st, x, v, lo8, sb8,
                                    wg32, sbg32, p);
  }
  if (err != cudaSuccess) return int(err);
  return int(launch_sum_step_partials(p, static_cast<const int32_t*>(sup),
                                      n_steps, n_sup,
                                      static_cast<float*>(out), st));
}
