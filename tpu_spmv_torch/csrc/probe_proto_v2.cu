// P1: the round-2 inner-loop candidates (port of the Pallas probe
// benchmarks/proto_v2.py::build, pallas_call at proto_v2.py:123).
//
// Every mode gathers and multiplies, p = vals * tab[wg[g]*8 + s, lo], over
// sub-tiles of T groups (T = 16, or 8 for v2s8), then adds:
//
//   gather  the sums over groups of p, per sublane s, into the fixed rows
//           cols8 + s and cols8 + 8 + s (the same sum twice)
//   v1x16   16 masked sums by sb (0..15) into the fixed rows cols8 + k
//   v2s8    8 masked sums by sb per unit of U groups, added at rows
//   v2s16   base[first group of the unit]*8 + k: U = 8 for v2s8 and v2b8
//   v2b8    (v2b8 computes with T = 16 and adds twice per sub-tile), 16 for
//   v2g16   v2s16, 1 for v2g16
//
// and each in a v3 form (v3gather, v3s8, v3s16, v3b8, v3g16), whose gather
// table is a copy of x2d, staged here in shared memory (16 KB at the main's
// size).  The v2 forms and v1x16 gather from the output's own first cols8
// rows.  In the Pallas probe those rows are zeroed at step 0 and never
// written, so every product is 0 (the reference's fault F5); here the
// wrapper seeds them with x2d before the launch, so a v2 mode computes what
// its v3 twin computes, its table read from the L2-resident output.  The
// wrapper checks that every destination row lies at or past cols8, so no
// add races with a gather.
//
// One CTA per grid step of S groups, kSlices slices of 128 threads (a
// thread per lane); slice w takes the step's sub-tiles w, w + kSlices, ...
// The fixed-row modes sum a lane's products in registers over its
// sub-tiles, add the slices' sums in slice order through shared memory,
// and add each of the 16 rows once per CTA into the output with
// red.global.add.f32 (per-sub-tile adds would be 2M atomics onto 2,048
// addresses at the main's size).  The dynamic-base modes add each unit's 8
// sums with red.global.add.f32, as P2 does: the Pallas grid added them in
// order in VMEM, so here the sum order of a row changes from run to run.
// Bound: the slot streams, 6 B/slot (5 B in gather, which reads no sb).

#include "probe_common.cuh"

namespace {

enum Mode : int { kGather = 0, kV1x16 = 1, kDynamic = 2 };

constexpr int kSlices = 8;
constexpr int kFixedRows = 16;

template <int MODE, int T, int UNIT, bool SPLIT>
__global__ void __launch_bounds__(kLane * kSlices)
proto_v2(const float* __restrict__ x2d, const float* __restrict__ vals,
         const int8_t* __restrict__ lo, const int8_t* __restrict__ sb,
         const int32_t* __restrict__ wg, const int32_t* __restrict__ base,
         int S, int cols8, float* out) {
  extern __shared__ float tab_s[];  // [cols8][kLane] in the v3 forms
  __shared__ float red[kFixedRows][kLane];
  const int l = threadIdx.x % kLane;
  const int w = threadIdx.x / kLane;
  const int64_t step = blockIdx.x;
  const float* tab = out;  // the head rows, seeded with x2d by the wrapper
  if (SPLIT) {
    for (int i = threadIdx.x; i < cols8 * kLane; i += blockDim.x) {
      tab_s[i] = x2d[i];
    }
    __syncthreads();
    tab = tab_s;
  }
  constexpr int kAcc = MODE == kV1x16 ? kFixedRows : kChunks;
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
  for (int q = w; q < S / T; q += kSlices) {
    const int64_t g0 = step * S + int64_t(q) * T;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int64_t g = g0 + t;
      const int wv = wg[g];
#pragma unroll
      for (int s = 0; s < kChunks; ++s) {
        const int64_t i = (g * kChunks + s) * kLane + l;
        const float p = vals[i] * window_gather(tab, wv, s, lo[i]);
        if (MODE == kGather) {
          acc[s] += p;
        } else {
          const int target = sb[i];
#pragma unroll
          for (int k = 0; k < kAcc; ++k) acc[k] += (target == k) ? p : 0.f;
        }
      }
      if (MODE == kDynamic && (t + 1) % UNIT == 0) {
        const int64_t row0 = int64_t(base[g + 1 - UNIT]) * kChunks;
#pragma unroll
        for (int k = 0; k < kChunks; ++k) {
          atomicAdd(out + (row0 + k) * kLane + l, acc[k]);
          acc[k] = 0.f;
        }
      }
    }
  }
  if (MODE == kDynamic) return;
  // the slices' sums, added in slice order
  for (int v = 0; v < kSlices; ++v) {
    if (w == v) {
#pragma unroll
      for (int k = 0; k < kAcc; ++k) {
        red[k][l] = (v ? red[k][l] : 0.f) + acc[k];
      }
    }
    __syncthreads();
  }
  for (int k = w; k < kFixedRows; k += kSlices) {
    const float sum = MODE == kGather ? red[k % kChunks][l] : red[k][l];
    atomicAdd(out + (int64_t(cols8) + k) * kLane + l, sum);
  }
}

template <int MODE, int T, int UNIT, bool SPLIT>
cudaError_t launch(int n_steps, int S, int cols8, cudaStream_t stream,
                   const float* x2d, const float* vals, const int8_t* lo,
                   const int8_t* sb, const int32_t* wg, const int32_t* base,
                   float* out) {
  const int smem = SPLIT ? cols8 * kLane * int(sizeof(float)) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        proto_v2<MODE, T, UNIT, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  proto_v2<MODE, T, UNIT, SPLIT><<<n_steps, kLane * kSlices, smem, stream>>>(
      x2d, vals, lo, sb, wg, base, S, cols8, out);
  return cudaGetLastError();
}

template <bool SPLIT>
cudaError_t launch_mode(int mode, int n_steps, int S, int cols8,
                        cudaStream_t st, const float* x, const float* v,
                        const int8_t* lo, const int8_t* sb, const int32_t* wg,
                        const int32_t* b, float* o) {
  switch (mode) {
    case 0:  // gather
      return launch<kGather, 16, 16, SPLIT>(n_steps, S, cols8, st, x, v, lo,
                                            sb, wg, b, o);
    case 1:  // v1x16
      return launch<kV1x16, 16, 16, SPLIT>(n_steps, S, cols8, st, x, v, lo,
                                           sb, wg, b, o);
    case 2:  // v2s8
      return launch<kDynamic, 8, 8, SPLIT>(n_steps, S, cols8, st, x, v, lo,
                                           sb, wg, b, o);
    case 3:  // v2s16
      return launch<kDynamic, 16, 16, SPLIT>(n_steps, S, cols8, st, x, v, lo,
                                             sb, wg, b, o);
    case 4:  // v2b8
      return launch<kDynamic, 16, 8, SPLIT>(n_steps, S, cols8, st, x, v, lo,
                                            sb, wg, b, o);
    case 5:  // v2g16
      return launch<kDynamic, 16, 1, SPLIT>(n_steps, S, cols8, st, x, v, lo,
                                            sb, wg, b, o);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One probe call over n_steps steps of S groups into `out` ((cols8 + out8,
// 128) f32), which the wrapper zeroes and, for a table in the output
// (split == 0), seeds with x2d in its first cols8 rows.  mode: 0 gather,
// 1 v1x16, 2 v2s8, 3 v2s16, 4 v2b8, 5 v2g16; split != 0 selects the v3 form
// (the table staged from x2d).  Returns the CUDA error of the launch
// (0 = launched); launches on `stream`, does not synchronize.
extern "C" int tsp_probe_proto_v2(const void* x2d, const void* vals,
                                  const void* lo, const void* sb,
                                  const void* wg, const void* base,
                                  int n_steps, int S, int cols8, int mode,
                                  int split, void* out, void* stream) {
  if (n_steps <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(x2d);
  const auto* v = static_cast<const float*>(vals);
  const auto* lo8 = static_cast<const int8_t*>(lo);
  const auto* sb8 = static_cast<const int8_t*>(sb);
  const auto* wg32 = static_cast<const int32_t*>(wg);
  const auto* b32 = static_cast<const int32_t*>(base);
  auto* o = static_cast<float*>(out);
  const cudaError_t err =
      split ? launch_mode<true>(mode, n_steps, S, cols8, st, x, v, lo8, sb8,
                                wg32, b32, o)
            : launch_mode<false>(mode, n_steps, S, cols8, st, x, v, lo8, sb8,
                                 wg32, b32, o);
  return int(err);
}
