// P3: the permutation scatter (port of the Pallas probe
// benchmarks/proto_v4.py::build, pallas_call at proto_v4.py:117).
//
// Per run of 8 groups, the 64 products of a lane, prod64[t*8 + s] =
// vals * x2d[wg[g]*8 + s, lo] for group g = r*8 + t, are a stack that each
// output row gathers from.  For output plane j < n_out and sublane s:
//
//   sj = src[(r*n_out + j)*8 + s, l]         (int8, sign-extended)
//   out[base[r]*8 + j*8 + s, l] += (sj < 64) ? prod64[sj & 63, l] : 0
//
// The planes are streamed like a plan's arrays would be (n_out*8 rows of
// int8 per run: at n_out 64 they outweigh the values).  msum128 is P2's
// w128, the same 128-target masked sum (masked_sum_wide in
// probe_common.cuh).  On the TPU the 64-deep sublane gather did not lower;
// on the card it is a shared-memory read.
//
// Design: one CTA per run, one thread per lane.  The thread stages its
// lane's 64 products in its column of a 64 x 128 shared stack (32 KB) and
// gathers from that column only, so no barrier is needed.  Runs of many
// CTAs add into the same output rows, so the adds are atomic
// (red.global.add.f32, as in P2); an entry with sj >= 64 adds nothing and
// skips its atomic.  Bound: per slot, n_out/8 B of src (8 B at n_out 64,
// more than the 6 B of the value, lo and sb streams) and up to n_out/8
// atomic adds.

#include "probe_common.cuh"

namespace {

enum Mode : int { kSg64 = 0, kMsum128 = 1 };
constexpr int kStack = kRun * kChunks;  // 64 products per lane and run

__global__ void __launch_bounds__(kLane)
permutation_scatter(const float* __restrict__ x2d,
                    const float* __restrict__ vals,
                    const int8_t* __restrict__ lo,
                    const int8_t* __restrict__ src,
                    const int32_t* __restrict__ wg,
                    const int32_t* __restrict__ base, int n_out,
                    float* __restrict__ out) {
  __shared__ float stack[kStack][kLane];
  const int l = threadIdx.x;
  const int64_t r = blockIdx.x;
  for (int t = 0; t < kRun; ++t) {
    const int64_t g = r * kRun + t;
    const int w = wg[g];
#pragma unroll
    for (int s = 0; s < kChunks; ++s) {
      const int64_t i = (g * kChunks + s) * kLane + l;
      stack[t * kChunks + s][l] = vals[i] * window_gather(x2d, w, s, lo[i]);
    }
  }
  const int8_t* __restrict__ planes = src + r * n_out * kTile + l;
  float* __restrict__ o = out + int64_t(base[r]) * kTile + l;
  for (int j = 0; j < n_out; ++j) {
#pragma unroll
    for (int s = 0; s < kChunks; ++s) {
      const int e = (j * kChunks + s) * kLane;
      const int sj = planes[e];
      if (sj < kStack) atomicAdd(o + e, stack[sj & (kStack - 1)][l]);
    }
  }
}

}  // namespace

// One probe call over n_runs runs, adding into `out`, which the wrapper
// zeroes.  mode: 0 sg64 (n_out planes per run, src read), 1 msum128 (sb
// read, src not).  Returns the CUDA error of the launch (0 = launched);
// launches on `stream`, does not synchronize.
extern "C" int tsp_probe_proto_v4(const void* x2d, const void* vals,
                                  const void* lo, const void* sb,
                                  const void* src, const void* wg,
                                  const void* base, int n_runs, int n_out,
                                  int mode, void* out, void* stream) {
  if (n_runs <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(x2d);
  const auto* v = static_cast<const float*>(vals);
  const auto* lo8 = static_cast<const int8_t*>(lo);
  const auto* wg32 = static_cast<const int32_t*>(wg);
  const auto* b32 = static_cast<const int32_t*>(base);
  auto* o = static_cast<float*>(out);
  if (mode == kMsum128) {
    return int(launch_masked_sum_wide(n_runs, st, x, v, lo8,
                                      static_cast<const int8_t*>(sb), wg32,
                                      b32, o));
  }
  if (mode != kSg64 || n_out <= 0) return int(cudaErrorInvalidValue);
  permutation_scatter<<<n_runs, kLane, 0, st>>>(
      x, v, lo8, static_cast<const int8_t*>(src), wg32, b32, n_out, o);
  return int(cudaGetLastError());
}
