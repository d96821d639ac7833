// P2: the round-3 scatter candidates (port of the Pallas probe
// benchmarks/proto_v3.py::build, pallas_call at proto_v3.py:172).
//
// Every mode gathers and multiplies, p = vals * x2d[wg[g]*8 + s, lo], then
// scatters each run of 8 groups (64 products per lane):
//
//   base     8 masked sums by sb (0..7), added at rows base[r]*8 + k
//   nib      the same, sb nibble-packed across group pairs: group 2t is
//            the low nibble (v & 15) and 2t+1 the high one (v >> 4, the
//            int8 sign-extended) of packed row t*8 + s
//   mrg      the same, lo and sb merged into one stream: step i's block
//            holds its S*8 lo rows, then its S*8 sb rows (the sb argument
//            is not read)
//   ind8     8 masked sums, sum k added at its own row tgt[r*8 + k]
//            (ind8u is the same on the card: they differ in Mosaic's
//            unrolling only)
//   sgather  per group, the sublane gather p[sb[g*8+s, l]] (sb 0..7),
//            summed over the run and added at rows base[r]*8 + s
//   w128     128 masked sums by sb (0..127), added at rows base[r]*128 + k
//            (masked_sum_wide, shared with P3's msum128)
//
// The Pallas output is resident for the whole grid and runs of different
// steps add into the same rows.  w128 keeps that order on the card: it runs
// masked_sum_wide (probe_common.cuh), owner-computes tiles that add the
// runs in run order with plain stores, bit-identical from call to call.
// The other modes take one run a CTA (one thread per lane, the 8 sums in
// registers), and their adds into the 1 MB output, which stays in L2, are
// atomic: red.global.add.f32 is the card's counterpart of the VMEM
// read-modify-write.  Their sum order therefore changes from run to run (a
// probe measures a cost and needs no fixed order; these modes reach half of
// their bound and were left as they were).  Bound: 6 B/slot of slot streams
// plus 8 atomic adds per lane per run.

#include "probe_common.cuh"

namespace {

enum Mode : int {
  kBase = 0,
  kNib = 1,
  kMrg = 2,
  kInd8 = 3,
  kSgather = 4,
  kW128 = 5,
};
constexpr int kW128Lanes = 16;   // w128's tiles: lanes of a 128-row block

template <int MODE>
__global__ void __launch_bounds__(kLane)
scatter_run(const float* __restrict__ x2d, const float* __restrict__ vals,
            const int8_t* __restrict__ lo, const int8_t* __restrict__ sb,
            const int32_t* __restrict__ wg, const int32_t* __restrict__ base,
            int S, float* __restrict__ out) {
  const int l = threadIdx.x;
  const int64_t r = blockIdx.x;
  float acc[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) acc[k] = 0.f;
  for (int t = 0; t < kRun; ++t) {
    const int64_t g = r * kRun + t;
    const int w = wg[g];
    int64_t lo_row = g * kChunks;  // first row of group g in lo and in sb
    int64_t sb_row = g * kChunks;
    if (MODE == kMrg) {
      const int64_t step = g / S;
      lo_row = (step * S + g) * kChunks;  // step*2S + (g - step*S) groups
      sb_row = lo_row + int64_t(S) * kChunks;
    } else if (MODE == kNib) {
      sb_row = (g >> 1) * kChunks;
    }
    float p[kChunks];
#pragma unroll
    for (int s = 0; s < kChunks; ++s) {
      p[s] = vals[(g * kChunks + s) * kLane + l] *
             window_gather(x2d, w, s, lo[(lo_row + s) * kLane + l]);
    }
#pragma unroll
    for (int s = 0; s < kChunks; ++s) {
      int target = sb[(sb_row + s) * kLane + l];
      if (MODE == kSgather) {
        float picked = p[0];
#pragma unroll
        for (int k = 1; k < kChunks; ++k) {
          picked = (target == k) ? p[k] : picked;
        }
        acc[s] += picked;
      } else {
        if (MODE == kNib) target = (g & 1) ? (target >> 4) : (target & 15);
#pragma unroll
        for (int k = 0; k < kChunks; ++k) acc[k] += (target == k) ? p[s] : 0.f;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int64_t row = MODE == kInd8 ? int64_t(base[r * kRun + k])
                                      : int64_t(base[r]) * kChunks + k;
    atomicAdd(out + row * kLane + l, acc[k]);
  }
}

template <int MODE>
cudaError_t launch_run(int n_runs, int S, cudaStream_t stream,
                       const float* x2d, const float* vals, const int8_t* lo,
                       const int8_t* sb, const int32_t* wg,
                       const int32_t* base, float* out) {
  scatter_run<MODE><<<n_runs, kLane, 0, stream>>>(x2d, vals, lo, sb, wg, base,
                                                  S, out);
  return cudaGetLastError();
}

}  // namespace

// One probe call over n_runs runs of 8 groups (S groups per step, used by
// mrg's layout).  mode: 0 base, 1 nib, 2 mrg, 3 ind8/ind8u, 4 sgather add
// into `out`, which the wrapper zeroes; 5 w128 writes every one of its
// out_rows rows, through the run index (band_ptr: n_bands + 1 offsets into
// band_runs, one band per 128-row block; max_runs, the most runs of a
// block) in tiles of 16 lanes, and reads no base.  Returns the CUDA error
// of the launch (0 = launched); launches on `stream`, does not
// synchronize.
extern "C" int tsp_probe_proto_v3(const void* x2d, const void* vals,
                                  const void* lo, const void* sb,
                                  const void* wg, const void* base,
                                  const void* band_ptr, const void* band_runs,
                                  int n_bands, int max_runs, int out_rows,
                                  int n_runs, int S, int mode, void* out,
                                  void* stream) {
  if (n_runs <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(x2d);
  const auto* v = static_cast<const float*>(vals);
  const auto* lo8 = static_cast<const int8_t*>(lo);
  const auto* sb8 = static_cast<const int8_t*>(sb);
  const auto* wg32 = static_cast<const int32_t*>(wg);
  const auto* b32 = static_cast<const int32_t*>(base);
  auto* o = static_cast<float*>(out);
  cudaError_t err = cudaErrorInvalidValue;
  switch (mode) {
    case kBase:
      err = launch_run<kBase>(n_runs, S, st, x, v, lo8, sb8, wg32, b32, o);
      break;
    case kNib:
      err = launch_run<kNib>(n_runs, S, st, x, v, lo8, sb8, wg32, b32, o);
      break;
    case kMrg:
      err = launch_run<kMrg>(n_runs, S, st, x, v, lo8, lo8, wg32, b32, o);
      break;
    case kInd8:
      err = launch_run<kInd8>(n_runs, S, st, x, v, lo8, sb8, wg32, b32, o);
      break;
    case kSgather:
      err = launch_run<kSgather>(n_runs, S, st, x, v, lo8, sb8, wg32, b32, o);
      break;
    case kW128:
      err = launch_masked_sum_wide<kW128Lanes>(
          n_bands, max_runs, n_runs, st, x, v, lo8, sb8, wg32,
          static_cast<const int32_t*>(band_ptr),
          static_cast<const int32_t*>(band_runs), out_rows, o);
      break;
    default:
      break;
  }
  return int(err);
}
