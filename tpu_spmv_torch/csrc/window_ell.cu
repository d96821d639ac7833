// K1: the packed window-ELL fold, y_sections = A_packed · [x ++ totals].
//
// Replaces the Pallas kernel tpu_spmv/kernels/window_ell.py::_build_pallas
// (pallas_call at window_ell.py:1454, driven by _spmv_window_ell at
// :1504-1523).  What it computes, for every slot (g, s, l) of a plan
// section (g = group, s in [0,8) sublane, l in [0,128) lane):
//
//   prod = vals[g,s,l] * T[wg[g]*1024 + s*128 + lo[g,s,l]]
//   out[(base[g / tb] + sb[g,s,l]) * 128 + l] += prod
//
// where T is x zero-padded to cols_pad followed by the extras-totals region
// the wrapper publishes between sections.  With `sbn` the sb stream is
// nibble-packed across group pairs: group 2t is the low nibble and 2t+1 the
// high nibble of packed row t*8+s (`& 15` on both; the int8 load
// sign-extends, so the high nibble is (v >> 4) & 15).
//
// The value stream comes in three forms, a template parameter V of both
// fold kernels (the Pallas kernel's `pat` and `astype(f32)` branches,
// window_ell.py:1321-1330, :1362-1367, :1389):
//   float          as above;
//   __nv_bfloat16  converted with __bfloat162float at load, so products and
//                  sums stay f32 as in the Pallas kernel; 128 threads read
//                  256 contiguous bytes per sublane;
//   Pattern        no vals pointer (null): prod is the gathered table value
//                  (every stored nonzero is 1.0).  Pad slots, whose lo and
//                  wg are 0 and so gather a real x entry, carry a sentinel
//                  sub-block instead of a zero value: -1 on the int8 stream,
//                  nibble 15 on the packed one.  Neither is a sub-block of
//                  the superblock, and the kernels drop such slots.
//
// Ordering.  The Pallas grid runs in order on one core and folds runs of
// one output superblock across steps.  Here the wrapper launches once per
// plan section (level-1 extras, level-2 extras, rows: the sections between
// fin_step marks write disjoint superblocks, and each reads only x and the
// totals earlier sections published), and inside a launch one CTA owns one
// output superblock: it walks that superblock's runs in plan order and is
// the only writer of its n_tb*128 outputs.  No atomics; the result is
// deterministic.  A thread owns one lane (the TPU lane l), so the fold by
// sub-block is private to the thread: n_tb accumulators in registers at
// n_tb = 8, a per-thread column of shared memory at 32 and 128.  Per run
// the thread forms the run's sum, then adds it to its total, which is the
// Pallas association up to the order within a run.  At n_tb = 8 four
// slices of 128 threads split a superblock's runs and add their totals in
// a fixed order at the end.  Runs that hold only zero-valued padding are
// left out of the schedule by the wrapper (kernels/window_ell.py).
//
// Bound.  The slot streams dominate the bytes: 5.5 B/slot with sbn (f32
// value + int8 lo + half an int8 sb), 6 B/slot without, 2 B less with bf16
// values, 4 B less on a pattern plan (stream_bytes in
// tpu_spmv_torch/kernels/window_ell.py).  The gathered table is at most a
// few MB and stays in L2.  Loads are coalesced: the 128 threads of a CTA
// read 512 contiguous bytes of vals and 128 of lo per sublane.
//
// What this simple design leaves on the table: a few hundred CTAs on the
// headline and a dependent gather per slot, so few loads in flight per SM
// (no cp.async/TMA staging of the slot streams); a serial walk over each
// slice's runs, so the heaviest superblock sets a section's time; one
// launch per section with the publish copy between; and the unpermute (K2)
// as a separate pass instead of this kernel's epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kLane = 128;
constexpr int kChunks = 8;
constexpr int kWindow = kChunks * kLane;

// The value type of a pattern plan, which streams no values.
struct Pattern {};

// One slot's product: its value (f32, or bf16 converted to f32) times the
// gathered table entry; the entry alone on a pattern plan.
template <typename V>
__device__ __forceinline__ float slot_product(const V* __restrict__ vals,
                                              int64_t i, float gathered) {
  if constexpr (std::is_same_v<V, Pattern>) {
    return gathered;
  } else if constexpr (std::is_same_v<V, __nv_bfloat16>) {
    return __bfloat162float(vals[i]) * gathered;
  } else {
    return vals[i] * gathered;
  }
}

template <bool SBN>
__device__ __forceinline__ int slot_sub_block(const int8_t* __restrict__ sb,
                                              int64_t g, int s, int l) {
  if (SBN) {
    const int v = sb[((g >> 1) * kChunks + s) * kLane + l];
    return (g & 1) ? ((v >> 4) & 15) : (v & 15);
  }
  return sb[(g * kChunks + s) * kLane + l];
}

// n_tb = 8: the fold by sub-block is a select ladder into registers (the
// Pallas masked sums, one thread's lane).  The CTA has kSlices slices of
// 128 threads; slice w walks runs k0+w, k0+w+kSlices, ... of the
// superblock, and the slices' totals are added in slice order through
// shared memory at the end, so the sum order is fixed.  The run length TB
// is a template parameter so that a run's loads unroll and issue together.
// A pattern plan's sentinel (-1, or nibble 15) matches no rung of the
// ladder, so its pad slots add nothing here without a test of their own.
constexpr int kSlices = 4;

template <int NTB, bool SBN, int TB, typename V>
__global__ void __launch_bounds__(kLane * kSlices)
fold_registers(const float* __restrict__ table,
               const V* __restrict__ vals,
               const int8_t* __restrict__ lo,
               const int8_t* __restrict__ sb,
               const int32_t* __restrict__ wg,
               const int32_t* __restrict__ base,
               const int32_t* __restrict__ run_order,
               const int32_t* __restrict__ cta_ptr,
               float* __restrict__ out) {
  __shared__ float part[kSlices - 1][NTB][kLane];
  const int l = threadIdx.x % kLane;
  const int w = threadIdx.x / kLane;
  const int k0 = cta_ptr[blockIdx.x];
  const int k1 = cta_ptr[blockIdx.x + 1];
  float acc[NTB];
#pragma unroll
  for (int t = 0; t < NTB; ++t) acc[t] = 0.f;
  for (int k = k0 + w; k < k1; k += kSlices) {
    const int64_t r = run_order[k];
    float run[NTB];
#pragma unroll
    for (int t = 0; t < NTB; ++t) run[t] = 0.f;
#pragma unroll
    for (int j = 0; j < TB; ++j) {
      const int64_t g = r * TB + j;
      const float* __restrict__ win = table + int64_t(wg[g]) * kWindow;
#pragma unroll
      for (int s = 0; s < kChunks; ++s) {
        const int64_t i = (g * kChunks + s) * kLane + l;
        const float p = slot_product(vals, i, win[s * kLane + lo[i]]);
        const int target = slot_sub_block<SBN>(sb, g, s, l);
#pragma unroll
        for (int t = 0; t < NTB; ++t) run[t] += (target == t) ? p : 0.f;
      }
    }
#pragma unroll
    for (int t = 0; t < NTB; ++t) acc[t] += run[t];
  }
  if (w > 0) {
#pragma unroll
    for (int t = 0; t < NTB; ++t) part[w - 1][t][l] = acc[t];
  }
  __syncthreads();
  if (w > 0 || k0 >= k1) return;
  for (int v = 0; v < kSlices - 1; ++v) {
#pragma unroll
    for (int t = 0; t < NTB; ++t) acc[t] += part[v][t][l];
  }
  float* __restrict__ o = out + int64_t(base[run_order[k0]]) * kLane + l;
#pragma unroll
  for (int t = 0; t < NTB; ++t) o[t * kLane] = acc[t];
}

// n_tb = 32 or 128: the run sum lives in this thread's column of shared
// memory (NTB*128 floats per CTA: 16 or 64 KB), the total in the output,
// which the wrapper zeroes and this CTA alone writes.  A pattern plan's pad
// slot (sub-block -1) is skipped: it would index below the shared array.
template <int NTB, bool SBN, typename V>
__global__ void __launch_bounds__(kLane)
fold_shared(const float* __restrict__ table,
            const V* __restrict__ vals,
            const int8_t* __restrict__ lo,
            const int8_t* __restrict__ sb,
            const int32_t* __restrict__ wg,
            const int32_t* __restrict__ base,
            const int32_t* __restrict__ run_order,
            const int32_t* __restrict__ cta_ptr, int tb,
            float* __restrict__ out) {
  extern __shared__ float run_sum[];   // [NTB][kLane]
  const int l = threadIdx.x;
  const int k0 = cta_ptr[blockIdx.x];
  const int k1 = cta_ptr[blockIdx.x + 1];
  if (k0 >= k1) return;
  float* __restrict__ o = out + int64_t(base[run_order[k0]]) * kLane + l;
  for (int k = k0; k < k1; ++k) {
    const int64_t r = run_order[k];
    for (int t = 0; t < NTB; ++t) run_sum[t * kLane + l] = 0.f;
    for (int j = 0; j < tb; ++j) {
      const int64_t g = r * tb + j;
      const float* __restrict__ win = table + int64_t(wg[g]) * kWindow;
#pragma unroll
      for (int s = 0; s < kChunks; ++s) {
        const int64_t i = (g * kChunks + s) * kLane + l;
        const float p = slot_product(vals, i, win[s * kLane + lo[i]]);
        const int target = slot_sub_block<SBN>(sb, g, s, l);
        if (!std::is_same_v<V, Pattern> || target >= 0) {
          run_sum[target * kLane + l] += p;
        }
      }
    }
    for (int t = 0; t < NTB; ++t) o[t * kLane] += run_sum[t * kLane + l];
  }
}

// The arguments every launch takes, the value stream typed by the caller.
struct FoldArgs {
  const float* table;
  const void* vals;
  const int8_t* lo;
  const int8_t* sb;
  const int32_t* wg;
  const int32_t* base;
  const int32_t* run_order;
  const int32_t* cta_ptr;
  int tb;
  float* out;
};

template <int NTB, bool SBN, typename V>
cudaError_t launch_shared(dim3 grid, cudaStream_t stream, const FoldArgs& a) {
  const int smem = NTB * kLane * int(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fold_shared<NTB, SBN, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  fold_shared<NTB, SBN, V><<<grid, kLane, smem, stream>>>(
      a.table, static_cast<const V*>(a.vals), a.lo, a.sb, a.wg, a.base,
      a.run_order, a.cta_ptr, a.tb, a.out);
  return cudaSuccess;
}

template <bool SBN, typename V>
cudaError_t launch_registers(dim3 grid, cudaStream_t stream,
                             const FoldArgs& a) {
  const dim3 block(kLane * kSlices);
  const V* v = static_cast<const V*>(a.vals);
  switch (a.tb) {
    case 2:
      fold_registers<8, SBN, 2, V><<<grid, block, 0, stream>>>(
          a.table, v, a.lo, a.sb, a.wg, a.base, a.run_order, a.cta_ptr,
          a.out);
      break;
    case 4:
      fold_registers<8, SBN, 4, V><<<grid, block, 0, stream>>>(
          a.table, v, a.lo, a.sb, a.wg, a.base, a.run_order, a.cta_ptr,
          a.out);
      break;
    case 8:
      fold_registers<8, SBN, 8, V><<<grid, block, 0, stream>>>(
          a.table, v, a.lo, a.sb, a.wg, a.base, a.run_order, a.cta_ptr,
          a.out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// The kernel for one superblock height and sb packing, typed by V.
template <typename V>
cudaError_t launch_fold(dim3 grid, cudaStream_t stream, int n_tb, bool sbn,
                        const FoldArgs& a) {
  if (n_tb == 8 && sbn) return launch_registers<true, V>(grid, stream, a);
  if (n_tb == 8) return launch_registers<false, V>(grid, stream, a);
  if (n_tb == 32 && !sbn) return launch_shared<32, false, V>(grid, stream, a);
  if (n_tb == 128 && !sbn) {
    return launch_shared<128, false, V>(grid, stream, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// One launch over one plan section: n_cta output superblocks, each owning
// the runs run_order[cta_ptr[c] : cta_ptr[c+1]].  `values` names the value
// stream: 0 f32, 1 bf16, 2 none (a pattern plan; `vals` is null).  Returns
// the CUDA error of the launch (0 = launched).  Launches on `stream`; does
// not synchronize.
extern "C" int tsp_window_ell_fold(const void* table, const void* vals,
                                   const void* lo, const void* sb,
                                   const void* wg, const void* base,
                                   const void* run_order,
                                   const void* cta_ptr, int n_cta, int tb,
                                   int n_tb, int sbn, int values, void* out,
                                   void* stream) {
  if (n_cta <= 0) return 0;
  if ((values == 2) != (vals == nullptr)) return int(cudaErrorInvalidValue);
  const dim3 grid(n_cta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FoldArgs a{static_cast<const float*>(table),
                   vals,
                   static_cast<const int8_t*>(lo),
                   static_cast<const int8_t*>(sb),
                   static_cast<const int32_t*>(wg),
                   static_cast<const int32_t*>(base),
                   static_cast<const int32_t*>(run_order),
                   static_cast<const int32_t*>(cta_ptr),
                   tb,
                   static_cast<float*>(out)};
  cudaError_t err;
  switch (values) {
    case 0:
      err = launch_fold<float>(grid, st, n_tb, sbn != 0, a);
      break;
    case 1:
      err = launch_fold<__nv_bfloat16>(grid, st, n_tb, sbn != 0, a);
      break;
    case 2:
      err = launch_fold<Pattern>(grid, st, n_tb, sbn != 0, a);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
