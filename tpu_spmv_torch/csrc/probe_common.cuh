// Device code shared by the benchmark-probe kernels (probe_*.cu), which
// include this header: the window gather of one slot, the per-block sum of
// per-step partials (P4 and P5), and the owner-computes tiles of P3 and of
// P2's `w128`: a run's products (run_products) and the wide 128-target
// masked sum (masked_sum_wide, P2's `w128` and P3's `msum128`, the same
// computation).  Everything here has internal linkage, so each including
// source compiles its own copy.
//
// Layouts are the Pallas probes': a slot stream is (G*8, 128), the slots of
// group g in rows g*8 .. g*8+8; the gather table x2d is (cols8, 128), and
// slot (g, s, l) reads x2d[wg[g]*8 + s, lo[g*8+s, l]]: the lane index picks
// within the same sublane row (take_along_axis along the lanes).  A run is
// the 8 groups r*8 .. r*8+8 (the probes' TB half of a T = 16 sub-tile).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
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

// ---- owner-computes tiles (P3, and P2's w128) ----
//
// The Pallas probes keep the whole output resident in VMEM and add each
// run into it in grid order, with no atomics.  On the card the output is
// cut into tiles of a band of rows by W lanes, and one CTA owns one tile:
// CTA q + (128/W)*b owns band b and lane slice q (lanes q*W ..), the slices
// of a band adjacent.  Lanes are independent (slot (g, s, l) adds only into
// lane l), so a tile needs only its own lanes of every slot stream.  The run
// index lists, per band, the runs whose output rows touch it, in run order:
// band_runs[band_ptr[b] .. band_ptr[b+1]) (built when the inputs are made,
// probes/common.py run_index).  A CTA copies its band's list into shared
// memory, keeps its tile in registers (each element owned by one thread),
// adds the runs into each element in run order, and writes the tile once
// with plain stores: the result is bit-identical from call to call and to
// the plain version's index_add_ on the CPU.  Products and sums use
// __fmul_rn / __fadd_rn, which the compiler may not fuse into an FMA.
//
// A lane slice of a slot stream is a strided box: 64 rows of W lanes, 32 or
// 16 bytes a row of int8.  Copied 16 bytes a thread (cp.async) it was
// slower on the H100 than through the Tensor Memory Accelerator: one 2-D
// box copy per array and run (cp.async.bulk.tensor, from a CUtensorMap
// made on the host for each launch), issued by one warp stages ahead into
// a ring in shared memory, each stage counted off by an mbarrier.
//
// A thread works on one lane, so a warp reads a 32-lane row of a stage:
// every thread its own bank.  A run read by several bands (P3's sg64 runs
// span 8N rows) is read by each band's CTAs; they all walk their lists in
// run order, so they reach a run at about the same time and the second
// read comes from L2.

constexpr int kSlots = kRun * kChunks;  // 64 slots of a lane in a run
constexpr int kMaxSmem = 232448;        // a CTA's shared memory on sm_90
constexpr int kWgBytes = kRun * 4;      // a run's wg entries

__host__ __device__ constexpr int align128(int b) {
  return (b + 127) / 128 * 128;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// This thread's arrival, announcing `bytes` of copies to land.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// The box of `tm` at (lane, row) into shared memory (128-byte aligned).
__device__ __forceinline__ void box_load(void* dst, const CUtensorMap* tm,
                                         int lane, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(lane), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) into shared memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Make the barriers' initialisation visible to the copy engine; the caller
// then syncs the CTA.
__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// A 2-D tensor map of a row-major (rows, 128) array of `elem` bytes, read in
// boxes of `box_rows` rows by `lanes` lanes; zero-filled past its last row.
inline cudaError_t lane_box_map(CUtensorMap* tm, const void* base, int elem,
                                int64_t rows, int lanes, int box_rows) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return cudaErrorNotSupported;
    }
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {cuuint64_t(kLane), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(kLane) * elem};
  const cuuint32_t box[2] = {cuuint32_t(lanes), cuuint32_t(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = encode(
      tm, elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The wide masked sum: per run, a lane's 64 products summed into 128
// targets by sb (0..127, checked when the inputs are made), in slot order
// from zero, then added into output rows base[r]*128 .. +128.  A run
// touches one 128-row block, so the bands are the blocks and every slot is
// read once.  A batch is R = 128/W runs: thread (j, l) sums run j of the
// batch for lane l into its own column of run_sum (R x 128 x W floats,
// 64 KB), reading the slots from the batch's stage, 8 slots at a time (one
// shared-memory latency a group, not a chain of 8); after a barrier, thread
// (j, l) adds the R runs' sums of targets j, j+R, ... into its registers
// (the tile: 128/R floats a thread) in run order, and zeroes them.  Two
// stages of a batch (48 KB each): warp 0 puts the next batch's boxes in
// flight (vals, lo and sb of each run, and its wg) while this one is
// summed.  Bound: 6 B a slot of streams (vals, lo, sb); no atomics.
template <int W>
struct WideLayout {
  static constexpr int R = kLane / W;
  static constexpr int kVals = kSlots * W * 4, kBytes = kSlots * W;
  static constexpr int kRunBytes = kVals + 2 * kBytes + kWgBytes;
  static constexpr int kRunStage = align128(kRunBytes);
  static constexpr int kSums = R * kWide * W * 4;
  static int bytes(int max_runs) {
    return kSums + 2 * R * kRunStage + 128 + align128(4 * max_runs);
  }
};

template <int W>
__global__ void __launch_bounds__(kLane)
masked_sum_wide(const __grid_constant__ CUtensorMap tm_vals,
                const __grid_constant__ CUtensorMap tm_lo,
                const __grid_constant__ CUtensorMap tm_sb,
                const float* __restrict__ x2d,
                const int32_t* __restrict__ wg,
                const int32_t* __restrict__ band_ptr,
                const int32_t* __restrict__ band_runs, int out_rows,
                float* __restrict__ out) {
  using L = WideLayout<W>;
  constexpr int R = L::R;             // runs a batch; also lane slices
  constexpr int kOwn = kWide / R;     // targets a thread owns
  extern __shared__ __align__(128) unsigned char smem[];
  float* run_sum = reinterpret_cast<float*>(smem);  // [R][kWide][W]
  unsigned char* ring = smem + L::kSums;            // [2][R][run stage]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + 2 * R * L::kRunStage);
  int32_t* list = reinterpret_cast<int32_t*>(bars + 16);
  const int q = blockIdx.x % R, b = blockIdx.x / R;
  const int tid = threadIdx.x, j = tid / W, l = tid % W, lane = q * W + l;
  const int first = band_ptr[b], count = band_ptr[b + 1] - first;
  for (int i = tid; i < count; i += kLane) list[i] = band_runs[first + i];
  for (int i = tid; i < R * kWide * W; i += kLane) run_sum[i] = 0.f;
  if (tid < 2) bar_init(bars + tid);
  bar_fence_init();
  __syncthreads();
  auto run_stage = [&](int stage, int jj) {
    return ring + (stage * R + jj) * L::kRunStage;
  };
  auto issue = [&](int i0) {  // warp 0: batch i0's boxes
    const int n = min(R, count - i0), stage = (i0 / R) & 1;
    if (tid == 0) bar_expect(bars + stage, n * L::kRunBytes);
    __syncwarp();
    for (int c = tid; c < 4 * n; c += 32) {
      const int jj = c / 4, what = c % 4;
      const int r = list[i0 + jj];
      unsigned char* st = run_stage(stage, jj);
      if (what == 0) {
        box_load(st, &tm_vals, q * W, r * kSlots, bars + stage);
      } else if (what == 1) {
        box_load(st + L::kVals, &tm_lo, q * W, r * kSlots, bars + stage);
      } else if (what == 2) {
        box_load(st + L::kVals + L::kBytes, &tm_sb, q * W, r * kSlots,
                 bars + stage);
      } else {
        bulk_load(st + L::kVals + 2 * L::kBytes, wg + int64_t(r) * kRun,
                  kWgBytes, bars + stage);
      }
    }
  };
  float acc[kOwn];
#pragma unroll
  for (int k = 0; k < kOwn; ++k) acc[k] = 0.f;
  if (tid < 32 && count > 0) issue(0);
  for (int i0 = 0; i0 < count; i0 += R) {
    const int n = min(R, count - i0), stage = (i0 / R) & 1;
    if (tid < 32 && i0 + R < count) issue(i0 + R);
    bar_wait(bars + stage, (i0 / R / 2) & 1);
    if (j < n) {
      const unsigned char* st = run_stage(stage, j);
      const float* sv = reinterpret_cast<const float*>(st) + l;
      const int8_t* slo = reinterpret_cast<const int8_t*>(st + L::kVals) + l;
      const int8_t* ssb = slo + L::kBytes;
      const int32_t* swg = reinterpret_cast<const int32_t*>(
          st + L::kVals + 2 * L::kBytes);
      float* col = run_sum + j * kWide * W + l;
#pragma unroll
      for (int g = 0; g < kRun; ++g) {
        const float* __restrict__ win = x2d + swg[g] * kChunks * kLane;
        float p[kChunks];
        int t[kChunks];
#pragma unroll
        for (int s = 0; s < kChunks; ++s) {
          const int i = (g * kChunks + s) * W;
          p[s] = __fmul_rn(sv[i], __ldg(win + s * kLane + slo[i]));
          t[s] = ssb[i];
        }
        // the group's 8 sums read together, each slot's add taking the
        // latest earlier slot's sum where the targets are equal, the
        // stores in slot order: slot order per target, one load latency a
        // group instead of 8 chained read-modify-writes
        float r[kChunks];
#pragma unroll
        for (int s = 0; s < kChunks; ++s) r[s] = col[t[s] * W];
#pragma unroll
        for (int s = 0; s < kChunks; ++s) {
          float cur = r[s];
#pragma unroll
          for (int k = 0; k < s; ++k) cur = t[k] == t[s] ? r[k] : cur;
          r[s] = __fadd_rn(cur, p[s]);
        }
#pragma unroll
        for (int s = 0; s < kChunks; ++s) col[t[s] * W] = r[s];
      }
    }
    __syncthreads();   // the sums are in; the stage is free again
    for (int jj = 0; jj < n; ++jj) {
      float* sums = run_sum + (jj * kWide + j) * W + l;
#pragma unroll
      for (int k = 0; k < kOwn; ++k) {
        acc[k] = __fadd_rn(acc[k], sums[k * R * W]);
        sums[k * R * W] = 0.f;
      }
    }
    __syncthreads();   // run_sum is zero again
  }
  const int row0 = b * kWide;
#pragma unroll
  for (int k = 0; k < kOwn; ++k) {
    const int row = row0 + j + k * R;
    if (row < out_rows) out[int64_t(row) * kLane + lane] = acc[k];
  }
}

// Writes every row of `out` (out_rows, 128): n_bands blocks of 128 rows,
// tiles of W lanes (P3's msum128 32, P2's w128 16); max_runs, the most
// runs of a block, sizes the CTA's copy of its list; n_runs sizes the
// streams.
template <int W>
cudaError_t launch_masked_sum_wide(int n_bands, int max_runs, int n_runs,
                                   cudaStream_t stream, const float* x2d,
                                   const float* vals, const int8_t* lo,
                                   const int8_t* sb, const int32_t* wg,
                                   const int32_t* band_ptr,
                                   const int32_t* band_runs, int out_rows,
                                   float* out) {
  if (n_bands <= 0 || (n_bands - 1) * kWide >= out_rows ||
      n_bands * kWide < out_rows || max_runs < 0 || n_runs <= 0) {
    return cudaErrorInvalidValue;
  }
  const int smem = WideLayout<W>::bytes(max_runs);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int64_t rows = int64_t(n_runs) * kSlots;
  CUtensorMap tv, tl, ts;
  cudaError_t err = lane_box_map(&tv, vals, 4, rows, W, kSlots);
  if (err == cudaSuccess) err = lane_box_map(&tl, lo, 1, rows, W, kSlots);
  if (err == cudaSuccess) err = lane_box_map(&ts, sb, 1, rows, W, kSlots);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(masked_sum_wide<W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  }
  if (err != cudaSuccess) return err;
  masked_sum_wide<W><<<n_bands * (kLane / W), kLane, smem, stream>>>(
      tv, tl, ts, x2d, wg, band_ptr, band_runs, out_rows, out);
  return cudaGetLastError();
}

}  // namespace
