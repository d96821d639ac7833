// K1: the packed window-ELL fold, y_sections = A_packed · [x ++ totals].
//
// Replaces tpu_spmv/kernels/window_ell.py:1313 _build_pallas (the Pallas
// kernel; pallas_call at window_ell.py:1454, driven by _spmv_window_ell at
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
// The value stream comes in three forms, a template parameter V (the Pallas
// kernel's `pat` and `astype(f32)` branches, window_ell.py:1321-1330,
// :1362-1367, :1389):
//   float          as above;
//   __nv_bfloat16  converted with __bfloat162float at use, so products and
//                  sums stay f32 as in the Pallas kernel;
//   Pattern        no vals pointer (null): prod is the gathered table value
//                  (every stored nonzero is 1.0).  Pad slots, whose lo and
//                  wg are 0 and so gather a real x entry, carry a sentinel
//                  sub-block instead of a zero value: -1 on the int8 stream,
//                  nibble 15 on the packed one.  Neither is a sub-block of
//                  the superblock, and the kernel drops such slots.
//
// Bound.  The slot streams are the bytes: 6 B/slot (f32 value, int8 lo,
// int8 sb), 0.5 B less with the packed sb, 2 B less with bf16 values, 4 B
// less on a pattern plan (stream_bytes in kernels/window_ell.py).  The
// gathered table (x and the extras totals, 1-4 MB) stays in L2, so a
// slot's only trip out of the SM besides its stream bytes is one L2 gather.
// Little's law on this card (3.35 TB/s, about 0.7 us of loaded latency)
// asks for about 2.3 MB in flight, 18-20 KB per SM.
//
// Schedule.  The Pallas grid runs in order on one core with the whole
// output resident, and folds each run into it (`o_ref[...] += acc`).  Here
// the host cuts each output superblock's runs, in plan order, into chunks
// of at most CHUNK_RUNS runs (kernels/window_ell.py), and one launch per
// plan section runs one CTA per chunk, heaviest superblock first.  The
// sections between fin_step marks write disjoint superblocks, and each
// reads only x and the totals earlier sections published.  A chunk that
// is its superblock's only one writes the superblock's n_tb*128 outputs;
// the chunks of a split superblock each write a partial tile to the
// workspace.  After every section but the last, section_epilogue (below)
// sums those tiles in chunk order into the output and publishes the
// extras totals into the table; the last section's tiles are summed by
// K2 (csrc/unpermute.cu), the SpMV's final epilogue.  Every output is
// written by exactly one thread, with a fixed order of additions: the
// result is bit-identical from call to call.
//
// fold_chunk.  A CTA has NS slices of 128 threads (4 at n_tb 8, 2 at 32, 1
// at 128); slice w folds the chunk's runs w, w+NS, ...  A thread owns one
// lane l (the TPU lane), so the fold by sub-block is private to the
// thread: 8 accumulators in registers at n_tb 8 (a select ladder), its own
// column of the slice's n_tb*128 shared-memory tile at 32 and 128.  The
// accumulators hold the chunk's total; the slices add theirs in slice
// order at the end and the CTA writes its tile once.
//
// Loads in flight.  A run's groups are contiguous in each slot stream, so
// a slice stages them in a ring in shared memory: a stage is one group pair
// (the packed sb's unit), brought by three 1-D bulk copies (vals, lo, sb;
// cp.async.bulk with an mbarrier per stage, started by the slice's first
// thread) up to D-1 stages ahead of the fold.  D fills kRingBytes per
// slice: 2 stages of 12 KB (f32), 3 of 8 KB (bf16), 6-8 of 3-4 KB
// (pattern), so a slice keeps 12-21 KB of slot streams in flight and an SM,
// with two CTAs of 2-4 slices, 48-168 KB.  The chunk's run indices and wg
// entries are read into shared memory once, when the CTA starts.  A
// thread's fold of a stage reads lo and sb from the staged tiles and
// puts the stage's 16 gathers in flight together (TB, the run length, is a
// template parameter, so the loops unroll).
//
// What is left on the table: two launches per section (the fold, then its
// epilogue, which programmatic dependent launch overlaps with the fold's
// last CTAs), and the final epilogue (K2) as a pass of its own that reads
// the output back instead of the fold writing rows in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <type_traits>

#include "epilogue.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kChunks = 8;
constexpr int kWindow = kChunks * kLane;
constexpr int kGroupSlots = kChunks * kLane;
constexpr int kStageGroups = 2;          // a stage is one group pair
constexpr int kStageSlots = kStageGroups * kChunks;
constexpr int kRingBytes = 24 * 1024;    // a slice's ring of stages
constexpr int kMaxDepth = 8;
constexpr int kBarBytes = 256;           // the mbarriers, at most 4 x 8

// The value type of a pattern plan, which streams no values.
struct Pattern {};

template <typename V>
constexpr int value_bytes() {
  if constexpr (std::is_same_v<V, Pattern>) {
    return 0;
  } else {
    return int(sizeof(V));
  }
}

// One stage of a slice's ring: a group pair's vals, lo and sb, in order.
template <typename V, bool SBN>
struct Stage {
  static constexpr int kVals = kStageGroups * kGroupSlots * value_bytes<V>();
  static constexpr int kLo = kStageGroups * kGroupSlots;
  static constexpr int kSb = SBN ? kGroupSlots : kStageGroups * kGroupSlots;
  static constexpr int kBytes = kVals + kLo + kSb;
  static constexpr int kFit = kRingBytes / kBytes;
  static constexpr int kDepth = kFit < 2 ? 2 : kFit > kMaxDepth ? kMaxDepth
                                                                : kFit;
  static_assert(kBytes % 16 == 0, "bulk copies move multiples of 16 bytes");
  // the n_tb 8 slice totals are combined through a slice's spent ring
  static_assert(kDepth * kBytes >= 8 * kLane * 4, "ring too small");
};

template <int NTB>
constexpr int slices() {
  return NTB == 8 ? 4 : NTB == 32 ? 2 : 1;
}

// Shared memory of one CTA: mbarriers, the chunk's runs and wg entries,
// the slices' rings, then (n_tb 32 and 128) the slices' tiles.
__host__ __device__ constexpr int align128(int b) {
  return (b + 127) / 128 * 128;
}

template <int NTB, bool SBN, int TB, typename V>
struct Layout {
  static constexpr int kNS = slices<NTB>();
  static constexpr int kRing = kNS * Stage<V, SBN>::kDepth
                               * Stage<V, SBN>::kBytes;
  static constexpr int kTiles = NTB > 8 ? kNS * NTB * kLane * 4 : 0;
  static_assert(kNS * Stage<V, SBN>::kDepth * 8 <= kBarBytes, "barriers");
  __host__ __device__ static constexpr int ring_offset(int max_runs) {
    return align128(kBarBytes + 4 * max_runs * (1 + TB));
  }
  __host__ __device__ static constexpr int bytes(int max_runs) {
    return ring_offset(max_runs) + kRing + kTiles;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Arm the stage's barrier for `bytes` of bulk copies (this thread's arrival).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory; the barrier counts them off when they land.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Sync the 128 threads of slice w (named barriers 1..4; 0 is the CTA's).
__device__ __forceinline__ void slice_sync(int w) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(w + 1), "r"(kLane) : "memory");
}

// One slot's product from a staged stage: its value (f32, or bf16 converted
// to f32) times the gathered table entry; the entry alone on a pattern plan.
template <typename V>
__device__ __forceinline__ float slot_product(const unsigned char* stage,
                                              int i, float gathered) {
  if constexpr (std::is_same_v<V, Pattern>) {
    return gathered;
  } else if constexpr (std::is_same_v<V, __nv_bfloat16>) {
    return __bfloat162float(
               reinterpret_cast<const __nv_bfloat16*>(stage)[i]) *
           gathered;
  } else {
    return reinterpret_cast<const float*>(stage)[i] * gathered;
  }
}

// Fold one staged group pair into this thread's accumulators: the 16
// gathers go out together, then are added in slot order.  n_tb 8: a select
// ladder over 8 registers, which a pattern plan's sentinel (-1 or 15)
// never matches.  n_tb 32/128: the thread's column of the slice's tile
// (`col` points at row 0 of lane l), where the sentinel -1 is skipped.
template <int NTB, bool SBN, typename V>
__device__ __forceinline__ void fold_stage(const unsigned char* stage,
                                           const int32_t* wgp,
                                           const float* __restrict__ table,
                                           int l, float* acc, float* col) {
  using St = Stage<V, SBN>;
  const int8_t* slo = reinterpret_cast<const int8_t*>(stage + St::kVals);
  const int8_t* ssb = slo + St::kLo;
  float p[kStageSlots];
  int t[kStageSlots];
#pragma unroll
  for (int j = 0; j < kStageGroups; ++j) {
    const float* __restrict__ win = table + int64_t(wgp[j]) * kWindow;
#pragma unroll
    for (int s = 0; s < kChunks; ++s) {
      const int q = j * kChunks + s;
      const int i = q * kLane + l;
      p[q] = slot_product<V>(stage, i, __ldg(win + s * kLane + slo[i]));
      if (SBN) {
        const int v = ssb[s * kLane + l];
        t[q] = j ? ((v >> 4) & 15) : (v & 15);
      } else {
        t[q] = ssb[i];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kStageSlots; ++q) {
    if constexpr (NTB == 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[u] += (t[q] == u) ? p[q] : 0.f;
    } else {
      if (!std::is_same_v<V, Pattern> || t[q] >= 0) {
        col[t[q] * kLane] += p[q];
      }
    }
  }
}

template <int NTB, bool SBN, int TB, typename V>
__global__ void __launch_bounds__(kLane * slices<NTB>())
fold_chunk(const float* __restrict__ table, const V* __restrict__ vals,
           const int8_t* __restrict__ lo, const int8_t* __restrict__ sb,
           const int32_t* __restrict__ wg, const int32_t* __restrict__ base,
           const int32_t* __restrict__ run_order,
           const int32_t* __restrict__ chunk_ptr,
           const int32_t* __restrict__ chunk_slot, int max_runs,
           float* __restrict__ out, float* __restrict__ partial) {
  using St = Stage<V, SBN>;
  using L = Layout<NTB, SBN, TB, V>;
  constexpr int NS = L::kNS;
  constexpr int D = St::kDepth;
  constexpr int kPairs = TB / kStageGroups;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);              // [NS][D]
  int32_t* runs = reinterpret_cast<int32_t*>(smem + kBarBytes);    // [n]
  int32_t* wgs = runs + max_runs;                                  // [n][TB]
  unsigned char* ring = smem + L::ring_offset(max_runs);  // [NS][D][stage]
  float* tiles = reinterpret_cast<float*>(ring + L::kRing);  // [NS][NTB][128]

  const int k0 = chunk_ptr[blockIdx.x];
  const int n = chunk_ptr[blockIdx.x + 1] - k0;
  if (n <= 0) return;
  const int l = threadIdx.x % kLane;
  const int w = threadIdx.x / kLane;
  for (int i = threadIdx.x; i < n * TB; i += blockDim.x) {
    const int r = run_order[k0 + i / TB];
    wgs[i] = wg[int64_t(r) * TB + i % TB];
    if (i % TB == 0) runs[i / TB] = r;
  }
  if constexpr (NTB > 8) {
    for (int i = threadIdx.x; i < NS * NTB * kLane; i += blockDim.x) {
      tiles[i] = 0.f;
    }
  }
  if (threadIdx.x < NS * D) mbar_init(bars + threadIdx.x);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // slice w folds runs w, w + NS, ... of the chunk, a group pair a stage
  const int n_stages = (n > w ? (n - w + NS - 1) / NS : 0) * kPairs;
  uint64_t* bar = bars + w * D;
  unsigned char* sring = ring + w * D * St::kBytes;
  auto load_stage = [&](int i) {
    const int64_t g0 = int64_t(runs[w + (i / kPairs) * NS]) * TB
                       + (i % kPairs) * kStageGroups;
    unsigned char* dst = sring + (i % D) * St::kBytes;
    mbar_expect(bar + i % D, St::kBytes);
    if constexpr (St::kVals > 0) {
      bulk_load(dst, vals + g0 * kGroupSlots, St::kVals, bar + i % D);
    }
    bulk_load(dst + St::kVals, lo + g0 * kGroupSlots, St::kLo, bar + i % D);
    bulk_load(dst + St::kVals + St::kLo,
              sb + (SBN ? g0 / 2 : g0) * kGroupSlots, St::kSb, bar + i % D);
  };
  if (l == 0) {
    for (int i = 0; i < D - 1 && i < n_stages; ++i) load_stage(i);
  }
  float acc[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) acc[u] = 0.f;
  float* col = tiles + w * NTB * kLane + l;
  for (int i = 0; i < n_stages; ++i) {
    // the buffer refilled here was folded in step i - 1, before the sync
    if (l == 0 && i + D - 1 < n_stages) load_stage(i + D - 1);
    mbar_wait(bar + i % D, (i / D) & 1);
    const int32_t* wgp = wgs + (w + (i / kPairs) * NS) * TB
                         + (i % kPairs) * kStageGroups;
    fold_stage<NTB, SBN, V>(sring + (i % D) * St::kBytes, wgp, table, l, acc,
                            col);
    slice_sync(w);
  }

  const int slot = chunk_slot[blockIdx.x];
  float* __restrict__ dst =
      slot < 0 ? out + int64_t(base[runs[0]]) * kLane
               : partial + int64_t(slot) * NTB * kLane;
  if constexpr (NTB == 8) {
    // slices 1.. leave their totals in their spent rings; slice 0 adds them
    // in slice order
    float* part = reinterpret_cast<float*>(sring);
    if (w > 0) {
#pragma unroll
      for (int u = 0; u < 8; ++u) part[u * kLane + l] = acc[u];
    }
    __syncthreads();
    if (w > 0) return;
    for (int v = 1; v < NS; ++v) {
      const float* pv = reinterpret_cast<const float*>(ring + v * D
                                                       * St::kBytes);
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[u] += pv[u * kLane + l];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) dst[u * kLane + l] = acc[u];
  } else {
    __syncthreads();
    for (int i = threadIdx.x; i < NTB * kLane; i += blockDim.x) {
      float v = tiles[i];
      for (int s = 1; s < NS; ++s) v += tiles[s * NTB * kLane + i];
      dst[i] = v;
    }
  }
}

// The section epilogue: the Pallas kernel's in-VMEM `o_ref[...] += acc`
// over a superblock's runs (window_ell.py:1407-1409) and its publish of the
// extras totals into the table between sections, after the chunked fold
// of one section.  Split superblock j's output tiles, from split_base[j]
// on, are the sum, from zero and in chunk order, of the workspace rows
// split_ptr[j] .. split_ptr[j+1]-1; split_of_tile[t] is the j that owns
// tile t, or -1.  The extras region's tiles (from extras_tile on) are
// copied to the table's tail, summed first where split.
//
// Bound: a few hundred KB (the partial tiles read, the split tiles
// written, the extras region written to the table and read from `out`
// where no split superblock owns it), 0.05-0.2 us at HBM's rate: launch
// latency sets its time, which is why it
// is launched after the fold with programmatic dependent launch.  One warp
// per 128-float tile, a lane per four floats: each partial row is one
// 512-byte float4 load of the warp.  Warps 0 .. n_extras-1 take the extras
// tiles, the rest the split superblocks' tiles below the extras region, so
// every value is written by one thread; its additions are the reduce's, in
// the same order.
constexpr int kEpilogueWarps = 8;

__global__ void __launch_bounds__(kEpilogueWarps * 32)
section_epilogue(const float* __restrict__ partial,
                 const int32_t* __restrict__ split_ptr,
                 const int32_t* __restrict__ split_base,
                 const int32_t* __restrict__ split_of_tile, int n_split,
                 int n_tb, int extras_tile, int n_extras,
                 float* __restrict__ out, float* __restrict__ table_tail) {
  const int w = blockIdx.x * kEpilogueWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int t, j;
  if (w < n_extras) {
    t = extras_tile + w;
    j = split_of_tile[t];
  } else {
    const int b = w - n_extras;
    if (b >= n_split * n_tb) return;
    j = b / n_tb;
    t = split_base[j] + b % n_tb;
    if (t >= extras_tile) return;   // an extras tile: a warp above has it
  }
  int c0 = 0, c1 = 0;
  int64_t col = 0;
  if (j >= 0) {
    c0 = split_ptr[j];
    c1 = split_ptr[j + 1];
    col = int64_t(t - split_base[j]) * kLane;
  }
  const int64_t row4 = int64_t(n_tb) * kLane / 4;   // float4s a partial row
  grid_dependency_wait();
  float4* o = reinterpret_cast<float4*>(out + int64_t(t) * kLane) + lane;
  float4 v;
  if (j >= 0) {
    v = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* p = reinterpret_cast<const float4*>(
                          partial + int64_t(c0) * n_tb * kLane + col) + lane;
#pragma unroll 4
    for (int c = c0; c < c1; ++c, p += row4) {
      const float4 q = *p;
      v.x += q.x;
      v.y += q.y;
      v.z += q.z;
      v.w += q.w;
    }
    *o = v;
  } else {
    v = *o;
  }
  if (w < n_extras) {
    reinterpret_cast<float4*>(table_tail)[int64_t(w) * 32 + lane] = v;
  }
}

// The arguments every fold launch takes, the value stream typed by the
// caller.
struct FoldArgs {
  const float* table;
  const void* vals;
  const int8_t* lo;
  const int8_t* sb;
  const int32_t* wg;
  const int32_t* base;
  const int32_t* run_order;
  const int32_t* chunk_ptr;
  const int32_t* chunk_slot;
  int n_chunks;
  int max_runs;
  float* out;
  float* partial;
};

// The dynamic shared memory a kernel may take is an attribute of the
// function on the current device: a grant on one card is none on another.
// So each variant keeps its grant per device (cudaGetDevice), and raises it
// under a lock, so that two threads launching on one card never lower it.
constexpr int kMaxDevices = 64;
constexpr int kDefaultSmem = 48 * 1024;   // the default dynamic cap
std::mutex grant_lock;

template <typename Kernel>
cudaError_t grant_smem(Kernel kernel, std::atomic<int>* granted, int smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= granted[dev].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  const std::lock_guard<std::mutex> hold(grant_lock);
  if (smem <= granted[dev].load(std::memory_order_relaxed)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) granted[dev].store(smem, std::memory_order_release);
  return err;
}

template <int NTB, bool SBN, int TB, typename V>
cudaError_t launch_chunk(cudaStream_t stream, const FoldArgs& a) {
  const int smem = Layout<NTB, SBN, TB, V>::bytes(a.max_runs);
  static std::atomic<int> granted[kMaxDevices];   // 0: nothing granted
  const cudaError_t err =
      grant_smem(fold_chunk<NTB, SBN, TB, V>, granted, smem);
  if (err != cudaSuccess) return err;
  fold_chunk<NTB, SBN, TB, V><<<a.n_chunks, kLane * slices<NTB>(), smem,
                                stream>>>(
      a.table, static_cast<const V*>(a.vals), a.lo, a.sb, a.wg, a.base,
      a.run_order, a.chunk_ptr, a.chunk_slot, a.max_runs, a.out, a.partial);
  return cudaSuccess;
}

template <int NTB, bool SBN, typename V>
cudaError_t launch_tb(int tb, cudaStream_t stream, const FoldArgs& a) {
  switch (tb) {
    case 2:
      return launch_chunk<NTB, SBN, 2, V>(stream, a);
    case 4:
      return launch_chunk<NTB, SBN, 4, V>(stream, a);
    case 8:
      return launch_chunk<NTB, SBN, 8, V>(stream, a);
    default:
      return cudaErrorInvalidValue;
  }
}

// The kernel for one superblock height, sb packing and run length, typed
// by V.
template <typename V>
cudaError_t launch_fold(cudaStream_t stream, int tb, int n_tb, bool sbn,
                        const FoldArgs& a) {
  if (n_tb == 8 && sbn) return launch_tb<8, true, V>(tb, stream, a);
  if (sbn) return cudaErrorInvalidValue;
  if (n_tb == 8) return launch_tb<8, false, V>(tb, stream, a);
  if (n_tb == 32) return launch_tb<32, false, V>(tb, stream, a);
  if (n_tb == 128) return launch_tb<128, false, V>(tb, stream, a);
  return cudaErrorInvalidValue;
}

// The argument block of tsp_section_epilogue (epilogue.cuh): the section's
// SplitTiles, packed once per section, then this launch's fields.
struct SectionEpilogueArgs {
  SplitTiles split;
  const float* partial;        // the workspace, n_tb*128 floats a row
  int64_t n_tb;
  int64_t extras_tile;         // the extras region's first tile
  float* out;                  // split.n_tiles tiles of 128 floats
  float* table_tail;           // 16-byte aligned
  void* stream;                // cudaStream_t
};
static_assert(sizeof(SectionEpilogueArgs) == 11 * 8, "8-byte fields");

}  // namespace

// One launch over one plan section: n_chunks CTAs, chunk c folding the runs
// run_order[chunk_ptr[c] : chunk_ptr[c+1]] (at most max_runs, all of one
// output superblock) into `out` (chunk_slot[c] = -1) or into workspace row
// chunk_slot[c] of `partial` (n_tb*128 floats a row).  `values` names the
// value stream: 0 f32, 1 bf16, 2 none (a pattern plan; `vals` is null).
// vals, lo and sb must be 16-byte aligned.  Returns the CUDA error of the
// launch (0 = launched).  Launches on `stream`; does not synchronize.
extern "C" int tsp_window_ell_fold(
    const void* table, const void* vals, const void* lo, const void* sb,
    const void* wg, const void* base, const void* run_order,
    const void* chunk_ptr, const void* chunk_slot, int n_chunks, int max_runs,
    int tb, int n_tb, int sbn, int values, void* out, void* partial,
    void* stream) {
  if (n_chunks <= 0) return 0;
  if ((values == 2) != (vals == nullptr) || max_runs <= 0) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FoldArgs a{static_cast<const float*>(table),
                   vals,
                   static_cast<const int8_t*>(lo),
                   static_cast<const int8_t*>(sb),
                   static_cast<const int32_t*>(wg),
                   static_cast<const int32_t*>(base),
                   static_cast<const int32_t*>(run_order),
                   static_cast<const int32_t*>(chunk_ptr),
                   static_cast<const int32_t*>(chunk_slot),
                   n_chunks,
                   max_runs,
                   static_cast<float*>(out),
                   static_cast<float*>(partial)};
  cudaError_t err;
  switch (values) {
    case 0:
      err = launch_fold<float>(st, tb, n_tb, sbn != 0, a);
      break;
    case 1:
      err = launch_fold<__nv_bfloat16>(st, tb, n_tb, sbn != 0, a);
      break;
    case 2:
      err = launch_fold<Pattern>(st, tb, n_tb, sbn != 0, a);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// The section epilogue of one section: split.n_split superblocks, each
// n_tb*128 outputs wide, summed into `out`, and the tiles from extras_tile
// on published into the table's tail.  Launched with programmatic
// dependent launch.  Returns the CUDA error of the launch (0 = launched, or
// nothing to do).
extern "C" int tsp_section_epilogue(const void* block) {
  SectionEpilogueArgs a;
  memcpy(&a, block, sizeof a);
  const SplitTiles& sp = a.split;
  const int n_extras = int(sp.n_tiles - a.extras_tile);
  const int warps = n_extras + int(sp.n_split * a.n_tb);
  if (warps <= 0) return 0;
  const cudaError_t err = launch_after(
      section_epilogue, dim3((warps + kEpilogueWarps - 1) / kEpilogueWarps),
      dim3(kEpilogueWarps * 32), static_cast<cudaStream_t>(a.stream),
      a.partial, sp.split_ptr, sp.split_base, sp.split_of_tile,
      int(sp.n_split), int(a.n_tb), int(a.extras_tile), n_extras, a.out,
      a.table_tail);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}
