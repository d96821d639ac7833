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
// Design: owner-computes tiles, no atomics (probe_common.cuh).  The Pallas
// kernel keeps the (out8, 128) output resident in VMEM and adds the runs in
// grid order (proto_v4.py:87-93, out_specs at :113-114).  Here CTA
// q + 4*b owns the tile of band b (kBand = 64 rows) by lane slice q (W =
// 32 lanes), 256 threads, two CTAs an SM: thread (j, l) owns lane l of the
// tile rows j, j+8, ... (RS = 8 rows a pass), 8 floats in registers.  The
// CTA walks the runs whose 8*n_out output rows touch its band, in run
// order, two runs a step:
//
//   copies  a ring of steps' stages, one run each, filled by warp 0 through
//           the TMA steps ahead: the run's lane slice of vals and lo (a
//           64-row box each) and its wg entries, and its src rows inside
//           the band (read by this CTA only; boxes of up to 32 rows);
//   A       thread (j, l) computes each run's products of slot rows j,
//           j+RS, ... of lane l into the run's stack prod[64][W] in shared
//           memory;
//   B       thread (j, l) takes the runs in order and gathers, for each of
//           its rows a run covers, its lane of stack row sj & 63 (a warp
//           reads one 32-lane row of a stack: a bank a thread) and adds it
//           where sj < 64.
//
// A run that covers rows of several bands is read by each of their CTAs,
// which reach it at about the same time, so the repeated reads come from
// L2, and its products are computed again by each: a run of 8*n_out rows
// touches about 1 + (8*n_out - 8)/64 bands (f).  Where a run spans two
// bands or more (f >= 3: n_out 16 and 64), a products pass first computes
// each slot's product once into a scratch array (run_products, coalesced,
// 4 lanes a thread) and the tiles stream the products instead of vals, lo
// and wg, skipping phase A: 32 MB more written and read, against f times
// the gathers.  The tile (64 x 32) was
// chosen on the H100 among 128 x 32, 64 x 64 and 128 x 16; the times and
// what holds each mode back: PERF.md section 6.
//
// Every output element is added to by one thread, in run order: the result
// is bit-identical from call to call and to the plain version (index_add_
// on the CPU).  Bound: per slot 5 B of vals and lo and n_out/8 B of src
// (8 B at n_out 64), plus the run index; the 2 MB output is written once.

#include "probe_common.cuh"

namespace {

enum Mode : int { kSg64 = 0, kMsum128 = 1 };
constexpr int kThreads = 256;
constexpr int kMaxSlots = 4;    // steps the ring holds, at most
constexpr int kSmemCap = 113 * 1024;   // two CTAs an SM
constexpr int W = 32;           // sg64's tile: lanes
constexpr int kBand = 64;       // and rows
constexpr int kMsumLanes = 32;  // msum128's tile: lanes of a 128-row block
constexpr int kBatch = 64 / W;  // runs a step: 64 lanes of runs a step
constexpr int kSrcBox = 32;     // src rows a box, at most

// One stage: vals [64][W] f32 (with PRE the run's products instead), lo
// [64][W] i8 and wg [8] (not with PRE), src [src_cap][W] i8.
template <bool PRE>
struct Stage {
  static constexpr int kVals = kSlots * W * 4, kLo = PRE ? 0 : kSlots * W;
  static constexpr int kWg = PRE ? 0 : kWgBytes;
  __host__ __device__ static constexpr int bytes(int src_cap) {
    return align128(kVals + kLo + src_cap * W + kWg);
  }
};

// src rows a stage holds: the most a run covers in a band, in whole boxes.
__host__ __device__ constexpr int src_capacity(int band, int span, int box) {
  return ((band < span ? band : span) + box - 1) / box * box;
}

// The products pass (PRE): prod[r*64 + s, l] = vals * x2d[wg[g]*8 + s, lo]
// for every slot, 4 lanes a thread, each computed once.
__global__ void __launch_bounds__(256)
run_products(const float* __restrict__ x2d, const float* __restrict__ vals,
             const int8_t* __restrict__ lo, const int32_t* __restrict__ wg,
             int64_t n_quads, float* __restrict__ prod) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_quads) return;
  const int64_t row = i / (kLane / 4);     // slot row g*8 + s
  const float4 v = reinterpret_cast<const float4*>(vals)[i];
  const char4 c = reinterpret_cast<const char4*>(lo)[i];
  const float* __restrict__ win =
      x2d + (int64_t(wg[row / kChunks]) * kChunks + row % kChunks) * kLane;
  float4 p;
  p.x = __fmul_rn(v.x, __ldg(win + c.x));
  p.y = __fmul_rn(v.y, __ldg(win + c.y));
  p.z = __fmul_rn(v.z, __ldg(win + c.z));
  p.w = __fmul_rn(v.w, __ldg(win + c.w));
  reinterpret_cast<float4*>(prod)[i] = p;
}

template <bool PRE>
__global__ void __launch_bounds__(kThreads)
scatter_tiles(const __grid_constant__ CUtensorMap tm_vals,
              const __grid_constant__ CUtensorMap tm_lo,
              const __grid_constant__ CUtensorMap tm_src,
              const float* __restrict__ x2d, const int32_t* __restrict__ wg,
              const int32_t* __restrict__ base,
              const int32_t* __restrict__ band_ptr,
              const int32_t* __restrict__ band_runs, int out_rows,
              int n_out, int src_box, int n_slots, float* __restrict__ out) {
  using St = Stage<PRE>;
  constexpr int RS = kThreads / W;        // tile rows a pass
  constexpr int kOwn = kBand / RS;        // tile rows a thread
  constexpr int kMine = kSlots / RS;      // products a thread, a run
  constexpr int kSlices = kLane / W;
  constexpr int kStacks = PRE ? 0 : kBatch * kSlots * W * 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int span = n_out * kChunks;       // output rows of a run
  const int src_bytes = src_capacity(kBand, span, src_box) * W;
  const int stage = St::bytes(src_bytes / W);
  float* prod = reinterpret_cast<float*>(smem);   // [kBatch][64][W]
  unsigned char* ring = smem + kStacks;           // [n_slots][kBatch]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + n_slots * kBatch *
                                                          stage);
  int32_t* runs = reinterpret_cast<int32_t*>(bars + n_slots * kBatch);
  const int q = blockIdx.x % kSlices, b = blockIdx.x / kSlices;
  const int tid = threadIdx.x, j = tid / W, l = tid % W, lane = q * W + l;
  const int row0 = b * kBand, rows = min(kBand, out_rows - row0);
  const int first = band_ptr[b], count = band_ptr[b + 1] - first;
  const int n_batches = (count + kBatch - 1) / kBatch;
  int32_t* tops = runs + count;   // tile row of each run's first row
  for (int i = tid; i < count; i += kThreads) {
    const int r = band_runs[first + i];
    runs[i] = r;
    tops[i] = base[r] * kChunks - row0;
  }
  if (tid < n_slots * kBatch) bar_init(bars + tid);
  bar_fence_init();
  __syncthreads();
  // run k0 + jj of batch i sits in stage (i % n_slots) * kBatch + jj
  auto issue = [&](int i) {  // warp 0: the boxes of batch i
    const int k0 = i * kBatch, n = min(kBatch, count - k0);
    for (int jj = 0; jj < n; ++jj) {
      const int k = k0 + jj, at = (i % n_slots) * kBatch + jj;
      unsigned char* st = ring + at * stage;
      uint64_t* bar = bars + at;
      const int r = runs[k], top = tops[k], t0 = max(top, 0);
      const int boxes = (max(min(top + span, rows) - t0, 0) + src_box - 1) /
                        src_box;
      if (tid == 0) {
        bar_expect(bar, St::kVals + St::kLo + boxes * src_box * W + St::kWg);
      }
      __syncwarp();
      for (int c = tid; c < 3 + boxes; c += 32) {
        if (c == 0) {
          box_load(st, &tm_vals, q * W, r * kSlots, bar);
        } else if (c == 1) {
          if (!PRE) box_load(st + St::kVals, &tm_lo, q * W, r * kSlots, bar);
        } else if (c == 2) {
          if (!PRE) {
            bulk_load(st + St::kVals + St::kLo + src_bytes,
                      wg + int64_t(r) * kRun, kWgBytes, bar);
          }
        } else {
          const int c3 = c - 3;
          box_load(st + St::kVals + St::kLo + c3 * src_box * W, &tm_src,
                   q * W, r * span + t0 - top + c3 * src_box, bar);
        }
      }
    }
  };
  float acc[kOwn];
#pragma unroll
  for (int u = 0; u < kOwn; ++u) acc[u] = 0.f;
  if (tid < 32) {
    for (int i = 0; i < min(n_slots - 1, n_batches); ++i) issue(i);
  }
  for (int i = 0; i < n_batches; ++i) {
    const int k0 = i * kBatch, n = min(kBatch, count - k0);
    __syncthreads();   // every thread is past batch i-1: its slot is free
    if (tid < 32 && i + n_slots - 1 < n_batches) issue(i + n_slots - 1);
    const unsigned char* slot = ring + (i % n_slots) * kBatch * stage;
    for (int jj = 0; jj < n; ++jj) {
      bar_wait(bars + (i % n_slots) * kBatch + jj, (i / n_slots) & 1);
    }
    if (!PRE) {
      // phase A: the batch's products, prod[jj][s][l]
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        if (jj < n) {
          const unsigned char* st = slot + jj * stage;
          const float* sv = reinterpret_cast<const float*>(st);
          const int8_t* slo = reinterpret_cast<const int8_t*>(st + St::kVals);
          const int32_t* swg = reinterpret_cast<const int32_t*>(
              slo + St::kLo + src_bytes);
          float p[kMine];
#pragma unroll
          for (int m = 0; m < kMine; ++m) {
            const int s = j + RS * m, e = s * W + l;
            p[m] = __fmul_rn(sv[e], __ldg(x2d + (swg[s / kChunks] * kChunks +
                                                 s % kChunks) * kLane +
                                          slo[e]));
          }
#pragma unroll
          for (int m = 0; m < kMine; ++m) {
            prod[(jj * kSlots + j + RS * m) * W + l] = p[m];
          }
        }
      }
      __syncthreads();
    }
    // phase B: the batch's runs in order, each element by its owner
#pragma unroll
    for (int jj = 0; jj < kBatch; ++jj) {
      if (jj < n) {
        const unsigned char* st = slot + jj * stage;
        const int8_t* ssrc =
            reinterpret_cast<const int8_t*>(st + St::kVals + St::kLo);
        const float* stack = (PRE ? reinterpret_cast<const float*>(st)
                                  : prod + jj * kSlots * W) + l;
        const int top = tops[k0 + jj], t0 = max(top, 0);
        const int t1 = min(top + span, rows);
        int sj[kOwn];
#pragma unroll
        for (int u = 0; u < kOwn; ++u) {
          const int t = j + RS * u;
          sj[u] = (t >= t0 && t < t1) ? int(ssrc[(t - t0) * W + l]) : kSlots;
        }
#pragma unroll
        for (int u = 0; u < kOwn; ++u) {
          if (sj[u] < kSlots) {
            acc[u] = __fadd_rn(acc[u], stack[(sj[u] & (kSlots - 1)) * W]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kOwn; ++u) {
    const int t = j + RS * u;
    if (t < rows) out[int64_t(row0 + t) * kLane + lane] = acc[u];
  }
}

// With `prod` (PRE): the products pass into it, then the tiles from it.
template <bool PRE>
cudaError_t launch_scatter_tiles(int n_bands, int max_runs, int n_runs,
                                 cudaStream_t stream, const float* x2d,
                                 const float* vals, const int8_t* lo,
                                 const int8_t* src, const int32_t* wg,
                                 const int32_t* base, const int32_t* band_ptr,
                                 const int32_t* band_runs, int out_rows,
                                 int n_out, float* prod, float* out) {
  using St = Stage<PRE>;
  const int span = n_out * kChunks;
  const int src_box = span < kSrcBox ? span : kSrcBox;
  // as many batch slots of stages as fit beside the stacks and the list
  const int fixed = (PRE ? 0 : kBatch * kSlots * W * 4) + 8 * max_runs;
  const int per_slot =
      kBatch * (St::bytes(src_capacity(kBand, span, src_box)) + 8);
  const int n_slots = min(kMaxSlots, (kSmemCap - fixed) / per_slot);
  if (n_slots < 2) return cudaErrorInvalidValue;
  const int smem = fixed + n_slots * per_slot;
  const int64_t rows = int64_t(n_runs) * kSlots;
  CUtensorMap tv, tl, ts;
  cudaError_t err =
      lane_box_map(&tv, PRE ? static_cast<const void*>(prod) : vals, 4, rows,
                   W, kSlots);
  if (err == cudaSuccess) err = lane_box_map(&tl, lo, 1, rows, W, kSlots);
  if (err == cudaSuccess) {
    err = lane_box_map(&ts, src, 1, int64_t(n_runs) * span, W, src_box);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(scatter_tiles<PRE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  }
  if (err != cudaSuccess) return err;
  if (PRE) {
    const int64_t quads = rows * (kLane / 4);
    run_products<<<int((quads + 255) / 256), 256, 0, stream>>>(
        x2d, vals, lo, wg, quads, prod);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  scatter_tiles<PRE>
      <<<n_bands * (kLane / W), kThreads, smem, stream>>>(
          tv, tl, ts, x2d, wg, base, band_ptr, band_runs, out_rows, n_out,
          src_box, n_slots, out);
  return cudaGetLastError();
}

}  // namespace

// One probe call: writes every row of `out` (out_rows, 128) from n_runs
// runs.  The run index (band_ptr: n_bands + 1 offsets into band_runs;
// max_runs, the most runs of a band) cuts the output into bands: sg64's of
// 64 rows, in tiles of 32 lanes, with `prod` (n_runs*64 x 128 f32 scratch)
// the products pass first; msum128's of 128 rows (a run's block), in tiles
// of 32 lanes.  mode: 0 sg64 (n_out planes per run, src read), 1 msum128
// (sb read, src not).  Returns the CUDA error of the launch (0 =
// launched); launches on `stream`, does not synchronize.
extern "C" int tsp_probe_proto_v4(const void* x2d, const void* vals,
                                  const void* lo, const void* sb,
                                  const void* src, const void* wg,
                                  const void* base, const void* band_ptr,
                                  const void* band_runs, int n_bands,
                                  int max_runs, int n_runs, int out_rows,
                                  int n_out, int mode, void* prod, void* out,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(x2d);
  const auto* v = static_cast<const float*>(vals);
  const auto* lo8 = static_cast<const int8_t*>(lo);
  const auto* wg32 = static_cast<const int32_t*>(wg);
  const auto* b32 = static_cast<const int32_t*>(base);
  const auto* ptr = static_cast<const int32_t*>(band_ptr);
  const auto* runs = static_cast<const int32_t*>(band_runs);
  auto* o = static_cast<float*>(out);
  if (mode == kMsum128) {
    return int(launch_masked_sum_wide<kMsumLanes>(
        n_bands, max_runs, n_runs, st, x, v, lo8,
        static_cast<const int8_t*>(sb), wg32, ptr, runs, out_rows, o));
  }
  if (mode != kSg64 || n_out <= 0 || max_runs < 0 || n_runs <= 0 ||
      n_bands <= 0 || (n_bands - 1) * kBand >= out_rows ||
      n_bands * kBand < out_rows) {
    return int(cudaErrorInvalidValue);
  }
  const auto* s8 = static_cast<const int8_t*>(src);
  auto* pr = static_cast<float*>(prod);
  return int(pr ? launch_scatter_tiles<true>(n_bands, max_runs, n_runs, st,
                                             x, v, lo8, s8, wg32, b32, ptr,
                                             runs, out_rows, n_out, pr, o)
                : launch_scatter_tiles<false>(n_bands, max_runs, n_runs, st,
                                              x, v, lo8, s8, wg32, b32, ptr,
                                              runs, out_rows, n_out, pr, o));
}
