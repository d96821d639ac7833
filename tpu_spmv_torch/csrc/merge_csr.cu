// K4: the merge-path CSR SpMV, y = A·x straight from the CSR arrays.
//
// Replaces no TPU kernel.  The JAX package serves VECTOR_CSR and MERGE_PATH
// through the window-ELL layout (K1), which packs each 1024-row x 1024-column
// tile of the matrix into groups of 8 x 128 slots, one output row a lane.
// On a matrix whose tiles hold a few dozen nonzeros (Graph500's permuted
// labels: about 30 a tile at SCALE 20) the plan streams ten slots a nonzero,
// and K1's time follows the slots.  K4 is the merge-based CSR SpMV of
// Merrill & Garland (SC16), which the original CUDA reference shipped as
// MERGE_PATH: no padding, every nonzero read once.  The dispatch serves it
// where the planner's packing model predicts that window-ELL pads more than
// K4 costs (tpu_spmv_torch/spmv.py, merge_route).
//
// Bound.  The streams are the bytes: 8 B a nonzero (int32 column, f32
// value; 4 B on a pattern plan), 4 B a row end and 4 B a row of y written.
// x (4 MB at 2^20 columns) stays in the 50 MB L2, so a nonzero's only other
// trip out of the SM is one gather of a 32-byte L2 sector, read through the
// read-only path (L1 keeps the hub columns that repeat).
//
// Split.  The merge path walks the row ends and the nonzeros as one list of
// rows + nnz items (a row's nonzeros, then its end).  The host
// (kernels/merge_csr.py, merge_starts) cuts it once, at plan time, into
// n_ctas equal shares (to within one item), one a CTA, and each share into
// `tiles` tiles of at most kTile items; tile_row/tile_nz hold every tile's
// start coordinate, so no call searches for a CTA's start.  The grid is
// one wave: as many CTAs as the card holds at once (tsp_merge_csr_ctas),
// each walking its tiles in order.
//
// Streams.  A tile's row ends (row_end = row_ptr[1:]), columns and values
// are contiguous, so thread 0 brings them into a ring of kDepth stages in
// shared memory with 1-D bulk copies (cp.async.bulk, one mbarrier a stage),
// the next tile's while the CTA works on this one: a stage is up to 16 KB
// (f32), and a card's CTAs keep 60-100 KB a SM in flight.  The copies cover
// the 16-byte aligned span around each range, so the arrays are padded to a
// multiple of 4 entries (row_end past num_rows with nnz).
//
// A tile.  (1) Products: thread t takes nonzeros t, t + 256, ... (8 at
// most, their gathers in flight together) and writes val * x[col] over the
// staged column.  (2) Merge: thread t takes the tile's items 8t .. 8t+7,
// finds its start by a binary search of the staged row ends, and walks
// them: a nonzero adds its product to the running sum, a row end closes
// the row's part.  (3) Carries: a segmented scan of (row, running sum)
// over the CTA's threads (shuffles in a warp, the 8 warp totals in warp
// order) gives each thread the part of its first row from the threads
// before it, and from the CTA's earlier tiles (the tile carry); a thread
// writes each row it closes, once, to y in the matrix's own row order.
// Empty rows are closed with 0.  A row open at the CTA's last item leaves
// its part in the CTA's carry slot (carry_row, carry_val), and
// merge_fixup, launched after with programmatic dependent launch, adds each
// run of carries of one row, in CTA order, to the row.  No atomics: the
// order of every addition is fixed by the plan's split, so two calls on
// one x are bit-identical.  A call is these two launches.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                     // merge items a thread a tile
constexpr int kTile = kThreads * kItems;      // merge items a tile
constexpr int kDepth = 2;                     // stages in a CTA's ring
constexpr int kHead = 128;                    // the stages' mbarriers
constexpr int kFixupThreads = 256;

// The value type of a pattern plan, which streams no values.
struct Pattern {};

// One stage: the tile's row ends then its columns (the products are
// written over the columns), then its values.  Each range is copied from
// the 16-byte boundary at or below its start to the one at or above its
// end: at most 3 + 3 entries more than it holds, and row ends plus
// nonzeros are at most kTile + 1.
template <typename V>
struct Stage {
  static constexpr int kCols = (kTile + 16) * 4;
  static constexpr int kVals =
      std::is_same_v<V, Pattern> ? 0 : (kTile + 8) * 4;
  static constexpr int kBytes = kCols + kVals;
  // the ring, then the warps' scan totals and the tile carry (two slots)
  static constexpr int kSmem = kHead + kDepth * kBytes + kWarps * 8 + 16;
  static_assert(kBytes % 16 == 0, "bulk copies move multiples of 16 bytes");
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

// A nonzero's product: its value (f32) times the gathered x entry; the
// entry alone on a pattern plan (x already column-scaled by the caller).
template <typename V>
__device__ __forceinline__ float product(const float* vals, int j, float g) {
  if constexpr (std::is_same_v<V, Pattern>) {
    return g;
  } else {
    return vals[j] * g;
  }
}

// The segmented sum's operator over (row, part): the later row's part, plus
// the earlier part where the two are of one row.
__device__ __forceinline__ float join(int k0, float v0, int k1, float v1) {
  return k0 == k1 ? v0 + v1 : v1;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
merge_csr(const int32_t* __restrict__ row_end,
          const int32_t* __restrict__ cols, const float* __restrict__ vals,
          const float* __restrict__ x, const int32_t* __restrict__ tile_row,
          const int32_t* __restrict__ tile_nz, int tiles, int num_rows,
          float* __restrict__ y, int32_t* __restrict__ carry_row,
          float* __restrict__ carry_val) {
  using St = Stage<V>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kHead;
  int32_t* wkey = reinterpret_cast<int32_t*>(ring + kDepth * St::kBytes);
  float* wval = reinterpret_cast<float*>(wkey + kWarps);
  float* tile_carry = wval + kWarps;   // [2]: read at step i from slot i & 1
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = blockIdx.x * tiles;

  // thread 0: bring tile t0 + i into stage i % kDepth
  auto fetch = [&](int i) {
    const int t = t0 + i;
    const int r0 = tile_row[t], r1 = tile_row[t + 1];
    const int k0 = tile_nz[t], k1 = tile_nz[t + 1];
    const int e0 = r0 & ~3, ne = ((r1 + 4) & ~3) - e0;   // row_end[r0..r1]
    const int c0 = k0 & ~3, nc = ((k1 + 3) & ~3) - c0;   // [k0, k1)
    unsigned char* st = ring + (i % kDepth) * St::kBytes;
    uint64_t* bar = bars + i % kDepth;
    // the stage was last written by this CTA's threads (the products):
    // order those writes before the copies that overwrite them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(bar, uint32_t(ne + (St::kVals ? 2 : 1) * nc) * 4u);
    bulk_load(st, row_end + e0, uint32_t(ne) * 4u, bar);
    if (nc > 0) {
      bulk_load(st + ne * 4, cols + c0, uint32_t(nc) * 4u, bar);
      if constexpr (St::kVals > 0) {
        bulk_load(st + St::kCols, vals + c0, uint32_t(nc) * 4u, bar);
      }
    }
  };

  if (tid < kDepth) mbar_init(bars + tid);
  if (tid == 0) tile_carry[0] = 0.f;
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < kDepth - 1 && i < tiles; ++i) fetch(i);
  }

  int r1 = 0;
  for (int i = 0; i < tiles; ++i) {
    // the stage refilled here was read in step i - 1, before its last sync
    if (tid == 0 && i + kDepth - 1 < tiles) fetch(i + kDepth - 1);
    const int t = t0 + i;
    const int r0 = tile_row[t], k0 = tile_nz[t], k1 = tile_nz[t + 1];
    r1 = tile_row[t + 1];
    const int n_rows = r1 - r0, n_nz = k1 - k0, items = n_rows + n_nz;
    unsigned char* st = ring + (i % kDepth) * St::kBytes;
    const int ne = ((r1 + 4) & ~3) - (r0 & ~3);
    const int32_t* ends = reinterpret_cast<const int32_t*>(st) + (r0 & 3);
    int32_t* scol = reinterpret_cast<int32_t*>(st) + ne + (k0 & 3);
    float* prod = reinterpret_cast<float*>(scol);
    const float* sval = reinterpret_cast<const float*>(st + St::kCols)
                        + (k0 & 3);
    const float carry = tile_carry[i & 1];
    mbar_wait(bars + i % kDepth, (i / kDepth) & 1);

    // (1) products, the gathers in flight together
    float g[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int j = tid + it * kThreads;
      g[it] = j < n_nz ? __ldg(x + scol[j]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int j = tid + it * kThreads;
      if (j < n_nz) prod[j] = product<V>(sval, j, g[it]);
    }
    __syncthreads();

    // (2) the thread's items: its start by the merge-path search, then
    // nonzeros summed in order and rows closed
    const int d0 = min(tid * kItems, items);
    const int d1 = min(d0 + kItems, items);
    int lo = max(0, d0 - n_nz), hi = min(d0, n_rows);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ends[mid] - k0 <= d0 - mid - 1) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int first = lo;
    int row = lo, nz = d0 - lo;
    float run = 0.f;
    float closed[kItems];
    uint32_t closes = 0;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (d0 + it < d1) {
        if (nz < ends[row] - k0) {
          run += prod[nz];
          ++nz;
        } else {
          closed[it] = run;
          closes |= 1u << it;
          run = 0.f;
          ++row;
        }
      }
    }

    // (3) the segmented scan of (row, run): in the warp, then the warps'
    // totals in warp order after the tile carry (row 0 of the tile)
    int key = row;
    float val = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int k2 = __shfl_up_sync(0xffffffffu, key, o);
      const float v2 = __shfl_up_sync(0xffffffffu, val, o);
      if (lane >= o) val = join(k2, v2, key, val);
    }
    const int ek = __shfl_up_sync(0xffffffffu, key, 1);
    const float ev = __shfl_up_sync(0xffffffffu, val, 1);
    if (lane == 31) {
      wkey[warp] = key;
      wval[warp] = val;
    }
    __syncthreads();
    int pk = 0;
    float pv = carry;
    for (int w = 0; w < warp; ++w) {
      pv = join(pk, pv, wkey[w], wval[w]);
      pk = wkey[w];
    }
    // the part of row `first` from before this thread
    const float before = lane == 0 ? pv : join(pk, pv, ek, ev);
    int r = r0 + first;
    bool head = true;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (closes >> it & 1u) {
        y[r] = head ? before + closed[it] : closed[it];
        head = false;
        ++r;
      }
    }
    if (tid == kThreads - 1) tile_carry[(i + 1) & 1] = join(pk, pv, key, val);
    __syncthreads();
  }
  if (tid == kThreads - 1) {
    carry_row[blockIdx.x] = r1 < num_rows ? r1 : -1;
    carry_val[blockIdx.x] = tile_carry[tiles & 1];
  }
}

// The fix-up: the head of each run of carry slots of one row (CTA order)
// sums the run in order and adds it to the row the last CTA closed.
__global__ void __launch_bounds__(kFixupThreads)
merge_fixup(const int32_t* __restrict__ carry_row,
            const float* __restrict__ carry_val, int n,
            float* __restrict__ y) {
  grid_dependency_wait();
  const int c = blockIdx.x * kFixupThreads + threadIdx.x;
  if (c >= n) return;
  const int r = carry_row[c];
  if (r < 0 || (c > 0 && carry_row[c - 1] == r)) return;
  float v = carry_val[c];
  for (int e = c + 1; e < n && carry_row[e] == r; ++e) v += carry_val[e];
  y[r] += v;
}

template <typename V>
cudaError_t launch(const int32_t* row_end, const int32_t* cols,
                   const float* vals, const float* x, const int32_t* tile_row,
                   const int32_t* tile_nz, int n_ctas, int tiles,
                   int num_rows, float* y, int32_t* carry,
                   cudaStream_t stream) {
  int32_t* carry_row = carry;
  float* carry_val = reinterpret_cast<float*>(carry + n_ctas);
  merge_csr<V><<<n_ctas, kThreads, Stage<V>::kSmem, stream>>>(
      row_end, cols, vals, x, tile_row, tile_nz, tiles, num_rows, y,
      carry_row, carry_val);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_ctas == 1) return err;
  return launch_after(merge_fixup,
                      dim3((n_ctas + kFixupThreads - 1) / kFixupThreads),
                      dim3(kFixupThreads), stream, carry_row, carry_val,
                      n_ctas, y);
}


// K5: the merge-path CSR SpMM, Y = A·H for a dense row-major H of
// num_cols x k (a graph network's node features, several right-hand
// sides): the same split of the merge path as K4, each item now k wide.
//
// Bound.  H (2 GiB at 2^21 rows x 256 f32) is far past the 50 MB L2, and a
// graph's permuted labels give its rows no locality, so each nonzero's
// gather of the k-wide row H[col, :] (1 KB at k = 256) is a trip to HBM
// unless the row is a hub's, which the L2 keeps: hub rows are the only
// reuse.  The index and value streams (8 B a nonzero) and the row ends are
// under 1% of the bytes; Y (rows x k) is written once, with streaming
// stores so that it does not push H's hub rows out of the L2.  The least
// time is the byte model (nnz·8 + (rows+1)·4 + cols·k·4 + rows·k·4) at the
// card's bandwidth; what paces the kernel is the gathers of H that miss
// the L2, and how many of them are in flight.
//
// Split.  The host (kernels/merge_csr.py, spmm_from_host) cuts the merge
// path of rows + nnz items into n_shares equal shares (merge_starts, as
// for K4), one a warp: a share's items each cost k multiply-adds (a
// nonzero) or one k-wide store (a row end), so a share is sized in warps,
// a few shares for each warp the card holds at once, not in CTAs.
//
// A share.  The warp's lanes span the k columns (blockIdx.y picks a block
// of 32 * V of them): lane l takes columns l, l + 32, ... in units T of
// 16 bytes (float4) where k is a multiple of 4 and H is 16-byte aligned,
// else of one float.  The lanes hold the next 32 row ends and the next 32
// (column, value) pairs of the share, read straight from the CSR arrays
// (coalesced; no staging), and hand each out by a shuffle.  A row's
// nonzeros are taken kSpmmUnroll at a time, their rows of H loaded
// together before the multiply-adds, so each lane keeps kSpmmUnroll * V
// 16-byte loads in flight.  The running sum of the row stays in registers;
// a row the share closes is written once, whole, to Y.  The row open at
// the share's end leaves its part, k wide, in the share's carry
// (carry_row, carry_val); spmm_fixup, launched after with programmatic
// dependent launch, adds each run of carries of one row, in share order,
// to the row.  Each row's sum is taken in the order of its nonzeros and
// no atomics are used, so two calls on one H give the same bits.

constexpr int kSpmmThreads = 256;
constexpr int kSpmmWarps = kSpmmThreads / 32;
constexpr int kSpmmUnroll = 4;     // nonzeros whose rows of H are in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void madd(float& acc, float w, float g) {
  acc = fmaf(w, g, acc);
}
__device__ __forceinline__ void madd(float4& acc, float w, float4 g) {
  acc.x = fmaf(w, g.x, acc.x);
  acc.y = fmaf(w, g.y, acc.y);
  acc.z = fmaf(w, g.z, acc.z);
  acc.w = fmaf(w, g.w, acc.w);
}
__device__ __forceinline__ void add_to(float& acc, float v) { acc += v; }
__device__ __forceinline__ void add_to(float4& acc, float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}
template <typename T>
__device__ __forceinline__ T zero() {
  return T{};
}

// V units T of a row a lane; width: k in units T (the row stride of H and
// Y).  tile_row/tile_nz as K4's plan gives them: share s starts at tile
// s * tiles and ends where share s + 1 starts.
template <typename T, int V>
__global__ void __launch_bounds__(kSpmmThreads)
merge_spmm(const int32_t* __restrict__ row_end,
           const int32_t* __restrict__ cols, const float* __restrict__ vals,
           const T* __restrict__ h, const int32_t* __restrict__ tile_row,
           const int32_t* __restrict__ tile_nz, int tiles, int n_shares,
           int num_rows, int width, T* __restrict__ y,
           int32_t* __restrict__ carry_row, T* __restrict__ carry_val) {
  const int lane = threadIdx.x & 31;
  const int share = blockIdx.x * kSpmmWarps + (threadIdx.x >> 5);
  if (share >= n_shares) return;
  int r = tile_row[share * tiles], j = tile_nz[share * tiles];
  const int r1 = tile_row[(share + 1) * tiles];
  const int j1 = tile_nz[(share + 1) * tiles];
  int col[V];
  bool live[V];
  T acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    col[v] = blockIdx.y * 32 * V + v * 32 + lane;
    live[v] = col[v] < width;
    acc[v] = zero<T>();
  }
  // the held batches: row ends rb .. rb + 31, nonzeros jb .. jb + 31
  int rb = r, jb = j;
  int ev = rb + lane < r1 ? row_end[rb + lane] : 0;
  int cv = jb + lane < j1 ? cols[jb + lane] : 0;
  float fv = jb + lane < j1 ? vals[jb + lane] : 0.f;
  for (;;) {
    const int e = r < r1 ? __shfl_sync(kFull, ev, r - rb) : j1;
    while (j < e) {
      const int n = min(e, jb + 32) - j;   // of this row, in the batch
      for (int u0 = 0; u0 < n; u0 += kSpmmUnroll) {
        T g[kSpmmUnroll][V];
        float w[kSpmmUnroll];
#pragma unroll
        for (int u = 0; u < kSpmmUnroll; ++u) {
          const int s = (j - jb + u0 + u) & 31;
          const int c = __shfl_sync(kFull, cv, s);
          w[u] = __shfl_sync(kFull, fv, s);
          const T* hr = h + size_t(c) * size_t(width);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            g[u][v] = u0 + u < n && live[v] ? __ldg(hr + col[v]) : zero<T>();
          }
        }
#pragma unroll
        for (int u = 0; u < kSpmmUnroll; ++u) {
          if (u0 + u < n) {
#pragma unroll
            for (int v = 0; v < V; ++v) madd(acc[v], w[u], g[u][v]);
          }
        }
      }
      j += n;
      if (j == jb + 32) {
        jb = j;
        cv = jb + lane < j1 ? cols[jb + lane] : 0;
        fv = jb + lane < j1 ? vals[jb + lane] : 0.f;
      }
    }
    if (r == r1) break;
    T* yr = y + size_t(r) * size_t(width);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (live[v]) __stcs(yr + col[v], acc[v]);
      acc[v] = zero<T>();
    }
    if (++r - rb == 32) {
      rb = r;
      ev = rb + lane < r1 ? row_end[rb + lane] : 0;
    }
  }
  if (blockIdx.y == 0 && lane == 0) {
    carry_row[share] = r1 < num_rows ? r1 : -1;
  }
  T* cr = carry_val + size_t(share) * size_t(width);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (live[v]) cr[col[v]] = acc[v];
  }
}

// K5's fix-up: a warp a share; the head of each run of carries of one row
// (share order) sums the run in order, column by column, and adds it to
// the row the last share of the run closed.
template <typename T>
__global__ void __launch_bounds__(kSpmmThreads)
spmm_fixup(const int32_t* __restrict__ carry_row,
           const T* __restrict__ carry_val, int n, int width,
           T* __restrict__ y) {
  grid_dependency_wait();
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kSpmmWarps + (threadIdx.x >> 5);
  if (c >= n) return;
  const int r = carry_row[c];
  if (r < 0 || (c > 0 && carry_row[c - 1] == r)) return;
  int last = c + 1;
  while (last < n && carry_row[last] == r) ++last;
  T* yr = y + size_t(r) * size_t(width);
  for (int t = lane; t < width; t += 32) {
    T v = carry_val[size_t(c) * size_t(width) + t];
    for (int e = c + 1; e < last; ++e) {
      add_to(v, carry_val[size_t(e) * size_t(width) + t]);
    }
    T out = yr[t];
    add_to(out, v);
    yr[t] = out;
  }
}

template <typename T, int V>
cudaError_t launch_spmm(const int32_t* row_end, const int32_t* cols,
                        const float* vals, const float* h,
                        const int32_t* tile_row, const int32_t* tile_nz,
                        int n_shares, int tiles, int num_rows, int width,
                        float* y, int32_t* carry_row, float* carry_val,
                        cudaStream_t stream) {
  const dim3 grid((n_shares + kSpmmWarps - 1) / kSpmmWarps,
                  (width + 32 * V - 1) / (32 * V));
  auto* ht = reinterpret_cast<const T*>(h);
  auto* yt = reinterpret_cast<T*>(y);
  auto* ct = reinterpret_cast<T*>(carry_val);
  merge_spmm<T, V><<<grid, kSpmmThreads, 0, stream>>>(
      row_end, cols, vals, ht, tile_row, tile_nz, tiles, n_shares, num_rows,
      width, yt, carry_row, ct);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_shares == 1) return err;
  return launch_after(spmm_fixup<T>,
                      dim3((n_shares + kSpmmWarps - 1) / kSpmmWarps),
                      dim3(kSpmmThreads), stream, carry_row,
                      static_cast<const T*>(ct), n_shares, width, yt);
}

}  // namespace

// One SpMV: n_ctas CTAs of `tiles` tiles each (tile_row/tile_nz: the
// n_ctas * tiles + 1 tile starts), then, where n_ctas > 1, the fix-up.
// `vals` null: a pattern plan.  row_end holds a multiple of 4 entries, at
// least num_rows + 1 (nnz past num_rows); cols and vals a multiple of 4, at
// least nnz; all 16-byte aligned.  `carry` is 2 * n_ctas 4-byte words of
// scratch.  Launches on `stream`; does not synchronize.  Returns the CUDA
// error of the launches (0 = launched).
extern "C" int tsp_merge_csr(const void* row_end, const void* cols,
                             const void* vals, const void* x,
                             const void* tile_row, const void* tile_nz,
                             int n_ctas, int tiles, int num_rows, void* y,
                             void* carry, void* stream) {
  if (n_ctas <= 0 || tiles <= 0 || num_rows < 0) {
    return int(cudaErrorInvalidValue);
  }
  const auto* re = static_cast<const int32_t*>(row_end);
  const auto* ci = static_cast<const int32_t*>(cols);
  const auto* tr = static_cast<const int32_t*>(tile_row);
  const auto* tn = static_cast<const int32_t*>(tile_nz);
  auto* out = static_cast<float*>(y);
  auto* cr = static_cast<int32_t*>(carry);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vals ? launch<float>(re, ci, static_cast<const float*>(vals),
                           static_cast<const float*>(x), tr, tn, n_ctas,
                           tiles, num_rows, out, cr, st)
           : launch<Pattern>(re, ci, nullptr, static_cast<const float*>(x),
                             tr, tn, n_ctas, tiles, num_rows, out, cr, st);
  return int(err);
}

// The CTAs of K4 the current device holds at once (its SMs times the
// blocks a SM holds), for the f32 (pattern 0) or the pattern kernel; 0
// where the query fails.
extern "C" int tsp_merge_csr_ctas(int pattern) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess) {
    return 0;
  }
  const cudaError_t err =
      pattern ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, merge_csr<Pattern>, kThreads,
                    Stage<Pattern>::kSmem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, merge_csr<float>, kThreads, Stage<float>::kSmem);
  return err == cudaSuccess ? sms * per_sm : 0;
}


// One SpMM, Y = A·H (K5): n_shares warps' shares of the merge path
// (tile_row/tile_nz: K4's plan of the matrix cut into n_shares CTAs of
// `tiles` tiles, share s starting at tile s * tiles), then, where n_shares
// > 1, the fix-up.  h is num_cols x k and y num_rows x k, f32, row-major;
// `vec` 1: k a multiple of 4 and h, y and carry 16-byte aligned (the
// float4 path), else 0.  `carry` is n_shares 4-byte words of rows, then
// n_shares * k floats (16-byte aligned where vec), of scratch.  Launches
// on `stream`; does not synchronize.  Returns the CUDA error of the
// launches (0 = launched).
extern "C" int tsp_merge_spmm(const void* row_end, const void* cols,
                              const void* vals, const void* h,
                              const void* tile_row, const void* tile_nz,
                              int n_shares, int tiles, int num_rows, int k,
                              int vec, void* y, void* carry_row,
                              void* carry_val, void* stream) {
  if (n_shares <= 0 || tiles <= 0 || num_rows < 0 || k <= 0
      || (vec && k % 4)) {
    return int(cudaErrorInvalidValue);
  }
  const auto* re = static_cast<const int32_t*>(row_end);
  const auto* ci = static_cast<const int32_t*>(cols);
  const auto* va = static_cast<const float*>(vals);
  const auto* hf = static_cast<const float*>(h);
  const auto* tr = static_cast<const int32_t*>(tile_row);
  const auto* tn = static_cast<const int32_t*>(tile_nz);
  auto* out = static_cast<float*>(y);
  auto* crow = static_cast<int32_t*>(carry_row);
  auto* cval = static_cast<float*>(carry_val);
  auto st = static_cast<cudaStream_t>(stream);
  const int width = vec ? k / 4 : k;
  cudaError_t err;
  if (vec) {
    err = width <= 32
              ? launch_spmm<float4, 1>(re, ci, va, hf, tr, tn, n_shares,
                                       tiles, num_rows, width, out, crow,
                                       cval, st)
              : launch_spmm<float4, 2>(re, ci, va, hf, tr, tn, n_shares,
                                       tiles, num_rows, width, out, crow,
                                       cval, st);
  } else {
    err = width <= 32
              ? launch_spmm<float, 1>(re, ci, va, hf, tr, tn, n_shares, tiles,
                                      num_rows, width, out, crow, cval, st)
              : launch_spmm<float, 2>(re, ci, va, hf, tr, tn, n_shares, tiles,
                                      num_rows, width, out, crow, cval, st);
  }
  return int(err);
}

// The warps of K5 the current device holds at once (its SMs times the
// blocks of the k = 256 instance a SM holds, times the warps of a block);
// 0 where the query fails.
extern "C" int tsp_merge_spmm_warps() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess) {
    return 0;
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, merge_spmm<float4, 2>, kSpmmThreads, 0);
  return err == cudaSuccess ? sms * per_sm * kSpmmWarps : 0;
}
