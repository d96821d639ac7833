// tpu_spmv native runtime — C++ host-side hot paths.
//
// The reference implements its entire host layer in C++ (csr_matrix.cpp,
// ell_matrix.cpp, spmv_cpu.cpp); this library is the TPU build's native
// equivalent for the paths where Python/NumPy is the bottleneck:
//
//  * cumcount_i64 / group_max_i64 — the window-ELL planner's per-cell layer
//    assignment (replaces two O(nnz log nnz) argsorts with one hash pass);
//  * spmv_cpu_csr_f32 — the golden oracle (spmv_cpu.cpp:6-16) at native
//    speed, with the exact per-row sequential fp32 accumulation order;
//  * coo_to_csr_f32 — COO→CSR conversion (counting sort by row, stable, so
//    column order within a row is preserved);
//  * mtx_parse — Matrix Market (coordinate, real/integer/pattern,
//    general/symmetric) parser, the data-loader component.
//
// Build: python -m tpu_spmv.native.build   (g++ -O3 -shared -fPIC)
// Python binding: ctypes (tpu_spmv/native/__init__.py), with NumPy
// fallbacks when the library is absent.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <thread>
#include <unordered_map>
#include <vector>

// Open-addressing hash table (linear probing, power-of-2 size) — 5-10x
// faster than std::unordered_map for the planner's integer-key passes.
namespace {
struct FlatHash {
  std::vector<int64_t> keys;
  std::vector<int64_t> vals;
  size_t mask;
  explicit FlatHash(int64_t n) {
    size_t cap = 16;
    while (cap < static_cast<size_t>(n) * 2) cap <<= 1;
    keys.assign(cap, INT64_MIN);
    vals.assign(cap, 0);
    mask = cap - 1;
  }
  // returns reference to the value slot for key (inserted as 0 if new)
  int64_t& slot(int64_t key) {
    size_t h = static_cast<size_t>(key) * 0x9E3779B97F4A7C15ull;
    size_t i = h & mask;
    while (keys[i] != key) {
      if (keys[i] == INT64_MIN) {
        keys[i] = key;
        break;
      }
      i = (i + 1) & mask;
    }
    return vals[i];
  }
};
}  // namespace

extern "C" {

// Occurrence index of each element within its key group.
// Single hash pass, O(n) expected.
void cumcount_i64(const int64_t* keys, int64_t n, int64_t* out) {
  FlatHash h(n);
  for (int64_t i = 0; i < n; ++i) {
    out[i] = h.slot(keys[i])++;
  }
}

// Fused planner derive: lane/superblock decode of each nonzero's row slot
// plus the per-cell stacking layer (cumcount of the cell key), one pass.
void plan_derive_i64(const int64_t* pos, const int64_t* w, const int64_t* c,
                     int64_t n, int64_t n_windows, int64_t sup_rows,
                     int64_t* lane, int64_t* sup, int64_t* layer) {
  FlatHash h(n);
  for (int64_t i = 0; i < n; ++i) {
    int64_t l = pos[i] & 127;          // pos % 128 (LANE)
    int64_t s = pos[i] / sup_rows;
    lane[i] = l;
    sup[i] = s;
    int64_t cell = ((s * n_windows + w[i]) * 8 + c[i]) * 128 + l;
    layer[i] = h.slot(cell)++;
  }
}

// Bounded variants: when the caller knows the key space is small
// (the planner's bucket/cell keys are dense products of superblock,
// window, chunk, lane counts), direct-addressed counter arrays replace
// the hash table — the hash version's tables span 2n slots (hundreds of
// MB for 10M-nnz plans) and every probe is a DRAM miss (~190 ns/elem
// measured); the direct arrays fit cache-friendly working sets.

// Deterministic key-partitioned threading: thread t owns keys with
// key % T == t, each thread scans the whole input (sequential reads are
// cheap) but touches only its own dense counter array of key_space/T
// slots, so the random counter accesses parallelize and shrink per
// thread.  Results are bit-identical to the serial pass (input order is
// preserved per key).
static int planner_threads(int64_t n) {
  if (n < (int64_t{1} << 21)) return 1;
  unsigned hw = std::thread::hardware_concurrency();
  return static_cast<int>(std::min<unsigned>(hw ? hw : 1, 8));
}

void cumcount_bounded_i64(const int64_t* keys, int64_t n, int64_t key_space,
                          int64_t* out) {
  const int T = planner_threads(n);
  if (T == 1) {
    std::vector<int32_t> cnt(static_cast<size_t>(key_space), 0);
    for (int64_t i = 0; i < n; ++i) out[i] = cnt[keys[i]]++;
    return;
  }
  auto work = [&](int t) {
    std::vector<int32_t> cnt(static_cast<size_t>(key_space / T + 1), 0);
    for (int64_t i = 0; i < n; ++i) {
      int64_t k = keys[i];
      if (k % T == t) out[i] = cnt[k / T]++;
    }
  };
  std::vector<std::thread> th;
  for (int t = 0; t < T; ++t) th.emplace_back(work, t);
  for (auto& x : th) x.join();
}

void plan_derive_bounded_i64(const int64_t* pos, const int64_t* w,
                             const int64_t* c, int64_t n, int64_t n_windows,
                             int64_t sup_rows, int64_t key_space,
                             int64_t* lane, int64_t* sup, int64_t* layer) {
  const int T = planner_threads(n);
  if (T == 1) {
    std::vector<int32_t> cnt(static_cast<size_t>(key_space), 0);
    for (int64_t i = 0; i < n; ++i) {
      int64_t l = pos[i] & 127;
      int64_t s = pos[i] / sup_rows;
      lane[i] = l;
      sup[i] = s;
      int64_t cell = ((s * n_windows + w[i]) * 8 + c[i]) * 128 + l;
      layer[i] = cnt[cell]++;
    }
    return;
  }
  auto work = [&](int t) {
    std::vector<int32_t> cnt(static_cast<size_t>(key_space / T + 1), 0);
    for (int64_t i = 0; i < n; ++i) {
      int64_t p = pos[i];
      int64_t l = p & 127;
      int64_t s = p / sup_rows;
      int64_t cell = ((s * n_windows + w[i]) * 8 + c[i]) * 128 + l;
      if (cell % T == t) {
        lane[i] = l;
        sup[i] = s;
        layer[i] = cnt[cell / T]++;
      }
    }
  };
  std::vector<std::thread> th;
  for (int t = 0; t < T; ++t) th.emplace_back(work, t);
  for (auto& x : th) x.join();
}

int64_t unique_ic_bounded_i64(const int64_t* keys, int64_t n,
                              int64_t key_space, int64_t* out_uniq,
                              int64_t* out_inv, int64_t* out_counts) {
  std::vector<int64_t> cnt(static_cast<size_t>(key_space), 0);
  for (int64_t i = 0; i < n; ++i) cnt[keys[i]]++;
  // ascending scan doubles as the sort np.unique performs
  std::vector<int32_t> rank(static_cast<size_t>(key_space));
  int64_t m = 0;
  for (int64_t k = 0; k < key_space; ++k) {
    if (cnt[k]) {
      out_uniq[m] = k;
      out_counts[m] = cnt[k];
      rank[k] = static_cast<int32_t>(m++);
    }
  }
  for (int64_t i = 0; i < n; ++i) out_inv[i] = rank[keys[i]];
  return m;
}

// unique + inverse + counts for integer keys, one hash pass + a sort of
// the (small) distinct set so uniques come out ascending like np.unique.
// Returns the distinct count m; out_uniq/out_counts sized >= m by caller
// (n is always enough), out_inv sized n.
int64_t unique_inverse_counts_i64(const int64_t* keys, int64_t n,
                                  int64_t* out_uniq, int64_t* out_inv,
                                  int64_t* out_counts) {
  FlatHash h(n);
  int64_t m = 0;
  std::vector<int64_t> first_id(0);
  // pass 1: assign first-appearance ids, count
  std::vector<int64_t> appear;
  std::vector<int64_t> counts;
  std::vector<int64_t> tmp_inv(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    int64_t& v = h.slot(keys[i]);
    if (v == 0) {
      v = m + 1;  // ids are 1-based inside the table (0 = empty)
      appear.push_back(keys[i]);
      counts.push_back(0);
      ++m;
    }
    tmp_inv[i] = v - 1;
    counts[v - 1]++;
  }
  // sort distinct keys ascending, build old-id -> rank map
  std::vector<int64_t> order(m);
  for (int64_t i = 0; i < m; ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](int64_t a, int64_t b) { return appear[a] < appear[b]; });
  std::vector<int64_t> rank(m);
  for (int64_t r = 0; r < m; ++r) {
    rank[order[r]] = r;
    out_uniq[r] = appear[order[r]];
    out_counts[r] = counts[order[r]];
  }
  for (int64_t i = 0; i < n; ++i) out_inv[i] = rank[tmp_inv[i]];
  return m;
}

// Fused split-position pass: per-nnz row id and packed position (the
// strided merge-path part assignment) in one walk over the row pointers —
// replaces three variable-count np.repeat passes plus arange/where
// (measured ~6 s of the 10M-nnz plan build on one core).
void plan_positions_i64(const int32_t* row_ptrs, int64_t rows,
                        const int64_t* parts,
                        const int64_t* extra_base_of_row,
                        int64_t extras_base, int64_t* pos, int64_t* row_of) {
  for (int64_t r = 0; r < rows; ++r) {
    const int64_t p = parts[r];
    const int64_t base = extras_base + extra_base_of_row[r];
    const int64_t lo = row_ptrs[r], hi = row_ptrs[r + 1];
    for (int64_t j = lo, k = 0; j < hi; ++j, ++k) {
      row_of[j] = r;
      const int64_t part = p > 1 ? k % p : 0;
      pos[j] = part == 0 ? r : base + part - 1;
    }
  }
}

// Final slot fill: vals/lo/sb written in one pass from per-nnz data.
void fill_slots_f32(int64_t n, const int64_t* flat, const float* values,
                    const int64_t* cols_mod, const int64_t* sbv,
                    float* vals_out, int8_t* lo_out, int8_t* sb_out) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t f = flat[i];
    vals_out[f] = values[i];
    lo_out[f] = static_cast<int8_t>(cols_mod[i]);
    sb_out[f] = static_cast<int8_t>(sbv[i]);
  }
}

// Per-group maximum of (value+1) — the planner's layer-count reduction.
// keys need not be sorted; out_keys/out_max are parallel arrays sized by
// the return value (number of distinct keys), written in first-appearance
// order.  Caller provides capacity n.
int64_t group_max_i64(const int64_t* keys, const int64_t* values, int64_t n,
                      int64_t* out_keys, int64_t* out_max) {
  std::unordered_map<int64_t, int64_t> index;
  index.reserve(static_cast<size_t>(n) * 2);
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    auto it = index.find(keys[i]);
    if (it == index.end()) {
      index.emplace(keys[i], m);
      out_keys[m] = keys[i];
      out_max[m] = values[i] + 1;
      ++m;
    } else if (values[i] + 1 > out_max[it->second]) {
      out_max[it->second] = values[i] + 1;
    }
  }
  return m;
}

// Golden CPU oracle: y = A x, per-row sequential fp32 accumulation
// (identical order to the reference spmv_cpu_csr, spmv_cpu.cpp:6-16).
void spmv_cpu_csr_f32(int32_t num_rows, const int32_t* row_ptrs,
                      const int32_t* col_indices, const float* values,
                      const float* x, float* y) {
  for (int32_t i = 0; i < num_rows; ++i) {
    float sum = 0.0f;
    for (int32_t j = row_ptrs[i]; j < row_ptrs[i + 1]; ++j) {
      sum += values[j] * x[col_indices[j]];
    }
    y[i] = sum;
  }
}

// COO → CSR with a stable counting sort by row (preserves input order of
// entries within a row, so pre-sorted columns stay sorted).
void coo_to_csr_f32(int32_t num_rows, int64_t nnz, const int32_t* coo_rows,
                    const int32_t* coo_cols, const float* coo_vals,
                    int32_t* row_ptrs, int32_t* out_cols, float* out_vals) {
  std::memset(row_ptrs, 0, sizeof(int32_t) * (num_rows + 1));
  for (int64_t i = 0; i < nnz; ++i) row_ptrs[coo_rows[i] + 1]++;
  for (int32_t r = 0; r < num_rows; ++r) row_ptrs[r + 1] += row_ptrs[r];
  std::vector<int32_t> cursor(row_ptrs, row_ptrs + num_rows);
  for (int64_t i = 0; i < nnz; ++i) {
    int32_t p = cursor[coo_rows[i]]++;
    out_cols[p] = coo_cols[i];
    out_vals[p] = coo_vals[i];
  }
}

// ---- Matrix Market loader ----
// Two-phase protocol: mtx_open parses the whole file into an internal
// buffer and returns a handle + dims; mtx_fetch copies the COO arrays out;
// mtx_close frees.  Supports coordinate format, real/integer/pattern
// fields, general/symmetric symmetry.  Returns 0 on success, negative
// error codes mirroring SpMVError (-6 FILE_IO, -5 INVALID_FORMAT).

struct MtxData {
  std::vector<int32_t> rows, cols;
  std::vector<float> vals;
  int32_t num_rows = 0, num_cols = 0;
};

static int mtx_parse_stream(FILE* f, MtxData* d) {
  char line[1024];
  if (!std::fgets(line, sizeof line, f)) return -6;
  if (std::strncmp(line, "%%MatrixMarket", 14) != 0) return -5;
  bool pattern = std::strstr(line, "pattern") != nullptr;
  bool symmetric = std::strstr(line, "symmetric") != nullptr;
  if (!std::strstr(line, "coordinate")) return -5;
  if (std::strstr(line, "complex")) return -5;
  // skip comments
  long nnz_declared = 0;
  for (;;) {
    if (!std::fgets(line, sizeof line, f)) return -6;
    if (line[0] == '%') continue;
    long r, c, n;
    if (std::sscanf(line, "%ld %ld %ld", &r, &c, &n) != 3) return -5;
    d->num_rows = static_cast<int32_t>(r);
    d->num_cols = static_cast<int32_t>(c);
    nnz_declared = n;
    break;
  }
  d->rows.reserve(nnz_declared * (symmetric ? 2 : 1));
  d->cols.reserve(nnz_declared * (symmetric ? 2 : 1));
  d->vals.reserve(nnz_declared * (symmetric ? 2 : 1));
  for (long i = 0; i < nnz_declared; ++i) {
    long r, c;
    double v = 1.0;
    if (!std::fgets(line, sizeof line, f)) return -6;
    int got = pattern ? std::sscanf(line, "%ld %ld", &r, &c)
                      : std::sscanf(line, "%ld %ld %lf", &r, &c, &v);
    if (got < (pattern ? 2 : 3)) return -5;
    d->rows.push_back(static_cast<int32_t>(r - 1));  // 1-based → 0-based
    d->cols.push_back(static_cast<int32_t>(c - 1));
    d->vals.push_back(static_cast<float>(v));
    if (symmetric && r != c) {
      d->rows.push_back(static_cast<int32_t>(c - 1));
      d->cols.push_back(static_cast<int32_t>(r - 1));
      d->vals.push_back(static_cast<float>(v));
    }
  }
  return 0;
}

void* mtx_open(const char* path, int32_t* num_rows, int32_t* num_cols,
               int64_t* nnz, int32_t* error) {
  FILE* f = std::fopen(path, "r");
  if (!f) {
    *error = -6;
    return nullptr;
  }
  auto* d = new MtxData();
  int rc = mtx_parse_stream(f, d);
  std::fclose(f);
  if (rc != 0) {
    delete d;
    *error = rc;
    return nullptr;
  }
  *num_rows = d->num_rows;
  *num_cols = d->num_cols;
  *nnz = static_cast<int64_t>(d->rows.size());
  *error = 0;
  return d;
}



// ---- content-aware extras lane balancing (round 3) ----
//
// The extras region's occupancy is limited by hot content cells: many
// extra rows carry nonzeros from the same (window, chunk) columns, and
// with lanes assigned by index order those nonzeros stack layers.  This
// pass reassigns each extra's LANE within its fixed 128-index block by
// two-choice greedy balancing on the projected cell depths
// D[(sup, window*8+chunk, lane)], spreading hot chunks across lanes.
// ext_ptr (n_extra+1) / ext_wc: per-extra content lists (wc = w*8+c).
// The last (partial) block is constrained to lanes [0, count) so the
// index space stays dense.  Deterministic.
// When hash_bits > 0 the depth table is a fixed 2^hash_bits-row hash
// (collisions smear depth across unrelated cells — acceptable noise for
// a balancing heuristic) so arbitrarily wide matrices stay in budget.
void balance_extra_lanes_i64(int64_t n_extra, const int64_t* ext_ptr,
                             const int64_t* ext_wc, int64_t n_wc,
                             int64_t blocks_per_sup, int64_t hash_bits,
                             int64_t* out_lane) {
  if (n_extra <= 0) return;
  const int64_t n_sups =
      (n_extra + blocks_per_sup * 128 - 1) / (blocks_per_sup * 128);
  const bool hashed = hash_bits > 0;
  const size_t h_rows = hashed ? (size_t{1} << hash_bits) : 0;
  const size_t h_mask = hashed ? h_rows - 1 : 0;
  std::vector<int32_t> depth(
      hashed ? h_rows * 128
             : static_cast<size_t>(n_sups) * n_wc * 128, 0);
  const int64_t n_blocks = (n_extra + 127) / 128;
  std::vector<int> order(128), free_lanes(128);
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int64_t e0 = b * 128;
    const int count = static_cast<int>(std::min<int64_t>(128, n_extra - e0));
    const int64_t sup = b / blocks_per_sup;
    int32_t* D = depth.data()
        + (hashed ? 0 : static_cast<size_t>(sup) * n_wc * 128);
    auto row_of = [&](int64_t wc) -> size_t {
      if (!hashed) return static_cast<size_t>(wc);
      uint64_t k = static_cast<uint64_t>(sup * n_wc + wc)
          * 0x9E3779B97F4A7C15ull;
      return static_cast<size_t>((k >> 24) & h_mask);
    };
    order.resize(count);
    for (int k = 0; k < count; ++k) order[k] = k;
    std::sort(order.begin(), order.end(), [&](int a, int c2) {
      int64_t la = ext_ptr[e0 + a + 1] - ext_ptr[e0 + a];
      int64_t lc = ext_ptr[e0 + c2 + 1] - ext_ptr[e0 + c2];
      return la != lc ? la > lc : a < c2;
    });
    free_lanes.resize(count);
    for (int k = 0; k < count; ++k) free_lanes[k] = k;
    int nfree = count;
    for (int k = 0; k < count; ++k) {
      const int64_t e = e0 + order[k];
      // exhaustive over the remaining free lanes (greedy min-cost
      // assignment; content lists are short, so this is cheap)
      int best_t = 0;
      int64_t best_score = INT64_MAX;
      for (int t = 0; t < nfree; ++t) {
        const int cand = free_lanes[t];
        int64_t sc = 0;
        for (int64_t j = ext_ptr[e]; j < ext_ptr[e + 1]; ++j) {
          const int32_t d = D[row_of(ext_wc[j]) * 128 + cand];
          sc += static_cast<int64_t>(d) * d;
        }
        if (sc < best_score) {
          best_score = sc;
          best_t = t;
        }
      }
      const int lane = free_lanes[best_t];
      out_lane[e] = lane;
      free_lanes[best_t] = free_lanes[--nfree];
      for (int64_t j = ext_ptr[e]; j < ext_ptr[e + 1]; ++j)
        D[row_of(ext_wc[j]) * 128 + lane] += 1;
    }
  }
}

// ---- extras (superblock, lane) slot balancing (round-3 backlog #2) ----
//
// Generalizes balance_extra_lanes_i64: instead of fixing each extra's
// 128-index block and choosing only its lane, the greedy assigns each
// extra a full SLOT — a (superblock, lane) pair with per-pair capacity
// sup_rows/128 sublanes — inside a sliding window of `window_sups`
// consecutive superblocks.  Layer depth is keyed by (sup, wc, lane)
// only (the sublane is the scatter row, not a packing dimension), so
// cross-superblock choice is the remaining freedom the lane balancer
// could not exploit.  Batches are non-overlapping windows, which keeps
// the assignment a bijection onto [0, n_extra) by construction.
// out_idx[e] = the extra's new index in the extras position space.
//
// ext_crow: per-extra combine coupling — the extra's ROW id when that
// row has exactly ONE extra (its combine nonzero gathers the level-1
// total directly at table column cols_pad + idx, so the combine cell's
// (window, chunk) is determined by the slot this pass assigns:
// window_off = sup*(n_tb/8) + sublane/8, chunk = sublane%8, lane =
// row%128), or -1 when the row is multi-extra (its combine reads the
// level-2 region, which this pass does not move).  Scoring those cells
// in a second depth table keeps cross-superblock moves from stacking
// combine gathers in the rows region — without it, slot choice wins
// ~8% extras density but loses MORE in combine-bucket layers
// (measured on the 10M headline: extras 4096->... but rows +512
// groups).  Pass ext_crow = NULL to disable.
//
// layer_aware != 0 changes the PRIMARY cost (round-3 late): the plan's
// true objective is the LAYER count per (superblock, window) bucket —
// sum over buckets of max cell depth — not the sum of squared depths.
// The pass tracks each bucket's current max depth and counts, per
// candidate slot, how many of the extra's content cells would be pushed
// PAST their bucket's max (each such push ultimately costs one group);
// sum-d^2 (and the crow cell) remain as the tiebreak.  Exact mode: a
// cell's depth never exceeds its bucket max, so the check is d == M;
// hashed mode smears both tables, so >= guards the comparison.
// Deterministic.
void balance_extra_slots2_i64(int64_t n_extra, const int64_t* ext_ptr,
                              const int64_t* ext_wc, int64_t n_wc,
                              const int64_t* ext_crow,
                              int64_t sup_rows, int64_t window_sups,
                              int64_t hash_bits, int64_t layer_aware,
                              int64_t* out_idx) {
  if (n_extra <= 0) return;
  const int64_t batch_sz = window_sups * sup_rows;
  const int64_t n_sups = (n_extra + sup_rows - 1) / sup_rows;
  const bool hashed = hash_bits > 0;
  const size_t h_rows = hashed ? (size_t{1} << hash_bits) : 0;
  const size_t h_mask = hashed ? h_rows - 1 : 0;
  std::vector<int32_t> depth(
      hashed ? h_rows * 128
             : static_cast<size_t>(n_sups) * n_wc * 128, 0);
  // combine-cell depths: always a fixed hashed table (the key space —
  // (row superblock, combine window, chunk) — is unbounded either way)
  const size_t c_rows = size_t{1} << 16;
  const size_t c_mask = c_rows - 1;
  std::vector<int32_t> cdepth(ext_crow ? c_rows * 128 : 0, 0);
  // combine BUCKET maxes (mode 2): the combine gather columns live in
  // the extras-totals windows, disjoint from row-content windows, so
  // their (row superblock, window) buckets are priced entirely by this
  // pass — a combine layer costs the same bytes as an extras layer.
  // Without this, mode 2's cross-superblock concentration reshuffles
  // single-extra rows' indices and the rows region grows MORE than the
  // extras region shrinks (measured +1280 vs -512 groups at win=4).
  std::vector<int32_t> cmax(ext_crow ? c_rows : 0, 0);
  auto cb_of = [&](int64_t row_sup, int64_t sup, int sub) -> size_t {
    const int64_t woff = sup * ((sup_rows / 128) / 8) + sub / 8;
    uint64_t kk = (static_cast<uint64_t>(row_sup) * 0x100000001ull
                   + static_cast<uint64_t>(woff))
        * 0x9E3779B97F4A7C15ull;
    return static_cast<size_t>((kk >> 24) & c_mask);
  };
  // per-(superblock, window) bucket max depth for layer_aware scoring
  // (ceil: n_wc below 8 — possible for the level-2 caller's compact
  // table-window key space — must still give every bucket a row)
  const int64_t n_w = (n_wc + 7) / 8;
  const size_t m_rows = size_t{1} << 16;
  const size_t m_mask = m_rows - 1;
  std::vector<int32_t> bmax(
      !layer_aware ? 0
      : hashed ? m_rows
               : static_cast<size_t>(n_sups) * n_w, 0);
  auto brow_of = [&](int64_t sup, int64_t w) -> size_t {
    if (!hashed) return static_cast<size_t>(sup * n_w + w);
    uint64_t kk = static_cast<uint64_t>(sup * n_w + w)
        * 0x9E3779B97F4A7C15ull;
    return static_cast<size_t>((kk >> 24) & m_mask);
  };
  const int64_t n_tb = sup_rows / 128;
  auto crow_of = [&](int64_t row_sup, int64_t sup, int sub) -> size_t {
    const int64_t woff = sup * (n_tb / 8) + sub / 8;
    uint64_t kk = (static_cast<uint64_t>(row_sup) * 0x100000001ull
                   + static_cast<uint64_t>(woff) * 8 + sub % 8)
        * 0x9E3779B97F4A7C15ull;
    return static_cast<size_t>((kk >> 24) & c_mask);
  };
  // mode 2 (atom-aware true cost): sort each extra's content by wc and
  // run-length compress it, so the score can aggregate same-cell
  // multiplicities.  The d^2 proxy reads a STALE depth for every
  // duplicate — a spill run concentrated in one chunk (a 30-deep atom)
  // scores 0 on an empty cell, and the proxy then spreads deep atoms
  // across superblocks where sharing a bucket's max would make them
  // nearly free.  Mode 2 charges each candidate slot the true increase
  // in sum-of-bucket-maxes (same-w cells are adjacent after the sort).
  std::vector<int64_t> cptr, cwc;
  std::vector<int32_t> ck;
  if (layer_aware >= 2) {
    cptr.assign(n_extra + 1, 0);
    cwc.reserve(ext_ptr[n_extra]);
    ck.reserve(ext_ptr[n_extra]);
    std::vector<int64_t> tmp;
    for (int64_t e = 0; e < n_extra; ++e) {
      tmp.assign(ext_wc + ext_ptr[e], ext_wc + ext_ptr[e + 1]);
      std::sort(tmp.begin(), tmp.end());
      for (size_t j = 0; j < tmp.size();) {
        size_t j2 = j;
        while (j2 < tmp.size() && tmp[j2] == tmp[j]) ++j2;
        cwc.push_back(tmp[j]);
        ck.push_back(static_cast<int32_t>(j2 - j));
        j = j2;
      }
      cptr[e + 1] = static_cast<int64_t>(cwc.size());
    }
  }
  std::vector<int> order;
  std::vector<int> cap(static_cast<size_t>(window_sups) * 128);
  std::vector<int> fill(static_cast<size_t>(window_sups) * 128);
  for (int64_t b0 = 0; b0 < n_extra; b0 += batch_sz) {
    const int64_t e_end = std::min(n_extra, b0 + batch_sz);
    const int count = static_cast<int>(e_end - b0);
    const int64_t sup0 = b0 / sup_rows;
    const int W = static_cast<int>(
        std::min<int64_t>(window_sups, n_sups - sup0));
    // free-slot capacity per (local sup, lane) over [b0, e_end)
    for (int s = 0; s < W; ++s) {
      const int64_t a = (sup0 + s) * sup_rows;
      const int64_t len = std::min(e_end, a + sup_rows) - a;
      for (int l = 0; l < 128; ++l) {
        cap[s * 128 + l] = static_cast<int>(
            len > 0 ? len / 128 + (l < len % 128 ? 1 : 0) : 0);
        fill[s * 128 + l] = 0;
      }
    }
    order.resize(count);
    for (int k = 0; k < count; ++k) order[k] = k;
    std::sort(order.begin(), order.end(), [&](int a, int c2) {
      int64_t la = ext_ptr[b0 + a + 1] - ext_ptr[b0 + a];
      int64_t lc = ext_ptr[b0 + c2 + 1] - ext_ptr[b0 + c2];
      return la != lc ? la > lc : a < c2;
    });
    for (int k = 0; k < count; ++k) {
      const int64_t e = b0 + order[k];
      const int64_t crow = ext_crow ? ext_crow[e] : -1;
      const int64_t crow_sup = crow >= 0 ? crow / sup_rows : 0;
      const int crow_lane = crow >= 0 ? static_cast<int>(crow % 128) : 0;
      int best_s = -1, best_l = 0;
      int64_t best_score = INT64_MAX, best_raises = INT64_MAX;
      for (int s = 0; s < W; ++s) {
        const int64_t sup = sup0 + s;
        int32_t* D = depth.data()
            + (hashed ? 0 : static_cast<size_t>(sup) * n_wc * 128);
        auto row_of = [&](int64_t wc) -> size_t {
          if (!hashed) return static_cast<size_t>(wc);
          uint64_t kk = static_cast<uint64_t>(sup * n_wc + wc)
              * 0x9E3779B97F4A7C15ull;
          return static_cast<size_t>((kk >> 24) & h_mask);
        };
        for (int l = 0; l < 128; ++l) {
          if (cap[s * 128 + l] == 0) continue;
          int64_t sc = 0, raises = 0;
          if (crow >= 0) {
            const int32_t d = cdepth[
                crow_of(crow_sup, sup, fill[s * 128 + l]) * 128
                + crow_lane];
            if (layer_aware >= 2) {
              const int32_t m =
                  cmax[cb_of(crow_sup, sup, fill[s * 128 + l])];
              if (d + 1 > m) raises += d + 1 - m;
            }
            sc += static_cast<int64_t>(d) * d;
          }
          if (layer_aware >= 2) {
            // true layer cost: per window, the new bucket max minus the
            // current one (cells of one window are adjacent post-sort)
            int64_t curw = -1;
            int32_t curmax = 0;
            for (int64_t j = cptr[e]; j < cptr[e + 1]; ++j) {
              const int64_t w2 = cwc[j] / 8;
              if (w2 != curw) {
                if (curw >= 0) {
                  const int32_t m = bmax[brow_of(sup, curw)];
                  if (curmax > m) raises += curmax - m;
                }
                curw = w2;
                curmax = 0;
              }
              const int32_t d = D[row_of(cwc[j]) * 128 + l];
              const int32_t nd = d + ck[j];
              if (nd > curmax) curmax = nd;
              sc += static_cast<int64_t>(d) * d;
            }
            if (curw >= 0) {
              const int32_t m = bmax[brow_of(sup, curw)];
              if (curmax > m) raises += curmax - m;
            }
          } else {
            for (int64_t j = ext_ptr[e]; j < ext_ptr[e + 1]; ++j) {
              const int32_t d = D[row_of(ext_wc[j]) * 128 + l];
              if (layer_aware &&
                  d >= bmax[brow_of(sup, ext_wc[j] / 8)])
                ++raises;
              sc += static_cast<int64_t>(d) * d;
            }
          }
          if (raises < best_raises ||
              (raises == best_raises && sc < best_score)) {
            best_score = sc;
            best_raises = raises;
            best_s = s;
            best_l = l;
            if (raises == 0 && sc == 0) break;  // cannot improve
          }
        }
        if (best_raises == 0 && best_score == 0) break;
      }
      const int64_t sup = sup0 + best_s;
      const int sub = fill[best_s * 128 + best_l];
      out_idx[e] = sup * sup_rows
          + static_cast<int64_t>(sub) * 128 + best_l;
      cap[best_s * 128 + best_l] -= 1;
      fill[best_s * 128 + best_l] += 1;
      int32_t* D = depth.data()
          + (hashed ? 0 : static_cast<size_t>(sup) * n_wc * 128);
      const int64_t* uwc = layer_aware >= 2 ? cwc.data() : ext_wc;
      const int64_t uj0 = layer_aware >= 2 ? cptr[e] : ext_ptr[e];
      const int64_t uj1 = layer_aware >= 2 ? cptr[e + 1] : ext_ptr[e + 1];
      for (int64_t j = uj0; j < uj1; ++j) {
        size_t row;
        if (!hashed) {
          row = static_cast<size_t>(uwc[j]);
        } else {
          uint64_t kk = static_cast<uint64_t>(sup * n_wc + uwc[j])
              * 0x9E3779B97F4A7C15ull;
          row = static_cast<size_t>((kk >> 24) & h_mask);
        }
        const int32_t add = layer_aware >= 2 ? ck[j] : 1;
        const int32_t nd = (D[row * 128 + best_l] += add);
        if (layer_aware) {
          int32_t& m = bmax[brow_of(sup, uwc[j] / 8)];
          if (nd > m) m = nd;
        }
      }
      if (crow >= 0) {
        const int32_t nd =
            (cdepth[crow_of(crow_sup, sup, sub) * 128 + crow_lane] += 1);
        if (layer_aware >= 2) {
          int32_t& m = cmax[cb_of(crow_sup, sup, sub)];
          if (nd > m) m = nd;
        }
      }
    }
  }
}

// ---- within-superblock row->lane leveling (round-3 late) ----
// Used by WindowEllPlan.build(permute_rows=True): rows of each 128-row
// TILE are assigned distinct lanes (a per-tile lane permutation), so
// the inverse on the output is ONE take_along_axis lane gather — the
// public y-order contract is unchanged.  Within a superblock the greedy
// levels per-(window, chunk, lane) cell depths with the same atom-aware
// layer cost as balance_extra_slots2_i64: raise-count primary (true
// increase in the superblock's sum-of-bucket-maxes), sum-d^2 tiebreak.
// parts[r] (or NULL) divides row content by its stride-split count so
// rows the planner will split are not over-weighted (each split part
// sees ~1/parts of every cell).  Rows of a partial final tile are
// confined to lanes [0, tile_len) so the permuted position space stays
// dense (argsort of positions is then a valid permutation).
// Measured on the 10M-nnz power-law headline: 17152 -> 15488 groups;
// 262K web graph at sup=4096: 39552 -> ~32.4K (docs/PERF.md).
// Deterministic.
void balance_row_tiles_i64(int64_t n_rows, const int64_t* row_ptr,
                           const int64_t* wc, const int64_t* parts,
                           int64_t n_wc, int64_t sup_rows,
                           int64_t* out_lane) {
  if (n_rows <= 0) return;
  // visitation order: per-tile descending content (default), or
  // superblock-global descending (TPU_SPMV_TILE_GLOBAL=1) — heaviest
  // rows of the WHOLE superblock claim lanes first, each still
  // confined to its own tile's free lanes
  const char* ge = std::getenv("TPU_SPMV_TILE_GLOBAL");
  const bool global_order = ge && *ge && std::strcmp(ge, "0") != 0;
  std::vector<int32_t> depth(static_cast<size_t>(n_wc) * 128);
  std::vector<int32_t> bmax(static_cast<size_t>((n_wc + 7) / 8));
  std::vector<int64_t> cwc, tmp, ord;
  std::vector<int32_t> ck;
  std::vector<uint64_t> used;
  for (int64_t sup0 = 0; sup0 < n_rows; sup0 += sup_rows) {
    std::fill(depth.begin(), depth.end(), 0);
    std::fill(bmax.begin(), bmax.end(), 0);
    const int64_t sup_end = std::min(n_rows, sup0 + sup_rows);
    const int64_t n_tiles = (sup_end - sup0 + 127) / 128;
    ord.resize(sup_end - sup0);
    for (int64_t i = 0; i < sup_end - sup0; ++i) ord[i] = sup0 + i;
    std::sort(ord.begin(), ord.end(), [&](int64_t a, int64_t b) {
      if (!global_order) {
        const int64_t ta = (a - sup0) / 128, tb = (b - sup0) / 128;
        if (ta != tb) return ta < tb;
      }
      int64_t la = row_ptr[a + 1] - row_ptr[a];
      int64_t lb = row_ptr[b + 1] - row_ptr[b];
      if (parts) {
        la /= std::max<int64_t>(parts[a], 1);
        lb /= std::max<int64_t>(parts[b], 1);
      }
      return la != lb ? la > lb : a < b;
    });
    used.assign(static_cast<size_t>(n_tiles) * 2, 0);
    for (const int64_t r : ord) {
      const int64_t tile = (r - sup0) / 128;
      const int64_t t0 = sup0 + tile * 128;
      const int tl = static_cast<int>(std::min<int64_t>(128, sup_end - t0));
      uint64_t* tused = &used[tile * 2];
      tmp.assign(wc + row_ptr[r], wc + row_ptr[r + 1]);
      std::sort(tmp.begin(), tmp.end());
      cwc.clear();
      ck.clear();
      const int64_t pr = parts ? std::max<int64_t>(parts[r], 1) : 1;
      for (size_t j = 0; j < tmp.size();) {
        size_t j2 = j;
        while (j2 < tmp.size() && tmp[j2] == tmp[j]) ++j2;
        cwc.push_back(tmp[j]);
        ck.push_back(static_cast<int32_t>(
            (static_cast<int64_t>(j2 - j) + pr - 1) / pr));
        j = j2;
      }
      int best_l = -1;
      int64_t best_raises = INT64_MAX, best_sc = INT64_MAX;
      for (int l = 0; l < tl; ++l) {
        if ((tused[l >> 6] >> (l & 63)) & 1) continue;
        int64_t raises = 0, sc = 0;
        int64_t curw = -1;
        int32_t curmax = 0;
        for (size_t j = 0; j < cwc.size(); ++j) {
          const int64_t w2 = cwc[j] / 8;
          if (w2 != curw) {
            if (curw >= 0 && curmax > bmax[curw])
              raises += curmax - bmax[curw];
            curw = w2;
            curmax = 0;
          }
          const int32_t d = depth[cwc[j] * 128 + l];
          const int32_t nd = d + ck[j];
          if (nd > curmax) curmax = nd;
          sc += static_cast<int64_t>(nd) * nd
              - static_cast<int64_t>(d) * d;
        }
        if (curw >= 0 && curmax > bmax[curw])
          raises += curmax - bmax[curw];
        if (raises < best_raises ||
            (raises == best_raises && sc < best_sc)) {
          best_raises = raises;
          best_sc = sc;
          best_l = l;
        }
      }
      tused[best_l >> 6] |= uint64_t{1} << (best_l & 63);
      for (size_t j = 0; j < cwc.size(); ++j) {
        const int32_t nd = (depth[cwc[j] * 128 + best_l] += ck[j]);
        int32_t& m = bmax[cwc[j] / 8];
        if (nd > m) m = nd;
      }
      out_lane[r] = best_l;
    }
  }
}

void mtx_fetch(void* handle, int32_t* rows, int32_t* cols, float* vals) {
  auto* d = static_cast<MtxData*>(handle);
  std::memcpy(rows, d->rows.data(), d->rows.size() * sizeof(int32_t));
  std::memcpy(cols, d->cols.data(), d->cols.size() * sizeof(int32_t));
  std::memcpy(vals, d->vals.data(), d->vals.size() * sizeof(float));
}

void mtx_close(void* handle) { delete static_cast<MtxData*>(handle); }

}  // extern "C"
