// K1, K3, K4a, K4b, K8 and K9 of the port: exact top-k of queries @ store.T
// on Hopper (sm_90a), over a whole store or over a list of its tiles, with
// bf16/f16/f32 or int8 rows.
//
// Replaces, in sema_tpu/ops/pallas_topk.py:
//   K1   pallas_topk              (_scan_kernel, _scan_kernel_nomask)
//   K4a  pallas_topk_int8         (_scan_kernel_int8)
//   K3   pallas_topk_pruned       (_scan_kernel_pruned)
//   K4b  pallas_topk_int8_pruned  (_scan_kernel_int8_pruned)
//   K8   pallas_topk, warm_rows > 0 (_scan_kernel_warm,
//        _scan_kernel_nomask_warm, with _warm_thr0's threshold)
// which all share _merge_and_emit, and in tools/scan_ab14.py:
//   K9   fold_topk                (_fold_kernel, _merge_and_emit_fold)
// The TPU kernels walk their tiles in
// order on one core and keep each query's running top-k in VMEM scratch
// from one grid step to the next. Blocks on Hopper run in no order, so the
// scan is two passes:
//
//   pass 1  grid (block of queries, chunk of rows): the query blocks of a
//           chunk are neighbours in the grid, so they run side by side and
//           read its rows from L2 at about the same time. Each block streams
//           its row range through shared memory 64 rows at a time (a row
//           wider than shared memory allows goes in slabs), scores the
//           rows against its queries and merges the scores into a
//           per-query sorted list of k in shared memory. A score enters
//           only if it beats the list's k-th entry (the TPU kernel's
//           threshold screen), and it goes in after equal scores, so equal
//           scores keep the row scanned first. The lists go out as
//           (Q, chunks, k) candidates.
//   pass 2  one warp per query merges its chunks' lists, chunk by chunk in
//           scan order, under the same rule; a list is left at its first
//           32 entries that do not beat the k-th. Slots with no row are
//           -inf with id 0, as the TPU kernels' zeroed ids leave them. An
//           int8 scan's per-query scale multiplies the merged scores here,
//           after the merge, as pallas_topk.py:432 does.
//
// Scoring, by the store dtype.
//   bf16, f16  the tensor cores: mma.sync m16n8k16, the store rows the A
//           operand (row-major, d contiguous), the queries the B operand,
//           both in the store dtype as the wrapper passes them and fed by
//           ldmatrix from shared memory whose rows are padded by 16 bytes;
//           f32 accumulators. The tiles (or slabs of their rows) come in by
//           cp.async into two buffers: the next is in flight while this one
//           is scored and merged. A block takes 64 queries for a batch at
//           k <= 128 (8 warps: 4 groups of 16 rows x 2 of 32 queries), so a
//           store is read once per 64 queries, else 8 (4 warps of 16 rows x
//           8 queries). A bf16 or f16 product is exact in f32; the
//           tensor cores add the 16 products of a k-step and the running
//           sum in their own order, not the IEEE sequence of FMAs, so the
//           scores may differ from a sequence of FMAs in the last bits.
//           Before a tile's scores go to the merge, each scoring thread
//           screens its own against its queries' k-th (the lists hold still
//           until the merge) and flags a query that has a score above it;
//           the merge skips an unflagged query, whose merge would insert
//           nothing, so the survivors reach the merge in row order as ever.
//   f32     f32 FMAs over the row's values against the query, one thread a
//           row (TF32 would round the operands).
//   int8    __dp4a over packed words of the row and of the per-query
//           quantized query, summed in i32, converted once to f32 and
//           multiplied once by the row's f32 scale: the order of
//           pallas_topk.py:219, exact (the i32 sum converts without loss
//           while d <= 1040), so the scores and ids equal the plain
//           version's.
// Masked rows score -inf.
//
// Row source. A whole store scans rows 0..n-1. A pruned scan (K3, K4b)
// takes the tile list of an IVF probe: logical row r is the physical row
// tile_ids[r / tile_n] * tile_n + r % tile_n, for r < n_live * tile_n;
// ids are physical rows (positions in the cluster-major bucket). The
// TPU kernel's grid runs over the whole static budget and its steps past
// n_live add nothing; here they are not launched at all. select_tiles
// sorts the tile ids, so the scan order is the row order and equal scores
// keep the lower id.
//
// K8, the warm start (scan A/B #15). Each query's screen is
// max(the list's k-th, thr0[q]), strictly: thr0 is one ULP below the k-th
// best score of the store's first warm_rows rows, so every row of the true
// top-k (score >= the sample's k-th) still enters and the result is K1's.
// The wrapper takes the sample's k-th from this kernel's own scores of
// those rows (passes 1-2 over store[:w]): a row's score does not depend on
// its chunk, its query block, its slab or its place in a tile, since its
// sum runs over the row's words (FMAs) or k-steps (mma: each element of an
// accumulator tile sums its own row and query over d, 16 at a time, in the
// same order wherever it sits) in order across slabs, so those are the
// very bits the full scan computes. A score from another product (cuBLAS sums in another order)
// could sit above the kernel's own score of a true top-k row. Pass 2
// needs nothing: the chunk lists only hold scores above thr0, and -inf.
//
// K9, the fold merge (scan A/B #14). Pass 1 merges once per span of 256
// rows instead of once per 64-row tile. Each lane of a query's warp folds
// its 8 columns of the span (lane, lane + 32, ...) to its best score, the
// first column among equals, and counts its survivors, the scores above
// the list's k-th. If no lane has two survivors, the survivors are exactly
// the best folded candidates, and the warp inserts them largest first, the
// lower column first among equals: min(survivors, k) rounds of a warp
// argmax, each the list that row-by-row insertion gives. Otherwise (every
// span at the start of a chunk, and two survivors tying in one lane) the
// span goes row by row as in K1. The ids and scores equal K1's. The span
// is the largest power of two whose scores ([16][256] floats, 16 KB) keep
// a bf16 block at d = 384 and k <= 128 inside half an SM's shared memory,
// two blocks an SM as for K1; the TPU folded 16 columns a lane (2,048 /
// 128), which would need 32 KB and one block an SM.
//
// What bounds it on the H100: at the CLI's Q=1 the single read of the rows
// scanned (N*d*itemsize bytes at 3.35 TB/s: 60 us for a sealed 262,144-row
// bf16 bucket at d=384, 80 us for an int8 one at d=1024); at Q=256 the
// bytes still for bf16 (2*Q*N*d operations over 2*N*d bytes is Q = 256 a
// byte, under the card's 295; 0.240 ms at 1M x 384), the rows read 4 times
// from L2 (once per query block of 64); for f32 and int8 the scoring, with
// scalar FMAs (67 TFLOP/s) or dp4a where IMMA would reach the tensor cores.
// What the tensor-core route spends beyond the scoring goes to the merge:
// each chunk restarts its lists, so the insertions grow with the chunks,
// and the wrapper plans one wave of blocks (chunk_plan), two an SM where
// shared memory holds two. Pass 2 walks a query's chunk lists one after
// another in one warp, so it grows with chunks * k, and bounds a small
// store's scan at Q=1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;
constexpr int kGroups = kThreads / kTileRows;  // query groups per tile row
constexpr int kPass2Warps = 4;
constexpr int kInt8 = 3;
constexpr int kFoldSpan = 256;  // rows a K9 merge folds: 8 columns a lane

// One 32-bit word of a row on the SIMT route, unpacked to floats: 2 = f32;
// 3 = int8 is scored on packed words and only gives its width here (bf16
// and f16 rows take the tensor-core route).
template <int DT> struct Elem;
template <> struct Elem<2> {
  static constexpr int kPerWord = 1;
  __device__ __forceinline__ static void unpack(uint32_t w, float* x) {
    x[0] = __uint_as_float(w);
  }
};
template <> struct Elem<kInt8> {
  static constexpr int kPerWord = 4;
};

// Insert (v, id) into one query's list of k entries, sorted by score
// descending, after every entry >= v. Called by a whole warp with the same
// arguments; the last entry falls off.
__device__ void warp_insert(float* ls, int* li, int k, float v, int id,
                            int lane) {
  int pos = 0;
  for (int c = 0; c < k; c += 32) {
    const int j = c + lane;
    pos += __popc(__ballot_sync(0xffffffffu, j < k && ls[j] >= v));
  }
  if (pos >= k) return;
  // shift [pos, k-1) up by one slot, top chunk first
  for (int c = ((k - 2) / 32) * 32; c >= (pos / 32) * 32; c -= 32) {
    const int j = c + lane;
    const bool mv = j >= pos && j < k - 1;
    float s = 0.f;
    int i = 0;
    if (mv) {
      s = ls[j];
      i = li[j];
    }
    __syncwarp();
    if (mv) {
      ls[j + 1] = s;
      li[j + 1] = i;
    }
    __syncwarp();
  }
  if (lane == 0) {
    ls[pos] = v;
    li[pos] = id;
  }
  __syncwarp();
}

// Merge a span's scores into one query's list in row order. A score enters
// only if it beats max(the list's k-th, warm), K8's threshold (-inf for
// every other scan). Called by a whole warp.
__device__ void merge_rows(const float* qsc, int rows, float* qls, int* qli,
                           int k, float warm, int row0, int lane) {
  for (int base = 0; base < rows; base += 32) {
    const float s = base + lane < rows ? qsc[base + lane] : -INFINITY;
    unsigned m = __ballot_sync(0xffffffffu, s > fmaxf(qls[k - 1], warm));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float v = __shfl_sync(0xffffffffu, s, src);
      if (v > fmaxf(qls[k - 1], warm))
        warp_insert(qls, qli, k, v, row0 + base + src, lane);
    }
  }
}

// K9's merge of one span (see the top of the file). Returns -1 when no
// score of the span beats the list's k-th, 1 when it took the fast path,
// 0 when it went row by row. Called by a whole warp.
__device__ int fold_merge(const float* qsc, int rows, float* qls, int* qli,
                          int k, int row0, int lane) {
  const float thr = qls[k - 1];
  float m1 = -INFINITY;  // the lane's best score and its column
  int c1 = lane, cnt = 0;
  for (int c = lane; c < rows; c += 32) {
    const float s = qsc[c];
    cnt += s > thr;
    if (s > m1) {
      m1 = s;
      c1 = c;
    }
  }
  const int total = __reduce_add_sync(0xffffffffu, cnt);
  if (total == 0) return -1;
  const bool fast = __all_sync(0xffffffffu, cnt <= 1);
  if (!fast) {
    merge_rows(qsc, rows, qls, qli, k, -INFINITY, row0, lane);
    return 0;
  }
  for (int r = min(total, k); r > 0; --r) {
    // the best candidate left, the lower column among equals; columns
    // differ from lane to lane, so every lane ends on the same pair
    float bv = m1;
    int bc = c1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
      if (ov > bv || (ov == bv && oc < bc)) {
        bv = ov;
        bc = oc;
      }
    }
    if (bv > qls[k - 1]) warp_insert(qls, qli, k, bv, row0 + bc, lane);
    if (c1 == bc) m1 = -INFINITY;
  }
  return 1;
}

// The row source and scoring inputs of one scan.
struct ScanArgs {
  const uint32_t* store;    // (physical rows, d) in the store dtype
  const uint32_t* queries;  // (nq, d) in the store dtype, or packed int8
  const uint8_t* valid;     // (physical rows,) or null: every row live
  const float* row_scale;   // (physical rows,) f32, int8 only
  const int* tile_ids;      // (>= n / tile_n,) or null: rows in order
  int tile_n;
  int n;                    // logical rows scanned
  int d, nq, k;
  int rows_per_chunk, slab_words, n_chunks;
  float* cand_s;
  int* cand_i;
  const float* thr0;        // (nq,) K8's warm-start thresholds, or null
  unsigned long long* fold_stats;  // K9: (spans merged, spans fast), or null
};

// The physical row of the first row of the tile at logical row t0; a tile
// never straddles two entries of tile_ids (tile_n and t0 are multiples of 64).
__device__ __forceinline__ int tile_row0(const ScanArgs& a, int t0) {
  return a.tile_ids == nullptr ? t0 : a.tile_ids[t0 / a.tile_n] * a.tile_n + t0 % a.tile_n;
}

// Merge the scores of a tile (or of K9's span) into the block's lists: one
// warp per query, survivors in row order. sc holds a query's scores scs
// floats apart; rows of them are live at [0, rows) (K9: the span's first
// off + rows, from span0).
// hit (the tensor-core route's screen, else null): a query whose flag is
// 0 has no score above its list's k-th in the span, so its merge would
// insert nothing and is skipped; a merged query's flag goes back to 0.
template <bool FOLD>
__device__ void merge_tile(const ScanArgs& a, const float* sc, int scs, float* ls, int* li,
                           int* hit, int nqb, int q0, int rows, int phys0, int off,
                           int span0, int warp, int lane, unsigned long long& n_merged,
                           unsigned long long& n_fast) {
  const int k = a.k;
  for (int qi = warp; qi < nqb; qi += kThreads / 32) {
    if (hit != nullptr) {
      if (!hit[qi]) continue;
      __syncwarp();  // every lane has read the flag
      if (lane == 0) hit[qi] = 0;
    }
    float* qls = ls + qi * k;
    int* qli = li + qi * k;
    const float* qsc = sc + qi * scs;
    if constexpr (FOLD) {
      const int r = fold_merge(qsc, off + rows, qls, qli, k, span0, lane);
      n_merged += r >= 0;
      n_fast += r > 0;
    } else {
      const float warm = a.thr0 == nullptr ? -INFINITY : a.thr0[q0 + qi];
      merge_rows(qsc, rows, qls, qli, k, warm, phys0, lane);
    }
  }
}

// Each block's lists out as its chunk's candidates.
__device__ void write_candidates(const ScanArgs& a, const float* ls, const int* li, int nqb,
                                 int q0, int chunk, int tid) {
  for (int e = tid; e < nqb * a.k; e += kThreads) {
    const int qi = e / a.k, j = e % a.k;
    const size_t o = ((size_t)(q0 + qi) * a.n_chunks + chunk) * a.k + j;
    a.cand_s[o] = ls[e];
    a.cand_i[o] = li[e];
  }
}

// f32 and int8 rows: scalar FFMAs or __dp4a, one thread per row of a tile
// against QB / 4 queries. FOLD: K9, merging spans of kFoldSpan rows by the
// fold; else one tile.
template <int DT, int QB, bool FOLD>
__global__ void __launch_bounds__(kThreads) scan_pass1_simt(ScanArgs a) {
  constexpr int PW = Elem<DT>::kPerWord;
  constexpr int QPT = QB / kGroups;  // queries per thread
  constexpr int SPAN = FOLD ? kFoldSpan : kTileRows;  // rows a merge takes
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.d, k = a.k;
  const int words = d / PW;                    // 32-bit words per row
  const int qwords = DT == kInt8 ? words : d;  // per staged query
  const int stride = a.slab_words + 1;  // odd stride: a column read hits 32 banks
  float* qs = reinterpret_cast<float*>(smem);  // [QB][qwords], floats or packed int8
  const uint32_t* qw = reinterpret_cast<const uint32_t*>(qs);
  uint32_t* tile = reinterpret_cast<uint32_t*>(qs + QB * qwords);    // [64][stride]
  float* sc = reinterpret_cast<float*>(tile + kTileRows * stride);  // [QB][SPAN]
  float* ls = sc + QB * SPAN;                                       // [QB][k]
  int* li = reinterpret_cast<int*>(ls + QB * k);                    // [QB][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.y;
  const int q0 = blockIdx.x * QB;
  const int nqb = min(QB, a.nq - q0);
  const int r_begin = chunk * a.rows_per_chunk;
  const int r_end = min(a.n, r_begin + a.rows_per_chunk);

  for (int e = tid; e < QB * words; e += kThreads) {
    const int qi = e / words, w = e % words;
    const uint32_t v = qi < nqb ? a.queries[(size_t)(q0 + qi) * words + w] : 0u;
    if constexpr (DT == kInt8) {
      reinterpret_cast<uint32_t*>(qs)[qi * words + w] = v;
    } else {
      float x[2] = {0.f, 0.f};
      Elem<DT>::unpack(v, x);
#pragma unroll
      for (int p = 0; p < PW; ++p) qs[qi * d + w * PW + p] = x[p];
    }
  }
  for (int e = tid; e < QB * k; e += kThreads) {
    ls[e] = -INFINITY;
    li[e] = 0;
  }

  const uint4* sv = reinterpret_cast<const uint4*>(a.store);
  const int vec_per_row = words / 4;
  const int row = tid % kTileRows, grp = tid / kTileRows;
  int n_active = 0;  // how many of this thread's queries are real
#pragma unroll
  for (int j = 0; j < QPT; ++j) n_active += (grp + j * kGroups < nqb);
  unsigned long long n_merged = 0, n_fast = 0;  // K9's spans, this warp's

  for (int t0 = r_begin; t0 < r_end; t0 += kTileRows) {
    const int rows = min(kTileRows, r_end - t0);
    const int phys0 = tile_row0(a, t0);
    // the span's first row and this tile's column in sc (K9 has no tiles)
    const int span0 = FOLD ? r_begin + (t0 - r_begin) / SPAN * SPAN : t0;
    const int off = t0 - span0;
    float acc[QPT];
    int iacc[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      acc[j] = 0.f;
      iacc[j] = 0;
    }
    for (int w0 = 0; w0 < words; w0 += a.slab_words) {
      const int wn = min(a.slab_words, words - w0);
      const int vec = wn / 4;
      if (w0 > 0) __syncthreads();  // every thread is done with the last slab
      for (int e = tid; e < kTileRows * vec; e += kThreads) {
        const int r = e / vec, v = e % vec;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows) val = sv[(size_t)(phys0 + r) * vec_per_row + w0 / 4 + v];
        uint32_t* dst = tile + r * stride + v * 4;
        dst[0] = val.x;
        dst[1] = val.y;
        dst[2] = val.z;
        dst[3] = val.w;
      }
      __syncthreads();

      const uint32_t* trow = tile + row * stride;
      if constexpr (DT == kInt8) {
        const uint32_t* qslab = qw + w0;
#pragma unroll 4
        for (int w = 0; w < wn; ++w) {
          const int x = static_cast<int>(trow[w]);
#pragma unroll
          for (int j = 0; j < QPT; ++j)
            if (j < n_active)
              iacc[j] = __dp4a(x, static_cast<int>(qslab[(grp + j * kGroups) * words + w]),
                               iacc[j]);
        }
      } else {
        const float* qslab = qs + w0 * PW;
        // wn is a multiple of 4; without the unroll this loop ran slower on
        // the H100 than the whole-row loop it replaced (chip_smoke.py, Q=256)
#pragma unroll 4
        for (int w = 0; w < wn; ++w) {
          float x[2];
          Elem<DT>::unpack(trow[w], x);
#pragma unroll
          for (int j = 0; j < QPT; ++j) {
            if (j < n_active) {
              const float* qrow = qslab + (grp + j * kGroups) * d + w * PW;
#pragma unroll
              for (int p = 0; p < PW; ++p) acc[j] = fmaf(x[p], qrow[p], acc[j]);
            }
          }
        }
      }
    }
    const int prow = phys0 + row;
    const bool live = row < rows && (a.valid == nullptr || a.valid[prow]);
    float rscale = 0.f;
    if (DT == kInt8 && live) rscale = a.row_scale[prow];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const float s = DT == kInt8 ? __fmul_rn(__int2float_rn(iacc[j]), rscale) : acc[j];
      sc[(grp + j * kGroups) * SPAN + off + row] = live ? s : -INFINITY;
    }
    __syncthreads();
    // K9 merges once its span is full or the chunk ends
    if (FOLD && off + kTileRows < SPAN && t0 + kTileRows < r_end) continue;

    merge_tile<FOLD>(a, sc, SPAN, ls, li, nullptr, nqb, q0, rows, phys0, off, span0, warp,
                     lane, n_merged, n_fast);
  }
  if (FOLD && a.fold_stats != nullptr && lane == 0 && n_merged > 0) {
    atomicAdd(a.fold_stats, n_merged);
    atomicAdd(a.fold_stats + 1, n_fast);
  }
  __syncthreads();
  write_candidates(a, ls, li, nqb, q0, chunk, tid);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
// d += a (16 rows x 16, row-major) * b (16 x 8 queries), f32 accumulators;
// DT 0 bf16, 1 f16 operands
template <int DT>
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  if constexpr (DT == 0)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 16 bytes from global to shared memory without the registers; zeros where
// !fill (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// bf16 and f16 rows on the tensor cores (see the top of the file). Shared
// memory: the queries [QB][dp + 8] in the store dtype, two stage buffers
// [64][se + 8] (se = 2 slab_words elements of each row), the scores
// [QB][SPAN + 4] f32, the lists, a screen flag per query. The padded
// strides put the 8 rows of an ldmatrix on distinct banks, and a warp's
// score stores too.
template <int DT, int QB, bool FOLD>
__global__ void __launch_bounds__(kThreads, 2) scan_pass1_mma(ScanArgs a) {
  constexpr int SPAN = FOLD ? kFoldSpan : kTileRows;
  constexpr int SCS = SPAN + 4;          // a query's scores, floats apart
  constexpr int WQ = QB >= 32 ? 32 : 8;  // queries a warp scores
  constexpr int NT = WQ / 8;             // its n8 tiles
  constexpr int SCORERS = 4 * (QB / WQ); // warps that score: 4 row groups of 16
  static_assert(QB % WQ == 0 && SCORERS <= kThreads / 32, "query block");
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.d, k = a.k;
  const int dp = (d + 15) / 16 * 16;  // staged width: whole k-steps, zeros past d
  const int se = 2 * a.slab_words;    // elements of a row a stage holds
  const int qstr = dp + 8, tstr = se + 8;
  const int nslab = (dp + se - 1) / se;
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);                 // [QB][qstr]
  uint16_t* tiles = qs + QB * qstr;                                 // [2][64][tstr]
  float* sc = reinterpret_cast<float*>(tiles + 2 * kTileRows * tstr);  // [QB][SCS]
  float* ls = sc + QB * SCS;                                        // [QB][k]
  int* li = reinterpret_cast<int*>(ls + QB * k);                    // [QB][k]
  int* hit = li + QB * k;                                           // [QB]
  const uint16_t* store = reinterpret_cast<const uint16_t*>(a.store);
  const uint16_t* queries = reinterpret_cast<const uint16_t*>(a.queries);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.y;
  const int q0 = blockIdx.x * QB;
  const int nqb = min(QB, a.nq - q0);
  const int r_begin = chunk * a.rows_per_chunk;
  const int r_end = min(a.n, r_begin + a.rows_per_chunk);
  const int n_stages = (r_end - r_begin + kTileRows - 1) / kTileRows * nslab;

  for (int e = tid; e < QB * (dp / 8); e += kThreads) {
    const int qi = e / (dp / 8), c = e % (dp / 8) * 8;
    const bool in = qi < nqb && c < d;
    cp_async16(qs + qi * qstr + c, in ? queries + (size_t)(q0 + qi) * d + c : queries, in);
  }
  for (int e = tid; e < QB * k; e += kThreads) {
    ls[e] = -INFINITY;
    li[e] = 0;
  }
  for (int e = tid; e < QB; e += kThreads) hit[e] = 0;
  // stage g: slab g % nslab of the chunk's tile g / nslab, into buffer g & 1;
  // zeros past the tile's rows and past d; one group
  auto load = [&](int g) {
    const int t0 = r_begin + g / nslab * kTileRows, c0 = g % nslab * se;
    const int rows = min(kTileRows, r_end - t0), phys0 = tile_row0(a, t0);
    const int vec = min(se, dp - c0) / 8;  // 16-byte pieces of a row
    uint16_t* buf = tiles + (g & 1) * kTileRows * tstr;
    int r = tid / vec, v = tid % vec;
    const int dr = kThreads / vec, dv = kThreads % vec;
    while (r < kTileRows) {
      const int c = c0 + v * 8;
      const bool in = r < rows && c < d;
      cp_async16(buf + r * tstr + v * 8, in ? store + (size_t)(phys0 + r) * d + c : store, in);
      v += dv;
      r += dr;
      if (v >= vec) {
        v -= vec;
        ++r;
      }
    }
    cp_async_commit();
  };

  const int rg = warp & 3, qg = warp >> 2;  // this warp's rows rg*16.., queries qg*WQ..
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[t][c] = 0.f;
  unsigned long long n_merged = 0, n_fast = 0;  // K9's spans, this warp's

  load(0);
  for (int g = 0; g < n_stages; ++g) {
    cp_async_wait_all();  // this thread's copies of stage g have landed
    __syncthreads();      // everyone's have; everyone is done with stage g - 1
    if (g + 1 < n_stages) load(g + 1);  // in flight while stage g is scored and merged
    const int s = g % nslab, c0 = s * se, cn = min(se, dp - c0);
    const uint16_t* buf = tiles + (g & 1) * kTileRows * tstr;
    if (warp < SCORERS) {
      const uint16_t* arow = buf + (rg * 16 + (lane & 15)) * tstr + (lane >> 4) * 8;
      const uint16_t* brow = qs + (qg * WQ) * qstr + c0 + ((lane >> 3) & 1) * 8;
      for (int kk = 0; kk < cn; kk += 16) {
        uint32_t af[4];
        ldmatrix_x4(af, arow + kk);
        if constexpr (NT == 1) {
          uint32_t bf[2];
          ldmatrix_x2(bf, brow + (lane & 7) * qstr + kk);
          mma16816<DT>(acc[0], af, bf[0], bf[1]);
        } else {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bf[4];
            ldmatrix_x4(bf, brow + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * qstr + kk);
            mma16816<DT>(acc[2 * np], af, bf[0], bf[1]);
            mma16816<DT>(acc[2 * np + 1], af, bf[2], bf[3]);
          }
        }
      }
    }
    if (s != nslab - 1) continue;  // the tile's next slab

    const int t0 = r_begin + g / nslab * kTileRows;
    const int rows = min(kTileRows, r_end - t0), phys0 = tile_row0(a, t0);
    // the span's first row and this tile's column in sc (K9 has no tiles)
    const int span0 = FOLD ? r_begin + (t0 - r_begin) / SPAN * SPAN : t0;
    const int off = t0 - span0;
    if (warp < SCORERS) {
      // accumulator (row lane/4 [+ 8], queries 2 (lane%4) [+ 1]) of each n8
      // tile, into sc; the screen: does a score beat its query's k-th (the
      // lists hold still until the merge below)
      bool beat[NT][2] = {};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rg * 16 + (lane >> 2) + 8 * h;
        const bool live = r < rows && (a.valid == nullptr || a.valid[phys0 + r]);
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qc = qg * WQ + t * 8 + (lane & 3) * 2 + c;
            const float v = live ? acc[t][2 * h + c] : -INFINITY;
            sc[qc * SCS + off + r] = v;
            beat[t][c] |= v > ls[qc * k + k - 1];
            acc[t][2 * h + c] = 0.f;
          }
      }
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (beat[t][c]) hit[qg * WQ + t * 8 + (lane & 3) * 2 + c] = 1;
    }
    __syncthreads();
    // K9 merges once its span is full or the chunk ends
    if (FOLD && off + kTileRows < SPAN && t0 + kTileRows < r_end) continue;
    merge_tile<FOLD>(a, sc, SCS, ls, li, hit, nqb, q0, rows, phys0, off, span0, warp,
                     lane, n_merged, n_fast);
  }
  if (FOLD && a.fold_stats != nullptr && lane == 0 && n_merged > 0) {
    atomicAdd(a.fold_stats, n_merged);
    atomicAdd(a.fold_stats + 1, n_fast);
  }
  __syncthreads();
  write_candidates(a, ls, li, nqb, q0, chunk, tid);
}

__global__ void __launch_bounds__(kPass2Warps * 32)
scan_pass2(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
           int nq, int n_chunks, int k, const float* __restrict__ qscale,
           float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ls = reinterpret_cast<float*>(smem) + warp * k;
  int* li = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) +
                                   kPass2Warps * k) + warp * k;
  const int q = blockIdx.x * kPass2Warps + warp;
  if (q >= nq) return;  // no block-wide barrier below
  for (int j = lane; j < k; j += 32) {
    ls[j] = -INFINITY;
    li[j] = 0;
  }
  __syncwarp();
  for (int c = 0; c < n_chunks; ++c) {
    const float* cs = cand_s + ((size_t)q * n_chunks + c) * k;
    const int* ci = cand_i + ((size_t)q * n_chunks + c) * k;
    for (int base = 0; base < k; base += 32) {
      const bool in = base + lane < k;
      const float s = in ? cs[base + lane] : -INFINITY;
      const int id = in ? ci[base + lane] : 0;
      unsigned m = __ballot_sync(0xffffffffu, s > ls[k - 1]);
      if (!m) break;  // the list is sorted: nothing later beats the k-th
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const float v = __shfl_sync(0xffffffffu, s, src);
        const int vid = __shfl_sync(0xffffffffu, id, src);
        if (v > ls[k - 1]) warp_insert(ls, li, k, v, vid, lane);
      }
    }
  }
  const float qs = qscale == nullptr ? 1.f : qscale[q];
  for (int j = lane; j < k; j += 32) {
    const float s = ls[j];
    const bool empty = s == -INFINITY;
    out_s[(size_t)q * k + j] = empty || qscale == nullptr ? s : __fmul_rn(s, qs);
    out_i[(size_t)q * k + j] = empty ? 0 : li[j];
  }
}

// Pass 1 of one route: checks the layout the wrapper planned, sizes the
// shared memory as the kernel carves it, grid (query blocks, chunks).
template <int DT, int QB, bool FOLD>
cudaError_t launch_pass1(const ScanArgs& a, cudaStream_t stream) {
  constexpr int SPAN = FOLD ? kFoldSpan : kTileRows;
  constexpr bool MMA = DT == 0 || DT == 1;
  if (a.tile_ids != nullptr && (FOLD || a.tile_n < kTileRows || a.tile_n % kTileRows))
    return cudaErrorInvalidValue;
  size_t smem;
  if constexpr (MMA) {
    if (a.slab_words < 8 || a.slab_words % 8) return cudaErrorInvalidValue;
    const size_t dp = (a.d + 15) / 16 * 16;
    smem = (size_t)QB * (dp + 8) * 2 + (size_t)2 * kTileRows * (2 * a.slab_words + 8) * 2 +
           (size_t)QB * (SPAN + 4) * 4 + (size_t)QB * a.k * 8 + (size_t)QB * 4;
  } else {
    if (a.slab_words < 4 || a.slab_words % 4) return cudaErrorInvalidValue;
    const size_t qwords = DT == kInt8 ? a.d / 4 : a.d;
    smem = (size_t)QB * qwords * 4 + (size_t)kTileRows * (a.slab_words + 1) * 4 +
           (size_t)QB * SPAN * 4 + (size_t)QB * a.k * 8;
  }
  void (*kern)(ScanArgs);
  if constexpr (MMA)
    kern = scan_pass1_mma<DT, QB, FOLD>;
  else
    kern = scan_pass1_simt<DT, QB, FOLD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.nq + QB - 1) / QB, a.n_chunks);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool FOLD>
cudaError_t launch_pass1_dt(int dtype, int qb, const ScanArgs& a, cudaStream_t st) {
  // bf16/f16: the tensor-core route, query blocks of 64 or 8
  if (dtype == 0 || dtype == 1) {
    if (qb != 64 && qb != 8) return cudaErrorInvalidValue;
    if (dtype == 0)
      return qb == 64 ? launch_pass1<0, 64, FOLD>(a, st) : launch_pass1<0, 8, FOLD>(a, st);
    return qb == 64 ? launch_pass1<1, 64, FOLD>(a, st) : launch_pass1<1, 8, FOLD>(a, st);
  }
  // f32, int8: the SIMT route, query blocks of 16 or 4
  if (qb != 16 && qb != 4) return cudaErrorInvalidValue;
  if (dtype == 2)
    return qb == 16 ? launch_pass1<2, 16, FOLD>(a, st) : launch_pass1<2, 4, FOLD>(a, st);
  if (dtype == kInt8 && !FOLD)  // K9 scores bf16/f16/f32 rows only
    return qb == 16 ? launch_pass1<kInt8, 16, false>(a, st)
                    : launch_pass1<kInt8, 4, false>(a, st);
  return cudaErrorInvalidValue;
}

// Both passes on one stream.
cudaError_t scan(const ScanArgs& a, int dtype, int qb, bool fold,
                 const float* qscale, float* out_s, int* out_i,
                 cudaStream_t st) {
  cudaError_t e = fold ? launch_pass1_dt<true>(dtype, qb, a, st)
                       : launch_pass1_dt<false>(dtype, qb, a, st);
  if (e != cudaSuccess) return e;
  const size_t smem2 = (size_t)kPass2Warps * a.k * 8;
  scan_pass2<<<(a.nq + kPass2Warps - 1) / kPass2Warps, kPass2Warps * 32, smem2,
               st>>>(a.cand_s, a.cand_i, a.nq, a.n_chunks, a.k, qscale, out_s,
                     out_i);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 bf16, 1 f16, 2 f32, 3 int8 (row_scale and qscale then given).
// tile_ids null: scan rows 0..n-1; else n = live tiles * tile_n logical
// rows through the tile list. thr0 null: K1, K3, K4a, K4b; else K8's
// per-query warm-start thresholds.
extern "C" int sema_scan_topk(const void* store, const void* queries,
                              const uint8_t* valid, const float* row_scale,
                              const int* tile_ids, int tile_n, int n, int d,
                              int nq, int k, int dtype, int qb,
                              int rows_per_chunk, int slab_words, int n_chunks,
                              float* cand_s, int* cand_i, const float* qscale,
                              const float* thr0, float* out_s, int* out_i,
                              void* stream) {
  if (dtype == kInt8 && (row_scale == nullptr || qscale == nullptr))
    return cudaErrorInvalidValue;
  const ScanArgs a{static_cast<const uint32_t*>(store),
                   static_cast<const uint32_t*>(queries),
                   valid, row_scale, tile_ids, tile_n, n, d, nq, k,
                   rows_per_chunk, slab_words, n_chunks, cand_s, cand_i,
                   thr0, nullptr};
  return scan(a, dtype, qb, false, qscale, out_s, out_i,
              static_cast<cudaStream_t>(stream));
}

// K9: rows 0..n-1 of a bf16/f16/f32 store, every row live. stats null, or
// two counters that gain the spans merged and the spans on the fast path.
extern "C" int sema_fold_topk(const void* store, const void* queries, int n,
                              int d, int nq, int k, int dtype, int qb,
                              int rows_per_chunk, int slab_words, int n_chunks,
                              float* cand_s, int* cand_i, float* out_s,
                              int* out_i, unsigned long long* stats,
                              void* stream) {
  const ScanArgs a{static_cast<const uint32_t*>(store),
                   static_cast<const uint32_t*>(queries),
                   nullptr, nullptr, nullptr, 0, n, d, nq, k,
                   rows_per_chunk, slab_words, n_chunks, cand_s, cand_i,
                   nullptr, stats};
  return scan(a, dtype, qb, true, nullptr, out_s, out_i,
              static_cast<cudaStream_t>(stream));
}

extern "C" const char* sema_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
