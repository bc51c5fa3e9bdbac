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
//   pass 1  grid (chunk of rows, block of queries). Each block streams its
//           row range through shared memory 64 rows at a time (a row wider
//           than shared memory allows goes in slabs of words), scores the
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
// Scoring. bf16/f16/f32 rows: f32 FMAs over the row's values against the
// query cast to the store dtype, f32 accumulation. int8 rows: __dp4a over
// packed words of the row and of the per-query quantized query, summed in
// i32, converted once to f32 and multiplied once by the row's f32 scale:
// the order of pallas_topk.py:219, exact (the i32 sum converts without
// loss while d <= 1040), so the scores and ids equal the plain version's.
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
// its chunk, its query block or its slab, since acc runs over the row's
// words in order across slabs, so those are the very bits the full scan
// computes. A score from another product (cuBLAS sums in another order)
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
// scoring, 2*Q*N*d operations, which the kernel does with scalar
// FMAs (67 TFLOP/s peak) or dp4a where mma.sync or wgmma (IMMA for int8)
// would reach the tensor cores. The chunking keeps about two blocks per SM
// in flight whatever Q is; the merge costs next to nothing once the lists
// fill, since few scores beat the k-th. Pass 2 walks a query's chunk lists
// one after another in one warp, so it grows with chunks * k; fewer, longer
// chunks make pass 1 slower by more than that (measured at 3,000 rows).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// One 32-bit word of a row, unpacked to floats. 0 = bf16, 1 = f16, 2 = f32;
// 3 = int8 is scored on packed words and only gives its width here.
template <int DT> struct Elem;
template <> struct Elem<0> {
  static constexpr int kPerWord = 2;
  __device__ __forceinline__ static void unpack(uint32_t w, float* x) {
    x[0] = __uint_as_float(w << 16);
    x[1] = __uint_as_float(w & 0xffff0000u);
  }
};
template <> struct Elem<1> {
  static constexpr int kPerWord = 2;
  __device__ __forceinline__ static void unpack(uint32_t w, float* x) {
    __half2 h = *reinterpret_cast<__half2*>(&w);
    float2 f = __half22float2(h);
    x[0] = f.x;
    x[1] = f.y;
  }
};
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

// FOLD: K9, merging spans of kFoldSpan rows by the fold; else one tile.
template <int DT, int QB, bool FOLD>
__global__ void __launch_bounds__(kThreads) scan_pass1(ScanArgs a) {
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
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QB;
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
    // the physical row of the tile's first row; a tile never straddles two
    // entries of tile_ids (tile_n and t0 are multiples of 64)
    const int phys0 = a.tile_ids == nullptr
                          ? t0
                          : a.tile_ids[t0 / a.tile_n] * a.tile_n + t0 % a.tile_n;
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

    // merge: one warp per query; survivors in row order
    for (int qi = warp; qi < nqb; qi += kThreads / 32) {
      float* qls = ls + qi * k;
      int* qli = li + qi * k;
      const float* qsc = sc + qi * SPAN;
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
  if (FOLD && a.fold_stats != nullptr && lane == 0 && n_merged > 0) {
    atomicAdd(a.fold_stats, n_merged);
    atomicAdd(a.fold_stats + 1, n_fast);
  }
  __syncthreads();
  for (int e = tid; e < nqb * k; e += kThreads) {
    const int qi = e / k, j = e % k;
    const size_t o = ((size_t)(q0 + qi) * a.n_chunks + chunk) * k + j;
    a.cand_s[o] = ls[e];
    a.cand_i[o] = li[e];
  }
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

template <int DT, int QB, bool FOLD>
cudaError_t launch_pass1(const ScanArgs& a, cudaStream_t stream) {
  constexpr int SPAN = FOLD ? kFoldSpan : kTileRows;
  if (a.slab_words < 4 || a.slab_words % 4) return cudaErrorInvalidValue;
  if (a.tile_ids != nullptr && (FOLD || a.tile_n < kTileRows || a.tile_n % kTileRows))
    return cudaErrorInvalidValue;
  const size_t qwords = DT == kInt8 ? a.d / 4 : a.d;
  const size_t smem = (size_t)QB * qwords * 4 + (size_t)kTileRows * (a.slab_words + 1) * 4 +
                      (size_t)QB * SPAN * 4 + (size_t)QB * a.k * 8;
  auto kern = scan_pass1<DT, QB, FOLD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.n_chunks, (a.nq + QB - 1) / QB);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int QB, bool FOLD>
cudaError_t launch_pass1_dt(int dtype, const ScanArgs& a, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_pass1<0, QB, FOLD>(a, stream);
    case 1: return launch_pass1<1, QB, FOLD>(a, stream);
    case 2: return launch_pass1<2, QB, FOLD>(a, stream);
    case kInt8:
      if constexpr (FOLD)
        return cudaErrorInvalidValue;  // K9 scores bf16/f16/f32 rows only
      else
        return launch_pass1<kInt8, QB, false>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Both passes on one stream.
cudaError_t scan(const ScanArgs& a, int dtype, int qb, bool fold,
                 const float* qscale, float* out_s, int* out_i,
                 cudaStream_t st) {
  cudaError_t e;
  if (qb == 16)
    e = fold ? launch_pass1_dt<16, true>(dtype, a, st)
             : launch_pass1_dt<16, false>(dtype, a, st);
  else if (qb == 4)
    e = fold ? launch_pass1_dt<4, true>(dtype, a, st)
             : launch_pass1_dt<4, false>(dtype, a, st);
  else
    e = cudaErrorInvalidValue;
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
