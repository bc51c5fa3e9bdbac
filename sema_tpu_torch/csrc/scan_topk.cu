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
//           (Q, chunks, k) candidates. f32 rows and K9 merge a tile's
//           survivors one at a time (merge_rows); int8 rows merge three or
//           more at once (merge_ranked), each survivor taking its rank.
//           bf16/f16 rows of K1, K3 and K8 (scan_pass1_merged) merge in
//           warps of their own beside the scoring warps: the scorers
//           write each tile's scores into a score buffer (two where shared
//           memory allows) and go on to the next stage, named barriers
//           handing the buffer over; a merger queues each query's scores
//           above its threshold (max(the list's k-th, K8's warm), as of
//           the last flush) 32 columns at a time, and flushes a queue
//           that a round does not fit, and every queue at the chunk's end:
//           a bitonic sort of the queue under before() in registers, then
//           each entry placed at its rank (flush_queue), ranks k and
//           below dropped, and the threshold refreshed.
//   pass 2  one block of W warps a query (W = min(32, chunks, 4096 / k),
//           the wrapper's pass2_warps). Warp w merges the chunk lists of
//           its run, chunks [w C / W, (w + 1) C / W), in order into a list
//           of k; then the runs' lists merge pairwise in a tree, warps i
//           .. i + 2s - 1 merging list i + s into list i at step s. A merge
//           (merge_lists) places each entry of either sorted list at its
//           index plus the entries of the other list that come before it,
//           by binary search: no dependent chain of loads, no insertion
//           one entry at a time. Slots with no row are -inf with id 0, as
//           the TPU kernels' zeroed ids leave them. An int8 scan's
//           per-query scale multiplies the merged scores here, after the
//           merge, as pallas_topk.py:432 does.
//   one launch  at one query (the CLI's, the server's single requests,
//           each shard's and each spill stage's call) the bf16/f16 route
//           of K1, K3 and K8 runs pass 2's merge inside pass 1's launch:
//           each block writes its candidates, fences them and counts
//           itself done on its query block's counter; the block that
//           counts last copies the query's chunk lists into its shared
//           memory in one sweep, merges them exactly as pass 2 does
//           (merge_chunks, with W = min(its 16 warps, chunks, 4096 / k)
//           warps: any W gives the same bits, see below) and sets the
//           counter back to 0 for the next launch on its stream. The
//           wrapper takes this route where the chunk lists and the
//           merge's own lists fit pass 1's shared memory (a few chunks,
//           or a small k); elsewhere pass 2's launch merges. At one
//           query pass 1 takes a few microseconds of device time and the
//           call's cost is the host's: one launch, no cast launch (f32
//           queries are rounded to bf16/f16 as they are staged), one
//           workspace allocation, the tile list through a pinned buffer
//           of the card's (ops/scan_topk.py:_launch).
//
// Why any merge order gives the sequential result. Rows are scanned in
// increasing row id: K1, K4a, K8 and K9 scan rows 0..n-1 in order, K3 and
// K4b tiles whose ids ops/ivf.py:select_tiles sorts (the wrapper refuses
// a list that is not strictly increasing), and a chunk is a range of that
// order. A score enters a list only if it beats the k-th, after equal
// scores, and -inf never enters. So the sequential merge of all chunks,
// which the TPU kernel performs, returns exactly the k best rows under
// the total order "higher score first, then lower row id" (before()),
// and so does any merge that ranks entries under that order: each row
// appears once, so the ranks of finite entries are distinct. The runs,
// the tree and merge_ranked rank by before(), score and id: the result,
// ids and scores, is the sequential merge's bit for bit. So do the
// queues of scan_pass1_merged: a flush keeps the first k of the list and
// the queue under before(), a total order, so the list after any sequence
// of flushes is the first k of every row queued so far; a stale threshold
// (one that has not risen since the last flush) is no higher than the
// sequential merge's at that row, so it queues every row that the
// sequential merge would insert, and the extra ones rank k or below
// when their flush places them. Where the flushes fall, and how many
// rows they take, changes no bit of the result.
//
// Scoring, by the store dtype.
//   bf16, f16, int8  the tensor cores: mma.sync m16n8k16 (bf16, f16; f32
//           accumulators) or m16n8k32 s8.s8.s32 (int8; i32 accumulators),
//           the store rows the A operand (row-major, d contiguous), the
//           queries the B operand, both in the store dtype (an int8
//           scan's f32 queries quantized per row by quantize_queries, its
//           first launch) and fed by ldmatrix from shared memory whose
//           rows are padded by 16 bytes.
//           An int8 row is addressed as pairs of values: a 16 x 32 int8
//           tile is a 16 x 16 tile of 16-bit pairs, and the fragments of
//           m16n8k32 hold, register for register, the pairs that the
//           m16n8k16 fragments hold, so ldmatrix's addressing is the bf16
//           route's; rows are zero past d up to the k-step (32 int8 values,
//           16 bf16). The tiles (or slabs of their rows) come in by
//           cp.async into two buffers: the next is in flight while this one
//           is scored and merged. An int8 or K9 block takes 64 queries
//           for a batch at k <= 128 (8 warps: 4 groups of 16 rows x 2 of 32
//           queries), so a store is read once per 64 queries, else 8 (4
//           warps of 16 rows x 8 queries). A bf16/f16 block of K1, K3 or
//           K8 takes the most of 64, 32 (4 scoring warps of 32 queries), 16
//           (8 of 8) and 8 whose lists leave room for slabs of 64 elements
//           (ops/scan_topk.py:merge_layout): at k 1,024 16, so that a batch
//           of 256 reads the store 16 times, not 32. A bf16 or f16 product is exact in f32; the
//           tensor cores add the 16 products of a k-step and the running
//           sum in their own order, not the IEEE sequence of FMAs, so the
//           scores may differ from a sequence of FMAs in the last bits.
//           An int8 row's i32 sum is exact in any order (d <= 1040: each
//           product is at most 127^2), is converted once to f32 and
//           multiplied once by the row's f32 scale (__fmul_rn(__int2float_rn
//           (sum), scale)), the order of pallas_topk.py:219, so the int8
//           scores and ids equal the plain version's bit for bit.
//           Before a tile's scores go to the merge, each scoring thread
//           screens its own against its queries' k-th (scan_pass1_merged:
//           their thresholds) and flags a query that has a score above it;
//           the merge skips an unflagged query, whose merge would take
//           nothing.
//           K1 and K8 of a batch (more than 8 queries, rows 0..n-1 of a
//           bf16/f16 store) score on wgmma instead (wgmma_scorers, the WG
//           form of scan_pass1_merged; ops/scan_topk.py:wgmma_layout plans
//           it): a producer warp keeps a ring of TMA copies of 64 x 64
//           boxes of the rows in flight, guarded by mbarriers, and a
//           consumer warpgroup runs wgmma m64nQBk16 (QB 32 or 64) on each
//           box against the block's queries, staged once, both in the
//           128-byte swizzle; each score is still one f32 accumulator
//           stepped over k16 in order, so the scores are mma.sync's bit
//           for bit. The mma.sync scorers read every operand through
//           ldmatrix (three times the shared-memory bytes of their
//           products) and stop the block at each stage's barrier: at
//           262,144 x 768, Q 256 they ran at a tenth of the card's bf16
//           rate, 1.35 times the library's matmul + topk.
//   f32     f32 FMAs over the row's values against the query, one thread a
//           row (TF32 would round the operands).
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
// bf16 bucket at d=384, 80 us for an int8 one at d=1024, 10 us for an int8
// IVF probe of 61 tiles of 512), and at small stores the host's issue of
// the call: at the main path's 3,600 x 384 pass 1 takes about 7 us of
// device time, its merge in the same launch about 20, and the host about
// 35-50 us a call (one launch, one allocation; it took 90-120 with two
// launches, a cast and five allocations: chip_smoke.py scan_host, H100);
// at Q=256 the bytes still for bf16 and int8 (2*Q*N*d operations
// over N*d*itemsize bytes is Q = 256 a byte for bf16, under the card's
// 295, and 512 for int8, under its 590; 0.240 ms at 1M x 384 bf16), the
// rows read 4 times from L2 (once per query block of 64); for f32 the
// scoring, with scalar FMAs (67 TFLOP/s). What the int8 route and K9
// spend beyond the scoring goes to the merge, which stops the scoring
// while it runs; the bf16/f16 route's merge runs in warps of its own, so
// that a tile's merge overlaps the next tile's copies and products, and
// costs time only where it takes longer than they do (the first tiles of
// a chunk, where every score survives). On the wgmma route of a batch the
// products take a fifth of the card's bf16 rate or less, and streaming the
// rows into the ring sets the time: with the products and the merge left
// out, a build still took two thirds of the route's time at 262,144 x
// 768, Q 256 (the four query blocks of a chunk each read its rows from L2,
// some 3.7 TB/s in all), and at one query block the route runs at 1.2
// times HBM's bound (chip_wgmma_ab.py, H100). A build that shared each
// box among a chunk's query blocks by TMA multicast (clusters of four)
// took 1.22-1.36 times as long, in turns. Each chunk
// restarts its lists, so the insertions grow with the chunks, and the
// wrapper plans
// one wave of blocks (chunk_plan), two an SM where shared memory holds
// two; at one query block an int8 scan takes fewer, longer chunks, so that
// at most a quarter of its rows become candidates. Pass 2 grows with
// chunks * k / W for its runs and k log k for each of log W tree steps.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>
#include <map>
#include <mutex>
#include <utility>

#include "hopper.cuh"  // smem_addr, mbarriers, TMA, wgmma_16

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;
constexpr int kGroups = kThreads / kTileRows;  // query groups per tile row
constexpr int kInt8 = 3;
constexpr int kFoldSpan = 256;      // rows a K9 merge folds: 8 columns a lane
constexpr int kPass2MaxWarps = 32;  // warps of a pass-2 block
constexpr int kPass2Slots = 4096;   // warps * k of a pass-2 block: 96 KB of lists

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

// The order of every list: (s1, i1) comes before (s2, i2) if its score is
// higher, or equal with a lower row id (see the top of the file).
__device__ __forceinline__ bool before(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// The entries of a sorted list (ls, li; its first n) that come before
// (v, id): a binary search.
__device__ __forceinline__ int count_before(const float* ls, const int* li, int n, float v,
                                            int id) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(ls[mid], li[mid], v, id))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// (os, oi) = the first k entries of the union of the sorted lists a and b
// (k entries each) under before(): an entry goes to its index in its own
// list plus the entries of the other list that come before it. Only the fa
// entries of a that come before b's k-th can rank below k (b's k entries
// come before the others), and the fb of b before a's k-th; where a list
// is not full, its k-th is -inf with id 0 and the other's finite entries
// all count. The finite entries' ids are distinct (rows of disjoint
// ranges), so their slots are distinct, and every slot below k that no
// entry takes lies at or past fa + fb, past the union's finite entries:
// -inf with id 0. Called by nthr threads, t the caller's index among them;
// o is neither a nor b, and every slot of o is written once.
__device__ void merge_lists(const float* as, const int* ai, const float* bs, const int* bi,
                            float* os, int* oi, int k, int t, int nthr) {
  const int fa = count_before(as, ai, k, bs[k - 1], bi[k - 1]);
  const int fb = count_before(bs, bi, k, as[k - 1], ai[k - 1]);
  for (int j = min(k, fa + fb) + t; j < k; j += nthr) {
    os[j] = -INFINITY;
    oi[j] = 0;
  }
  for (int j = t; j < fa; j += nthr) {
    const int p = j + count_before(bs, bi, fb, as[j], ai[j]);
    if (p < k) {
      os[p] = as[j];
      oi[p] = ai[j];
    }
  }
  for (int j = t; j < fb; j += nthr) {
    const int p = j + count_before(as, ai, fa, bs[j], bi[j]);
    if (p < k) {
      os[p] = bs[j];
      oi[p] = bi[j];
    }
  }
}

// The int8 route's merge of a tile's scores (qsc[0, rows), rows row0 + c)
// into one query's sorted list, all survivors at once: a score above the
// list's k-th takes the slot of its rank under before() among the list's
// entries (all of earlier rows) and the tile's other survivors (no other
// score of the tile can come before it); the list's entries keep their
// order in the slots left, each moved up by the survivors placed below it.
// That is the list which inserting the survivors one by one in row order
// gives, and what merge_rows gives; a tile of at most kRankedMin survivors
// goes through merge_rows, whose insertions then cost less. taken:
// (k + 31) / 32 words of scratch, the slots the survivors take. Called by
// a whole warp; k <= 1024, rows <= 64.
constexpr int kRankedMin = 2;
__device__ void merge_ranked(const float* qsc, int rows, float* qls, int* qli, int k,
                             int row0, int lane, unsigned* taken) {
  const float kth = qls[k - 1];
  float v[2];
  unsigned surv[2];  // the tile's survivors, columns h * 32 + bit
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + 32 * h;
    v[h] = c < rows ? qsc[c] : -INFINITY;
    surv[h] = __ballot_sync(0xffffffffu, v[h] > kth);
  }
  if (__popc(surv[0]) + __popc(surv[1]) <= kRankedMin) {
    merge_rows(qsc, rows, qls, qli, k, -INFINITY, row0, lane);
    return;
  }
  const int words = (k + 31) / 32;
  if (lane < words) taken[lane] = 0u;
  // each score's rank among the tile's scores: the scores of columns j and
  // j + 32 from lane j, compared by every lane with its own two
  int rank[2] = {0, 0};
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    const float a0 = __shfl_sync(0xffffffffu, v[0], j);
    const float a1 = __shfl_sync(0xffffffffu, v[1], j);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rank[h] += before(a0, j, v[h], lane + 32 * h) + before(a1, j + 32, v[h], lane + 32 * h);
  }
  __syncwarp();
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pos[h] = k;
    if (v[h] > kth) {
      const int r = rank[h] + count_before(qls, qli, k, v[h], row0 + lane + 32 * h);
      pos[h] = r;
      if (r < k) atomicOr(&taken[r >> 5], 1u << (r & 31));
    }
  }
  __syncwarp();
  // taken slots below each word of slots: an exclusive scan of its popcounts
  const unsigned own = lane < words ? taken[lane] : 0u;
  int incl = __popc(own);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  const int excl = incl - __popc(own);
  const unsigned busy = __ballot_sync(0xffffffffu, own != 0u);
  // from the top word down to the lowest with a taken slot: free slot p
  // takes entry p - (taken slots below p), which lies at or below p, so
  // every entry is read before its slot is written
  for (int w = words - 1; busy != 0u && w >= __ffs(busy) - 1; --w) {
    const unsigned bits = __shfl_sync(0xffffffffu, own, w);
    const int below = __shfl_sync(0xffffffffu, excl, w) + __popc(bits & ((1u << lane) - 1u));
    const int p = w * 32 + lane;
    const bool mv = p < k && !((bits >> lane) & 1u);
    float s = 0.f;
    int id = 0;
    if (mv) {
      s = qls[p - below];
      id = qli[p - below];
    }
    __syncwarp();
    if (mv) {
      qls[p] = s;
      qli[p] = id;
    }
    __syncwarp();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (pos[h] < k) {
      qls[pos[h]] = v[h];
      qli[pos[h]] = row0 + lane + 32 * h;
    }
  __syncwarp();
}

// The row source and scoring inputs of one scan.
struct ScanArgs {
  const uint32_t* store;    // (physical rows, d) in the store dtype
  const uint32_t* queries;  // (nq, d) in the store dtype, int8 quantized
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
  int score_bufs;           // bf16/f16 K1, K3, K8: score buffers (1 or 2)
  int ring_stages;          // bf16/f16 K1, K8 of a batch: the wgmma route's
                            // ring of TMA stages, or 0: the mma.sync scorers
  int smem_plan;            // pass 1's shared memory as the wrapper planned it
  unsigned long long* merge_stats;  // bf16/f16 K1, K3, K8: (survivors
                                    // queued, flushes), or null
  const float* fq;          // bf16/f16 K1, K3, K8: (nq, d) f32 queries, cast
                            // as they are staged (queries then null), or null
  int* done;                // the one-launch route: a counter a query block,
                            // or null (pass 2 merges)
  int pass2_warps;          // the warps of pass 2's merge
  float* out_s;             // (nq, k) merged scores and ids
  int* out_i;
  int card;                 // the card the launch runs on (host side)
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
// RANKED: the int8 route, merge_ranked (taken: 32 words a warp).
template <bool FOLD, bool RANKED>
__device__ void merge_tile(const ScanArgs& a, const float* sc, int scs, float* ls, int* li,
                           int* hit, unsigned* taken, int nqb, int q0, int rows, int phys0,
                           int off, int span0, int warp, int lane,
                           unsigned long long& n_merged, unsigned long long& n_fast) {
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
    } else if constexpr (RANKED) {
      merge_ranked(qsc, rows, qls, qli, k, phys0, lane, taken + warp * 32);
    } else {
      const float warm = a.thr0 == nullptr ? -INFINITY : a.thr0[q0 + qi];
      merge_rows(qsc, rows, qls, qli, k, warm, phys0, lane);
    }
  }
}

// Each block's lists out as its chunk's candidates (nthr threads).
__device__ void write_candidates(const ScanArgs& a, const float* ls, const int* li, int nqb,
                                 int q0, int chunk, int tid, int nthr = kThreads) {
  for (int e = tid; e < nqb * a.k; e += nthr) {
    const int qi = e / a.k, j = e % a.k;
    const size_t o = ((size_t)(q0 + qi) * a.n_chunks + chunk) * a.k + j;
    a.cand_s[o] = ls[e];
    a.cand_i[o] = li[e];
  }
}

// f32 rows: scalar FFMAs, one thread per row of a tile against QB / 4
// queries. FOLD: K9, merging spans of kFoldSpan rows by the fold; else one
// tile.
template <int QB, bool FOLD>
__global__ void __launch_bounds__(kThreads) scan_pass1_simt(ScanArgs a) {
  constexpr int QPT = QB / kGroups;  // queries per thread
  constexpr int SPAN = FOLD ? kFoldSpan : kTileRows;  // rows a merge takes
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.d, k = a.k;
  const int stride = a.slab_words + 1;  // odd stride: a column read hits 32 banks
  float* qs = reinterpret_cast<float*>(smem);                       // [QB][d]
  uint32_t* tile = reinterpret_cast<uint32_t*>(qs + QB * d);        // [64][stride]
  float* sc = reinterpret_cast<float*>(tile + kTileRows * stride);  // [QB][SPAN]
  float* ls = sc + QB * SPAN;                                       // [QB][k]
  int* li = reinterpret_cast<int*>(ls + QB * k);                    // [QB][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.y;
  const int q0 = blockIdx.x * QB;
  const int nqb = min(QB, a.nq - q0);
  const int r_begin = chunk * a.rows_per_chunk;
  const int r_end = min(a.n, r_begin + a.rows_per_chunk);

  for (int e = tid; e < QB * d; e += kThreads) {
    const int qi = e / d, w = e % d;
    qs[e] = qi < nqb ? __uint_as_float(a.queries[(size_t)(q0 + qi) * d + w]) : 0.f;
  }
  for (int e = tid; e < QB * k; e += kThreads) {
    ls[e] = -INFINITY;
    li[e] = 0;
  }

  const uint4* sv = reinterpret_cast<const uint4*>(a.store);
  const int vec_per_row = d / 4;
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
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc[j] = 0.f;
    for (int w0 = 0; w0 < d; w0 += a.slab_words) {
      const int wn = min(a.slab_words, d - w0);
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
      const float* qslab = qs + w0;
      // wn is a multiple of 4; without the unroll this loop ran slower on
      // the H100 than the whole-row loop it replaced (chip_smoke.py, Q=256)
#pragma unroll 4
      for (int w = 0; w < wn; ++w) {
        const float x = __uint_as_float(trow[w]);
#pragma unroll
        for (int j = 0; j < QPT; ++j)
          if (j < n_active) acc[j] = fmaf(x, qslab[(grp + j * kGroups) * d + w], acc[j]);
      }
    }
    const bool live = row < rows && (a.valid == nullptr || a.valid[phys0 + row]);
#pragma unroll
    for (int j = 0; j < QPT; ++j) sc[(grp + j * kGroups) * SPAN + off + row] = live ? acc[j] : -INFINITY;
    __syncthreads();
    // K9 merges once its span is full or the chunk ends
    if (FOLD && off + kTileRows < SPAN && t0 + kTileRows < r_end) continue;

    merge_tile<FOLD, false>(a, sc, SPAN, ls, li, nullptr, nullptr, nqb, q0, rows, phys0, off,
                            span0, warp, lane, n_merged, n_fast);
  }
  if (FOLD && a.fold_stats != nullptr && lane == 0 && n_merged > 0) {
    atomicAdd(a.fold_stats, n_merged);
    atomicAdd(a.fold_stats + 1, n_fast);
  }
  __syncthreads();
  write_candidates(a, ls, li, nqb, q0, chunk, tid);
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
// d += a (16 rows x 32, row-major) * b (32 x 8 queries), int8 operands,
// i32 accumulators: the same registers as mma16816's, read as int8 quads
template <int DT>
__device__ __forceinline__ void mma16816(int* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int DT> struct Acc {
  using T = float;
};
template <> struct Acc<kInt8> {
  using T = int;
};
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
// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the first `bytes` (0-16) of 16 from global to shared memory, zeros after
__device__ __forceinline__ void cp_async16n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
// the first `bytes` (0-4) of 4, zeros after
__device__ __forceinline__ void cp_async4n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// int8 rows (K4a, K4b) and K9's bf16/f16 rows on the tensor cores (see the
// top of the file; K1, K3 and K8 take scan_pass1_merged). Widths here are
// in 16-bit units: an int8 row of d values is d / 2 pairs.
// Shared memory: the queries [QB][dp + 8], NS stage buffers [64][se + 8]
// (se = 2 slab_words units of each row), the scores [QB][SPAN + 4] f32, the
// lists, a screen flag per query, and for int8 the slots merge_ranked's
// survivors take ([8][32] words) and each stage's row scales and valid
// flags ([NS][64] f32, [NS][64] bytes). The padded strides put the 8 rows of
// an ldmatrix on distinct banks, and a warp's score stores too.
// int8 at small Q (QB 8) keeps two stages in flight (NS = 3) where the
// others keep one, and int8 brings a tile's row scales and valid flags in
// with its last slab, so that no global load waits between the scoring
// and the merge: at one query a block's time a tile is the latency of its
// copies.
template <int DT, int QB, bool FOLD>
__global__ void __launch_bounds__(kThreads, 2) scan_pass1_mma(ScanArgs a) {
  constexpr bool I8 = DT == kInt8;
  constexpr int SPAN = FOLD ? kFoldSpan : kTileRows;
  constexpr int SCS = SPAN + 4;          // a query's scores, floats apart
  constexpr int WQ = QB >= 32 ? 32 : 8;  // queries a warp scores
  constexpr int NT = WQ / 8;             // its n8 tiles
  constexpr int SCORERS = 4 * (QB / WQ); // warps that score: 4 row groups of 16
  static_assert(QB % WQ == 0 && SCORERS <= kThreads / 32, "query block");
  static_assert(!(I8 && FOLD), "K9 scores bf16/f16/f32 rows");
  constexpr int NS = I8 && QB == 8 ? 3 : 2;  // stage buffers
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = I8 ? a.d / 2 : a.d, k = a.k;
  const int dp = (d + 15) / 16 * 16;  // staged width: whole k-steps, zeros past d
  const int se = 2 * a.slab_words;    // units of a row a stage holds
  const int qstr = dp + 8, tstr = se + 8;
  const int nslab = (dp + se - 1) / se;
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);                 // [QB][qstr]
  uint16_t* tiles = qs + QB * qstr;                                 // [NS][64][tstr]
  float* sc = reinterpret_cast<float*>(tiles + NS * kTileRows * tstr);  // [QB][SCS]
  float* ls = sc + QB * SCS;                                        // [QB][k]
  int* li = reinterpret_cast<int*>(ls + QB * k);                    // [QB][k]
  int* hit = li + QB * k;                                           // [QB]
  unsigned* taken = reinterpret_cast<unsigned*>(hit + QB);          // [8][32], int8
  float* st_scale = reinterpret_cast<float*>(taken + kThreads);      // [NS][64], int8
  uint8_t* st_valid = reinterpret_cast<uint8_t*>(st_scale + NS * kTileRows);  // [NS][64]
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
  // stage g: slab g % nslab of the chunk's tile g / nslab, into buffer
  // g % NS; zeros past the tile's rows and past d; int8: with the tile's
  // last slab its row scales and valid flags; one group
  auto load = [&](int g) {
    const int t0 = r_begin + g / nslab * kTileRows, c0 = g % nslab * se;
    const int rows = min(kTileRows, r_end - t0), phys0 = tile_row0(a, t0);
    const int vec = min(se, dp - c0) / 8;  // 16-byte pieces of a row
    uint16_t* buf = tiles + (g % NS) * kTileRows * tstr;
    if (I8 && g % nslab == nslab - 1 && tid < 32) {
      const int r = (tid & 15) * 4, n = max(0, min(4, rows - r));  // rows of 4
      if (tid < 16)
        cp_async16n(st_scale + (g % NS) * kTileRows + r, a.row_scale + phys0 + (n ? r : 0), n * 4);
      else if (a.valid != nullptr)
        cp_async4n(st_valid + (g % NS) * kTileRows + r, a.valid + phys0 + (n ? r : 0), n);
    }
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
  typename Acc<DT>::T acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[t][c] = 0;
  unsigned long long n_merged = 0, n_fast = 0;  // K9's spans, this warp's

  load(0);
  if constexpr (NS == 3) {
    if (1 < n_stages)
      load(1);
    else
      cp_async_commit();  // an empty group: one group a stage
  }
  for (int g = 0; g < n_stages; ++g) {
    if constexpr (NS == 2)
      cp_async_wait_all();  // this thread's copies of stage g have landed
    else
      cp_async_wait<NS - 2>();  // stage g's have; the next may still fly
    __syncthreads();      // everyone's have; everyone is done with stage g - 1
    if (g + NS - 1 < n_stages)
      load(g + NS - 1);  // in flight while stage g is scored and merged
    else if (NS > 2)
      cp_async_commit();
    const int s = g % nslab, c0 = s * se, cn = min(se, dp - c0);
    const uint16_t* buf = tiles + (g % NS) * kTileRows * tstr;
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
        bool live;
        float rs = 0.f;  // int8: the row's scale, staged with the tile
        if constexpr (I8) {
          live = r < rows && (a.valid == nullptr || st_valid[(g % NS) * kTileRows + r]);
          rs = st_scale[(g % NS) * kTileRows + r];
        } else {
          live = r < rows && (a.valid == nullptr || a.valid[phys0 + r]);
        }
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qc = qg * WQ + t * 8 + (lane & 3) * 2 + c;
            float v = -INFINITY;
            if (live) {
              if constexpr (I8)
                v = __fmul_rn(__int2float_rn(acc[t][2 * h + c]), rs);
              else
                v = acc[t][2 * h + c];
            }
            sc[qc * SCS + off + r] = v;
            beat[t][c] |= v > ls[qc * k + k - 1];
            acc[t][2 * h + c] = 0;
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
    merge_tile<FOLD, I8>(a, sc, SCS, ls, li, hit, taken, nqb, q0, rows, phys0, off, span0,
                         warp, lane, n_merged, n_fast);
  }
  if (FOLD && a.fold_stats != nullptr && lane == 0 && n_merged > 0) {
    atomicAdd(a.fold_stats, n_merged);
    atomicAdd(a.fold_stats + 1, n_fast);
  }
  __syncthreads();
  write_candidates(a, ls, li, nqb, q0, chunk, tid);
}

// Warp w of a merge of W warps takes the chunks [run_start(w),
// run_start(w + 1)) of its query.
__device__ __forceinline__ int run_start(int w, int n_chunks, int W) {
  return (int)((long long)w * n_chunks / W);
}

// Pass 2's merge of one query's chunk lists (qcs, qci: n_chunks lists of k,
// see the top of the file) into (out_s, out_i), by the first W warps of the
// calling block; every thread of the block calls it (the tree's barriers).
// Shared memory (smem): three lists of k a warp, [3][W][k] scores then
// [3][W][k] ids: slot 0 the warp's list, slot 1 a chunk list staged from
// the candidates, slot 2 a merge's output. GLOBAL: the lists lie in global
// memory (pass 2; read through L2), else in shared memory (the one-launch
// route stages them first). qscale: an int8 scan's scale of the query, or
// null.
template <bool GLOBAL>
__device__ void merge_chunks(const float* qcs, const int* qci, int n_chunks, int k, int W,
                             const float* qscale, float* out_s, int* out_i,
                             unsigned char* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* lists_s = reinterpret_cast<float*>(smem);
  int* lists_i = reinterpret_cast<int*>(lists_s + 3 * W * k);
  auto S = [&](int slot, int w) { return lists_s + (slot * W + w) * k; };
  auto I = [&](int slot, int w) { return lists_i + (slot * W + w) * k; };
  auto ld = [](const auto* p) {
    if constexpr (GLOBAL)
      return __ldcg(p);
    else
      return *p;
  };

  if (warp < W) {
    // the run: each chunk list merged into the warp's list in turn
    float* rs = S(0, warp);
    int* ri = I(0, warp);
    for (int j = lane; j < k; j += 32) {
      rs[j] = -INFINITY;
      ri[j] = 0;
    }
    __syncwarp();
    const int c0 = run_start(warp, n_chunks, W);
    const int c1 = run_start(warp + 1, n_chunks, W);
    for (int c = c0; c < c1; ++c) {
      const float* cs = qcs + (size_t)c * k;
      const int* ci = qci + (size_t)c * k;
      // a chunk list is sorted: if its first entry does not come before the
      // run's k-th, none of it enters
      if (!before(ld(cs), ld(ci), rs[k - 1], ri[k - 1])) continue;
      const float* bs = cs;
      const int* bi = ci;
      if (GLOBAL) {
        float* ss = S(1, warp);
        int* si = I(1, warp);
        for (int j = lane; j < k; j += 32) {
          ss[j] = ld(cs + j);
          si[j] = ld(ci + j);
        }
        bs = ss;
        bi = si;
      }
      __syncwarp();
      merge_lists(rs, ri, bs, bi, S(2, warp), I(2, warp), k, lane, 32);
      __syncwarp();
      for (int j = lane; j < k; j += 32) {
        rs[j] = S(2, warp)[j];
        ri[j] = I(2, warp)[j];
      }
      __syncwarp();
    }
  }
  // the runs' lists, pairwise: at step s list i (a multiple of 2s) takes
  // list i + s, merged by the warps i .. i + 2s - 1 that exist
  for (int s = 1; s < W; s <<= 1) {
    __syncthreads();
    const int i = warp / (2 * s) * (2 * s);
    const bool pair = warp < W && i + s < W;
    const int t = (warp - i) * 32 + lane, nthr = (min(i + 2 * s, W) - i) * 32;
    if (pair) merge_lists(S(0, i), I(0, i), S(0, i + s), I(0, i + s), S(2, i), I(2, i), k, t, nthr);
    __syncthreads();
    if (pair)
      for (int j = t; j < k; j += nthr) {
        S(0, i)[j] = S(2, i)[j];
        I(0, i)[j] = I(2, i)[j];
      }
  }
  __syncthreads();
  const float qsc = qscale == nullptr ? 1.f : *qscale;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float s = S(0, 0)[j];
    const bool empty = s == -INFINITY;
    out_s[j] = empty || qscale == nullptr ? s : __fmul_rn(s, qsc);
    out_i[j] = empty ? 0 : I(0, 0)[j];
  }
  __syncthreads();  // the lists are read before a next merge writes them
}

// Pass 2 (see the top of the file): one block a query, its W = blockDim.x
// / 32 warps merging the query's chunk lists.
__global__ void __launch_bounds__(kPass2MaxWarps * 32)
scan_pass2(const float* cand_s, const int* cand_i, int n_chunks, int k,
           const float* __restrict__ qscale, float* __restrict__ out_s,
           int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  const size_t o = (size_t)q * n_chunks * k;
  merge_chunks<true>(cand_s + o, cand_i + o, n_chunks, k, blockDim.x / 32,
                     qscale == nullptr ? nullptr : qscale + q, out_s + (size_t)q * k,
                     out_i + (size_t)q * k, smem);
}

// -- bf16/f16 pass 1 of K1, K3 and K8: survivors queued, merged beside the
// scoring (see the top of the file) --------------------------------------

constexpr int kQueue = 32;    // survivors a query's queue holds: a flush sorts
                              // them in one warp, an entry a lane
constexpr int kScoreStride = kTileRows + 4;  // a query's scores, floats apart
// named barriers (0 is __syncthreads): the scorers around each stage; score
// buffer b written (kBarFull + b: the scorers arrive, the mergers wait) and
// read (kBarEmpty + b: the mergers arrive, the scorers wait)
constexpr int kBarStage = 1, kBarFull = 2, kBarEmpty = 4;
// the wgmma route's two consumer warpgroups take turns on the ring: the
// one with tile t + 1 waits on kBarTurn + (t + 1) % 2 for the other to be
// done waiting on tile t's slabs
constexpr int kBarTurn = 6;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Flush one query's queue (qv, qid: n entries, 1 <= n <= kQueue) into its
// sorted list of k (qls, qli). A bitonic network sorts the queue under
// before() in registers, an entry a lane; sorted entry j takes slot j +
// (the list's entries before it) where that is below k; the list's entries
// keep their order in the slots left, each moved up by the queue entries
// placed below it, and those pushed past k drop out (merge_ranked's
// placement). taken: (k + 31) / 32 words of scratch. Called by a whole
// warp; k <= 1024.
__device__ void flush_queue(const float* qv, const int* qid, int n, float* qls, int* qli,
                            int k, int lane, unsigned* taken) {
  float v = lane < n ? qv[lane] : -INFINITY;
  int id = lane < n ? qid[lane] : 0x7fffffff;  // after every real entry
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, stride);
      const int oi = __shfl_xor_sync(0xffffffffu, id, stride);
      // the lane's slot holds the pair's first entry where its block runs
      // first to last (every block at size 32), else the pair's last
      const bool first = ((lane & stride) == 0) == ((lane & size) == 0);
      const bool other_first = ov > v || (ov == v && oi < id);
      if (other_first == first) {
        v = ov;
        id = oi;
      }
    }
  const int words = (k + 31) / 32;
  if (lane < words) taken[lane] = 0u;
  __syncwarp();
  int pos = k;
  if (lane < n) {
    pos = lane + count_before(qls, qli, k, v, id);
    if (pos < k) atomicOr(&taken[pos >> 5], 1u << (pos & 31));
  }
  __syncwarp();
  // taken slots below each word of slots: an exclusive scan of popcounts
  const unsigned own = lane < words ? taken[lane] : 0u;
  int incl = __popc(own);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  const int excl = incl - __popc(own);
  const unsigned busy = __ballot_sync(0xffffffffu, own != 0u);
  // from the top word down to the lowest with a taken slot: free slot p
  // takes entry p - (taken slots below p), which lies at or below p
  for (int w = words - 1; busy != 0u && w >= __ffs(busy) - 1; --w) {
    const unsigned bits = __shfl_sync(0xffffffffu, own, w);
    const int below = __shfl_sync(0xffffffffu, excl, w) + __popc(bits & ((1u << lane) - 1u));
    const int p = w * 32 + lane;
    const bool mv = p < k && !((bits >> lane) & 1u);
    float s = 0.f;
    int i = 0;
    if (mv) {
      s = qls[p - below];
      i = qli[p - below];
    }
    __syncwarp();
    if (mv) {
      qls[p] = s;
      qli[p] = i;
    }
    __syncwarp();
  }
  if (pos < k) {
    qls[pos] = v;
    qli[pos] = id;
  }
  __syncwarp();
}

// The warps of scan_pass1_merged for a query block of QB: scorers of WQ
// queries each (4 row groups of 16 x QB / WQ query groups), with warps that
// only copy the stages where the scorers are fewer than 8 (8 warps issue
// a stage's copies, as in scan_pass1_mma: with 4, pass 1 of K1 over a
// 262,144 x 1,024 slice at Q 1 took 0.227 device ms on the H100 against
// 0.206), then the mergers, a query each in a block of 8, else 16 (K1 at
// 1M x 384, Q 256, k 128: 2.27 ms against 2.63 with 8 and 2.42 with 12,
// in turns). chip_merge_ab.py measures both.
// An f32 value in the store's 16-bit dtype (DT 0 bf16, 1 f16), rounded to
// nearest even as torch's cast rounds it.
template <int DT>
__device__ __forceinline__ uint16_t to_store16(float v) {
  if constexpr (DT == 0)
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  else
    return __half_as_ushort(__float2half_rn(v));
}

// WG: the wgmma route (wgmma_scorers), two consumer warpgroups (warps 0-7)
// and a producer warp (8) where the mma.sync route has its scorers and
// copiers; each use of a score buffer's barriers is one consumer
// warpgroup's and the mergers' (kBarThreads).
template <int QB, bool WG = false> struct Merged {
  static constexpr int kWQ = QB >= 32 ? 32 : 8;
  static constexpr int kScorers = WG ? 8 : 4 * (QB / kWQ);
  static constexpr int kCopiers = WG ? 9 : kScorers < 8 ? 8 : kScorers;
  static constexpr int kMergers = QB == 8 ? 8 : 16;
  static constexpr int kThreads = (kCopiers + kMergers) * 32;
  static constexpr int kBarThreads = WG ? 128 + kMergers * 32 : kThreads;
};

constexpr int kRingStage = kTileRows * 128;  // a ring stage: 64 rows x 128 bytes
constexpr int kRingMin = 3;                  // stages the wgmma route needs

// The wgmma route's queries (WG of scan_pass1_merged): the block's QB
// queries, [nslab][QB][64 values] with the 128-byte swizzle (16-byte piece
// u of query qi's 128 bytes at piece u ^ (qi % 8), as TMA lays the rows
// out); zeros past d (up to the last slab's end) and past the batch. f32
// queries are rounded to the store dtype as the wrapper's cast would round
// them (no cast launch before the scan). d is a multiple of 8, and so is
// each piece of 8 values. Thread t of the nthr that stage them; each then
// makes its part visible to wgmma (the async proxy).
template <int DT, int QB>
__device__ void wgmma_queries(const ScanArgs& a, uint16_t* qs, int q0, int nqb, int t,
                              int nthr) {
  const int d = a.d, nslab = ((d + 15) / 16 * 16 + 63) / 64;
  const uint16_t* queries = reinterpret_cast<const uint16_t*>(a.queries);
  for (int e = t; e < QB * nslab * 8; e += nthr) {
    const int qi = e / (nslab * 8), c = e % (nslab * 8) * 8;
    uint16_t* dst = qs + (c / 64 * QB + qi) * 64 + ((c / 8 % 8) ^ (qi & 7)) * 8;
    const bool in = qi < nqb && c < d;
    if (a.fq == nullptr) {
      cp_async16(dst, in ? queries + (size_t)(q0 + qi) * d + c : queries, in);
    } else {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (in) {
        const float4* src = reinterpret_cast<const float4*>(a.fq + (size_t)(q0 + qi) * d + c);
        x = src[0];
        y = src[1];
      }
      const float v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = (uint32_t)to_store16<DT>(v[2 * j]) | (uint32_t)to_store16<DT>(v[2 * j + 1]) << 16;
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  cp_async_commit();
  cp_async_wait_all();  // this thread's copies have landed
  fence_proxy_async();  // the queries are wgmma's to read
}

// The wgmma route's scorers (WG of scan_pass1_merged, K1 and K8 of a
// batch at query blocks of 32 and 64; see the top of the file). Warp 8 is
// the producer: one thread keeps the ring's S stages (a.ring_stages) in
// flight, stage g the 64 x 64 box (128 bytes of each of the tile's 64 rows,
// the 128-byte swizzle, zeros past d and past the store) of slab g % nslab
// of the chunk's tile g / nslab, through TMA (cp.async.bulk.tensor), each
// stage guarded by a full mbarrier (its bytes have landed) and an empty one
// (each warp of the tile's consumer warpgroup is done with it). Warps 0-3
// and 4-7 are the consumer warpgroups, one a score buffer (a.score_bufs):
// warpgroup w takes the tiles w, w + nb, ... and score buffer w, so that
// one's epilogue, and its wait for the mergers, runs beside the other's
// products. They take the ring's slabs in turns, tile by tile (kBarTurn):
// a slab's full barrier tells apart only its last two uses (its phase's
// parity), so no consumer may wait on a slab before the one S slabs back
// has been waited on. Once the block's queries are staged (wgmma_queries,
// K-major in the same swizzled layout), a warpgroup scores each of its
// tiles: a slab is four k16 steps of one wgmma m64nQBk16 (A the tile's
// rows, B the queries, both K-major in shared memory), each score one f32
// accumulator stepped over k16 in order from column 0 across the slabs,
// as mma.sync's is, so the scores are the mma.sync route's bit for bit.
// The steps past d rounded up to 16 (a last slab of a row not a multiple
// of 64) add products of zeros (TMA's fill, the queries' padding), which
// change no bit: an accumulator that starts at +0 is never -0, and x + 0
// is x. One slab's products are in flight while the next is issued. At
// the tile's end the epilogue writes the scores, -inf for a dead row, and
// the flags into score buffer tt % nb as the mma.sync scorers do (wgmma's
// fragment: row (warp % 4) * 16 + lane / 4 + 8 h, query 8 j + 2 (lane %
// 4) + c).
template <int DT, int QB>
__device__ void wgmma_scorers(const ScanArgs& a, const CUtensorMap* rows_map,
                              unsigned char* ring, uint16_t* qs, uint64_t* full,
                              uint64_t* empty, float* sc, const float* thr, int* hit,
                              int r_begin, int r_end, int n_tiles, int warp, int lane) {
  constexpr int NTH = Merged<QB, true>::kBarThreads;  // the score buffers' barriers
  const int d = a.d, nb = a.score_bufs, S = a.ring_stages;
  const int dp = (d + 15) / 16 * 16;
  const int nslab = (dp + 63) / 64;  // slabs of 64 values, 128 bytes
  const int n_stages = n_tiles * nslab;
  if (warp == 8) {  // the producer: one thread issues every copy
    if (lane == 0) {
      int s = 0, ph = 0;
      for (int g = 0; g < n_stages; ++g) {
        mbar_wait(empty + s, ph ^ 1);  // the consumers are done with the slot
        mbar_expect_tx(full + s, kRingStage);
        tma_load_2d(ring + s * kRingStage, rows_map, g % nslab * 64,
                    r_begin + g / nslab * kTileRows, full + s);
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    __syncwarp();
    return;
  }
  const int wg = warp / 4, consumers = nb;  // a consumer warpgroup a score buffer
  if (wg >= consumers) return;
  const volatile float* vthr = thr;
  float acc[QB / 2];
  for (int tt = wg; tt < n_tiles; tt += consumers) {
#pragma unroll
    for (int i = 0; i < QB / 2; ++i) acc[i] = 0.f;
    int prev = -1, g = tt * nslab, s = g % S, ph = g / S & 1;
    if (consumers == 2 && tt > 0) bar_sync(kBarTurn + tt % 2, 256);  // tile tt - 1's slabs
    for (int j = 0; j < nslab; ++j) {
      mbar_wait(full + s, ph);  // the slab's rows have landed
      const uint32_t ra = smem_addr(ring + s * kRingStage);
      const uint32_t qa = smem_addr(qs + j * QB * 64);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // k16 steps, 32 bytes of the slab each
        wgmma_16<DT == 1, QB, 0>(acc, sw128_desc(ra + kk * 32, 16, 1024),
                                 sw128_desc(qa + kk * 32, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the slab before this one is done: its stage goes back
      if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
      prev = s;
      if (++s == S) {
        s = 0;
        ph ^= 1;
      }
    }
    if (consumers == 2 && tt + 1 < n_tiles) bar_arrive(kBarTurn + (tt + 1) % 2, 256);
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + prev);
    fence_acc<QB / 2>(acc);

    const int b = tt % nb, t0 = r_begin + tt * kTileRows;
    const int rows = min(kTileRows, r_end - t0);
    if (tt >= nb) bar_sync(kBarEmpty + b, NTH);  // the mergers are done with b
    float* sb = sc + b * QB * kScoreStride;
    float th[QB / 8][2];
    bool beat[QB / 8][2] = {};
#pragma unroll
    for (int t = 0; t < QB / 8; ++t)
#pragma unroll
      for (int c = 0; c < 2; ++c) th[t][c] = vthr[t * 8 + (lane & 3) * 2 + c];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (warp & 3) * 16 + (lane >> 2) + 8 * h;
      const bool live = r < rows && (a.valid == nullptr || a.valid[t0 + r]);
#pragma unroll
      for (int t = 0; t < QB / 8; ++t)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v = live ? acc[4 * t + 2 * h + c] : -INFINITY;
          sb[(t * 8 + (lane & 3) * 2 + c) * kScoreStride + r] = v;
          beat[t][c] |= v > th[t][c];
        }
    }
#pragma unroll
    for (int t = 0; t < QB / 8; ++t)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (beat[t][c]) hit[b * QB + t * 8 + (lane & 3) * 2 + c] = 1;
    bar_arrive(kBarFull + b, NTH);  // buffer b is the mergers'
  }
}

// bf16/f16 rows on the tensor cores, the merge in warps of its own (see the
// top of the file). The scorers (and copiers) stream the chunk's tiles
// through two stage buffers and score them as scan_pass1_mma does; at a
// tile's last slab the scorers write its scores into score buffer tile %
// nb (nb, 1 or 2, the wrapper's plan), flag each query that has a score
// above its threshold (thr, which only the mergers write: a stale read
// flags more, never fewer), and go on to the next stage. Merger
// warp m of M takes queries m, m + M, ...: for each flagged query, the
// tile's 64 scores in two rounds of 32 columns; a round's scores above the
// threshold go to the query's queue (ballot and popc offsets); a round that
// does not fit flushes the queue first, refreshes the threshold (max(the
// list's k-th, K8's warm)) and screens again. The queues flush at the
// chunk's end. Shared memory: the queries [QB][dp + 8], 2 stage buffers
// [64][se + 8], nb score buffers [QB][kScoreStride] f32, the lists
// [QB][k] (scores, then ids), the queues [QB][kQueue] (scores, then ids),
// thr [QB], the queues' counts [QB], nb flag sets [QB], and each merger's
// placement scratch [M][(k + 31) / 32].
// WG (query blocks of 32 and 64 of K1 and K8, rows of a whole store): the
// scorers are wgmma_scorers' consumer warpgroups and producer warp, and the
// queries and stage buffers give way to the ring [S][64][128 bytes]
// (1,024-aligned, the swizzle's unit), the queries [nslab][QB][128 bytes]
// and the ring's full and empty mbarriers [S] each; the rest as above.
template <int DT, int QB, bool WG>
__global__ void __launch_bounds__(Merged<QB, WG>::kThreads, QB == 8 ? 2 : 1)
    scan_pass1_merged(ScanArgs a, const __grid_constant__ CUtensorMap rows_map) {
  constexpr int WQ = Merged<QB, WG>::kWQ;
  constexpr int NT = WQ / 8;  // n8 tiles of a scorer
  constexpr int SCORERS = Merged<QB, WG>::kScorers;
  constexpr int NSC = Merged<QB, WG>::kCopiers * 32;  // the stages' copies and barrier
  constexpr int NTH = Merged<QB, WG>::kBarThreads;    // the score buffers' barriers
  constexpr int NALL = Merged<QB, WG>::kThreads;
  constexpr int M = Merged<QB, WG>::kMergers;
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.d, k = a.k, nb = a.score_bufs;
  const int dp = (d + 15) / 16 * 16;
  const int se = 2 * a.slab_words;
  const int qstr = dp + 8, tstr = se + 8;
  const int nslab = (dp + se - 1) / se;
  uint16_t *qs, *tiles = nullptr;
  unsigned char* ring = nullptr;
  uint64_t *full = nullptr, *empty = nullptr;
  float* sc;
  if constexpr (WG) {
    const int S = a.ring_stages;
    ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);               // [S][kRingStage]
    qs = reinterpret_cast<uint16_t*>(ring + S * kRingStage);                // [nslab][QB][64]
    full = reinterpret_cast<uint64_t*>(qs + (dp + 63) / 64 * QB * 64);      // [S]
    empty = full + S;                                                       // [S]
    sc = reinterpret_cast<float*>(empty + S);                               // [nb][QB][stride]
  } else {
    qs = reinterpret_cast<uint16_t*>(smem);                                 // [QB][qstr]
    tiles = qs + QB * qstr;                                                 // [2][64][tstr]
    sc = reinterpret_cast<float*>(tiles + 2 * kTileRows * tstr);            // [nb][QB][stride]
  }
  float* ls = sc + nb * QB * kScoreStride;                               // [QB][k]
  int* li = reinterpret_cast<int*>(ls + QB * k);                         // [QB][k]
  float* qv = reinterpret_cast<float*>(li + QB * k);                     // [QB][kQueue]
  int* qid = reinterpret_cast<int*>(qv + QB * kQueue);                   // [QB][kQueue]
  float* thr = reinterpret_cast<float*>(qid + QB * kQueue);              // [QB]
  int* qcnt = reinterpret_cast<int*>(thr + QB);                          // [QB]
  int* hit = qcnt + QB;                                                  // [nb][QB]
  unsigned* taken = reinterpret_cast<unsigned*>(hit + nb * QB);          // [M][words]
  const uint16_t* store = reinterpret_cast<const uint16_t*>(a.store);
  const uint16_t* queries = reinterpret_cast<const uint16_t*>(a.queries);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.y;
  const int q0 = blockIdx.x * QB;
  const int nqb = min(QB, a.nq - q0);
  const int r_begin = chunk * a.rows_per_chunk;
  const int r_end = min(a.n, r_begin + a.rows_per_chunk);
  const int n_tiles = (r_end - r_begin + kTileRows - 1) / kTileRows;

  for (int e = tid; !WG && e < QB * (dp / 8) && tid < NSC && a.fq == nullptr; e += NSC) {
    const int qi = e / (dp / 8), c = e % (dp / 8) * 8;
    const bool in = qi < nqb && c < d;
    cp_async16(qs + qi * qstr + c, in ? queries + (size_t)(q0 + qi) * d + c : queries, in);
  }
  if (WG && tid == 0) {
    for (int i = 0; i < a.ring_stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < QB * k; e += NALL) {
    ls[e] = -INFINITY;
    li[e] = 0;
  }
  for (int qi = tid; qi < QB; qi += NALL) {
    // a query past the batch is never flagged
    thr[qi] = qi >= nqb ? INFINITY : a.thr0 == nullptr ? -INFINITY : a.thr0[q0 + qi];
    qcnt[qi] = 0;
  }
  for (int e = tid; e < nb * QB; e += NALL) hit[e] = 0;
  __syncthreads();
  if constexpr (WG) {
    if (warp != 8) {  // all but the producer, which starts the ring meanwhile
      wgmma_queries<DT, QB>(a, qs, q0, nqb, warp < 8 ? tid : tid - 32, NALL - 32);
      bar_sync(kBarStage, NALL - 32);  // the queries are staged
    }
  }

  if (WG && warp < NSC / 32) {
    if constexpr (WG)
      wgmma_scorers<DT, QB>(a, &rows_map, ring, qs, full, empty, sc, thr, hit, r_begin,
                            r_end, n_tiles, warp, lane);
  } else if (warp < NSC / 32) {
    // stage g: slab g % nslab of the chunk's tile g / nslab, into buffer
    // g % 2; zeros past the tile's rows and past d; one group
    auto load = [&](int g) {
      const int t0 = r_begin + g / nslab * kTileRows, c0 = g % nslab * se;
      const int rows = min(kTileRows, r_end - t0), phys0 = tile_row0(a, t0);
      const int vec = min(se, dp - c0) / 8;  // 16-byte pieces of a row
      uint16_t* buf = tiles + (g % 2) * kTileRows * tstr;
      int r = tid / vec, v = tid % vec;
      const int dr = NSC / vec, dv = NSC % vec;
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
    const int rg = warp & 3, qg = warp >> 2;  // rows rg*16.., queries qg*WQ..
    const volatile float* vthr = thr;
    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][c] = 0.f;
    const int n_stages = n_tiles * nslab;
    load(0);
    if (a.fq != nullptr) {
      // f32 queries, rounded to the store dtype here while stage 0's copies
      // fly, to nearest even as the wrapper's cast would round them (no
      // cast launch before the scan); zeros past d and past the batch. d is
      // a multiple of 8 (16-byte rows), and so is each piece of 8 values.
      for (int e = tid; e < QB * (dp / 8); e += NSC) {
        const int qi = e / (dp / 8), c = e % (dp / 8) * 8;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
        if (qi < nqb && c < d) {
          const float4* src = reinterpret_cast<const float4*>(a.fq + (size_t)(q0 + qi) * d + c);
          x = src[0];
          y = src[1];
        }
        const float v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = (uint32_t)to_store16<DT>(v[2 * j]) | (uint32_t)to_store16<DT>(v[2 * j + 1]) << 16;
        *reinterpret_cast<uint4*>(qs + qi * qstr + c) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    for (int g = 0; g < n_stages; ++g) {
      cp_async_wait_all();  // this thread's copies of stage g have landed
      bar_sync(kBarStage, NSC);  // everyone's have; all are done with g - 1
      if (g + 1 < n_stages) load(g + 1);  // in flight while stage g is scored
      const int s = g % nslab, c0 = s * se;
      const int cn = warp < SCORERS ? min(se, dp - c0) : 0;  // a copier scores nothing
      const uint16_t* buf = tiles + (g % 2) * kTileRows * tstr;
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
      if (s != nslab - 1) continue;  // the tile's next slab

      const int tt = g / nslab, b = tt % nb;
      const int t0 = r_begin + tt * kTileRows;
      const int rows = min(kTileRows, r_end - t0), phys0 = tile_row0(a, t0);
      if (tt >= nb) bar_sync(kBarEmpty + b, NTH);  // the mergers are done with b
      if (warp >= SCORERS) {  // a copier
        bar_arrive(kBarFull + b, NTH);
        continue;
      }
      float* sb = sc + b * QB * kScoreStride;
      // accumulator (row lane/4 [+ 8], queries 2 (lane%4) [+ 1]) of each
      // n8 tile, into buffer b; the flag: a score above its query's
      // threshold
      float th[NT][2];
      bool beat[NT][2] = {};
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int c = 0; c < 2; ++c) th[t][c] = vthr[qg * WQ + t * 8 + (lane & 3) * 2 + c];
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
            sb[qc * kScoreStride + r] = v;
            beat[t][c] |= v > th[t][c];
            acc[t][2 * h + c] = 0.f;
          }
      }
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (beat[t][c]) hit[b * QB + qg * WQ + t * 8 + (lane & 3) * 2 + c] = 1;
      bar_arrive(kBarFull + b, NTH);  // buffer b is the mergers'
    }
  } else {
    const int mw = warp - NSC / 32;
    unsigned* mtaken = taken + mw * ((k + 31) / 32);
    unsigned long long queued = 0, flushes = 0;
    auto flush = [&](int qi, int n) {
      float* qls = ls + qi * k;
      flush_queue(qv + qi * kQueue, qid + qi * kQueue, n, qls, li + qi * k, k, lane, mtaken);
      const float warm = a.thr0 == nullptr ? -INFINITY : a.thr0[q0 + qi];
      const float t = fmaxf(qls[k - 1], warm);
      if (lane == 0) thr[qi] = t;
      ++flushes;
      return t;
    };
    for (int tt = 0; tt < n_tiles; ++tt) {
      const int b = tt % nb;
      const int t0 = r_begin + tt * kTileRows, phys0 = tile_row0(a, t0);
      bar_sync(kBarFull + b, NTH);  // the scorers have written buffer b
      const float* sb = sc + b * QB * kScoreStride;
      // the flags of this merger's queries, lane j's mw + j M, at once
      const int qj = mw + lane * M;
      const bool mine = qj < nqb && hit[b * QB + qj];
      unsigned flagged = __ballot_sync(0xffffffffu, mine);
      if (mine) hit[b * QB + qj] = 0;
      while (flagged) {
        const int qi = mw + (__ffs(flagged) - 1) * M;
        flagged &= flagged - 1;
        float t = thr[qi];
        int cnt = qcnt[qi];
        for (int half = 0; half < 2; ++half) {
          const int c = half * 32 + lane;
          const float s = sb[qi * kScoreStride + c];
          unsigned m = __ballot_sync(0xffffffffu, s > t);
          if (m == 0u) continue;
          if (cnt + __popc(m) > kQueue) {  // the round does not fit: flush
            t = flush(qi, cnt);
            cnt = 0;
            m = __ballot_sync(0xffffffffu, s > t);
          }
          if ((m >> lane) & 1u) {
            const int p = qi * kQueue + cnt + __popc(m & ((1u << lane) - 1u));
            qv[p] = s;
            qid[p] = phys0 + c;
          }
          cnt += __popc(m);
          queued += __popc(m);
        }
        __syncwarp();
        if (lane == 0) qcnt[qi] = cnt;
      }
      if (tt + nb < n_tiles) bar_arrive(kBarEmpty + b, NTH);  // b is the scorers'
    }
    for (int qi = mw; qi < nqb; qi += M) {  // the chunk's end
      const int cnt = qcnt[qi];
      __syncwarp();
      if (cnt > 0) flush(qi, cnt);
    }
    if (a.merge_stats != nullptr && lane == 0 && queued > 0) {
      atomicAdd(a.merge_stats, queued);
      atomicAdd(a.merge_stats + 1, flushes);
    }
  }
  __syncthreads();
  write_candidates(a, ls, li, nqb, q0, chunk, tid, NALL);
  if (a.done == nullptr) return;  // scan_pass2 merges the chunk lists
  // one launch (see the top of the file): the last of the query block's
  // chunks to finish merges their lists
  __threadfence();  // this block's candidates reach the card before its count does
  __syncthreads();
  if (!__syncthreads_or(tid == 0 && atomicAdd(a.done + blockIdx.x, 1) == (int)gridDim.y - 1))
    return;
  __threadfence();  // the other blocks' candidates are read after their counts
  // each query's lists into shared memory, past the merge's own lists (the
  // wrapper takes this route only where they fit), in one sweep of the block
  const size_t m = (size_t)a.n_chunks * k;
  float* st_s = reinterpret_cast<float*>(smem + (size_t)24 * a.pass2_warps * k);
  int* st_i = reinterpret_cast<int*>(st_s + m);
  for (int qi = 0; qi < nqb; ++qi) {
    const size_t o = (size_t)(q0 + qi) * m;
    for (size_t e = tid; e < m; e += NALL) {
      st_s[e] = __ldcg(a.cand_s + o + e);
      st_i[e] = __ldcg(a.cand_i + o + e);
    }
    __syncthreads();
    merge_chunks<false>(st_s, st_i, a.n_chunks, k, a.pass2_warps, nullptr,
                        a.out_s + (size_t)(q0 + qi) * k, a.out_i + (size_t)(q0 + qi) * k, smem);
  }
  if (tid == 0) a.done[blockIdx.x] = 0;  // the next launch on this stream counts from 0
}

// An int8 scan's queries, quantized per row as ops/quant.py:quantize_query
// does, in one launch: scale = amax |q| / 127 (IEEE division), qi =
// round-half-even(q / scale) clamped to [-127, 127] (a zero row: scale 0,
// values 0). One block a query.
__global__ void __launch_bounds__(256)
quantize_queries(const float* __restrict__ q, int d, int8_t* __restrict__ qi,
                 float* __restrict__ qscale) {
  __shared__ float part[8];
  const float* row = q + (size_t)blockIdx.x * d;
  float m = 0.f;
  for (int j = threadIdx.x; j < d; j += 256) m = fmaxf(m, fabsf(row[j]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  m = part[0];
#pragma unroll
  for (int w = 1; w < 8; ++w) m = fmaxf(m, part[w]);
  const float scale = __fdiv_rn(m, 127.f);
  const float safe = scale > 0.f ? scale : 1.f;
  for (int j = threadIdx.x; j < d; j += 256)
    qi[(size_t)blockIdx.x * d + j] =
        static_cast<int8_t>(max(-127, min(127, __float2int_rn(__fdiv_rn(row[j], safe)))));
  if (threadIdx.x == 0) qscale[blockIdx.x] = scale;
}

// -- the launch path ----------------------------------------------------------

constexpr int kMaxCards = 64;
constexpr int kMaxDone = 1024;  // query blocks a one-launch grid may take

// A kernel launches on the current card, into the stream it is given. The
// wrapper makes its tensors' card current (ops/_cuda.py:launch); an entry
// point refuses a call whose card is not the current one, or whose stream
// lies on another card, with cudaErrorInvalidDevice. Otherwise the launch
// runs on the current card, reading the other card's memory over NVLink
// unordered with that card's stream (torch's current stream is the legacy
// default stream, handle 0, whichever card is current).
cudaError_t on_card(int card, void* stream) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  if (cur != card || card < 0 || card >= kMaxCards) return cudaErrorInvalidDevice;
#if CUDART_VERSION >= 12080
  if (stream != nullptr) {
    int dev = -1;
    e = cudaStreamGetDevice(static_cast<cudaStream_t>(stream), &dev);
    if (e != cudaSuccess) return e;
    if (dev != cur) return cudaErrorInvalidDevice;
  }
#endif
  return cudaSuccess;
}

// A kernel's dynamic shared-memory limit, raised on a card the first time a
// launch there needs more: the attribute holds per card, so a process that
// launches on four cards sets it on each.
cudaError_t allow_smem(const void* kern, int card, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> limit;
  std::lock_guard<std::mutex> hold(mu);
  size_t& have = limit[{card, kern}];
  if (bytes <= have) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) have = bytes;
  return e;
}

// The one-launch route's counters, an int a query block, one set per (card,
// stream): launches on one stream run in order, so each finds them at 0,
// where the last block of the launch before it left them; launches on two
// streams may overlap.
cudaError_t done_counters(int card, cudaStream_t st, int** out) {
  static std::mutex mu;
  static std::map<std::pair<int, cudaStream_t>, int*> sets;
  std::lock_guard<std::mutex> hold(mu);
  int*& p = sets[{card, st}];
  if (p == nullptr) {
    int* q = nullptr;
    cudaError_t e = cudaMalloc(&q, kMaxDone * sizeof(int));
    if (e != cudaSuccess) return e;
    e = cudaMemsetAsync(q, 0, kMaxDone * sizeof(int), st);
    if (e != cudaSuccess) return e;
    p = q;
  }
  *out = p;
  return cudaSuccess;
}

// A pruned scan's tile list goes to the card from a pinned buffer of the
// card's, in stream order, maybe long after the call returns: the buffer is
// written again only once its last copy has completed (its event).
struct Staging {
  std::mutex mu;
  int* host = nullptr;
  size_t cap = 0;
  cudaEvent_t copied = nullptr;
};
cudaError_t stage_tiles(int card, const int* tiles, int n, int* dst, cudaStream_t st) {
  static Staging staging[kMaxCards];
  Staging& s = staging[card];
  std::lock_guard<std::mutex> hold(s.mu);
  cudaError_t e;
  if (s.copied == nullptr &&
      (e = cudaEventCreateWithFlags(&s.copied, cudaEventDisableTiming)) != cudaSuccess)
    return e;
  if ((e = cudaEventSynchronize(s.copied)) != cudaSuccess) return e;  // the last copy is done
  if ((size_t)n > s.cap) {
    if (s.host != nullptr && (e = cudaFreeHost(s.host)) != cudaSuccess) return e;
    s.host = nullptr;
    s.cap = 0;
    const size_t cap = std::max<size_t>(n, 16384);
    if ((e = cudaMallocHost(&s.host, cap * sizeof(int))) != cudaSuccess) return e;
    s.cap = cap;
  }
  std::memcpy(s.host, tiles, (size_t)n * sizeof(int));
  e = cudaMemcpyAsync(dst, s.host, (size_t)n * sizeof(int), cudaMemcpyHostToDevice, st);
  return e != cudaSuccess ? e : cudaEventRecord(s.copied, st);
}

// The call's one device allocation (the wrapper's), carved in this order,
// each piece rounded up to 16 bytes (ops/scan_topk.py:workspace_layout):
// the (nq, k) scores and ids returned, the (nq, chunks, k) candidates, a
// pruned scan's tile ids, an int8 scan's quantized queries and their scales.
struct Workspace {
  float* out_s;
  int* out_i;
  float* cand_s;
  int* cand_i;
  int* tiles;
  int8_t* qbuf;
  float* qscale;
  size_t bytes;
};
Workspace carve(void* base, int nq, int k, int chunks, int n_tiles, int d, bool i8) {
  unsigned char* p = static_cast<unsigned char*>(base);
  size_t at = 0;
  auto take = [&](size_t bytes) {
    unsigned char* q = p + at;
    at += (bytes + 15) / 16 * 16;
    return q;
  };
  Workspace w;
  w.out_s = reinterpret_cast<float*>(take((size_t)nq * k * 4));
  w.out_i = reinterpret_cast<int*>(take((size_t)nq * k * 4));
  w.cand_s = reinterpret_cast<float*>(take((size_t)nq * chunks * k * 4));
  w.cand_i = reinterpret_cast<int*>(take((size_t)nq * chunks * k * 4));
  w.tiles = reinterpret_cast<int*>(take((size_t)n_tiles * 4));
  w.qbuf = reinterpret_cast<int8_t*>(take(i8 ? (size_t)nq * d : 0));
  w.qscale = reinterpret_cast<float*>(take(i8 ? (size_t)nq * 4 : 0));
  w.bytes = at;
  return w;
}

// Pass 1 of one route: checks the layout the wrapper planned, sizes the
// shared memory as the kernel carves it, grid (query blocks, chunks).
template <int DT, int QB, bool FOLD>
cudaError_t launch_pass1(const ScanArgs& a, cudaStream_t stream) {
  constexpr int SPAN = FOLD ? kFoldSpan : kTileRows;
  constexpr bool MMA = DT != 2;
  if (a.tile_ids != nullptr && (FOLD || a.tile_n < kTileRows || a.tile_n % kTileRows))
    return cudaErrorInvalidValue;
  if (a.done != nullptr || a.fq != nullptr || a.ring_stages != 0)
    return cudaErrorInvalidValue;  // merged route only
  size_t smem;
  if constexpr (MMA) {
    if (a.slab_words < 8 || a.slab_words % 8) return cudaErrorInvalidValue;
    const size_t d = DT == kInt8 ? a.d / 2 : a.d;  // 16-bit units
    const size_t dp = (d + 15) / 16 * 16;
    const size_t ns = DT == kInt8 && QB == 8 ? 3 : 2;  // scan_pass1_mma's NS
    smem = (size_t)QB * (dp + 8) * 2 + ns * kTileRows * (2 * a.slab_words + 8) * 2 +
           (size_t)QB * (SPAN + 4) * 4 + (size_t)QB * a.k * 8 + (size_t)QB * 4 +
           (DT == kInt8 ? (size_t)kThreads * 4 + (size_t)3 * kTileRows * 5 : 0);
  } else {
    if (a.slab_words < 4 || a.slab_words % 4) return cudaErrorInvalidValue;
    smem = (size_t)QB * a.d * 4 + (size_t)kTileRows * (a.slab_words + 1) * 4 +
           (size_t)QB * SPAN * 4 + (size_t)QB * a.k * 8;
  }
  if (smem != (size_t)a.smem_plan) return cudaErrorInvalidValue;  // the plan drifted
  void (*kern)(ScanArgs);
  if constexpr (MMA)
    kern = scan_pass1_mma<DT, QB, FOLD>;
  else
    kern = scan_pass1_simt<QB, FOLD>;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), a.card, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.nq + QB - 1) / QB, a.n_chunks);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// bf16/f16 pass 1 of K1, K3 and K8 (scan_pass1_merged): checks the layout
// the wrapper planned, sizes the shared memory as the kernel carves it; in
// the one-launch route, that its last block's merge fits its warps and its
// shared memory. WG, the wgmma route: rows of a whole store (no tile list),
// no one-launch merge, slabs of 64 values (32 words), at least kRingMin
// stages; the store's TMA map built here, boxes of 64 rows x 128 bytes.
template <int DT, int QB, bool WG>
cudaError_t launch_merged(const ScanArgs& a, cudaStream_t stream) {
  if (a.tile_ids != nullptr && (WG || a.tile_n < kTileRows || a.tile_n % kTileRows))
    return cudaErrorInvalidValue;
  if (a.slab_words < 8 || a.slab_words % 8 || (a.score_bufs != 1 && a.score_bufs != 2))
    return cudaErrorInvalidValue;
  if (WG && (a.done != nullptr || a.slab_words != 32 || a.ring_stages < kRingMin))
    return cudaErrorInvalidValue;
  const int q_blocks = (a.nq + QB - 1) / QB;
  const size_t dp = (a.d + 15) / 16 * 16, nb = a.score_bufs;
  const size_t beside = nb * QB * kScoreStride * 4 + (size_t)QB * a.k * 8 +
                        (size_t)QB * kQueue * 8 + (size_t)QB * 8 + nb * QB * 4 +
                        (size_t)Merged<QB, WG>::kMergers * ((a.k + 31) / 32) * 4;
  const size_t smem =
      WG ? 1024 + (size_t)a.ring_stages * (kRingStage + 16) + (dp + 63) / 64 * QB * 128 + beside
         : (size_t)QB * (dp + 8) * 2 + 2 * kTileRows * (2 * a.slab_words + 8) * 2 + beside;
  if (smem != (size_t)a.smem_plan) return cudaErrorInvalidValue;  // the plan drifted
  if (a.done != nullptr &&
      (q_blocks > kMaxDone || a.pass2_warps > Merged<QB, WG>::kThreads / 32 ||
       (size_t)24 * a.pass2_warps * a.k + (size_t)a.n_chunks * a.k * 8 > smem))
    return cudaErrorInvalidValue;  // the merge's lists and a query's chunk lists
  CUtensorMap rows_map{};
  const CUtensorMapDataType type =
      DT == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  if (WG && !tma_map_2d(&rows_map, type, 2, a.store, a.n, a.d, kTileRows))
    return cudaErrorInvalidValue;

  void (*kern)(ScanArgs, const CUtensorMap) = scan_pass1_merged<DT, QB, WG>;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), a.card, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(q_blocks, a.n_chunks);
  kern<<<grid, Merged<QB, WG>::kThreads, smem, stream>>>(a, rows_map);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_merged_qb(int qb, const ScanArgs& a, cudaStream_t st) {
  if (a.ring_stages > 0) {  // the wgmma route
    switch (qb) {
      case 64: return launch_merged<DT, 64, true>(a, st);
      case 32: return launch_merged<DT, 32, true>(a, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (qb) {
    case 64: return launch_merged<DT, 64, false>(a, st);
    case 32: return launch_merged<DT, 32, false>(a, st);
    case 16: return launch_merged<DT, 16, false>(a, st);
    case 8: return launch_merged<DT, 8, false>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool FOLD>
cudaError_t launch_pass1_dt(int dtype, int qb, const ScanArgs& a, cudaStream_t st) {
  // bf16/f16 K1, K3, K8: the merge beside the scoring, query blocks of 64,
  // 32, 16 or 8
  if constexpr (!FOLD) {
    if (dtype == 0) return launch_merged_qb<0>(qb, a, st);
    if (dtype == 1) return launch_merged_qb<1>(qb, a, st);
  }
  // bf16/f16 K9 and int8: the tensor-core route, query blocks of 64 or 8
  if (dtype == 0 || dtype == 1 || dtype == kInt8) {
    if (qb != 64 && qb != 8) return cudaErrorInvalidValue;
    if constexpr (FOLD) {
      if (dtype == 0)
        return qb == 64 ? launch_pass1<0, 64, true>(a, st) : launch_pass1<0, 8, true>(a, st);
      if (dtype == 1)
        return qb == 64 ? launch_pass1<1, 64, true>(a, st) : launch_pass1<1, 8, true>(a, st);
      return cudaErrorInvalidValue;  // K9 scores bf16/f16/f32 rows only
    } else {
      return qb == 64 ? launch_pass1<kInt8, 64, false>(a, st)
                      : launch_pass1<kInt8, 8, false>(a, st);
    }
  }
  // f32: the SIMT route, query blocks of 16 or 4
  if (dtype != 2 || (qb != 16 && qb != 4)) return cudaErrorInvalidValue;
  return qb == 16 ? launch_pass1<2, 16, FOLD>(a, st) : launch_pass1<2, 4, FOLD>(a, st);
}

// The scan on one stream: an int8 scan quantizes its f32 queries (fq) into
// a.queries and qscale first; pass 1; pass 2 with a.pass2_warps warps a
// query, unless pass 1's last blocks merge (a.done, the one-launch route).
cudaError_t scan(const ScanArgs& a, int dtype, int qb, bool fold, const float* fq,
                 float* qscale, cudaStream_t st) {
  const int warps2 = a.pass2_warps;
  if (warps2 < 1 || warps2 > kPass2MaxWarps || warps2 > a.n_chunks ||
      warps2 * a.k > kPass2Slots)
    return cudaErrorInvalidValue;
  cudaError_t e;
  if (dtype == kInt8) {
    quantize_queries<<<a.nq, 256, 0, st>>>(
        fq, a.d, reinterpret_cast<int8_t*>(const_cast<uint32_t*>(a.queries)), qscale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  e = fold ? launch_pass1_dt<true>(dtype, qb, a, st)
           : launch_pass1_dt<false>(dtype, qb, a, st);
  if (e != cudaSuccess || a.done != nullptr) return e;
  const size_t smem2 = (size_t)3 * warps2 * a.k * 8;
  e = allow_smem(reinterpret_cast<const void*>(scan_pass2), a.card, smem2);
  if (e != cudaSuccess) return e;
  scan_pass2<<<a.nq, warps2 * 32, smem2, st>>>(a.cand_s, a.cand_i, a.n_chunks, a.k, qscale,
                                                a.out_s, a.out_i);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 bf16, 1 f16, 2 f32, 3 int8. queries: (nq, d) in the store dtype,
// or f32 where query_f32 (an int8 scan's always, quantized here; bf16/f16
// rows of K1, K3 and K8 cast them as they stage them; not f32 rows). row_scale
// given for int8. tile_host null: scan rows 0..n-1; else the host's n_tiles
// tile ids (staged to the card here) and n = n_tiles * tile_n logical rows.
// thr0 null: K1, K3, K4a, K4b; else K8's per-query warm-start thresholds
// (bf16/f16/f32 only). score_bufs: the bf16/f16 route's score buffers (1 or
// 2); ring_stages: the wgmma route's TMA stages (bf16/f16 K1 and K8 at query
// blocks of 32 and 64), or 0 for the mma.sync scorers; smem_plan: pass 1's
// shared memory in the wrapper's plan, which must be the kernel's.
// one_launch: pass 1's last blocks merge (the bf16/f16 route only), with
// pass2_warps warps. ws: the call's workspace of ws_bytes
// (carve), 16-byte aligned, whose first pieces are the results. stats null,
// or two counters that gain the bf16/f16 route's survivors queued and its
// flushes. card: the card of every pointer and of the stream, which must
// be the current one.
extern "C" int sema_scan_topk(const void* store, const void* queries, int query_f32,
                              const uint8_t* valid, const float* row_scale,
                              const int* tile_host, int n_tiles, int tile_n, int n, int d,
                              int nq, int k, int dtype, int qb, int rows_per_chunk,
                              int slab_words, int n_chunks, int pass2_warps, int score_bufs,
                              int ring_stages, int smem_plan, int one_launch, void* ws,
                              long long ws_bytes,
                              const float* thr0, unsigned long long* stats, void* stream,
                              int card) {
  cudaError_t e = on_card(card, stream);
  if (e != cudaSuccess) return e;
  const bool i8 = dtype == kInt8;
  if (i8 && (row_scale == nullptr || !query_f32 || thr0 != nullptr)) return cudaErrorInvalidValue;
  if (query_f32 && !i8 && dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if ((tile_host == nullptr) != (n_tiles == 0)) return cudaErrorInvalidValue;
  const Workspace w = carve(ws, nq, k, n_chunks, n_tiles, d, i8);
  if (reinterpret_cast<uintptr_t>(ws) % 16 || (long long)w.bytes != ws_bytes)
    return cudaErrorInvalidValue;  // the plan drifted
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_tiles > 0 && (e = stage_tiles(card, tile_host, n_tiles, w.tiles, st)) != cudaSuccess)
    return e;
  ScanArgs a{};
  a.store = static_cast<const uint32_t*>(store);
  a.queries = reinterpret_cast<const uint32_t*>(i8 ? w.qbuf : query_f32 ? nullptr : queries);
  a.fq = !i8 && query_f32 ? static_cast<const float*>(queries) : nullptr;
  a.valid = valid;
  a.row_scale = row_scale;
  a.tile_ids = n_tiles > 0 ? w.tiles : nullptr;
  a.tile_n = tile_n;
  a.n = n;
  a.d = d;
  a.nq = nq;
  a.k = k;
  a.rows_per_chunk = rows_per_chunk;
  a.slab_words = slab_words;
  a.n_chunks = n_chunks;
  a.cand_s = w.cand_s;
  a.cand_i = w.cand_i;
  a.thr0 = thr0;
  a.score_bufs = score_bufs;
  a.ring_stages = ring_stages;
  a.smem_plan = smem_plan;
  a.merge_stats = stats;
  a.pass2_warps = pass2_warps;
  a.out_s = w.out_s;
  a.out_i = w.out_i;
  a.card = card;
  if (one_launch && (e = done_counters(card, st, &a.done)) != cudaSuccess) return e;
  return scan(a, dtype, qb, false, static_cast<const float*>(queries), i8 ? w.qscale : nullptr,
              st);
}

// K9: rows 0..n-1 of a bf16/f16/f32 store, every row live, queries in the
// store dtype; two launches. stats null, or two counters that gain the spans
// merged and the spans on the fast path; the rest as above.
extern "C" int sema_fold_topk(const void* store, const void* queries, int n, int d, int nq,
                              int k, int dtype, int qb, int rows_per_chunk, int slab_words,
                              int n_chunks, int pass2_warps, int smem_plan, void* ws,
                              long long ws_bytes, unsigned long long* stats, void* stream,
                              int card) {
  cudaError_t e = on_card(card, stream);
  if (e != cudaSuccess) return e;
  const Workspace w = carve(ws, nq, k, n_chunks, 0, d, false);
  if (reinterpret_cast<uintptr_t>(ws) % 16 || (long long)w.bytes != ws_bytes)
    return cudaErrorInvalidValue;  // the plan drifted
  ScanArgs a{};
  a.store = static_cast<const uint32_t*>(store);
  a.queries = static_cast<const uint32_t*>(queries);
  a.n = n;
  a.d = d;
  a.nq = nq;
  a.k = k;
  a.rows_per_chunk = rows_per_chunk;
  a.slab_words = slab_words;
  a.n_chunks = n_chunks;
  a.cand_s = w.cand_s;
  a.cand_i = w.cand_i;
  a.fold_stats = stats;
  a.score_bufs = 1;
  a.smem_plan = smem_plan;
  a.pass2_warps = pass2_warps;
  a.out_s = w.out_s;
  a.out_i = w.out_i;
  a.card = card;
  return scan(a, dtype, qb, true, nullptr, nullptr, static_cast<cudaStream_t>(stream));
}

extern "C" const char* sema_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
