// K1 of the port: exact top-k of queries @ store.T on Hopper (sm_90a).
//
// Replaces sema_tpu/ops/pallas_topk.py:pallas_topk (_scan_kernel,
// _scan_kernel_nomask and their shared _merge_and_emit). The TPU kernel
// walks the store's tiles in order on one core and keeps each query's
// running top-k in VMEM scratch from one grid step to the next. Blocks on
// Hopper run in no order, so the scan is two passes:
//
//   pass 1  grid (chunk of rows, block of queries). Each block streams its
//           row range through shared memory 64 rows at a time (a row wider
//           than shared memory allows goes in slabs of words), scores the
//           rows against its queries (f32 FMAs over the store dtype, f32
//           accumulation, invalid rows -inf) and merges the scores into a
//           per-query sorted list of k in shared memory. A score enters
//           only if it beats the list's k-th entry (the TPU kernel's
//           threshold screen), and it goes in after equal scores, so equal
//           scores keep the lower row id. The lists go out as
//           (Q, chunks, k) candidates.
//   pass 2  one warp per query merges its chunks' lists, chunk by chunk in
//           row order, under the same rule; a list is left at its first
//           32 entries that do not beat the k-th. Slots with no row are
//           -inf with id 0, as the TPU kernel's zeroed ids leave them.
//
// What bounds it on the H100: at the CLI's Q=1 the single read of the
// store (N*d*2 bytes at 3.35 TB/s, 60 us for a sealed 262,144-row bucket
// at d=384); at Q=256 the scoring, 2*Q*N*d operations, which this first
// version does with scalar FMAs (67 TFLOP/s peak) where mma.sync or wgmma
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

// One 32-bit word of a row, unpacked to floats. 0 = bf16, 1 = f16, 2 = f32.
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

template <int DT, int QB>
__global__ void __launch_bounds__(kThreads)
scan_pass1(const uint32_t* __restrict__ store, const uint32_t* __restrict__ queries,
           const uint8_t* __restrict__ valid, int n, int d, int nq, int k,
           int rows_per_chunk, int slab_words, float* __restrict__ cand_s,
           int* __restrict__ cand_i, int n_chunks) {
  constexpr int PW = Elem<DT>::kPerWord;
  constexpr int QPT = QB / kGroups;  // queries per thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = d / PW;          // 32-bit words per row
  const int stride = slab_words + 1; // odd stride: a column read hits 32 banks
  float* qs = reinterpret_cast<float*>(smem);             // [QB][d]
  uint32_t* tile = reinterpret_cast<uint32_t*>(qs + QB * d);  // [64][stride]
  float* sc = reinterpret_cast<float*>(tile + kTileRows * stride);  // [QB][64]
  float* ls = sc + QB * kTileRows;                        // [QB][k]
  int* li = reinterpret_cast<int*>(ls + QB * k);          // [QB][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int nqb = min(QB, nq - q0);
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(n, r_begin + rows_per_chunk);

  for (int e = tid; e < QB * words; e += kThreads) {
    const int qi = e / words, w = e % words;
    float x[2] = {0.f, 0.f};
    if (qi < nqb) Elem<DT>::unpack(queries[(size_t)(q0 + qi) * words + w], x);
#pragma unroll
    for (int p = 0; p < PW; ++p) qs[qi * d + w * PW + p] = x[p];
  }
  for (int e = tid; e < QB * k; e += kThreads) {
    ls[e] = -INFINITY;
    li[e] = 0;
  }

  const uint4* sv = reinterpret_cast<const uint4*>(store);
  const int vec_per_row = words / 4;
  const int row = tid % kTileRows, grp = tid / kTileRows;
  int n_active = 0;  // how many of this thread's queries are real
#pragma unroll
  for (int j = 0; j < QPT; ++j) n_active += (grp + j * kGroups < nqb);

  for (int t0 = r_begin; t0 < r_end; t0 += kTileRows) {
    const int rows = min(kTileRows, r_end - t0);
    float acc[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc[j] = 0.f;
    for (int w0 = 0; w0 < words; w0 += slab_words) {
      const int wn = min(slab_words, words - w0);
      const int vec = wn / 4;
      if (w0 > 0) __syncthreads();  // every thread is done with the last slab
      for (int e = tid; e < kTileRows * vec; e += kThreads) {
        const int r = e / vec, v = e % vec;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows) val = sv[(size_t)(t0 + r) * vec_per_row + w0 / 4 + v];
        uint32_t* dst = tile + r * stride + v * 4;
        dst[0] = val.x;
        dst[1] = val.y;
        dst[2] = val.z;
        dst[3] = val.w;
      }
      __syncthreads();

      const uint32_t* trow = tile + row * stride;
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
    const bool live = row < rows && (valid == nullptr || valid[t0 + row]);
#pragma unroll
    for (int j = 0; j < QPT; ++j)
      sc[(grp + j * kGroups) * kTileRows + row] = live ? acc[j] : -INFINITY;
    __syncthreads();

    // merge: one warp per query; survivors in row order
    for (int qi = warp; qi < nqb; qi += kThreads / 32) {
      float* qls = ls + qi * k;
      int* qli = li + qi * k;
      for (int base = 0; base < rows; base += 32) {
        const float s = base + lane < rows ? sc[qi * kTileRows + base + lane]
                                           : -INFINITY;
        unsigned m = __ballot_sync(0xffffffffu, s > qls[k - 1]);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float v = __shfl_sync(0xffffffffu, s, src);
          if (v > qls[k - 1]) warp_insert(qls, qli, k, v, t0 + base + src, lane);
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nqb * k; e += kThreads) {
    const int qi = e / k, j = e % k;
    const size_t o = ((size_t)(q0 + qi) * n_chunks + chunk) * k + j;
    cand_s[o] = ls[e];
    cand_i[o] = li[e];
  }
}

__global__ void __launch_bounds__(kPass2Warps * 32)
scan_pass2(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
           int nq, int n_chunks, int k, float* __restrict__ out_s,
           int* __restrict__ out_i) {
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
  for (int j = lane; j < k; j += 32) {
    const float s = ls[j];
    out_s[(size_t)q * k + j] = s;
    out_i[(size_t)q * k + j] = s == -INFINITY ? 0 : li[j];
  }
}

template <int DT, int QB>
cudaError_t launch_pass1(const void* store, const void* queries,
                         const uint8_t* valid, int n, int d, int nq, int k,
                         int rows_per_chunk, int slab_words, int n_chunks,
                         float* cand_s, int* cand_i, cudaStream_t stream) {
  if (slab_words < 4 || slab_words % 4) return cudaErrorInvalidValue;
  const size_t smem = (size_t)QB * d * 4 + (size_t)kTileRows * (slab_words + 1) * 4 +
                      (size_t)QB * kTileRows * 4 + (size_t)QB * k * 8;
  auto kern = scan_pass1<DT, QB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(n_chunks, (nq + QB - 1) / QB);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(store), static_cast<const uint32_t*>(queries),
      valid, n, d, nq, k, rows_per_chunk, slab_words, cand_s, cand_i, n_chunks);
  return cudaGetLastError();
}

template <int QB>
cudaError_t launch_pass1_dt(int dtype, const void* store, const void* queries,
                            const uint8_t* valid, int n, int d, int nq, int k,
                            int rows_per_chunk, int slab_words, int n_chunks,
                            float* cand_s, int* cand_i, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_pass1<0, QB>(store, queries, valid, n, d, nq, k, rows_per_chunk,
                                       slab_words, n_chunks, cand_s, cand_i, stream);
    case 1: return launch_pass1<1, QB>(store, queries, valid, n, d, nq, k, rows_per_chunk,
                                       slab_words, n_chunks, cand_s, cand_i, stream);
    case 2: return launch_pass1<2, QB>(store, queries, valid, n, d, nq, k, rows_per_chunk,
                                       slab_words, n_chunks, cand_s, cand_i, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int sema_scan_topk(const void* store, const void* queries,
                              const uint8_t* valid, int n, int d, int nq,
                              int k, int dtype, int qb, int rows_per_chunk,
                              int slab_words, int n_chunks, float* cand_s,
                              int* cand_i, float* out_s, int* out_i,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (qb == 16)
    e = launch_pass1_dt<16>(dtype, store, queries, valid, n, d, nq, k,
                            rows_per_chunk, slab_words, n_chunks, cand_s, cand_i, st);
  else if (qb == 4)
    e = launch_pass1_dt<4>(dtype, store, queries, valid, n, d, nq, k,
                           rows_per_chunk, slab_words, n_chunks, cand_s, cand_i, st);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  const size_t smem2 = (size_t)kPass2Warps * k * 8;
  scan_pass2<<<(nq + kPass2Warps - 1) / kPass2Warps, kPass2Warps * 32, smem2,
               st>>>(cand_s, cand_i, nq, n_chunks, k, out_s, out_i);
  return cudaGetLastError();
}

extern "C" const char* sema_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
