// Streaming exact L2 top-k for Hopper (sm_90a), plain C interface (ctypes).
//
// Replaces: fspann_tpu/ops/pallas_topk.py:_topk_kernel (reached through
// _topk_call / bitonic_topk from io/groundtruth.precompute), the Pallas TPU
// kernel that scores |b|^2 - 2 q.b per base tile on the MXU and merges the
// tile into a running top-K held in VMEM.  This kernel computes the same
// thing: for each query, the K base rows with the smallest |b|^2 - 2 q.b,
// in ascending (value, row) order, with distinct rows.  The caller adds
// |q|^2 and takes the square root (ops/l2_topk.py).
//
// What bounds it on the H100: the product.  Q x N x d multiply-adds in
// float32 on the CUDA cores (67 TFLOP/s peak; the ground-truth shape
// 1,024 x 1M x 128 is 2.7e11 FLOP, 4 ms at peak) against one read of the
// base per 32-query tile (at that shape 32 x 0.5 GB = 16 GB, 5 ms at
// 3.35 TB/s if none of it hits L2).  Selection is cheap once a running
// threshold exists: after the first tiles almost no score beats the K-th
// best, so the sorting network runs a handful of times per query and split.
//
// Design (simple first; wgmma/TMA come later):
// * The TPU's sequential grid with a VMEM carry has no Hopper equivalent,
//   so pass 1 runs a grid of (query tile x base split) blocks in parallel.
//   Each block keeps 32 queries' running lists in shared memory and walks
//   its split of the base in tiles of 128 rows.  Per tile it computes the
//   32 x 128 score block in registers (4 x 4 per thread, operands staged
//   through shared memory 32 dims at a time, padded against bank
//   conflicts), and |b|^2 in the same pass.
// * A score enters a query's candidate buffer only if it beats the
//   query's current K-th (value, row).  When a buffer could overflow on
//   the next tile, one warp bitonic-sorts that query's list + buffer (512
//   pairs, row index as tie-break, as the Pallas network does) and takes
//   the new threshold.  Pass 1 writes each split's sorted top-K: [Q, S, K].
// * Pass 2 merges each query's S x K partials with the same warp sort,
//   128 at a time, into the final [Q, K].
// * No padding sentinels in the inputs: rows past a split's end, queries
//   past Q and dims past d are masked.  Empty list slots hold
//   (FLT_MAX, INT_MAX) and never surface because K <= N.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstddef>

namespace {

constexpr int QT = 32;           // queries per block
constexpr int TN = 128;          // base rows per tile
constexpr int DK = 32;           // depth of one product step
constexpr int THREADS = 256;     // 8 warps: warp w owns queries 4w..4w+3
constexpr int KP = 128;          // running-list slots (K <= KP)
constexpr int SORT = 512;        // list + candidate buffer, sorted together
constexpr int CAP = SORT - KP;   // candidate-buffer slots per query
constexpr int MERGE = 256;       // pass 2: running list + one chunk
constexpr int MERGE_WARPS = 4;

constexpr size_t kPartialSmem =
    sizeof(float) * (DK * (QT + 1) + DK * (TN + 1) + TN) +
    (sizeof(float) + sizeof(int)) * QT * SORT +
    (sizeof(float) + 2 * sizeof(int)) * QT;

__device__ __forceinline__ bool pair_gt(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia > ib);
}

// Ascending bitonic sort of N (a power of two) (value, row) pairs held in
// shared memory, by the 32 lanes of one warp.
template <int N>
__device__ void warp_sort(float* v, int* ix, int lane) {
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < N / 2; t += 32) {
        const int i = 2 * t - (t & (j - 1));   // bit j of i is clear
        const int p = i + j;
        const float a = v[i], b = v[p];
        const int ia = ix[i], ib = ix[p];
        if (pair_gt(a, ia, b, ib) == ((i & k) == 0)) {
          v[i] = b; v[p] = a;
          ix[i] = ib; ix[p] = ia;
        }
      }
      __syncwarp();
    }
  }
}

// Sort one query's running list + its buffered candidates; the K-th pair
// becomes the new admission threshold.
__device__ void merge_list(float* v, int* ix, float* thv, int* thi, int* cnt,
                           int k, int lane) {
  const int c = *cnt;
  for (int t = KP + c + lane; t < SORT; t += 32) {
    v[t] = FLT_MAX;
    ix[t] = INT_MAX;
  }
  __syncwarp();
  warp_sort<SORT>(v, ix, lane);
  if (lane == 0) {
    *thv = v[k - 1];
    *thi = ix[k - 1];
    *cnt = 0;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS)
l2_topk_partial(const float* __restrict__ base,
                const float* __restrict__ queries, int n, int d, int nq,
                int k, int rows_per_split, float* __restrict__ part_v,
                int* __restrict__ part_i) {
  extern __shared__ float smem[];
  float* As = smem;                                   // [DK][QT + 1]
  float* Bs = As + DK * (QT + 1);                     // [DK][TN + 1]
  float* bnorm = Bs + DK * (TN + 1);                  // [TN]
  float* lv = bnorm + TN;                             // [QT][SORT]
  int* li = reinterpret_cast<int*>(lv + QT * SORT);   // [QT][SORT]
  float* thv = reinterpret_cast<float*>(li + QT * SORT);  // [QT]
  int* thi = reinterpret_cast<int*>(thv + QT);        // [QT]
  int* cnt = thi + QT;                                // [QT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;
  const int row_lo = split * rows_per_split;
  const int row_hi = min(n, row_lo + rows_per_split);

  for (int e = tid; e < QT * SORT; e += THREADS) {
    lv[e] = FLT_MAX;
    li[e] = INT_MAX;
  }
  if (tid < QT) {
    thv[tid] = FLT_MAX;
    thi[tid] = INT_MAX;
    cnt[tid] = 0;
  }
  __syncthreads();

  for (int t0 = row_lo; t0 < row_hi; t0 += TN) {
    float acc[4][4] = {};
    float nacc = 0.f;
    for (int k0 = 0; k0 < d; k0 += DK) {
      for (int e = tid; e < QT * DK; e += THREADS) {
        const int r = e / DK, c = e % DK;
        const int gq = q0 + r, gc = k0 + c;
        As[c * (QT + 1) + r] =
            (gq < nq && gc < d) ? queries[(size_t)gq * d + gc] : 0.f;
      }
      for (int e = tid; e < TN * DK; e += THREADS) {
        const int r = e / DK, c = e % DK;
        const int gr = t0 + r, gc = k0 + c;
        Bs[c * (TN + 1) + r] =
            (gr < row_hi && gc < d) ? base[(size_t)gr * d + gc] : 0.f;
      }
      __syncthreads();
      if (tid < TN) {
#pragma unroll 8
        for (int c = 0; c < DK; ++c) {
          const float x = Bs[c * (TN + 1) + tid];
          nacc = fmaf(x, x, nacc);
        }
      }
#pragma unroll 8
      for (int c = 0; c < DK; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[c * (QT + 1) + warp * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[c * (TN + 1) + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (tid < TN) bnorm[tid] = nacc;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ql = warp * 4 + i;
      if (q0 + ql >= nq) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = lane + 32 * j;
        const int gr = t0 + r;
        if (gr >= row_hi) continue;
        const float s = bnorm[r] - 2.f * acc[i][j];
        if (pair_gt(thv[ql], thi[ql], s, gr)) {
          const int pos = atomicAdd(&cnt[ql], 1);
          lv[ql * SORT + KP + pos] = s;
          li[ql * SORT + KP + pos] = gr;
        }
      }
    }
    __syncthreads();
    // a buffer above CAP - TN could overflow on the next tile: merge it now
    for (int ql = warp; ql < QT; ql += THREADS / 32) {
      if (cnt[ql] > CAP - TN)
        merge_list(lv + ql * SORT, li + ql * SORT, thv + ql, thi + ql,
                   cnt + ql, k, lane);
    }
    __syncthreads();
  }
  for (int ql = warp; ql < QT; ql += THREADS / 32) {
    if (cnt[ql] > 0)
      merge_list(lv + ql * SORT, li + ql * SORT, thv + ql, thi + ql,
                 cnt + ql, k, lane);
  }
  __syncthreads();

  const int splits = gridDim.y;
  for (int e = tid; e < QT * k; e += THREADS) {
    const int ql = e / k, j = e % k;
    const int gq = q0 + ql;
    if (gq >= nq) continue;
    const size_t o = ((size_t)gq * splits + split) * k + j;
    part_v[o] = lv[ql * SORT + j];
    part_i[o] = li[ql * SORT + j];
  }
}

__global__ void __launch_bounds__(32 * MERGE_WARPS)
l2_topk_merge(const float* __restrict__ part_v,
              const int* __restrict__ part_i, int nq, int total, int k,
              float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float sv[MERGE_WARPS][MERGE];
  __shared__ int si[MERGE_WARPS][MERGE];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int q = blockIdx.x * MERGE_WARPS + w;
  if (q >= nq) return;   // whole warp leaves; no block-wide barrier below
  constexpr int HALF = MERGE / 2;
  float* v = sv[w];
  int* ix = si[w];
  for (int t = lane; t < HALF; t += 32) {
    v[t] = FLT_MAX;
    ix[t] = INT_MAX;
  }
  const float* pv = part_v + (size_t)q * total;
  const int* pi = part_i + (size_t)q * total;
  for (int c0 = 0; c0 < total; c0 += HALF) {
    for (int t = lane; t < HALF; t += 32) {
      const int e = c0 + t;
      v[HALF + t] = e < total ? pv[e] : FLT_MAX;
      ix[HALF + t] = e < total ? pi[e] : INT_MAX;
    }
    __syncwarp();
    warp_sort<MERGE>(v, ix, lane);
  }
  for (int t = lane; t < k; t += 32) {
    out_v[(size_t)q * k + t] = v[t];
    out_i[(size_t)q * k + t] = ix[t];
  }
}

}  // namespace

extern "C" {

// base f32 [n, d], queries f32 [nq, d], both contiguous; part_v/part_i
// scratch [nq, splits, k]; out_v f32 [nq, k] (|b|^2 - 2 q.b) and out_i
// int32 [nq, k].  rows_per_split * splits >= n.  Launches on ``stream``
// and returns the first CUDA error (0 = both launches accepted).
int fspann_l2_topk(const float* base, const float* queries, int n, int d,
                   int nq, int k, int rows_per_split, int splits,
                   float* part_v, int* part_i, float* out_v, int* out_i,
                   void* stream) {
  if (k < 1 || k > KP || n < k || d < 1 || nq < 1 || splits < 1 ||
      (long long)rows_per_split * splits < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      l2_topk_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kPartialSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + QT - 1) / QT, splits);
  l2_topk_partial<<<grid, THREADS, kPartialSmem, s>>>(
      base, queries, n, d, nq, k, rows_per_split, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  l2_topk_merge<<<(nq + MERGE_WARPS - 1) / MERGE_WARPS, 32 * MERGE_WARPS, 0,
                  s>>>(part_v, part_i, nq, splits * k, k, out_v, out_i);
  return (int)cudaGetLastError();
}

const char* fspann_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
