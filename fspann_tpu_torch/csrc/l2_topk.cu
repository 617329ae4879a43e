// Streaming exact L2 top-k for Hopper (sm_90a) on the tensor cores, plain C
// interface (ctypes).
//
// Replaces: fspann_tpu/ops/pallas_topk.py:_topk_kernel (:106, called at :158
// through _topk_call / bitonic_topk from io/groundtruth.precompute), the
// Pallas TPU kernel that scores |b|^2 - 2 q.b per base tile on the MXU and
// merges the tile into a running top-K held in VMEM.  This kernel computes
// the same thing: for each query, the K base rows with the smallest
// |b|^2 - 2 q.b, in ascending (value, row) order, with distinct rows.  The
// caller adds |q|^2 and takes the square root (ops/l2_topk.py).
//
// Bounds on the H100 (SXM, 700 W) at the ground-truth shape 1,000,000 rows
// x 128 dims x 1,024 queries:
// * operations: 2 Q N d = 2.62e11 FLOP.  On the CUDA cores in float32 (67
//   TFLOP/s) that is 3.91 ms.  This kernel runs the product on the tensor
//   cores as split TF32, three TF32 products per float32 product, so its
//   floor is 3 x 2.62e11 / 495e12 = 1.59 ms;
// * bytes: the base read once, 512 MB, is 0.15 ms at 3.35 TB/s.  Each
//   query tile reads the base again (16 x 0.5 GB at 64 queries a tile),
//   most of it from L2: the tiles of one split run side by side
//   (blockIdx.x is the query tile).
// What holds it above the product's floor is selection: every (query,
// split) pair warms up its own threshold, and a merge holds its block at
// the next barrier (PERF.md).
//
// Design:
// * Grid (query tile of QT = 64, base split); ops/l2_topk.py sizes the
//   splits so that the grid is whole waves of 2 resident blocks per SM.
//   Each block walks its split in row tiles of TN = 128, each tile in depth
//   chunks of DK = 64.  A two-stage cp.async ring stages the (query chunk,
//   base chunk) pair of step s+1 while step s is multiplied and its tile
//   selected.  The query chunks come from L2 (the tile is 32 KB at d = 128
//   and 240 KB at d = 960, so it is streamed beside the base instead of
//   staged whole, and every d <= 960 takes the same path).  Depth and rows
//   past the end are zero-filled by the copy (src-size 0), so d need not be
//   a multiple of 8 or 64.  Rows are copied 16 bytes a thread where d % 4
//   == 0 and both pointers are 16-byte aligned, else 4 bytes a thread.
// * The product: 8 warps as 2 (queries) x 4 (rows), 32 x 32 outputs each,
//   mma.sync.m16n8k8 TF32 with float32 accumulators.  Every operand is
//   split as it leaves shared memory into hi (x rounded to TF32) and lo =
//   x - hi, and q.b = lo.hi + hi.lo + hi.hi (the lo.lo term is below
//   float32's rounding).  One TF32 pass alone keeps about three digits and
//   would flip ground-truth ids that are not ties.  Each k-step's three
//   products go into fresh accumulators, which float32 adds (rounding to
//   nearest) then fold into the running sums: the tensor cores' own
//   accumulation truncates, so a running accumulator carried through all
//   d / 8 k-steps drifts toward zero, by about 1e-5 of |q|^2 + |b|^2 at d =
//   960 on clustered data (the 1M x 960 point, chip_smoke.py phase 18), past
//   F32_ERROR_LIMIT; with the adds the drift is that of 3 k-steps, and the
//   adds' own errors do not pile up one way.  |b|^2 is an exact float32
//   sum of the same staged chunks (threads 0..127, one row each).
//   Defining FSPANN_L2_TOPK_ONE_TF32_PASS keeps hi.hi alone: the control
//   that scripts/torch_l2_topk_precision.py builds to set the precision
//   limit that chip_smoke.py and the tests hold this kernel to.
// * Accumulator map (PTX ISA, mma.m16n8k8, f32 accumulators): with g =
//   lane / 4 and t = lane % 4, register c[i] of the m16 x n8 tile holds
//   (M = g + 8 (i / 2), N = 2 t + i % 2).  M is the query, N the base row:
//   query = 32 wq + 16 mt + g + 8 (i / 2), row = 32 wr + 8 nt + 2 t + i % 2.
// * Selection: a score is admitted only if it beats its pair's current
//   K-th (value, row) and is at or under the query's published threshold:
//   the least K-th value any split of the query has reached (the final
//   K-th is at or under each, so the filter drops no true neighbour).  The
//   running list (K slots) and the admission buffer (CAP slots) of each
//   (query, split) pair live in global scratch; shared memory holds the
//   thresholds and the counts.  When a list can be filled, or a buffer
//   could overflow on the next tile, one warp refreshes the list by a
//   k-select in registers (merge_query) and publishes the new K-th value;
//   every other buffer above EAGER entries merges in the same phase, so
//   that the warps share the stall.  Whether a merge is due is voted by
//   the admitting threads from their own atomicAdd results, not read from
//   the counts, which other warps may still be raising.  An admission past
//   CAP traps, so the launch fails instead of writing into the next pair's
//   scratch (the build defines no NDEBUG; -DNDEBUG drops the check).
//   Shared memory is 104 KB a block, so two blocks share an SM.
// * Pass 2 gathers, for each query, the entries of its S lists at or under
//   its published threshold and merges them 128 at a time with a warp
//   bitonic sort ((value, row) pairs, the row as tie-break, as the Pallas
//   network does) into the final [Q, K].
// * No padding sentinels in the inputs: rows past a split's end and queries
//   past Q are masked.  Short lists are padded with (FLT_MAX, INT_MAX),
//   which never surface because K <= N.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int QT = 64;           // queries per block
constexpr int TN = 128;          // base rows per tile
constexpr int DK = 64;           // depth of one pipeline step
constexpr int LD = DK + 4;       // staged row stride: fragment loads hit 32 banks
constexpr int THREADS = 256;     // 8 warps: 2 along queries x 4 along rows
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 2;
constexpr int STAGE_FLOATS = (QT + TN) * LD;
constexpr int KP = 128;          // running-list slots (K <= KP)
constexpr int SORT = 512;        // list + admission buffer of one (query, split)
constexpr int CAP = SORT - KP;   // admission-buffer slots
constexpr int EAGER = 64;        // buffers merged along with a full one
constexpr int MERGE = 256;       // pass 2: running list + one chunk
constexpr int MERGE_WARPS = 4;

constexpr size_t kPartialSmem =
    sizeof(float) * (STAGES * STAGE_FLOATS + TN) +
    (2 * sizeof(float) + 3 * sizeof(int)) * QT;

// float <-> int32 whose signed order is the float order (non-NaN); the map
// is its own inverse.
__device__ __forceinline__ int sortable(int i) {
  return i ^ ((i >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ bool pair_gt(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia > ib);
}

// Ascending bitonic sort of N (a power of two) (value, row) pairs held in
// shared memory, by the 32 lanes of one warp.  Each stage loads all of a
// lane's pairs before it stores any, so their latencies overlap.
template <int N>
__device__ void warp_sort(float* v, int* ix, int lane) {
  constexpr int PER = N / 64;            // compare-exchanges per lane
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      float a[PER], b[PER];
      int ia[PER], ib[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int t = lane + 32 * u;
        const int i = 2 * t - (t & (j - 1));   // bit j of i is clear
        a[u] = v[i];
        b[u] = v[i + j];
        ia[u] = ix[i];
        ib[u] = ix[i + j];
      }
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int t = lane + 32 * u;
        const int i = 2 * t - (t & (j - 1));
        const bool swap = pair_gt(a[u], ia[u], b[u], ib[u]) == ((i & k) == 0);
        v[i] = swap ? b[u] : a[u];
        v[i + j] = swap ? a[u] : b[u];
        ix[i] = swap ? ib[u] : ia[u];
        ix[i + j] = swap ? ia[u] : ib[u];
      }
      __syncwarp();
    }
  }
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? bytes : 0;          // src-size 0: zero-fill
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
}

// x = hi + lo with hi x rounded to TF32 (half an ulp added to the magnitude,
// the low 13 bits cleared) and lo = x - hi exactly; the tensor core reads
// lo's top 19 bits (TF32), so lo is truncated there.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage the query chunk [QT][DK] and base chunk [TN][DK] of one step.
template <bool VEC>
__device__ __forceinline__ void stage(float* st, const float* base,
                                      const float* queries, int d, int nq,
                                      int q0, int t0, int row_hi, int k0,
                                      int tid) {
  constexpr int W = VEC ? 4 : 1;          // floats per copy
  constexpr int PER_ROW = DK / W;
  for (int e = tid; e < (QT + TN) * PER_ROW; e += THREADS) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * W;
    const int gc = k0 + c;
    const bool isq = r < QT;
    const int gr = isq ? q0 + r : t0 + (r - QT);
    const bool ok = gc < d && (isq ? gr < nq : gr < row_hi);
    const float* src = isq ? queries : base;
    cp_async(st + r * LD + c, ok ? src + (size_t)gr * d + gc : src, ok,
             4 * W);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Count, over the warp, the held entries (those of the first ``total``)
// for which ``pred(u)`` holds.
template <typename P>
__device__ __forceinline__ int warp_count(int total, int lane, P pred) {
  int c = 0;
#pragma unroll
  for (int u = 0; u < SORT / 32; ++u)
    c += (lane + 32 * u < total && pred(u)) ? 1 : 0;
  return __reduce_add_sync(0xFFFFFFFFu, c);
}

// Refresh one query's running list from its admission buffer (global
// scratch ``gv``/``gi``: [0, len) list, [KP, KP + cnt) buffer; all rows
// distinct).  A warp holds the len + cnt <= SORT pairs in registers, 16 a
// lane, finds the k-th smallest (value, row) by a bitwise binary search
// (value bits first, then the row among tied values) and writes the k pairs
// at or under it to [0, k) in no order, pads (FLT_MAX, INT_MAX) after fewer.
// A full list's k-th pair becomes the query's threshold, and its value is
// published to ``gthr`` for every split of the query.
__device__ void merge_query(float* gv, int* gi, float* thv, int* thi,
                            int* cnt, int* len, int k, int* gthr, int lane) {
  constexpr int PER = SORT / 32;
  const int l = *len;
  const int total = l + *cnt;
  unsigned key[PER];                      // value bits in unsigned order
  int row[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {         // all loads in flight at once
    const int t = lane + 32 * u;
    const int src = t < l ? t : KP + t - l;
    key[u] = t < total
        ? static_cast<unsigned>(sortable(__float_as_int(gv[src]))) ^
              0x80000000u
        : 0xFFFFFFFFu;
    row[u] = t < total ? gi[src] : INT_MAX;
  }
  unsigned tk = 0xFFFFFFFFu;              // the k-th pair (tk, tr)
  int tr = INT_MAX;
  if (total >= k) {
    // the bits the held keys share are the k-th key's too; search the rest
    unsigned lo = 0xFFFFFFFFu, hi = 0;
#pragma unroll
    for (int u = 0; u < PER; ++u)
      if (lane + 32 * u < total) {
        lo = min(lo, key[u]);
        hi = max(hi, key[u]);
      }
    lo = __reduce_min_sync(0xFFFFFFFFu, lo);
    hi = __reduce_max_sync(0xFFFFFFFFu, hi);
    tk = lo;
    if (lo != hi) {
      const int top = 31 - __clz(lo ^ hi);
      tk = lo & ~((2u << top) - 1u);    // smallest key with >= k at or under
      for (int b = top; b >= 0; --b) {
        const unsigned cand = tk | ((1u << b) - 1);
        if (warp_count(total, lane, [&](int u) { return key[u] <= cand; }) <
            k)
          tk |= 1u << b;
      }
    }
    const int need =
        k - warp_count(total, lane, [&](int u) { return key[u] < tk; });
    int tie = 0;                          // rows of the k-th key: the largest
#pragma unroll
    for (int u = 0; u < PER; ++u)
      if (lane + 32 * u < total && key[u] == tk) tie = max(tie, row[u]);
    tr = __reduce_max_sync(0xFFFFFFFFu, tie);
    if (warp_count(total, lane, [&](int u) { return key[u] == tk; }) > need) {
      tr = 0;                             // need-th row among the tied keys
      for (int b = 30; b >= 0; --b) {
        const int cand = tr | ((1 << b) - 1);
        if (warp_count(total, lane, [&](int u) {
              return key[u] == tk && row[u] <= cand;
            }) < need)
          tr |= 1 << b;
      }
    }
  }
  __syncwarp();                           // every load before any store
  int at = 0;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const bool keep = lane + 32 * u < total &&
                      (key[u] < tk || (key[u] == tk && row[u] <= tr));
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, keep);
    if (keep) {
      const int pos = at + __popc(mask & ((1u << lane) - 1));
      gv[pos] = __int_as_float(sortable(static_cast<int>(key[u] ^
                                                         0x80000000u)));
      gi[pos] = row[u];
    }
    at += __popc(mask);
  }
  for (int t = at + lane; t < k; t += 32) {
    gv[t] = FLT_MAX;
    gi[t] = INT_MAX;
  }
  if (lane == 0) {
    *cnt = 0;
    *len = at;
    if (at == k) {
      const float v = __int_as_float(sortable(static_cast<int>(tk ^
                                                               0x80000000u)));
      *thv = v;
      *thi = tr;
      atomicMin(gthr, sortable(__float_as_int(v)));
    }
  }
  __syncwarp();
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
l2_topk_partial(const float* __restrict__ base,
                const float* __restrict__ queries, int n, int d, int nq,
                int k, int rows_per_split, float* __restrict__ scr_v,
                int* __restrict__ scr_i, int* __restrict__ thr) {
  extern __shared__ float smem[];
  float* ring = smem;                                   // [STAGES][QT+TN][LD]
  float* bnorm = ring + STAGES * STAGE_FLOATS;          // [TN]
  float* thg = bnorm + TN;                              // [QT]
  float* thv = thg + QT;                                // [QT]
  int* thi = reinterpret_cast<int*>(thv + QT);          // [QT]
  int* cnt = thi + QT;                                  // [QT]
  int* len = cnt + QT;                                  // [QT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wq = warp & 1, wr = warp >> 1;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y, splits = gridDim.y;
  const int row_lo = split * rows_per_split;
  const int row_hi = min(n, row_lo + rows_per_split);
  const int nchunks = (d + DK - 1) / DK;
  const int nsteps = (row_hi - row_lo + TN - 1) / TN * nchunks;

  if (tid < QT) {
    thv[tid] = FLT_MAX;
    thi[tid] = INT_MAX;
    cnt[tid] = 0;
    len[tid] = 0;
  }

  float acc[2][4][4];
  float nacc = 0.f;
  stage<VEC>(ring, base, queries, d, nq, q0, row_lo, row_hi, 0, tid);
  for (int s = 0; s < nsteps; ++s) {
    const int tile = s / nchunks, chunk = s % nchunks;
    const int t0 = row_lo + tile * TN;
    if (s + 1 < nsteps) {
      const int nt = (s + 1) / nchunks, nc = (s + 1) % nchunks;
      stage<VEC>(ring + ((s + 1) % STAGES) * STAGE_FLOATS, base, queries, d,
                 nq, q0, row_lo + nt * TN, row_hi, nc * DK, tid);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* As = ring + (s % STAGES) * STAGE_FLOATS;
    const float* Bs = As + QT * LD;
    if (chunk == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
      nacc = 0.f;
    }
    if (tid < TN) {
      const float4* row = reinterpret_cast<const float4*>(Bs + tid * LD);
#pragma unroll
      for (int c = 0; c < DK / 4; ++c) {
        const float4 x = row[c];
        nacc = fmaf(x.x, x.x, nacc);
        nacc = fmaf(x.y, x.y, nacc);
        nacc = fmaf(x.z, x.z, nacc);
        nacc = fmaf(x.w, x.w, nacc);
      }
    }
#pragma unroll
    for (int kk = 0; kk < DK; kk += 8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* a = As + (32 * wq + 16 * mt + g) * LD + kk + t4;
        split_tf32(a[0], ah[mt][0], al[mt][0]);
        split_tf32(a[8 * LD], ah[mt][1], al[mt][1]);
        split_tf32(a[4], ah[mt][2], al[mt][2]);
        split_tf32(a[8 * LD + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* b = Bs + (32 * wr + 8 * nt + g) * LD + kk + t4;
        split_tf32(b[0], bh[nt][0], bl[nt][0]);
        split_tf32(b[4], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          // this k-step's products, added to the running sums by float32
          // adds (the design note: the tensor cores' own accumulation
          // truncates)
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#ifndef FSPANN_L2_TOPK_ONE_TF32_PASS
          mma_tf32(part, al[mt], bh[nt]);
          mma_tf32(part, ah[mt], bl[nt]);
#endif
          mma_tf32(part, ah[mt], bh[nt]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[i];
        }
    }

    if (chunk == nchunks - 1) {
      if (tid < TN) bnorm[tid] = nacc;
      if (tid < QT && q0 + tid < nq)     // the best K-th any split published
        thg[tid] = __int_as_float(sortable(__ldcg(thr + q0 + tid)));
      __syncthreads();
      // A buffer above CAP - TN could overflow on the next tile (a tile
      // adds at most TN to a query), and a list that can be filled gives
      // the first threshold: either calls a merge.  Neither holds when the
      // tile starts (the last merge phase cleared both), so each count
      // crosses its limit at one atomicAdd, and the thread that made it
      // votes.  Reading cnt here instead would race with the warps still
      // admitting.
      bool merge_due = false;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ql = 32 * wq + 16 * mt + g + 8 * h;
          const int gq = q0 + ql;
          if (gq >= nq) continue;
          const float tv = thv[ql], tg = thg[ql];
          const int ti = thi[ql];
          const size_t off = ((size_t)gq * splits + split) * SORT + KP;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int r = 32 * wr + 8 * nt + 2 * t4 + j;
              const int gr = t0 + r;
              if (gr >= row_hi) continue;
              const float sc = bnorm[r] - 2.f * acc[mt][nt][2 * h + j];
              if (sc <= tg && pair_gt(tv, ti, sc, gr)) {
                const int pos = atomicAdd(&cnt[ql], 1);
#ifndef NDEBUG
                if (pos >= CAP) __trap();   // the vote below rules it out
#endif
                scr_v[off + pos] = sc;
                scr_i[off + pos] = gr;
                merge_due |= pos + 1 > CAP - TN ||
                             (len[ql] < k && len[ql] + pos + 1 >= k);
              }
            }
        }
      // A merge holds the block at the next barrier, so every buffer above
      // EAGER merges in the same phase, spread over the warps.
      const bool any = __syncthreads_or(merge_due);
      for (int ql = warp; any && ql < QT && q0 + ql < nq; ql += WARPS) {
        if (cnt[ql] > EAGER || (len[ql] < k && len[ql] + cnt[ql] >= k)) {
          const size_t off = ((size_t)(q0 + ql) * splits + split) * SORT;
          merge_query(scr_v + off, scr_i + off, thv + ql, thi + ql, cnt + ql,
                      len + ql, k, thr + q0 + ql, lane);
        }
      }
    }
    __syncthreads();   // stage s % STAGES is free for step s + 2
  }
  for (int ql = warp; ql < QT && q0 + ql < nq; ql += WARPS) {
    if (cnt[ql] > 0 || len[ql] < k) {
      const size_t off = ((size_t)(q0 + ql) * splits + split) * SORT;
      merge_query(scr_v + off, scr_i + off, thv + ql, thi + ql, cnt + ql,
                  len + ql, k, thr + q0 + ql, lane);
    }
  }
}

// Each query's S partial lists (the first k slots of its S scratch regions)
// merged into the final top-k, one warp a query.  Only entries at or under
// the query's published threshold can be in the top-k; they are gathered
// 128 at a time and merged into the running best with the warp sort.
__global__ void __launch_bounds__(32 * MERGE_WARPS)
l2_topk_merge(const float* __restrict__ scr_v, const int* __restrict__ scr_i,
              const int* __restrict__ thr, int nq, int splits, int k,
              float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float sv[MERGE_WARPS][MERGE];
  __shared__ int si[MERGE_WARPS][MERGE];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int q = blockIdx.x * MERGE_WARPS + w;
  if (q >= nq) return;   // whole warp leaves; no block-wide barrier below
  constexpr int HALF = MERGE / 2;
  float* v = sv[w];
  int* ix = si[w];
  for (int t = lane; t < MERGE; t += 32) {
    v[t] = FLT_MAX;
    ix[t] = INT_MAX;
  }
  __syncwarp();
  const float tv = __int_as_float(sortable(thr[q]));
  const size_t row = (size_t)q * splits * SORT;
  const int total = splits * k;
  int fill = 0;                           // gathered in v[HALF, HALF + fill)
  for (int c0 = 0; c0 < total; c0 += 32) {
    const int e = c0 + lane;
    float a = FLT_MAX;
    int ia = INT_MAX;
    if (e < total) {
      const size_t o = row + (size_t)(e / k) * SORT + e % k;
      a = scr_v[o];
      ia = scr_i[o];
    }
    const bool keep = e < total && a <= tv;
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, keep);
    if (keep) {
      const int at = HALF + fill + __popc(mask & ((1u << lane) - 1));
      v[at] = a;
      ix[at] = ia;
    }
    fill += __popc(mask);
    if (fill > HALF - 32 || (c0 + 32 >= total && fill > 0)) {
      for (int t = HALF + fill + lane; t < MERGE; t += 32) {
        v[t] = FLT_MAX;
        ix[t] = INT_MAX;
      }
      __syncwarp();
      warp_sort<MERGE>(v, ix, lane);
      fill = 0;
    }
  }
  for (int t = lane; t < k; t += 32) {
    out_v[(size_t)q * k + t] = v[t];
    out_i[(size_t)q * k + t] = ix[t];
  }
}

template <bool VEC>
cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      l2_topk_partial<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kPartialSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(l2_topk_partial<VEC>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" {

// base f32 [n, d], queries f32 [nq, d], both contiguous; scr_v/scr_i
// scratch [nq, splits, 512] (running lists and admission buffers); thr
// [nq] 32-bit words holding the bits of +inf (the published thresholds, as
// int32 in float order); out_v
// f32 [nq, k] (|b|^2 - 2 q.b) and out_i int32 [nq, k].
// rows_per_split * splits >= n and every split holds a row.  Launches on
// ``stream`` and returns the first CUDA error (0 = both launches accepted).
int fspann_l2_topk(const float* base, const float* queries, int n, int d,
                   int nq, int k, int rows_per_split, int splits,
                   float* scr_v, int* scr_i, int* thr, float* out_v,
                   int* out_i, void* stream) {
  if (k < 1 || k > KP || n < k || d < 1 || nq < 1 || splits < 1 ||
      rows_per_split < 1 || (long long)rows_per_split * splits < n ||
      (long long)rows_per_split * (splits - 1) >= n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(base) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(queries) % 16 == 0;
  cudaError_t err = vec ? set_attributes<true>() : set_attributes<false>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + QT - 1) / QT, splits);
  if (vec)
    l2_topk_partial<true><<<grid, THREADS, kPartialSmem, s>>>(
        base, queries, n, d, nq, k, rows_per_split, scr_v, scr_i, thr);
  else
    l2_topk_partial<false><<<grid, THREADS, kPartialSmem, s>>>(
        base, queries, n, d, nq, k, rows_per_split, scr_v, scr_i, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  l2_topk_merge<<<(nq + MERGE_WARPS - 1) / MERGE_WARPS, 32 * MERGE_WARPS, 0,
                  s>>>(scr_v, scr_i, thr, nq, splits, k, out_v, out_i);
  return (int)cudaGetLastError();
}

// Resident blocks of pass 1 per SM (the launch geometry in ops/l2_topk.py
// assumes 2), or a negative CUDA error.
int fspann_l2_topk_blocks_per_sm(void) {
  cudaError_t err = set_attributes<true>();
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, l2_topk_partial<true>, THREADS, kPartialSmem);
  return err == cudaSuccess ? blocks : -(int)err;
}

const char* fspann_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
