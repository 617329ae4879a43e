// Candidate full-code Hamming for Hopper (sm_90a), plain C interface (ctypes).
//
// Replaces: the XLA gather + XOR + population_count + sum that scores each
// routed candidate by its own packed codes in the probe route,
// fspann_tpu/ops/routing.py:281-283 (route_rerank) and :334-336 (rerank).
// There it is no Pallas kernel: XLA materialises the gathered codes
// [Q, R, C] before the popcount.  In PyTorch, which has no popcount, the
// plain version (ops/code_hamming.code_hamming_plain) materialises them too,
// plus int64 bit-count scratch of the same shape.
//
//   fine[q, r] = sum_w popc(codes[ids[q, r], w] ^ qcodes[q, w])
//   fine[q, r] = INT_MAX where ids[q, r] < 0 or ids[q, r] >= n
//
// What bounds it on the H100: device-memory reads of the code rows.  At the
// probe slice's operating point (Q = 64 queries, R = 49,152 candidates,
// C = 96 words, 1M rows) a batch names 94% of the rows, each about three
// times: 1.1 GB of 384-byte rows if every candidate is fetched on its own,
// 0.39 GB if every row leaves device memory once.  Next comes integer issue:
// an SM issues 64 integer lanes a clock, popcounts slower still, and the
// batch needs 282M of each of XOR, popcount and add.
//
// Two paths, picked by ops/code_hamming.py from the sizes alone:
//
// * Gather (any ids; the path of small or unordered batches).  One warp
//   scores one candidate row at a time, so a row's C words are read by
//   neighbouring lanes as one coalesced request (16 bytes a lane when C is a
//   multiple of 4 and the rows are 16-byte aligned, else 4).  A block serves
//   one query: its C words sit in shared memory, loaded once.  The query is
//   the fastest block index, so the resident blocks score about the same
//   columns of every query together; where the ids ascend with the column
//   those are about the same rows, and L2 serves part of the repeats.  It
//   reads valid x C x 4 bytes.
//
// * Row-window sweep (dense batches whose ids ascend with the column).  The
//   code array is cut into windows of T = 2^shift consecutive rows.  A
//   pre-pass over the ids records, for each (window, query), the span of
//   columns [first, last) that holds every id of that window (atomicMin on
//   first and on -last, one pair per run of equal windows in a warp), marks
//   the windows that any query touches, and writes INT_MAX at every pad.
//   One persistent block to an SM then walks its touched windows in turns.
//   Everything a turn reads from device memory was asked for by cp.async
//   turns before: the window's rows (one contiguous copy, two windows
//   ahead, marked evict-first in L2), its spans (four ahead) and the first
//   ID_CAP ids of each span (three ahead, from the spans already there, in
//   aligned 16-byte pieces).  A load in the turn's own path would wait
//   microseconds behind the window copies in flight.  A turn has one
//   barrier.  Behind it the warps score this window's list of (query,
//   column) pairs, made during the turn before, 4 lanes an item: a lane
//   takes every fourth 16-byte chunk of the item's row and of its query
//   (both in shared memory), odd items one chunk on, so a quarter warp reads
//   8 different bank groups; a 2-step shuffle sums the 4 lanes.  A warp that
//   has scored its items goes on to list the next window: it tests the
//   staged ids of each span against that window and appends the hits to a
//   second list.  Pads and ids of other windows inside a span are not
//   listed.  A span longer than ID_CAP takes further rounds, with ids from
//   device memory.  Every row leaves device memory once per batch, whatever
//   Q is: it reads N x C x 4 bytes.  The span rule is right for ids in any
//   order; only its time depends on the order (an unordered query's spans
//   cover most of its columns in every window).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int WARPS = 8;            // gather: warps per block (256 threads)
constexpr int ROWS_PER_WARP = 8;    // gather: candidates each warp scores
constexpr int MAX_C = 192;          // words per point (6,144-bit codes)
constexpr int MAX_Q = 65535;
// The sweep at turn t holds the rows of windows t..t+2, the ids of t+1..t+3
// and the spans of t..t+4 (a block's t-th touched window).
constexpr int ROW_STAGES = 3;
constexpr int ID_STAGES = 3;
constexpr int SPAN_STAGES = 5;
constexpr int ID_CAP = 16;          // sweep: ids of a span staged ahead
constexpr int ID_SLOT = ID_CAP + 4;  // sweep: their room, at any alignment
constexpr int MARKS = 64;           // sweep: touched marks read at a time
constexpr int MAX_SWEEP_THREADS = 1024;
// sweep: an item holds its query in 10 bits, its row of the window in 10
// and its column of the round in 4
constexpr int MAX_SWEEP_Q = 1024;
constexpr int MAX_SHIFT = 10;
constexpr int EMPTY = 0x7f7f7f7f;   // span table after memset(0x7f)
constexpr unsigned FULL = 0xffffffffu;

// The sweep's shared memory, in words, each part rounded up to 16 bytes:
// the queries' codes, ROW_STAGES windows of rows, SPAN_STAGES windows of
// spans, ID_STAGES windows of ids (ID_SLOT a query), two lists of items (a
// word each, ID_CAP a query).
__host__ __device__ inline size_t round4(size_t words) {
  return (words + 3) & ~(size_t)3;
}
__host__ __device__ inline size_t query_words(int c, int nq) {
  return round4((size_t)c * nq);
}
__host__ __device__ inline size_t row_words(int c, int shift) {
  return round4((size_t)c << shift);
}
__host__ __device__ inline size_t span_words(int nq) {
  return round4(2 * (size_t)nq);
}
__host__ __device__ inline size_t id_words(int nq) {
  return (size_t)ID_SLOT * nq;
}
__host__ __device__ inline size_t item_words(int nq) {
  return (size_t)ID_CAP * nq;
}
__host__ __device__ inline size_t sweep_words(int c, int shift, int nq) {
  return query_words(c, nq) + ROW_STAGES * row_words(c, shift) +
         SPAN_STAGES * span_words(nq) + ID_STAGES * id_words(nq) +
         2 * item_words(nq);
}

template <bool VEC4>
__global__ void __launch_bounds__(WARPS * 32)
gather_kernel(const int* __restrict__ codes, int n, int c,
              const int* __restrict__ qcodes, int nq,
              const int* __restrict__ ids, int r, int* __restrict__ out) {
  __shared__ __align__(16) int sq[MAX_C];
#ifdef FSPANN_CODE_HAMMING_COLUMN_FASTEST
  // the control of the block order's measurement: one query's columns first
  const unsigned chunks = (r + WARPS * ROWS_PER_WARP - 1) /
                          (WARPS * ROWS_PER_WARP);
  const int q = blockIdx.x / chunks;
  const unsigned chunk = blockIdx.x % chunks;
#else
  const int q = blockIdx.x % nq;
  const unsigned chunk = blockIdx.x / nq;
#endif
  for (int t = threadIdx.x; t < c; t += blockDim.x)
    sq[t] = qcodes[(size_t)q * c + t];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r0 = ((long long)chunk * WARPS + warp) * ROWS_PER_WARP;
  const int* qids = ids + (size_t)q * r;
  int* qout = out + (size_t)q * r;
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const long long rr = r0 + i;
    if (rr >= r) break;                       // uniform across the warp
    const int id = __ldg(qids + rr);
    int acc = INT_MAX;
    if (id >= 0 && id < n) {                  // uniform across the warp
      const int* row = codes + (size_t)id * c;
      int s = 0;
      if (VEC4) {
        const int4* row4 = reinterpret_cast<const int4*>(row);
        const int4* sq4 = reinterpret_cast<const int4*>(sq);
        for (int t = lane; t < (c >> 2); t += 32) {
          const int4 a = __ldg(row4 + t);
          const int4 b = sq4[t];
          s += __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) +
               __popc(a.w ^ b.w);
        }
      } else {
        for (int t = lane; t < c; t += 32) s += __popc(__ldg(row + t) ^ sq[t]);
      }
      for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      acc = s;
    }
    if (lane == 0) qout[rr] = acc;
  }
}

// Sweep pre-pass.  table: int32 [windows, nq, 2], touched: int32 [windows],
// both holding EMPTY in every word.  A thread takes one (query, column).
__global__ void __launch_bounds__(256)
span_kernel(const int* __restrict__ ids, int n, int nq, int r, int shift,
            int* __restrict__ out, int* __restrict__ table,
            int* __restrict__ touched) {
  const int q = blockIdx.y;
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int w = -1;
  if (col < r) {
    const int id = __ldg(ids + (size_t)q * r + col);
    if (id >= 0 && id < n)
      w = id >> shift;
    else
      out[(size_t)q * r + col] = INT_MAX;
  }
  // one atomic pair per run of equal windows among the warp's columns: the
  // run's first column bounds the span below, its last column above
  int prev = __shfl_up_sync(FULL, w, 1);
  int next = __shfl_down_sync(FULL, w, 1);
  if (lane == 0) prev = -2;
  if (lane == 31) next = -2;
  if (w >= 0) {
    int* e = table + 2 * ((size_t)w * nq + q);
    if (w != prev) {
      atomicMin(e, (int)col);
      touched[w] = 0;
    }
    if (w != next) atomicMin(e + 1, -(int)(col + 1));
  }
}

// The code rows stream through L2 once: marked evict-first, they leave the
// ids and the span table (read again by every window) in place.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void cp_async_16(int* dst, const int* src,
                                            uint64_t policy) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "l"(policy) : "memory");
}

__device__ __forceinline__ void cp_async_16(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_8(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

// Start the copy of window w's rows ([w << shift, ...) clipped to n) into
// ``dst``, 16 bytes at a time where the rows in device memory allow it;
// nothing past the last window.
__device__ __forceinline__ void stage_rows(int* dst, const int* codes, int n,
                                           int c, int shift, bool wide,
                                           uint64_t policy, int w, int nw) {
  if (w >= nw) return;
  const long long row0 = (long long)w << shift;
  const long long left = n - row0;
  const int rows = left < (1LL << shift) ? (int)left : (1 << shift);
  const int words = rows * c;
  const int* src = codes + (size_t)row0 * c;
  if (wide) {
    for (int i = threadIdx.x * 4; i < words; i += blockDim.x * 4)
      cp_async_16(dst + i, src + i, policy);
  } else {
    for (int i = threadIdx.x; i < words; i += blockDim.x)
      cp_async_4(dst + i, src + i);
  }
}

// Start the copy of window w's nq spans into ``dst``.
__device__ __forceinline__ void stage_spans(int* dst, const int* table,
                                            int nq, int w, int nw) {
  if (w >= nw) return;
  const int* spans = table + 2 * (size_t)w * nq;
  for (int i = threadIdx.x; i < nq; i += blockDim.x)
    cp_async_8(dst + 2 * i, spans + 2 * i);
}

// Start the copy of the first ID_CAP ids of every query's span in a window
// whose spans are in shared memory.  Query q's ids land at dst[q * ID_SLOT +
// (first & 3) + k]: where the rows of ``ids`` are 16-byte aligned
// (``wide``) they come as the 5 aligned 16-byte pieces that cover them, a
// scattered 4-byte copy costing the load unit as much as a 16-byte one.
__device__ __forceinline__ void stage_ids(int* dst, const int* spans,
                                          const int* ids, int nq, int r,
                                          bool wide) {
  if (wide) {
    for (int i = threadIdx.x; i < nq * (ID_SLOT / 4); i += blockDim.x) {
      const int q = i / (ID_SLOT / 4), piece = i % (ID_SLOT / 4);
      const int first = spans[2 * q], last = -spans[2 * q + 1];
      const int at = (first & ~3) + 4 * piece;
      if (first != EMPTY && at < last)
        cp_async_16(dst + q * ID_SLOT + 4 * piece, ids + (size_t)q * r + at);
    }
  } else {
    for (int i = threadIdx.x; i < nq * ID_CAP; i += blockDim.x) {
      const int q = i / ID_CAP, k = i % ID_CAP;
      const int first = spans[2 * q], last = -spans[2 * q + 1];
      if (first != EMPTY && first + k < last)
        cp_async_4(dst + q * ID_SLOT + (first & 3) + k,
                   ids + (size_t)q * r + first + k);
    }
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A block's windows are blockIdx.x + k * gridDim.x, k = 0, 1, ...  Their
// touched marks are read MARKS at a time into shared memory.  Returns the
// window of the first touched k at or after ``k`` (and sets ``k`` to it),
// or nw.  Every thread of the block calls it with the same arguments.
__device__ __forceinline__ int next_touched(int* marks, int& base,
                                            const int* touched, int& k,
                                            int nw) {
  for (;; ++k) {
    const long long w = blockIdx.x + (long long)k * gridDim.x;
    if (w >= nw) return nw;
    if (k >= base + MARKS) {
      __syncthreads();                        // every reader has left
      base = k;
      if (threadIdx.x < MARKS) {
        const long long wt =
            blockIdx.x + (long long)(k + threadIdx.x) * gridDim.x;
        marks[threadIdx.x] = wt < nw ? __ldg(touched + wt) : 0;
      }
      __syncthreads();
    }
    if (marks[k - base] == 0) return (int)w;
  }
}

// VEC4: c is a multiple of 4, so a row in shared memory is read 16 bytes at
// a time.  K > 0: c is 16 K words (the 3,072- and 6,144-bit codes: K = 6 and
// 12), and the scoring loop is unrolled over a lane's K chunks.
template <bool VEC4, int K>
__global__ void __launch_bounds__(MAX_SWEEP_THREADS)
sweep_kernel(const int* __restrict__ codes, int n, int c,
             const int* __restrict__ qcodes, int nq,
             const int* __restrict__ ids, int r, int* __restrict__ out,
             const int* __restrict__ table, const int* __restrict__ touched,
             int shift, int nw, bool wide, bool wide_ids) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int marks[MARKS];
  // a window's list: how many items, and its longest span; by window mod 3
  __shared__ int count[3], longest[3], extra;
  const size_t rwords = row_words(c, shift), swords = span_words(nq);
  const size_t iwords = id_words(nq);
  int* const qsm = smem;
  int* const row_ring = qsm + query_words(c, nq);
  int* const span_ring = row_ring + ROW_STAGES * rwords;
  int* const id_ring = span_ring + SPAN_STAGES * swords;
  int* const item_ring = id_ring + ID_STAGES * iwords;
  const int lane = threadIdx.x & 31;
  const uint64_t policy = evict_first_policy();
  const int slots = (nq * ID_CAP + 31) & ~31;

  // List into ``items`` the (query, column) pairs of window ``w`` whose id
  // lies in it, ID_CAP columns of every query's span a round: an item is
  // query << 14 | row in the window << 4 | column in the round.  The first
  // round's ids are in shared memory (``idbuf``), a longer span's come from
  // device memory.  ``n_items`` counts them; ``len_max`` takes the longest
  // span above ID_CAP.
  auto list = [&](int w, const int* span_buf, const int* idbuf, int round,
                  int* items, int* n_items, int* len_max) {
    const int2* spans = reinterpret_cast<const int2*>(span_buf);
    const long long row0 = (long long)w << shift;
    const long long left = n - row0;
    const unsigned rows = left < (1LL << shift) ? (unsigned)left
                                                : (1u << shift);
    for (int i = threadIdx.x; i < slots; i += blockDim.x) {
      const int q = i / ID_CAP, k = i % ID_CAP;
      unsigned local = UINT_MAX;
      if (q < nq) {
        const int2 sp = spans[q];
        const int len = sp.x == EMPTY ? 0 : -sp.y - sp.x;
        if (k == 0 && round == 0 && len > ID_CAP) atomicMax(len_max, len);
        if (round * ID_CAP + k < len) {
          const int id =
              round == 0 ? idbuf[q * ID_SLOT + (sp.x & 3) + k]
                         : __ldg(ids + (size_t)q * r + sp.x + round * ID_CAP +
                                 k);
          local = (unsigned)id - (unsigned)row0;
        }
      }
      const bool in_window = local < rows;
      const unsigned vote = __ballot_sync(FULL, in_window);
      int at = 0;
      if (lane == 0 && vote != 0) at = atomicAdd(n_items, __popc(vote));
      at = __shfl_sync(FULL, at, 0) + __popc(vote & ((1u << lane) - 1));
      if (in_window) items[at] = (q << 14) | ((int)local << 4) | k;
    }
  };

  // Score ``total`` items of a window whose rows are in ``buf``, 4 lanes an
  // item: lane ``sub`` takes the 16-byte chunks sub, sub + 4, ... of the row
  // and of the query.  Odd items start one chunk later, so the 8 lanes of a
  // quarter warp (2 items) read 8 different bank groups.
  auto score = [&](const int* items, int total, const int* buf,
                   const int* span_buf, int round) {
    const int2* spans = reinterpret_cast<const int2*>(span_buf);
    const int sub = lane & 3;
    for (int i = threadIdx.x >> 2; (i & ~7) < total;
         i += blockDim.x >> 2) {              // uniform across the warp
      const bool act = i < total;
      const int item = items[act ? i : 0];
      const int q = item >> 14;
      const int* row = buf + (size_t)((item >> 4) & 0x3ff) * c;
      const int* qrow = qsm + (size_t)q * c;
      int s = 0;
      if (VEC4) {
        const int4* row4 = reinterpret_cast<const int4*>(row);
        const int4* q4 = reinterpret_cast<const int4*>(qrow);
        if (K > 0) {
          // c == 16 K: the lane's K chunks at fixed offsets from where it
          // starts; an odd item's last chunk is the one before its first
          const int start = sub + 4 * (i & 1);
          const int4* rp = row4 + start;
          const int4* qp = q4 + start;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int at = j < K - 1 ? 4 * j : (i & 1) ? -4 : 4 * (K - 1);
            const int4 a = rp[at], b = qp[at];
            s += __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) +
                 __popc(a.w ^ b.w);
          }
        } else {
          const int mine = ((c >> 2) - sub + 3) >> 2;   // this lane's chunks
          int k = mine > 1 ? (i & 1) : 0;
#pragma unroll 3
          for (int j = 0; j < mine; ++j) {
            const int t = sub + 4 * k;
            const int4 a = row4[t], b = q4[t];
            s += __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) +
                 __popc(a.w ^ b.w);
            k = k + 1 == mine ? 0 : k + 1;
          }
        }
      } else {
        for (int t = sub; t < c; t += 4) s += __popc(row[t] ^ qrow[t]);
      }
      s += __shfl_xor_sync(FULL, s, 1);
      s += __shfl_xor_sync(FULL, s, 2);
      if (act && sub == 0)
        out[(size_t)q * r + spans[q].x + round * ID_CAP + (item & 15)] = s;
    }
  };

  for (int i = threadIdx.x; i < nq * c; i += blockDim.x) qsm[i] = qcodes[i];
  if (threadIdx.x < 3) count[threadIdx.x] = longest[threadIdx.x] = 0;

  // this block's touched windows: now and the four after
  int base = -MARKS, k = 0;
  int w[5];
  w[0] = next_touched(marks, base, touched, k, nw);
#pragma unroll
  for (int a = 1; a < 5; ++a)
    w[a] = next_touched(marks, base, touched, ++k, nw);
  if (w[0] >= nw) return;                     // uniform across the block
  // Before the first turn: spans 0..3, then the first window's ids and its
  // list, as a turn would have left them.
#pragma unroll
  for (int a = 0; a < 4; ++a)
    stage_spans(span_ring + a * swords, table, nq, w[a], nw);
  commit_group();
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  stage_ids(id_ring, span_ring, ids, nq, r, wide_ids);
  commit_group();
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  list(w[0], span_ring, id_ring, 0, item_ring, &count[0], &longest[0]);
  // Groups are closed in the order S (spans of t + 4), I (ids of t + 3), R
  // (rows of t + 2) every turn t; a turn starts by waiting for all but the
  // I and R of the turn before.  The turns -2 and -1:
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (a > 0) commit_group();                // S
    if (w[a + 1] < nw)
      stage_ids(id_ring + (a + 1) * iwords, span_ring + (a + 1) * swords, ids,
                nq, r, wide_ids);
    commit_group();                           // I
    stage_rows(row_ring + a * rwords, codes, n, c, shift, wide, policy, w[a],
               nw);
    commit_group();                           // R
  }
  for (int turn = 0; w[0] < nw; ++turn) {
    // Done now: this window's rows, the next window's ids, the spans up to
    // three ahead.  The one barrier of a turn: behind it this window's list
    // (made last turn) is whole, and every buffer refilled below has lost
    // its last reader.
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0)
      count[(turn + 2) % 3] = longest[(turn + 2) % 3] = 0;
    stage_spans(span_ring + ((turn + 4) % SPAN_STAGES) * swords, table, nq,
                w[4], nw);
    commit_group();
    if (w[3] < nw)
      stage_ids(id_ring + ((turn + 3) % ID_STAGES) * iwords,
                span_ring + ((turn + 3) % SPAN_STAGES) * swords, ids, nq, r,
                wide_ids);
    commit_group();
    stage_rows(row_ring + ((turn + 2) % ROW_STAGES) * rwords, codes, n, c,
               shift, wide, policy, w[2], nw);
    commit_group();

    const int* buf = row_ring + (turn % ROW_STAGES) * rwords;
    const int* span_buf = span_ring + (turn % SPAN_STAGES) * swords;
    int* items = item_ring + (turn & 1) * item_words(nq);
    score(items, count[turn % 3], buf, span_buf, 0);
    // the next window's list, while other warps still score this one
    if (w[1] < nw)
      list(w[1], span_ring + ((turn + 1) % SPAN_STAGES) * swords,
           id_ring + ((turn + 1) % ID_STAGES) * iwords, 0,
           item_ring + ((turn + 1) & 1) * item_words(nq),
           &count[(turn + 1) % 3], &longest[(turn + 1) % 3]);
    // A span longer than ID_CAP (rare where ids ascend): further rounds of
    // this window, listed from device memory into its own list.
    const int rounds = (longest[turn % 3] + ID_CAP - 1) / ID_CAP;
    for (int round = 1; round < rounds; ++round) {
      __syncthreads();                        // the list has been scored
      if (threadIdx.x == 0) extra = 0;
      __syncthreads();
      list(w[0], span_buf, nullptr, round, items, &extra, &extra);
      __syncthreads();
      score(items, extra, buf, span_buf, round);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) w[a] = w[a + 1];
    w[4] = next_touched(marks, base, touched, ++k, nw);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool VEC4, int K>
cudaError_t launch_sweep(const int* codes, int n, int c, const int* qcodes,
                         int nq, const int* ids, int r, int* out, int* table,
                         int* touched, int shift, int nw, int threads,
                         cudaStream_t s) {
  const size_t smem = sweep_words(c, shift, nq) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<VEC4, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sweep_kernel<VEC4, K>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, resident = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, sweep_kernel<VEC4, K>, threads, smem);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  long long blocks = (long long)sms * resident;
  if (blocks > nw) blocks = nw;
  sweep_kernel<VEC4, K><<<(unsigned)blocks, threads, smem, s>>>(
      codes, n, c, qcodes, nq, ids, r, out, table, touched, shift, nw,
      c % 4 == 0 && aligned16(codes), r % 4 == 0 && aligned16(ids));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The gather path.  codes int32 [n, c], qcodes int32 [nq, c], ids int32
// [nq, r], out int32 [nq, r]; all contiguous.  Launches on ``stream`` and
// returns the first CUDA error (0 = the launch was accepted).
int fspann_code_hamming(const int* codes, int n, int c, const int* qcodes,
                        int nq, const int* ids, int r, int* out,
                        void* stream) {
  if (n < 1 || c < 1 || c > MAX_C || nq < 1 || nq > MAX_Q || r < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_block = (long long)WARPS * ROWS_PER_WARP;
  const long long blocks = (r + per_block - 1) / per_block * nq;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (c % 4 == 0 && aligned16(codes))
    gather_kernel<true><<<(unsigned)blocks, WARPS * 32, 0, s>>>(
        codes, n, c, qcodes, nq, ids, r, out);
  else
    gather_kernel<false><<<(unsigned)blocks, WARPS * 32, 0, s>>>(
        codes, n, c, qcodes, nq, ids, r, out);
  return (int)cudaGetLastError();
}

// The sweep path: same tensors, plus ``scratch``, int32 [windows * (2 * nq
// + 1)] with windows = ceil(n / 2^shift), which this call fills itself (the
// span table, then the touched marks).  ``threads`` a block: a multiple of
// 32 from 64 to 1024.  Three operations on ``stream``: a memset, the
// pre-pass, the sweep.
int fspann_code_hamming_sweep(const int* codes, int n, int c,
                              const int* qcodes, int nq, const int* ids,
                              int r, int* out, int* scratch, int shift,
                              int threads, void* stream) {
  if (n < 1 || c < 1 || c > MAX_C || nq < 1 || nq > MAX_Q || r < 1 ||
      r >= EMPTY || nq > MAX_SWEEP_Q || shift < 0 || shift > MAX_SHIFT ||
      threads < MARKS || threads > MAX_SWEEP_THREADS || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nw = (int)(((long long)n + (1LL << shift) - 1) >> shift);
  int* table = scratch;
  int* touched = scratch + 2 * (size_t)nw * nq;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0x7f, (size_t)nw * (2 * (size_t)nq + 1) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((r + 255) / 256), (unsigned)nq);
  span_kernel<<<grid, 256, 0, s>>>(ids, n, nq, r, shift, out, table, touched);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (c == 96)
    err = launch_sweep<true, 6>(codes, n, c, qcodes, nq, ids, r, out, table,
                                touched, shift, nw, threads, s);
  else if (c == 192)
    err = launch_sweep<true, 12>(codes, n, c, qcodes, nq, ids, r, out, table,
                                 touched, shift, nw, threads, s);
  else if (c % 4 == 0)
    err = launch_sweep<true, 0>(codes, n, c, qcodes, nq, ids, r, out, table,
                                touched, shift, nw, threads, s);
  else
    err = launch_sweep<false, 0>(codes, n, c, qcodes, nq, ids, r, out, table,
                                 touched, shift, nw, threads, s);
  return (int)err;
}

const char* fspann_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
