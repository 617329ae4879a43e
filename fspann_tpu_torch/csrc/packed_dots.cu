// Bit products of packed Hamming codes on the tensor cores, for Hopper
// (sm_90a), plain C interface (ctypes).
//
// Replaces: XLA's unpack plus int8 dot in the JAX package's packed chunked
// scan (fspann_tpu/ops/hamming_scan.py, scan_chunk_merge as scan_chunked runs
// it over a PackedScanState: each chunk's words unpacked to an int8 bit block,
// then lax.dot_general against the query bits).  Run as torch ops, those two
// steps wrote and re-read about 1.8 GB of byte-wide scratch for each 192 MB
// chunk of words.  Here nothing the size of a chunk's bits is ever written:
//
//   out[q, c] = sum over code bits b of qbit(q, b) * bit(words[c], b)
//
// int32 [Q, C], the values ops/hamming_scan._bit_dots(qbits,
// unpack_bits_device(words, code_bits)) gives.
//
// What bounds it on the H100: operations.  At the deep chunk (64 queries,
// 524,288 rows, 3,072 bits) the product is 2QCB = 206 G int8 operations,
// 0.104 ms at 1,979 TOP/s; it reads 201 MB of words (0.060 ms at 3.35 TB/s)
// and writes 134 MB of products (0.040 ms).  A CUDA-core AND + __popc runs
// at 16 popcounts a clock per SM: 15 ms for a batch of 64 over 10M rows
// against the tensor cores' 2 ms.
//
// Design: mma.sync m16n8k32 (u8 x u8 -> s32), corpus rows on the M side,
// queries on the N side.  Each warp expands its rows' words into A fragments
// in registers, one AND a register: for a 32-bit word w and j in 0..7,
// w & (0x01010101 << j) holds bits j, j+8, j+16, j+24 of w as four bytes of
// value 0 or 2^j.  The query's words are stored with the bits of each byte
// reversed (query_words_kernel), so the same AND with the mask shifted by
// 7 - j gives bytes of 0 or 2^(7-j) for the same bit positions.  Every
// product of two set bits is then 2^7 whatever j is: the sum is 128 times
// the bit product, exact in int32, and the kernel stores it shifted right by
// 7.  Which bits a step takes is free as long as both sides take the same:
// thread t of a quad takes word 4t + ws (ws = 0..3) of a 16-word slice, and
// step jp = 0..3 takes bit 2jp (a0/a1, b0) and bit 2jp + 1 (a2/a3, b1) of it,
// so one 16-byte load a row and slice feeds 16 mma steps.
//
// A block of 8 warps takes 256 rows and a tile of 64 queries (grid.y walks
// the tiles; queries past Q read zero words and store nothing); a warp takes
// 32 rows (two m16 tiles) by the 64 queries (eight n8 tiles), 64 int32
// accumulators a thread.  The tile's query words sit in shared memory (GW x
// 256 bytes: 24 KB at 96 words a row) in the order the lanes read them, so
// each read is one 128-byte row of banks.  Rows past C read zero words and
// are not stored; so do words past GW in a ragged last slice.  Pad bits past
// code_bits are zero in the query words, so the corpus's pad bits add
// nothing.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int QT = 64;               // queries a block: eight n8 tiles
constexpr int NT = QT / 8;
constexpr int MT = 2;                // m16 tiles a warp
constexpr int WARP_ROWS = MT * 16;
constexpr int BLOCK_ROWS = WARPS * WARP_ROWS;
constexpr int SLICE = 16;            // words a slice: 4 for each quad lane
constexpr int SLICE_SMEM = 4 * NT * 32;  // query words a slice in smem
constexpr unsigned LOW = 0x01010101u;
constexpr int MAX_TILES_Y = 65535;   // gridDim.y
constexpr int MAX_SMEM = 232448;     // a block's dynamic shared memory
constexpr int QW_THREADS = 256;

__device__ __forceinline__ void mma_u8(int (&d)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Words w0..w0+3 of `row` (zero past c rows or past the row's gw words).
// VEC: gw % 4 == 0 and 16-byte aligned rows, so the four are one load.
template <bool VEC>
__device__ __forceinline__ uint4 row_words(const unsigned* __restrict__ words,
                                           long long row, long long c, int gw,
                                           int w0) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= c || w0 >= gw) return v;
  const unsigned* p = words + row * gw + w0;
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(p));
  v.x = __ldg(p);
  if (w0 + 1 < gw) v.y = __ldg(p + 1);
  if (w0 + 2 < gw) v.z = __ldg(p + 2);
  if (w0 + 3 < gw) v.w = __ldg(p + 3);
  return v;
}

// One thread a query word: the int8 0/1 bits [q, g * code_bits] (MSB first
// within each group's words, as ops/coding packs them) into int32 words
// [q, g * w] whose byte i holds, in bit e, the bit at MSB-first place
// 8 (3 - i) + e of the word: the code word with each byte's bits reversed.
// Places past code_bits are zero.
__global__ void __launch_bounds__(QW_THREADS)
query_words_kernel(const signed char* __restrict__ qbits, int q, int g,
                   int w, int code_bits, unsigned* __restrict__ out) {
  const long long i = (long long)blockIdx.x * QW_THREADS + threadIdx.x;
  const int gw = g * w;
  if (i >= (long long)q * gw) return;
  const int n = (int)(i / gw), word = (int)(i % gw);
  const int grp = word / w, b0 = (word % w) * 32;
  const signed char* src = qbits + (long long)n * g * code_bits
                           + (long long)grp * code_bits + b0;
  unsigned v = 0u;
#pragma unroll
  for (int p = 0; p < 32; ++p)
    if (b0 + p < code_bits && src[p] != 0)
      v |= 1u << (8 * (3 - p / 8) + p % 8);
  out[i] = v;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
packed_dots_kernel(const unsigned* __restrict__ words, long long c, int gw,
                   const unsigned* __restrict__ qwords, int q,
                   int* __restrict__ out) {
  extern __shared__ unsigned sq[];  // [slice][ws][n8 tile][lane]
  const int slices = (gw + SLICE - 1) / SLICE;
  const int q0 = blockIdx.y * QT;
  for (int e = threadIdx.x; e < slices * SLICE_SMEM; e += THREADS) {
    const int lane = e & 31, nt = (e >> 5) & (NT - 1), ws = (e >> 8) & 3;
    const int s = e >> 10;
    const int n = q0 + nt * 8 + (lane >> 2);
    const int word = s * SLICE + 4 * (lane & 3) + ws;
    sq[e] = n < q && word < gw ? __ldg(qwords + (long long)n * gw + word)
                               : 0u;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long r0 = (long long)blockIdx.x * BLOCK_ROWS + warp * WARP_ROWS;
  if (r0 >= c) return;  // after the block's only barrier

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  for (int s = 0; s < slices; ++s) {
    const int w0 = s * SLICE + 4 * t;
    uint4 a[MT][2];  // rows g and g + 8 of each m16 tile
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = row_words<VEC>(words, r0 + mt * 16 + g, c, gw, w0);
      a[mt][1] = row_words<VEC>(words, r0 + mt * 16 + g + 8, c, gw, w0);
    }
    const unsigned* sqs = sq + s * SLICE_SMEM + lane;
#pragma unroll
    for (int ws = 0; ws < 4; ++ws) {
      unsigned qw[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) qw[nt] = sqs[(ws * NT + nt) * 32];
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const unsigned m0 = LOW << (2 * jp), m1 = LOW << (2 * jp + 1);
        const unsigned n0 = LOW << (7 - 2 * jp), n1 = LOW << (6 - 2 * jp);
        unsigned fa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const unsigned lo = word_of(a[mt][0], ws);
          const unsigned hi = word_of(a[mt][1], ws);
          fa[mt][0] = lo & m0;
          fa[mt][1] = hi & m0;
          fa[mt][2] = lo & m1;
          fa[mt][3] = hi & m1;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const unsigned b0 = qw[nt] & n0, b1 = qw[nt] & n1;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_u8(acc[mt][nt], fa[mt][0], fa[mt][1], fa[mt][2], fa[mt][3],
                   b0, b1);
        }
      }
    }
  }

  // c0, c1: row g, queries 2t and 2t + 1; c2, c3: row g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const long long ra = r0 + mt * 16 + g, rb = ra + 8;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = q0 + nt * 8 + 2 * t + e;
        if (n >= q) continue;
        int* row = out + (long long)n * c;
        if (ra < c) row[ra] = acc[mt][nt][e] >> 7;
        if (rb < c) row[rb] = acc[mt][nt][2 + e] >> 7;
      }
    }
  }
}

template <bool VEC>
cudaError_t launch_dots(const unsigned* words, long long c, int gw,
                        const unsigned* qwords, int q, int* out,
                        cudaStream_t stream) {
  const int slices = (gw + SLICE - 1) / SLICE;
  const size_t smem = (size_t)slices * SLICE_SMEM * sizeof(unsigned);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      packed_dots_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((c + BLOCK_ROWS - 1) / BLOCK_ROWS),
                  (unsigned)((q + QT - 1) / QT));
  packed_dots_kernel<VEC><<<grid, THREADS, smem, stream>>>(words, c, gw,
                                                           qwords, q, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qbits int8 [q, g * code_bits] (0/1), words int32 [c, g, w] (the uint32 bit
// patterns), qwords int32 [q, g * w] scratch, out int32 [q, c]; all
// contiguous, 0 < code_bits <= 32 w.  Launches the query-word kernel and the
// product kernel on `stream` and returns the first CUDA error (0 = both
// launches were accepted).
int fspann_packed_dots(const signed char* qbits, int q, int g, int w,
                       int code_bits, const unsigned* words, long long c,
                       unsigned* qwords, int* out, void* stream) {
  if (q < 1 || (q + QT - 1) / QT > MAX_TILES_Y || g < 1 || w < 1
      || code_bits < 1 || code_bits > 32 * w || c < 1 || c > INT_MAX
      || (long long)g * w > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gw = g * w;
  const long long nw = (long long)q * gw;
  query_words_kernel<<<(unsigned)((nw + QW_THREADS - 1) / QW_THREADS),
                       QW_THREADS, 0, s>>>(qbits, q, g, w, code_bits, qwords);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool vec = gw % 4 == 0
                   && reinterpret_cast<uintptr_t>(words) % 16 == 0;
  err = vec ? launch_dots<true>(words, c, gw, qwords, q, out, s)
            : launch_dots<false>(words, c, gw, qwords, q, out, s);
  return (int)err;
}

const char* fspann_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
