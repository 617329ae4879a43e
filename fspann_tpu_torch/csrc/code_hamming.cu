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
// What bounds it on the H100: device-memory reads of the gathered rows.  At
// the probe slice's operating point (Q = 64 queries, R = 49,152 candidates,
// C = 96 words) that is 1.2 GB of 384-byte rows per batch, 0.36 ms at
// 3.35 TB/s; the popcounts are 302M integer ops, far below the card's rate.
// Nothing is written but the [Q, R] result.
//
// Design (simple first): one warp scores one candidate row at a time, so a
// row's C words are read by neighbouring lanes as one coalesced request
// (16 bytes a lane when C is a multiple of 4 and the rows are 16-byte
// aligned, else 4).  A block serves one query: its C words sit in shared
// memory, loaded once.  Each warp walks ROWS_PER_WARP candidates; the
// warp's partial counts meet in a shuffle reduction.  The id is read by
// every lane from one address (a broadcast), so the pad test is uniform
// across the warp and the shuffle never sees a divergent warp.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int WARPS = 8;            // warps per block (256 threads)
constexpr int ROWS_PER_WARP = 8;    // candidates each warp scores
constexpr int MAX_C = 192;          // words per point (6,144-bit codes)
constexpr int MAX_Q = 65535;        // grid.y

template <bool VEC4>
__global__ void __launch_bounds__(WARPS * 32)
code_hamming_kernel(const int* __restrict__ codes, int n, int c,
                    const int* __restrict__ qcodes,
                    const int* __restrict__ ids, int r,
                    int* __restrict__ out) {
  __shared__ __align__(16) int sq[MAX_C];
  const int q = blockIdx.y;
  for (int t = threadIdx.x; t < c; t += blockDim.x)
    sq[t] = qcodes[(size_t)q * c + t];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r0 =
      ((long long)blockIdx.x * WARPS + warp) * ROWS_PER_WARP;
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
      for (int off = 16; off; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      acc = s;
    }
    if (lane == 0) qout[rr] = acc;
  }
}

}  // namespace

extern "C" {

// codes int32 [n, c], qcodes int32 [nq, c], ids int32 [nq, r], out int32
// [nq, r]; all contiguous.  Launches on ``stream`` and returns the first
// CUDA error (0 = the launch was accepted).
int fspann_code_hamming(const int* codes, int n, int c, const int* qcodes,
                        int nq, const int* ids, int r, int* out,
                        void* stream) {
  if (n < 1 || c < 1 || c > MAX_C || nq < 1 || nq > MAX_Q || r < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_block = (long long)WARPS * ROWS_PER_WARP;
  dim3 grid((unsigned)((r + per_block - 1) / per_block), (unsigned)nq);
  const bool vec4 = (c % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  if (vec4)
    code_hamming_kernel<true><<<grid, WARPS * 32, 0, s>>>(codes, n, c, qcodes,
                                                          ids, r, out);
  else
    code_hamming_kernel<false><<<grid, WARPS * 32, 0, s>>>(codes, n, c,
                                                           qcodes, ids, r,
                                                           out);
  return (int)cudaGetLastError();
}

const char* fspann_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
