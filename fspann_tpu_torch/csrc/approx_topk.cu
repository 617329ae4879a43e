// Approximate top-k's reduction step for Hopper (sm_90a), plain C interface
// (ctypes).
//
// Replaces: the TPU's ApproxTopK PartialReduce, which jax.lax.approx_max_k
// lowers to on the TPU (not a Pallas kernel): fspann_tpu/ops/hamming_scan.py
// :212 (scan) and :252 (scan_chunk_merge), ops/routing.py:297
// (route_rerank), parallel/sharded.py:688 (scan_route_step_fn).
//
// For each row q and bin b < W (W a multiple of 128, W * steps >= C + off):
//
//   out[q, b] = min over i with (i + off) mod W == b, 0 <= i < C, of
//               (value(q, i) << 32) | (row0 + i)          (int64)
//   value(q, i) = scale * x[q, i] + popc[i]   (popc may be absent: 0)
//   value(q, i) = 1 << 30                     where dead[i] (may be absent)
//
// and INT64_MAX for a bin that holds no element.  The offset places the C
// columns at the end of a block of C + off whose first off columns are dead:
// the chunked scan's tail, which the JAX package scans as a whole chunk-row
// block with the rows already scanned masked dead, bins as that block does
// without reading those rows (a bin of dead rows only loses to any other).
// ops/approx_topk.py takes the exact top-k of the W minima (torch.topk) and
// holds this kernel to its plain twin, partial_reduce_plain.
//
// What bounds it on the H100: device-memory bytes.  At the scan point (64
// queries, 1M rows, k = 2,000: W = 125,056, 8 steps) it reads 256 MB of int32
// bit products plus 5 MB of popcounts and dead marks, and writes 64 MB of
// keys: 0.097 ms at 3.35 TB/s.  The work is one compare per element.
//
// Design: one thread per (row, bin).  Consecutive threads take consecutive
// bins, so each of a warp's `steps` strided reads is one coalesced 128-byte
// request, and each thread keeps its minimum in a register: every element
// is read once and every bin written once.  The popcounts and dead marks
// are read by every row's threads; at 5 MB they stay in the 50 MB L2.  The
// rank value is formed here, so the exact path's [Q, C] int64 key (512 MB
// at the scan point) is never written.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_Q = 65535;   // gridDim.y
constexpr int DEAD = 1 << 30;  // ops/approx_topk._DEAD

__global__ void __launch_bounds__(THREADS)
partial_reduce_kernel(const int* __restrict__ x, int c, int w, int steps,
                      int off, const int* __restrict__ popc, int scale,
                      const unsigned char* __restrict__ dead, long long row0,
                      long long* __restrict__ out) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= w) return;
  const int q = blockIdx.y;
  const int* row = x + (size_t)q * c;
  long long best = LLONG_MAX;
  // the first step whose column lies past the block's dead front
  const int j0 = b >= off ? 0 : (off - b + w - 1) / w;
#pragma unroll 4
  for (int j = j0; j < steps; ++j) {
    const long long i = (long long)j * w + b - off;
    if (i >= c) break;
    int v = scale * __ldg(row + i);
    if (popc != nullptr) v += __ldg(popc + i);
    if (dead != nullptr && __ldg(dead + i)) v = DEAD;
    const long long key = (long long)((unsigned long long)(long long)v << 32)
                          | (long long)(unsigned)(row0 + i);
    best = key < best ? key : best;
  }
  out[(size_t)q * w + b] = best;
}

}  // namespace

extern "C" {

// x int32 [q, c], popc int32 [c] or null, dead uint8/bool [c] or null, out
// int64 [q, w]; all contiguous.  `steps` = 2^r, with w * steps >= c + off,
// off >= 0.  Launches on ``stream`` and returns the first CUDA error (0 =
// the launch was accepted).
int fspann_partial_reduce(const int* x, int q, int c, int w, int steps,
                          int off, const int* popc, int scale,
                          const unsigned char* dead, long long row0,
                          long long* out, void* stream) {
  if (q < 1 || q > MAX_Q || c < 1 || w < 1 || steps < 1 || off < 0
      || (long long)w * steps < (long long)c + off || row0 < 0
      || row0 + c > (long long)INT_MAX + 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + THREADS - 1) / THREADS, q);
  partial_reduce_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, c, w, steps, off, popc, scale, dead, row0, out);
  return (int)cudaGetLastError();
}

const char* fspann_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
