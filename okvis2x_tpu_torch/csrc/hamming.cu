// Packed binary-descriptor Hamming distance matrix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel okvis2x_tpu/ops/hamming_pallas.py
// (_hamming_kernel, launched by hamming_matrix_packed through pl.pallas_call).
// out[q, d] = sum over the 12 words of popcount(Q[q, w] ^ D[d, w]), the
// Hamming distance of 384-bit descriptors packed LSB-first (bit b in word
// b / 32).  Descriptors arrive as int32 holding the same bits; the kernel
// reads them as uint32.
//
// What bounds it: popcounts.  Each output costs 12 XOR + 12 __popc, and an
// SM retires 16 __popc a clock (132 SMs at 1.98 GHz: 4.18e12 a second), so
// 704 x 1024 outputs need 2.1 us; the bytes (48 per descriptor in, one int32
// per output: 2.9 MB of the 3.0 MB moved) need 0.9 us at 3.35 TB/s.  The
// output write dominates the memory traffic but not the time.  Callers that
// only reduce the matrix use the fused kernel in hamming_match.cu, which
// never writes it.
//
// Design: a 64 x 64
// output tile per block; the query and database tiles are staged in shared
// memory word-major ([word][row]), so the 16 x 16 threads read neighbouring
// rows from neighbouring banks.  Each thread owns a 4 x 4 register tile at
// rows ty + 16 i and columns tx + 16 j, so a warp's stores to one output row
// are contiguous.  Any NQ and ND are accepted: ragged edges are zero-filled
// on load and masked on store, so callers never pad.
//
// Plain C interface (loaded with ctypes): the caller passes device pointers
// and the CUDA stream, and gets the launch's cudaError_t back.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 12;
constexpr int kTile = 64;
constexpr int kThreads = 16;
constexpr int kPer = kTile / kThreads;  // 4 outputs per thread per axis

__global__ void hamming_kernel(const uint32_t* __restrict__ q,
                               const uint32_t* __restrict__ d,
                               int32_t* __restrict__ out, int nq, int nd) {
  __shared__ uint32_t qs[kWords][kTile];
  __shared__ uint32_t ds[kWords][kTile];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreads + tx;
  const int q0 = blockIdx.y * kTile;
  const int d0 = blockIdx.x * kTile;

  // cooperative tile loads: 64 rows x 12 words each, 256 threads
  for (int i = tid; i < kTile * kWords; i += kThreads * kThreads) {
    const int row = i / kWords;
    const int w = i % kWords;
    const int gq = q0 + row;
    const int gd = d0 + row;
    qs[w][row] = gq < nq ? q[(int64_t)gq * kWords + w] : 0u;
    ds[w][row] = gd < nd ? d[(int64_t)gd * kWords + w] : 0u;
  }
  __syncthreads();

  int acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0;

#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    uint32_t qv[kPer], dv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) qv[i] = qs[w][ty + kThreads * i];
#pragma unroll
    for (int j = 0; j < kPer; ++j) dv[j] = ds[w][tx + kThreads * j];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[i][j] += __popc(qv[i] ^ dv[j]);
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int gq = q0 + ty + kThreads * i;
    if (gq >= nq) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int gd = d0 + tx + kThreads * j;
      if (gd < nd) out[(int64_t)gq * nd + gd] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int okvis_hamming_i32(const void* q, const void* d, void* out,
                                 int nq, int nd, void* stream) {
  if (nq <= 0 || nd <= 0) return 0;
  const dim3 block(kThreads, kThreads);
  const dim3 grid((nd + kTile - 1) / kTile, (nq + kTile - 1) / kTile);
  hamming_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(d),
      static_cast<int32_t*>(out), nq, nd);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* okvis_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
