// Fused packed-descriptor matching for Hopper (sm_90a): masked Hamming
// distances reduced to row and column argmins without writing the matrix.
//
// Replaces the Pallas TPU kernel okvis2x_tpu/ops/hamming_pallas.py:39-47
// (_hamming_kernel) together with the wrappers that reduce its output,
// hamming_pallas.py:88-132 (best_matches_packed, match_packed_mutual), and
// the same reductions at the matcher, the vocabulary descent and the loop
// matching.  On the TPU the wrappers are jnp.where / argmin calls that XLA
// fuses behind the kernel; eager PyTorch runs each as a launch over a
// full-size copy of the matrix, so here the reduction is the kernel's
// epilogue.
//
// For descriptors q (NQ, 12) and d (ND, 12), validity bytes vq, vd, an
// optional byte mask allowed (NQ, ND) and the database axis cut into
// S = ND / seg segments, the value of a cell is
//     v(i, j) = popcount(q_i ^ d_j)   where vq[i] and vd[j],
//               fill_invalid          elsewhere,
//     then      fill_disallowed       where allowed[i, j] is 0,
// and the kernel gives, per row and segment, the least v and its first
// column, and per column the first row of the least v.
//
// What bounds it: popcounts.  A cell costs 12 __popc, which an SM retires 16
// a clock (132 SMs, 1.98 GHz: 4.18e12 a second), so 704 x 1024 cells need
// 2.1 us and 704 x 4096 cells 8.3 us, while the bytes (48 a descriptor, the
// outputs of 12 a row and 8 a column, one mask byte a cell where there is a
// mask) need 0.03 to 0.25 us at 3.35 TB/s.  With the matrix gone the bytes
// are 40 to 400 times below the popcounts, and at these shapes the bound is
// of the order of one launch.
//
// Design.
//  * A block of 8 x 16 threads takes 32 queries and walks `walk` database
//    tiles of 64 rows inside one segment; both tiles are staged word-major
//    in shared memory and read back 16 bytes a thread.  Each thread owns a
//    4 x 4 register tile of neighbouring rows and columns, so its four mask
//    bytes of a row are one 32-bit load.  Small tiles: 704 x 704 is 242
//    blocks and 704 x 1024 is 352, all resident at once on the 132 SMs.
//  * The epilogue folds each cell into the key (v << 23) | index, once with
//    the column and once with the row.  A minimum over such keys is the
//    least v and, among equal v, the first index, in whatever order the
//    minima are taken, so the result is the same from run to run.  The 16
//    threads of a row combine with shuffles, the columns of a tile through
//    shared memory.  v must fit 9 bits: the wrapper maps a fill above 511
//    to 511 here and back in the last pass.
//  * A block stores its partial keys (a row's minimum over the block's
//    tiles, a column's over the block's 32 rows) into scratch that needs no
//    initialising, and a second small kernel takes the minimum over the
//    blocks and writes the int32 minima and int64 indices.  Two graph nodes
//    a call, where the matrix kernel's callers launched about ten full-size
//    passes; no atomics on device memory, no memset, no state between calls.
//  * At the pipeline's shapes the popcounts take 1 to 4 us, and most of a
//    call's time on the device is the latency of its dependent nodes.
//    Four other ways to combine the blocks were built and measured on an
//    H100 (device time a call at 704x64, 704x1024 with a mask, 704x2112 in
//    three segments with columns, 768x16384 with columns; this version:
//    5.7, 8.7, 14.9, 72 us):
//    atomicMin on key arrays between a memset and a decode kernel, three
//    nodes (8.5-9.3, 11.2-12.5, 13.4-15.2, 57-72 us); one node with a ticket
//    counter for each row and column of blocks and a last-block reduction
//    (6.7, 10.3, 15.1, 64 us, and a zeroed counter array kept between
//    calls); one node of blocks that own their rows and walk the whole
//    database, the columns by a second pass with the sides exchanged (4.0,
//    10.1, 23.5, 130 us: one block of four warps an SM leaves the popcount
//    pipe idle more than half the time); and the same with the blocks of a
//    row joined in a thread block cluster that combines through distributed
//    shared memory (5.7, 11.9, 37.7, 159 us).
//  * The vocabulary's leaf step (row_seg) gives every row its own segment:
//    one warp a row gathers that segment's rows straight from the database
//    (the 64 leaves of the chosen branch: 704 x 64 distances, not
//    704 x 4096), reduces by shuffles and writes the result itself; no
//    second kernel, one launch.
//
// Plain C interface (loaded with ctypes): device pointers and the CUDA
// stream come from the caller, nothing is allocated here, and the first
// CUDA error of the enqueue is returned.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 12;
constexpr int kTQ = 32;   // query rows of a block
constexpr int kTD = 64;   // database rows of a tile
constexpr int kTX = 16;   // threads along the database axis
constexpr int kTY = 8;    // threads along the query axis
constexpr int kPer = 4;   // rows and columns of a thread's register tile
constexpr int kThreads = kTX * kTY;
constexpr int kIdxBits = 23;
constexpr uint32_t kIdxMask = (1u << kIdxBits) - 1u;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr int kRowWarps = 4;  // warps (rows) of a block of the row_seg kernel

__device__ __forceinline__ uint32_t make_key(int v, int index) {
  return (static_cast<uint32_t>(v) << kIdxBits) | static_cast<uint32_t>(index);
}

__device__ __forceinline__ int decode_value(uint32_t key, int fill_inv, int fill_dis,
                                            int fill_inv_out, int fill_dis_out) {
  const int v = static_cast<int>(key >> kIdxBits);
  if (v == fill_inv) return fill_inv_out;
  if (v == fill_dis) return fill_dis_out;
  return v;
}

template <bool kCols>  // also the column argmins
__global__ void __launch_bounds__(kThreads)
hamming_match_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ d,
                     const uint8_t* __restrict__ vq, const uint8_t* __restrict__ vd,
                     const uint8_t* __restrict__ allowed, int allowed_vec4,
                     int nq, int nd, int seg, int n_seg, int tiles_per_seg, int walk,
                     int fill_inv, int fill_dis,
                     uint32_t* __restrict__ row_part, uint32_t* __restrict__ col_part) {
  __shared__ __align__(16) uint32_t qs[kWords][kTQ];
  __shared__ __align__(16) uint32_t ds[kWords][kTD];
  __shared__ uint32_t colk[kTD];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int blocks_per_seg = (tiles_per_seg + walk - 1) / walk;
  const int s = blockIdx.x / blocks_per_seg;
  const int t_lo = (blockIdx.x % blocks_per_seg) * walk;
  const int t_hi = min(t_lo + walk, tiles_per_seg);
  const int q0 = blockIdx.y * kTQ;
  const int seg_lo = s * seg;
  const int seg_hi = seg_lo + seg;

  for (int i = tid; i < kTQ * kWords; i += kThreads) {
    const int row = i / kWords;
    const int w = i % kWords;
    const int gq = q0 + row;
    qs[w][row] = gq < nq ? q[(int64_t)gq * kWords + w] : 0u;
  }

  bool rin[kPer], rval[kPer];
  uint32_t rk[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int gq = q0 + ty * kPer + i;
    rin[i] = gq < nq;
    rval[i] = rin[i] && (vq == nullptr || vq[gq] != 0);
    rk[i] = kEmpty;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int d0 = seg_lo + t * kTD;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kTD * kWords; i += kThreads) {
      const int row = i / kWords;
      const int w = i % kWords;
      const int gd = d0 + row;
      ds[w][row] = gd < seg_hi ? d[(int64_t)gd * kWords + w] : 0u;
    }
    if (kCols && tid < kTD) colk[tid] = kEmpty;
    __syncthreads();

    const int c0 = d0 + tx * kPer;
    bool cin[kPer], cval[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      cin[j] = c0 + j < seg_hi;
      cval[j] = cin[j] && (vd == nullptr || vd[c0 + j] != 0);
    }
    uint32_t amask[kPer];  // byte j of amask[i]: cell (i, j) is allowed
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      amask[i] = 0x01010101u;
      if (allowed != nullptr && rin[i]) {
        const uint8_t* a = allowed + (int64_t)(q0 + ty * kPer + i) * nd + c0;
        if (allowed_vec4 && cin[kPer - 1]) {
          amask[i] = *reinterpret_cast<const uint32_t*>(a);
        } else {
          amask[i] = 0u;
#pragma unroll
          for (int j = 0; j < kPer; ++j)
            if (cin[j] && a[j] != 0) amask[i] |= 1u << (8 * j);
        }
      }
    }

    int acc[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[i][j] = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint4 q4 = *reinterpret_cast<const uint4*>(&qs[w][ty * kPer]);
      const uint4 d4 = *reinterpret_cast<const uint4*>(&ds[w][tx * kPer]);
      const uint32_t qv[kPer] = {q4.x, q4.y, q4.z, q4.w};
      const uint32_t dv[kPer] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] += __popc(qv[i] ^ dv[j]);
    }

    uint32_t ck[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) ck[j] = kEmpty;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int gq = q0 + ty * kPer + i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int v = (rval[i] && cval[j]) ? acc[i][j] : fill_inv;
        if (((amask[i] >> (8 * j)) & 0xFFu) == 0u) v = fill_dis;
        if (rin[i] && cin[j]) {
          rk[i] = min(rk[i], make_key(v, c0 + j));
          if (kCols) ck[j] = min(ck[j], make_key(v, gq));
        }
      }
    }

    if (kCols) {
      // the warp's two rows of threads, then the block's four warps
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        ck[j] = min(ck[j], __shfl_xor_sync(0xFFFFFFFFu, ck[j], kTX));
        if ((ty & 1) == 0 && ck[j] != kEmpty) atomicMin(&colk[tx * kPer + j], ck[j]);
      }
      __syncthreads();
      if (tid < kTD && d0 + tid < seg_hi)
        col_part[(int64_t)blockIdx.y * nd + d0 + tid] = colk[tid];
    }
  }

  // the 16 threads of a row of the block hold the row's partial minima
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    uint32_t r = rk[i];
#pragma unroll
    for (int o = kTX / 2; o > 0; o >>= 1) r = min(r, __shfl_xor_sync(0xFFFFFFFFu, r, o));
    if (tx == 0 && rin[i])
      row_part[(int64_t)(q0 + ty * kPer + i) * gridDim.x + blockIdx.x] = r;
  }
}

// row_part holds, for each of the n_row (row, segment) pairs, the keys of the
// `per_row` blocks that walked the segment; col_part, for each of the n_col
// columns, those of the `per_col` rows of blocks, n_col apart.
__global__ void hamming_match_reduce_kernel(const uint32_t* __restrict__ row_part, int n_row,
                                            int per_row, const uint32_t* __restrict__ col_part,
                                            int n_col, int per_col, int fill_inv, int fill_dis,
                                            int fill_inv_out, int fill_dis_out,
                                            int32_t* __restrict__ row_min,
                                            int64_t* __restrict__ row_arg,
                                            int64_t* __restrict__ col_arg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t key = kEmpty;
  if (i < n_row) {
    const uint32_t* part = row_part + (int64_t)i * per_row;
    for (int b = 0; b < per_row; ++b) key = min(key, part[b]);
    row_min[i] = decode_value(key, fill_inv, fill_dis, fill_inv_out, fill_dis_out);
    row_arg[i] = static_cast<int64_t>(key & kIdxMask);
  } else if (i < n_row + n_col) {
    const uint32_t* part = col_part + (i - n_row);
    for (int y = 0; y < per_col; ++y) key = min(key, part[(int64_t)y * n_col]);
    col_arg[i - n_row] = static_cast<int64_t>(key & kIdxMask);
  }
}

// One warp a query row; the row looks only at database segment row_seg[row]
// (clamped to the segments there are) and gathers its rows directly.
__global__ void __launch_bounds__(32 * kRowWarps)
hamming_match_rowseg_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ d,
                            const uint8_t* __restrict__ vq, const uint8_t* __restrict__ vd,
                            const int32_t* __restrict__ row_seg, int nq, int seg, int n_seg,
                            int fill_inv, int fill_inv_out, int32_t* __restrict__ row_min,
                            int64_t* __restrict__ row_arg) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= nq) return;  // the whole warp leaves
  const int s = min(max(row_seg[row], 0), n_seg - 1);
  const bool rvalid = vq == nullptr || vq[row] != 0;
  uint32_t qw[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) qw[w] = q[(int64_t)row * kWords + w];

  uint32_t key = kEmpty;
  for (int c = lane; c < seg; c += 32) {
    const int gd = s * seg + c;
    const uint32_t* dr = d + (int64_t)gd * kWords;
    int v = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) v += __popc(qw[w] ^ dr[w]);
    if (!(rvalid && (vd == nullptr || vd[gd] != 0))) v = fill_inv;
    key = min(key, make_key(v, gd));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) key = min(key, __shfl_xor_sync(0xFFFFFFFFu, key, o));
  if (lane == 0) {
    row_min[row] = decode_value(key, fill_inv, -1, fill_inv_out, -1);
    row_arg[row] = static_cast<int64_t>(key & kIdxMask);
  }
}

}  // namespace

// q (nq, 12), d (nd, 12) words; vq, vd validity bytes or null (all valid);
// allowed (nq, nd) bytes or null; row_seg (nq,) int32 or null.  nd is a
// multiple of seg.  fill_inv / fill_dis are the 9-bit values used in the
// keys, *_out what the minima report for them.  row_min int32 and row_arg
// int64 are (nq, nd / seg), or (nq,) with row_seg; col_arg int64 (nd,) or
// null.  A block walks `walk` tiles of 64 database rows, so without row_seg
// the grid is gx x gy blocks,
//     gx = (nd / seg) * ceil(ceil(seg / 64) / walk),  gy = ceil(nq / 32),
// and scratch must hold nq * gx words, and gy * nd more where col_arg is
// given; `scratch_words` says what it holds.
extern "C" int okvis_hamming_match(const void* q, const void* d, const void* vq, const void* vd,
                                   const void* allowed, const void* row_seg, int nq, int nd,
                                   int seg, int walk, int fill_inv, int fill_dis,
                                   int fill_inv_out, int fill_dis_out, void* scratch,
                                   long long scratch_words, void* row_min, void* row_arg,
                                   void* col_arg, void* stream) {
  if (nq <= 0 || nd <= 0 || seg <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_seg = nd / seg;
  const auto* qp = static_cast<const uint32_t*>(q);
  const auto* dp = static_cast<const uint32_t*>(d);
  const auto* vqp = static_cast<const uint8_t*>(vq);
  const auto* vdp = static_cast<const uint8_t*>(vd);
  const auto* ap = static_cast<const uint8_t*>(allowed);

  if (row_seg != nullptr) {
    hamming_match_rowseg_kernel<<<(nq + kRowWarps - 1) / kRowWarps, 32 * kRowWarps, 0, st>>>(
        qp, dp, vqp, vdp, static_cast<const int32_t*>(row_seg), nq, seg, n_seg, fill_inv,
        fill_inv_out, static_cast<int32_t*>(row_min), static_cast<int64_t*>(row_arg));
    return static_cast<int>(cudaGetLastError());
  }

  // a thread's four mask bytes of a row are one aligned word
  const int vec4 = ap != nullptr && reinterpret_cast<uintptr_t>(ap) % 4 == 0 && nd % 4 == 0 &&
                   seg % 4 == 0;
  const int tiles_per_seg = (seg + kTD - 1) / kTD;
  if (walk < 1) walk = 1;
  const int blocks_per_seg = (tiles_per_seg + walk - 1) / walk;
  const dim3 block(kTX, kTY);
  const dim3 grid(n_seg * blocks_per_seg, (nq + kTQ - 1) / kTQ);
  const int n_row = nq * n_seg;
  const int n_col = col_arg != nullptr ? nd : 0;
  const long long row_words = (long long)nq * grid.x;
  if (scratch_words < row_words + (long long)grid.y * n_col) return cudaErrorInvalidValue;
  auto* row_part = static_cast<uint32_t*>(scratch);
  auto* col_part = n_col ? row_part + row_words : nullptr;

  auto* kernel = n_col ? hamming_match_kernel<true> : hamming_match_kernel<false>;
  kernel<<<grid, block, 0, st>>>(qp, dp, vqp, vdp, ap, vec4, nq, nd, seg, n_seg, tiles_per_seg,
                                 walk, fill_inv, fill_dis, row_part, col_part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n = n_row + n_col;
  hamming_match_reduce_kernel<<<(n + 127) / 128, 128, 0, st>>>(
      row_part, n_row, blocks_per_seg, col_part, n_col, grid.y, fill_inv, fill_dis, fill_inv_out,
      fill_dis_out, static_cast<int32_t*>(row_min), static_cast<int64_t*>(row_arg),
      static_cast<int64_t*>(col_arg));
  return static_cast<int>(cudaGetLastError());
}
