// Hand-written Hopper (sm_90a) kernels of the tuned symmetric fp32 SpMV
// path: the CUDA counterparts of the Pallas kernels that path reaches.
//
// Plain C interface (no PyTorch headers), compiled by nvcc into a shared
// library and loaded with ctypes by cfs_spmv_tpu_torch/ops/_cuda.py. Every
// entry point launches on the stream it is given, allocates nothing (the
// Python wrapper allocates with torch.empty), does not synchronise, and
// returns cudaGetLastError() so a refused launch surfaces at once.
//
// Shared layout (see cfs_spmv_tpu/formats/bell2.py): a chunk is an (8, 128)
// slot grid; lane j of chunk c holds entries of row tile
// step_block[c / K] * BT + meta[c, 0]; x is read as (x_rows, 128) tiles.
//
// All three kernels move little data per operation (one multiply-add per
// 4-byte value plus its index bytes), so each is bound by device-memory
// bytes, not arithmetic. Their designs keep loads coalesced along the 128
// lanes and leave reuse of re-read bytes to the 50 MB L2; tiling through
// shared memory is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kSublanes = 8;
constexpr int kBlockRows = kSublanes * kLanes;  // rows per SDIA value block
constexpr int kMetaW = 2 + kSublanes;           // [sub, nwin, win0..win7]

// ---------------------------------------------------------------------------
// sdia_sym — replaces cfs_spmv_tpu/ops/sdia_kernel.py:sdia_sym_tiles.
//
// y += (L + L^T) x over D dense strict-lower diagonals with offsets d_j >= 1.
// vals[r, j, i, l] = A[g, g - d_j] at g = 1024 r + 128 i + l, so the value of
// diagonal j at row g sits at vals[(g >> 10) * D * 1024 + j * 1024 + (g & 1023)].
//
// Gather form, no atomics: one thread per output row g sums the row side
// v_j[g] * x[g - d_j] and the transpose side v_j[g + d_j] * x[g + d_j]. The
// TPU kernel reads each value once and scatters its transpose product with
// lane rolls; here each value is read twice (once by row g, once by row
// g - d_j). Neighbouring threads read neighbouring values and x entries, so
// both reads coalesce, and for the small offsets of banded matrices the
// second read of a value usually hits L2. Reading each value once (a
// shared-memory tile of 1024 + max d rows) is later work.
// ---------------------------------------------------------------------------
__global__ void sdia_sym_kernel(const float* __restrict__ vals,
                                const int* __restrict__ offsets, int D,
                                int64_t n_vals_rows,
                                const float* __restrict__ x, int64_t x_len,
                                float* __restrict__ y, int64_t y_len) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= y_len) return;
  const bool own = g < n_vals_rows;
  float acc = 0.0f;
  for (int j = 0; j < D; ++j) {
    const int64_t d = offsets[j];
    const int64_t s = g - d;
    if (own && s >= 0 && s < x_len) {
      const int64_t vi = ((g >> 10) * D + j) * kBlockRows + (g & (kBlockRows - 1));
      acc = fmaf(vals[vi], x[s], acc);
    }
    const int64_t h = g + d;
    if (h < n_vals_rows && h < x_len) {
      const int64_t vi = ((h >> 10) * D + j) * kBlockRows + (h & (kBlockRows - 1));
      acc = fmaf(vals[vi], x[h], acc);
    }
  }
  y[g] += acc;
}

// ---------------------------------------------------------------------------
// bell2_spmv — replaces cfs_spmv_tpu/ops/bell2_kernel.py:bell2_spmv_tiles
// (zero_blocks = 1) and bell2_spmv_tiles_accum (zero_blocks = 0).
//
// Slot (i, j) of chunk c holds q = pk & 0x7F in bits 0-6; the window index r2
// serving gather lane q of sublane i sits in bits 7-11 of the packed word AT
// lane q. The x row is meta[c, 2] + r2 for contiguous or deep windows, and
// meta[c, 2 + (r2 & 7)] for listed windows. The 8 sublanes sum into row
// meta[c, 0] of block step_block[c / K].
//
// One CTA of 128 threads (one per lane) walks kChunksPerCta consecutive
// chunks: the TPU walks a K-chunk grid step in order on one core, but a
// K = 128 step count (63 steps for the audikw proxy) would leave most of
// the 132 SMs idle, so each step is split across K / 8 CTAs. The chunk's
// r2 fields go through shared memory (a lane needs lane q's field). Each
// thread keeps a register sum while the target row stays the same and
// flushes it with one atomicAdd when the row changes: blocks of different
// CTAs (and different grid steps) can target one row. Chunks are
// tile-sorted, so flushes are rare. K-padding chunks carry zero values and
// forward-filled meta, so they add exactly 0.
// ---------------------------------------------------------------------------
constexpr int kChunksPerCta = 8;

// Zeroes each output block the stream visits, once: step_block ascends, so
// a block starts where the step's block differs from the previous step's.
// Unvisited blocks are left as they are (the TPU kernel leaves them unset).
__global__ void bell2_zero_blocks_kernel(const int* __restrict__ step_block,
                                         int BT, float* __restrict__ y) {
  const int g = blockIdx.x;
  if (g > 0 && step_block[g] == step_block[g - 1]) return;
  float4* base = reinterpret_cast<float4*>(
      y + static_cast<int64_t>(step_block[g]) * BT * kLanes);
  const int n4 = BT * kLanes / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    base[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <bool kContig>
__global__ void __launch_bounds__(kLanes)
bell2_spmv_kernel(const float* __restrict__ vals,
                  const int16_t* __restrict__ packed,
                  const int* __restrict__ meta,
                  const int* __restrict__ step_block, int64_t C, int K,
                  int BT, const float* __restrict__ x,
                  float* __restrict__ y) {
  __shared__ int r2s[kSublanes][kLanes];
  const int lane = threadIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kChunksPerCta;
  const int64_t c1 = c0 + kChunksPerCta < C ? c0 + kChunksPerCta : C;
  int64_t row = -1;  // y tile row of the running sum
  float acc = 0.0f;
  for (int64_t c = c0; c < c1; ++c) {
    const int* m = meta + c * kMetaW;
    const int64_t tgt = static_cast<int64_t>(step_block[c / K]) * BT + m[0];
    const int64_t slot0 = c * kSublanes * kLanes + lane;
    int pk[kSublanes];
#pragma unroll
    for (int i = 0; i < kSublanes; ++i) {
      pk[i] = packed[slot0 + i * kLanes];
      r2s[i][lane] = (pk[i] >> 7) & 0x1F;
    }
    __syncthreads();
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < kSublanes; ++i) {
      const int q = pk[i] & 0x7F;
      const int r2 = r2s[i][q];
      const int xrow = kContig ? m[2] + r2 : m[2 + (r2 & 7)];
      part = fmaf(vals[slot0 + i * kLanes],
                  x[static_cast<int64_t>(xrow) * kLanes + q], part);
    }
    __syncthreads();
    if (tgt != row) {
      if (row >= 0) atomicAdd(y + row * kLanes + lane, acc);
      row = tgt;
      acc = 0.0f;
    }
    acc += part;
  }
  if (row >= 0) atomicAdd(y + row * kLanes + lane, acc);
}

// ---------------------------------------------------------------------------
// unperm_gather — replaces cfs_spmv_tpu/ops/bell2_kernel.py:unperm_gather_tiles.
//
// Original-order y from a degree-grouped stream's compact tiles: output row
// o reads pk = pk2d[o]; pk < 0 writes exact 0, otherwise the value
// g[rows[o >> 10, pk >> 7], pk & 127]. One thread per output element: the
// pk and output accesses coalesce; the gathered reads land in the few
// tile rows each 1024-row block draws from (at most 16), which stay in L2.
// ---------------------------------------------------------------------------
__global__ void unperm_gather_kernel(const int* __restrict__ pk,
                                     const int* __restrict__ rows, int W,
                                     const float* __restrict__ g,
                                     float* __restrict__ out, int64_t n_out) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  const int p = pk[o];
  float v = 0.0f;
  if (p >= 0) {
    const int64_t tile = rows[(o >> 10) * W + (p >> 7)];
    v = g[tile * kLanes + (p & 0x7F)];
  }
  out[o] = v;
}

inline unsigned int blocks_for(int64_t n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

int cfs_sdia_sym(const float* vals, const int* offsets, int D,
                 int64_t n_vals_rows, const float* x, int64_t x_len,
                 float* y, int64_t y_len, cudaStream_t stream) {
  if (y_len > 0 && D > 0) {
    constexpr int kThreads = 256;
    sdia_sym_kernel<<<blocks_for(y_len, kThreads), kThreads, 0, stream>>>(
        vals, offsets, D, n_vals_rows, x, x_len, y, y_len);
  }
  return static_cast<int>(cudaGetLastError());
}

int cfs_bell2_spmv(const float* vals, const int16_t* packed, const int* meta,
                   const int* step_block, int64_t C, int K, int BT,
                   int contig, int zero_blocks, const float* x, float* y,
                   cudaStream_t stream) {
  if (C > 0) {
    const int64_t G = C / K;
    if (zero_blocks)
      bell2_zero_blocks_kernel<<<static_cast<unsigned int>(G), 256, 0, stream>>>(
          step_block, BT, y);
    const unsigned int grid = blocks_for(C, kChunksPerCta);
    if (contig)
      bell2_spmv_kernel<true><<<grid, kLanes, 0, stream>>>(
          vals, packed, meta, step_block, C, K, BT, x, y);
    else
      bell2_spmv_kernel<false><<<grid, kLanes, 0, stream>>>(
          vals, packed, meta, step_block, C, K, BT, x, y);
  }
  return static_cast<int>(cudaGetLastError());
}

int cfs_unperm_gather(const int* pk, const int* rows, int W, const float* g,
                      float* out, int64_t n_out, cudaStream_t stream) {
  if (n_out > 0) {
    constexpr int kThreads = 256;
    unperm_gather_kernel<<<blocks_for(n_out, kThreads), kThreads, 0, stream>>>(
        pk, rows, W, g, out, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cfs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
