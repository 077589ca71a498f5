// Hand-written Hopper (sm_90a) kernels of the SpMV and SpMM paths: fp32
// (the tuned symmetric path, its paired stream and the general path) and
// IEEE fp64 (the symmetric dense-diagonal stream and the one-sided stream
// of the float64 route): the CUDA counterparts of the Pallas kernels those
// paths reach.
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
// All kernels move little data per operation (one multiply-add per 4- or
// 8-byte value plus its index bytes), so each is bound by device-memory
// bytes, not arithmetic. Their designs keep loads coalesced along the 128
// lanes and leave reuse of re-read bytes to the 50 MB L2; sbell_spmv
// stages the x tiles of a chunk in shared memory, sdia_sym over planes the
// x rows of a CTA, and the float multi-RHS bell2_spmv and sdia_gen read an
// interleaved X, one 32-byte sector an element for 8 planes.
//
// Right-hand-side groups (SpMM, the Pallas *_mm kernels). Each stream
// kernel is a template on kRhs, the number of right-hand sides one pass
// over the stream serves: a thread loads a value and its index fields
// once and applies them to up to kRhs planes, holding one sum per plane in
// registers. X is a stack of (x_rows, 128) planes (for the float
// multi-RHS bell2_spmv and sdia_gen an interleaved X) and Y of (T, 128)
// planes, each plane contiguous, at plane strides xs and ys (elements);
// sdia_sym_rows reads X and writes Y as the caller's row-major (n, B).
// The Python wrapper launches once per group of at most kMaxRhs planes,
// so the stream (values and index words) is read once per group, not once
// per right-hand side; nr is the group's plane count, and the launch takes
// the smallest instance of 1, 2, 4 or 8 that holds it (planes >= nr are
// skipped). The SpMV entry points are the nr = 1 case.
//
// Sum type and value type. The five stream kernels are also templates on
// the type T of x, y and the sums: float, or double for the float64 route
// (sdia_sym, bell2_spmv, bell2_entries) and for the float64 distributed
// operator (sdia_gen, sbell_spmv: its mirrored diagonals and paired shards,
// parallel/dist.py). All five stream kernels are templates on the storage type
// V of the stream's values as well, V = T by default: with T = float, V may
// be __nv_bfloat16 (``values="bfloat16"``, the reference's
// tuning/tune.py:_cast_values), which halves the value bytes. A value is
// widened to T as it is loaded (exactly: every bf16 is a float) and the
// products and sums run in T as before, which is what the reference
// computes (a bf16 value times an f32 x, promoted to f32, summed in f32).
// The bf16 entry points end in _bf16; x and y stay float. Half the value
// bytes shortens what bytes bound (the one-sided grid stream of B2/B7, the
// signed diagonals over planes of B12) and leaves what chains of
// dependent loads or a launch's fixed cost bound (B1, B4, B5, and B6 at one
// plane, whose load count is the same): PERF.md §6 has the times. The TPU has no 64-bit lanes, so the reference's float64 kernels
// (sdia_df.py, bell2_df.py) carry every value, x and sum as an fp32 (hi, lo)
// pair with error-free transforms; what they compute is y = A x in double,
// and the double instances here compute that with fp64 FMA and
// atomicAdd(double*). The reference's distributed operator runs its fp32
// Pallas kernels on float64 arrays (interpreted on the CPU); the double
// instances of sdia_gen and sbell_spmv compute that in native IEEE double,
// not as double-float pairs.

#include <atomic>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kSublanes = 8;
constexpr int kBlockRows = kSublanes * kLanes;  // rows per SDIA value block
constexpr int kMetaW = 2 + kSublanes;           // [sub, nwin, win0..win7]
constexpr int kMaxRhs = 8;                      // planes per launch, at most

// Plane b of a group of nr (the test folds away for kRhs = 1).
template <int kRhs>
__device__ __forceinline__ bool live(int b, int nr) {
  return kRhs == 1 || b < nr;
}

// A stored value in the sum type: bf16 widens exactly, float and double
// are themselves.
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

// a * b + c in one rounding, in the operands' type.
__device__ __forceinline__ float mul_add(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double mul_add(double a, double b, double c) {
  return fma(a, b, c);
}

// The kRhs planes of one interleaved x element (kRhs floats, aligned to
// their size): 8- or 16-byte loads.
template <int kRhs>
__device__ __forceinline__ void load_group(const float* p, float (&v)[kRhs]) {
  static_assert(kRhs == 2 || kRhs == 4 || kRhs == 8, "a group of planes");
  if constexpr (kRhs == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x, v[1] = a.y;
  } else {
#pragma unroll
    for (int k = 0; k < kRhs / 4; ++k) {
      const float4 a = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = a.x, v[4 * k + 1] = a.y, v[4 * k + 2] = a.z;
      v[4 * k + 3] = a.w;
    }
  }
}

// The same for doubles: 16-byte loads (double2), one to four of them;
// sm_90 has no 32-byte vector load.
template <int kRhs>
__device__ __forceinline__ void load_group(const double* p,
                                           double (&v)[kRhs]) {
  static_assert(kRhs == 2 || kRhs == 4 || kRhs == 8, "a group of planes");
#pragma unroll
  for (int k = 0; k < kRhs / 2; ++k) {
    const double2 a = reinterpret_cast<const double2*>(p)[k];
    v[2 * k] = a.x, v[2 * k + 1] = a.y;
  }
}

// ---------------------------------------------------------------------------
// sdia_sym — replaces cfs_spmv_tpu/ops/sdia_kernel.py:sdia_sym_tiles
// (kernel B1) and, over planes, sdia_sym_tiles_mm (B11); with T = double,
// cfs_spmv_tpu/ops/sdia_df.py:sdia_sym_tiles_df (B13) and
// sdia_sym_tiles_df_mm (B14).
//
// y += (L + L^T) x over D dense lower diagonals with offsets d_j >= 0: all
// >= 1 on the fp32 path; the float64 route also stores the main diagonal
// (d = 0) with its values halved, so that the row side and the transpose
// side, which then both land on row g, sum to the full term.
// vals[r, j, i, l] = A[g, g - d_j] at g = 1024 r + 128 i + l, so the value of
// diagonal j at row g sits at vals[(g >> 10) * D * 1024 + j * 1024 + (g & 1023)].
//
// What bounds it on this card. The stream moves 4 bytes (8 in double) a
// stored value and no index, and cant-sized planes (8-17 MB) stay in the
// 50 MB L2 across calls, so the time follows the chains of dependent loads
// (offset, then value and x) and how many of them the card keeps in flight,
// and over planes the count of x loads (2 D kRhs a row), not bytes. The
// form before this one ran one thread per output row in CTAs of 256: on
// cant_proxy() (62,464 rows, 32 diagonals) 244 CTAs, under a quarter of the
// card's thread slots, each thread walking all D diagonals one L2 round
// trip after another.
//
// What the design does about it. A CTA of kSdiaRows * kSdiaSlices threads
// takes kSdiaRows consecutive rows h (one value block); thread (r, s) takes
// row h = r0 + r and the diagonals j = s, s + kSdiaSlices, ... of its
// slice, kUnroll of them a step with their loads issued together: twice
// the threads of the form before, each with half a row's chain of loads.
// Warps run along rows, so every value and x load coalesces. Each row sums
// its row side v_j[h] x[h - d_j] and gathers its transpose side v_j[h +
// d_j] x[h + d_j], reading that value a second time; the slices' sums meet
// in shared memory and the CTA adds each output row once, no atomics.
// Over planes, given stage (the upload's ``dia_stage_x``: at least half the
// offsets within kSdiaHalo, as on cant and the flagship, decided once from
// the offsets), the CTA first stages the x rows within kSdiaHalo of its own
// for every plane in shared memory, and those offsets read x there; offsets
// past it (stencil27's 1,559-1,641) read x from global memory. Measured
// beside it and slower (SDIA_SYM_ALT_SRC of chip_smoke.py, PERF.md §6): 1,
// 4 and 8 slices; scattering the transpose products of offsets up to
// kSdiaHalo into a shared y tile with its halo, which reads each value once
// but adds kRhs shared atomics a value; staging x at one plane, and at 8
// planes where most offsets are far.
// ---------------------------------------------------------------------------
constexpr int kSdiaRows = 128, kSdiaSlices = 2;
constexpr int kSdiaHalo = 64;

template <typename T, int kRhs, typename V = T>
__global__ void sdia_sym_kernel(const V* __restrict__ vals,
                                const int* __restrict__ offsets, int D,
                                int64_t n_vals_rows,
                                const T* __restrict__ x, int64_t x_len,
                                int64_t xs, T* __restrict__ y, int64_t y_len,
                                int64_t ys, int nr, bool stage) {
  constexpr int kThreads = kSdiaRows * kSdiaSlices;
  constexpr int kUnroll = kRhs == 1 ? 4 : 2;
  constexpr bool kMayStage = kRhs > 1;
  constexpr int kXSpan = kMayStage ? kSdiaRows + 2 * kSdiaHalo : 1;
  __shared__ T sums[kSdiaSlices][kRhs][kSdiaRows];
  // x[r0 - kSdiaHalo, r0 + kSdiaRows + kSdiaHalo) of each plane
  __shared__ T xsh[kMayStage ? kRhs : 1][kXSpan];
  const int tid = threadIdx.x;
  const int r = tid % kSdiaRows, s = tid / kSdiaRows;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kSdiaRows;
  const int64_t h = r0 + r;
  const bool hv = h < n_vals_rows;
  const V* vh = vals + (h >> 10) * D * kBlockRows + (h & (kBlockRows - 1));
  stage = kMayStage && stage;
  if constexpr (kMayStage) {
    if (stage) {
      for (int i = tid; i < kRhs * kXSpan; i += kThreads) {
        const int b = i / kXSpan, k = i % kXSpan;
        const int64_t gx = r0 - kSdiaHalo + k;
        xsh[b][k] = live<kRhs>(b, nr) && gx >= 0 && gx < x_len
                        ? x[b * xs + gx] : T(0);
      }
      __syncthreads();
    }
  }
  T acc[kRhs];
#pragma unroll
  for (int b = 0; b < kRhs; ++b) acc[b] = T(0);
  for (int j0 = s; j0 < D; j0 += kSdiaSlices * kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kSdiaSlices;
      if (j >= D) break;
      const int64_t d = offsets[j];
      const bool staged = stage && d <= kSdiaHalo;
      const T v = hv ? widen(vh[static_cast<int64_t>(j) * kBlockRows]) : T(0);
      if (staged) {  // xsh holds zeros outside [0, x_len)
#pragma unroll
        for (int b = 0; b < kRhs; ++b)
          if (live<kRhs>(b, nr))
            acc[b] = mul_add(v, xsh[b][kSdiaHalo + r - d], acc[b]);
      } else if (hv && h - d >= 0 && h - d < x_len) {
#pragma unroll
        for (int b = 0; b < kRhs; ++b)
          if (live<kRhs>(b, nr))
            acc[b] = mul_add(v, x[b * xs + h - d], acc[b]);
      }
      const int64_t t = h + d;
      if (t < n_vals_rows && t < x_len) {
        const T w = widen(
            vals[((t >> 10) * D + j) * kBlockRows + (t & (kBlockRows - 1))]);
#pragma unroll
        for (int b = 0; b < kRhs; ++b)
          if (live<kRhs>(b, nr))
            acc[b] = mul_add(
                w, staged ? xsh[b][kSdiaHalo + r + d] : x[b * xs + t], acc[b]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kRhs; ++b) sums[s][b][r] = acc[b];
  __syncthreads();
  for (int i = tid; i < kRhs * kSdiaRows; i += kThreads) {
    const int b = i / kSdiaRows, k = i % kSdiaRows;
    const int64_t g = r0 + k;
    if (!live<kRhs>(b, nr) || g >= y_len) continue;
    T sum = sums[0][b][k];
#pragma unroll
    for (int t = 1; t < kSdiaSlices; ++t) sum += sums[t][b][k];
    y[b * ys + g] += sum;
  }
}

// ---------------------------------------------------------------------------
// sdia_sym_rows — B14 (cfs_spmv_tpu/ops/sdia_df.py:222 sdia_sym_tiles_df_mm)
// over X and Y in the caller's row-major (n, B) layout, for a float64 plan
// that is diagonals only (HPCG's 27-point stencil: 14 lower diagonals). A
// launch serves a group of kRhs = 2, 4 or 8 columns, read at row stride ld,
// and stores (does not add) those columns of Y's rows at the same stride:
// no planes, no zero pass, no read of Y.
//
// y[g] = sum_j v_j[g] x[g - d_j] + v_j[g + d_j] x[g + d_j] over the stored
// lower diagonals in order, the offset-0 plane holding the halved main
// diagonal, in float64 with fma; x outside [0, n) is not read (it adds 0).
//
// What bounds it on this card. The stream is 4.01 GB an apply at B = 8 on
// HPCG at 256^3 (1.88 GB of values, X and Y 1.07 GB each: 1.198 ms at
// 3.35 TB/s), 37x the L2; the transpose side reads each value a second
// time, up to 65,793 rows after its row side, and x rows up to 65,793 rows
// either side. B14 over planes took 3.91 ms, and its applier 3.8 ms more
// to copy X into padded planes and zero the output (PERF.md §5).
//
// What the design does about it. One thread a row, CTAs of kRowsCta
// rows; each thread walks every diagonal of its row, two at a time with
// their loads issued together, and reads x's rows where they lie: 16 bytes
// a load, a row's chunks from the lane's rotation on (chunk_rot), so that
// the 8 lanes of a quarter warp on 8 consecutive rows of 64 bytes hit 8
// distinct bank groups of L1, which serves the re-reads of neighbouring
// offsets (1 apart in a cluster). No shared memory, so nothing caps the
// CTAs an SM holds but registers. Each thread stores its row's columns.
// Device ms of one launch at hpcg-256's shape, B = 8, event-timed in one
// run (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): 2.39-2.42. Measured
// beside it and slower: x staged in shared memory first, once a CTA, one
// window per cluster of offsets and side (9 windows of 130 rows on HPCG,
// 75 KB at 8 columns), by cp.async.bulk on an mbarrier 3.64-3.66 (3.93 at
// 64 rows a CTA, 5.39 at 256), by the threads' 16-byte loads row by row
// 4.71-4.72, plane by plane as sdia_gen_staged_kernel does 5.13-5.15; a
// thread a 16-byte chunk, four a row, each warp load contiguous 2.92-3.66;
// two threads a row whose sums meet in shared memory 2.44-2.59 (64 rows),
// 2.51-2.76 (128 rows). The staged windows hold about nine times a CTA's
// own rows of x, which leaves 3 CTAs an SM at 128 rows, each idle until
// its windows have landed (a reading of the numbers, not a measurement).
// ---------------------------------------------------------------------------
constexpr int kRowsCta = 128;

// The 16-byte chunk a lane reads first of a row of kChunks: lanes on 8
// consecutive rows of one quarter warp start at distinct bank groups where
// a row spans less than the 128 bytes of a bank row.
template <int kChunks>
__device__ __forceinline__ int chunk_rot(int lane) {
  return kChunks == 1 ? 0 : (lane / (8 / kChunks)) % kChunks;
}

// acc += v * row over a row of X's kRhs columns (16-byte aligned), its
// chunks read from the lane's rotation on: acc slot 2k + i holds column
// 2c + i of chunk c = (k + rot) % kChunks; chunks past nr columns are not
// read (they may lie past X).
template <int kRhs>
__device__ __forceinline__ void add_row(double (&acc)[kRhs], double v,
                                        const double* row, int rot, int nr) {
  constexpr int kChunks = kRhs / 2;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = (k + rot) & (kChunks - 1);
    if (2 * c >= nr) continue;
    const double2 xv = reinterpret_cast<const double2*>(row)[c];
    acc[2 * k] = fma(v, xv.x, acc[2 * k]);
    acc[2 * k + 1] = fma(v, xv.y, acc[2 * k + 1]);
  }
}

// x: the group's first column of X, y of Y, rows at stride ld (elements),
// 16-byte aligned; nr of the kRhs columns live.
template <int kRhs>
__global__ void __launch_bounds__(kRowsCta)
sdia_sym_rows_kernel(const double* __restrict__ vals,
                     const int* __restrict__ offsets, int D,
                     int64_t n_vals_rows, int64_t n, int64_t ld,
                     const double* __restrict__ x, double* __restrict__ y,
                     int nr) {
  static_assert(kRhs == 2 || kRhs == 4 || kRhs == 8, "a group of columns");
  constexpr int kChunks = kRhs / 2;
  constexpr int kUnroll = 2;
  const int64_t h = static_cast<int64_t>(blockIdx.x) * kRowsCta + threadIdx.x;
  if (h >= n) return;
  const int rot = chunk_rot<kChunks>(threadIdx.x & 31);
  const bool hv = h < n_vals_rows;
  const double* vh = vals + (h >> 10) * D * kBlockRows + (h & (kBlockRows - 1));
  double acc[kRhs];
#pragma unroll
  for (int b = 0; b < kRhs; ++b) acc[b] = 0.0;
  for (int j0 = 0; j0 < D; j0 += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u;
      if (j >= D) break;
      const int64_t d = __ldg(offsets + j);
      const int64_t t = h + d;
      const double v = hv ? vh[static_cast<int64_t>(j) * kBlockRows] : 0.0;
      const double w =
          t < n_vals_rows
              ? vals[((t >> 10) * D + j) * kBlockRows + (t & (kBlockRows - 1))]
              : 0.0;
      if (h - d >= 0) add_row(acc, v, x + (h - d) * ld, rot, nr);  // row
      if (t < n) add_row(acc, w, x + t * ld, rot, nr);  // transpose side
    }
  }
  double2* yr = reinterpret_cast<double2*>(y + h * ld);
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = (k + rot) & (kChunks - 1);
    if (2 * c < nr) yr[c] = make_double2(acc[2 * k], acc[2 * k + 1]);
  }
}

// ---------------------------------------------------------------------------
// sdia_gen — replaces cfs_spmv_tpu/ops/sdia_kernel.py:sdia_gen_tiles (B6)
// and, over planes, sdia_gen_tiles_mm (B12).
//
// y += A_dia x over D dense diagonals with SIGNED offsets d_j (d > 0 reads
// behind, d < 0 ahead, d = 0 the main diagonal), row side only: row g sums
// v_j[g] * x[g - d_j], reading zero where g - d_j falls outside x. Same
// value layout as sdia_sym; mirrored symmetric plans carry their transpose
// planes host-shifted, so the kernel does no mirroring. Rows of y below
// nv_rows = R * 1024 get the sum; rows past it keep their value, as in the
// reference. The store form (kStore, for an applier that would otherwise
// pass zeroed tiles) writes y instead of adding to it, and writes exact 0
// into the rows past nv_rows, so no zero pass runs and y is not read.
//
// What bounds it on this card. Each value is read once per group of
// planes, coalesced along g, so at one plane the kernel runs at the memory
// rate (B6 on general_asym(), 0.0060 ms against a bound of 0.0061). Over
// planes the form before this one gathered x from each plane: kRhs 4-byte
// loads a diagonal and row, each its own sector, so the count of x loads
// and sectors bounded it (B12 at 8 planes 0.0399 ms against 0.0190 on
// general_asym()), as it bounded sdia_sym and bell2_spmv over planes. On
// the narrow plans (62-65k rows: cant_proxy() mirrored, 64 diagonals; the
// flagship as CSR, 33) one thread per row also left most of the card's
// thread slots empty, each thread walking all D diagonals.
//
// What the design does about it.
// - Over planes x is read interleaved, as bell2_spmv reads it: a group's
//   2, 4 or 8 planes of an element side by side (bell2_kernel.interleave_x;
//   one plane is the plane), so a diagonal costs one or two vector loads a
//   row, one 32-byte sector for 8 planes. A contiguous (m, B) X with B of
//   1, 2, 4 or 8 is that layout already, and the wrappers pass it in place
//   with x_len = m: the bound check reads the zeros past m that the planes
//   copy used to write.
// - kSlices threads share a row, each taking every kSlices-th diagonal;
//   their sums meet in shared memory and one thread adds each output
//   element, no atomics. The wrapper picks the count from the rows and D
//   (sdia_kernel.gen_slices): 2 where two threads a row still fit the
//   card's thread slots at once (the narrow plans), else 1
//   (general_asym()). A CTA is kGenThreads threads, 256 / kSlices rows.
// The double instance (T = double, the float64 distributed operator's
// mirrored diagonals) reads an interleaved X of doubles in 16-byte loads
// (two per 4 planes), otherwise the same; where the plan's offsets span
// little, sdia_gen_staged_kernel below runs in its place, and this one is
// its form of comparison in chip_smoke.py.
// The one-plane, one-slice instance is B6's code as it was. At 8 planes on
// general_asym() the kernel takes 0.0204 ms storing and 0.0272 adding
// (bounds 0.0141 and 0.0190); on mirrored cant_proxy() 2 slices take
// 0.0127 where 1 took 0.0167 and 4 0.0133 (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md §6). Measured beside it and not faster (SDIA_GEN_ALT_SRC of
// chip_smoke.py): 4 slices, and issuing the loads of two diagonals
// together.
// ---------------------------------------------------------------------------
constexpr int kGenThreads = 256;

template <int kRhs, int kSlices, bool kStore, typename T = float,
          typename V = T>
__global__ void sdia_gen_kernel(const V* __restrict__ vals,
                                const int* __restrict__ offsets, int D,
                                int64_t nv_rows, int64_t n_rows,
                                const T* __restrict__ x, int64_t x_len,
                                T* __restrict__ y, int64_t ys, int nr) {
  constexpr int kRows = kGenThreads / kSlices;
  // the slices' sums of a CTA's rows (kSlices > 1)
  __shared__ T sums[kSlices > 1 ? kSlices : 1][kSlices > 1 ? kRhs : 1]
                   [kSlices > 1 ? kRows : 1];
  const int r = threadIdx.x % kRows, s = threadIdx.x / kRows;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kRows + r;
  if (kSlices == 1 && g >= n_rows) return;
  const V* vg = vals + (g >> 10) * D * kBlockRows + (g & (kBlockRows - 1));
  T acc[kRhs];
#pragma unroll
  for (int b = 0; b < kRhs; ++b) acc[b] = T(0);
  if (g < nv_rows && g < n_rows) {
    for (int j = s; j < D; j += kSlices) {
      const int64_t src = g - static_cast<int64_t>(offsets[j]);
      if (src >= 0 && src < x_len) {
        const T v = widen(vg[static_cast<int64_t>(j) * kBlockRows]);
        if constexpr (kRhs == 1) {
          acc[0] = mul_add(v, x[src], acc[0]);
        } else {
          T xv[kRhs];
          load_group<kRhs>(x + src * kRhs, xv);
#pragma unroll
          for (int b = 0; b < kRhs; ++b)
            if (live<kRhs>(b, nr)) acc[b] = mul_add(v, xv[b], acc[b]);
        }
      }
    }
  }
  if constexpr (kSlices == 1) {
#pragma unroll
    for (int b = 0; b < kRhs; ++b)
      if (live<kRhs>(b, nr)) {
        if constexpr (kStore)
          y[b * ys + g] = acc[b];
        else
          y[b * ys + g] += acc[b];
      }
  } else {
#pragma unroll
    for (int b = 0; b < kRhs; ++b) sums[s][b][r] = acc[b];
    __syncthreads();
    for (int i = threadIdx.x; i < kRhs * kRows; i += kGenThreads) {
      const int b = i / kRows, k = i % kRows;
      const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + k;
      if (!live<kRhs>(b, nr) || row >= n_rows) continue;
      T sum = sums[0][b][k];
#pragma unroll
      for (int t = 1; t < kSlices; ++t) sum += sums[t][b][k];
      if constexpr (kStore)
        y[b * ys + row] = sum;
      else
        y[b * ys + row] += sum;
    }
  }
}

// ---------------------------------------------------------------------------
// sdia_gen_staged — the double instance of sdia_gen_tiles_mm (B12 f64) and
// sdia_gen_tiles (B6 f64) on a plan whose signed offsets span at most
// kGenSpan: the float64 DistSpDMV's mirrored diagonals of a banded shard
// (cant's +-1..32).
//
// What bounds it on this card. The values are read once, coalesced: on D1's
// mirrored shard 1 (16,384 rows, 64 diagonals) 8.4 MB, which stays in the
// L2. sdia_gen_kernel reads each diagonal's x of 8 interleaved double planes
// as four 16-byte loads a row, lanes 64 bytes apart: each load of a warp
// spans 16 L1 lines, so x costs four times the L1 wavefronts its 2 KB need,
// eight times the bytes of the values.
//
// What the design does about it. A CTA of kGenThreads threads takes
// kGenThreads / kSlices rows and first stages its window of X in shared
// memory, once: the rows [r0 - hi, r0 + rows - lo) of each plane (hi, lo
// the largest and smallest offset), zero outside x, copied from the
// interleaved X (or the plane) in coalesced 16-byte loads and laid out
// plane by plane, so that a warp's reads of a diagonal's x are 8 bytes a
// lane on consecutive addresses, no bank conflict. Then every diagonal
// reads x there and its value once from global memory, and the slices' sums
// meet as in sdia_gen_kernel: no atomics, y the same bit for bit from run
// to run. The upload decides once a plan whether it stages
// (sdia_kernel.gen_window: span = hi - lo <= kGenSpan); other plans, and
// every float and bf16 plan, run sdia_gen_kernel. Device ms on D1's shard
// 1, storing (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): at 8 planes
// 0.0049-0.0051 at 4 slices (sdia_kernel.stage_slices), where
// sdia_gen_kernel took 0.0104-0.0115 at 2 slices; at one plane
// 0.0028-0.0030 against 0.0049-0.0055. 1, 2 and 8 slices staged ran
// slower than 4; at the same slices the staged sums equal sdia_gen_kernel's
// bit for bit.
// ---------------------------------------------------------------------------
constexpr int kGenSpan = 128;

template <int kRhs, int kSlices, bool kStore>
__global__ void __launch_bounds__(kGenThreads)
sdia_gen_staged_kernel(const double* __restrict__ vals,
                       const int* __restrict__ offsets, int D,
                       int64_t nv_rows, int64_t n_rows,
                       const double* __restrict__ x, int64_t x_len, int hi,
                       int span, double* __restrict__ y, int64_t ys, int nr) {
  constexpr int kRows = kGenThreads / kSlices;
  constexpr int kWin = kRows + kGenSpan;
  constexpr int kPairs = kRhs > 1 ? kRhs / 2 : 1;  // 16-byte loads a row
  // x[r0 - hi + k] of plane b at xsh[b][k]
  __shared__ __align__(16) double xsh[kRhs][kWin];
  __shared__ double sums[kSlices > 1 ? kSlices : 1][kSlices > 1 ? kRhs : 1]
                        [kSlices > 1 ? kRows : 1];
  const int r = threadIdx.x % kRows, s = threadIdx.x / kRows;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t base = r0 - hi;
  const int width = kRows + span;
  for (int i = threadIdx.x; i < width * kPairs; i += kGenThreads) {
    const int k = i / kPairs, p = i % kPairs;
    const int64_t src = base + k;
    const bool in = src >= 0 && src < x_len;
    if constexpr (kRhs == 1) {
      xsh[0][k] = in ? x[src] : 0.0;
    } else {
      const double2 v = in ? reinterpret_cast<const double2*>(
                                 x + src * kRhs)[p]
                           : make_double2(0.0, 0.0);
      xsh[2 * p][k] = v.x;
      xsh[2 * p + 1][k] = v.y;
    }
  }
  __syncthreads();
  const int64_t g = r0 + r;
  double acc[kRhs];
#pragma unroll
  for (int b = 0; b < kRhs; ++b) acc[b] = 0.0;
  if (g < nv_rows && g < n_rows) {
    const double* vg =
        vals + (g >> 10) * D * kBlockRows + (g & (kBlockRows - 1));
    const int k0 = r + hi;  // x[g - d] sits at xsh[.][k0 - d]
#pragma unroll 4
    for (int j = s; j < D; j += kSlices) {
      const int k = k0 - offsets[j];
      const double v = vg[static_cast<int64_t>(j) * kBlockRows];
#pragma unroll
      for (int b = 0; b < kRhs; ++b)
        if (live<kRhs>(b, nr)) acc[b] = fma(v, xsh[b][k], acc[b]);
    }
  }
  if constexpr (kSlices == 1) {
    if (g >= n_rows) return;
#pragma unroll
    for (int b = 0; b < kRhs; ++b)
      if (live<kRhs>(b, nr)) {
        if constexpr (kStore)
          y[b * ys + g] = acc[b];
        else
          y[b * ys + g] += acc[b];
      }
  } else {
#pragma unroll
    for (int b = 0; b < kRhs; ++b) sums[s][b][r] = acc[b];
    __syncthreads();
    for (int i = threadIdx.x; i < kRhs * kRows; i += kGenThreads) {
      const int b = i / kRows, k = i % kRows;
      const int64_t row = r0 + k;
      if (!live<kRhs>(b, nr) || row >= n_rows) continue;
      double sum = sums[0][b][k];
#pragma unroll
      for (int t = 1; t < kSlices; ++t) sum += sums[t][b][k];
      if constexpr (kStore)
        y[b * ys + row] = sum;
      else
        y[b * ys + row] += sum;
    }
  }
}

// ---------------------------------------------------------------------------
// bell2_spmv — replaces cfs_spmv_tpu/ops/bell2_kernel.py:bell2_spmv_tiles
// (B2) and, over planes, bell2_spmm_tiles (B7); with T = double,
// cfs_spmv_tpu/ops/bell2_df.py:bell2_spmv_tiles_df (B15) and
// bell2_spmm_tiles_df (B16). Every launch follows a zero pass: y = A x over
// the blocks the stream visits. The accumulating forms (B4, B8), and B15/B16
// on a float64 peel residual or sparse stream, run bell2_entries instead.
// The reference's double-float kernels write
// 8x-tall sublane partials (or fold them pairwise) to keep compensated sums
// out of the TPU's reduce tree; the double instance sums a row's 8 sublanes
// in a double register like the float one, so there is nothing to fold.
//
// Slot (i, j) of chunk c holds q = pk & 0x7F in bits 0-6; the window index r2
// serving gather lane q of sublane i sits in bits 7-11 of the packed word AT
// lane q. The x row is meta[c, 2] + r2 for contiguous or deep windows, and
// meta[c, 2 + (r2 & 7)] for listed windows. The 8 sublanes sum into row
// meta[c, 0] of block step_block[c / K].
//
// B2, one plane in float32 or bf16, runs bell2_walks_kernel (below). What
// bounds it on this card is its bytes: 6 a slot in float32 (a 4-byte value
// and a 2-byte packed word), 4 in bf16, each read once, plus x and y. What
// held it back was the bytes in flight: it was bell2_spmv_kernel walking 8
// chunks a CTA, C / 8 CTAs of 4 warps whatever C was (128 CTAs for the
// 1,024 chunks of a general_asym() shard at P = 4, under one an SM), each
// chunk a chain of loads the next waited behind. The walk groups keep that
// chain and fill the card: a group of 128 threads walks the fewest chunks
// that keep every group resident at once, so the shard's chunks run as
// 1,024 walks of one chunk in a single wave. Short walks would leave a
// row's sums to meet in y from many CTAs, in any order; the 8 walk groups
// of a CTA add up their walks' first and last rows in walk order first,
// so y repeats bit for bit wherever the walk of 8 did. Staging the stream
// in shared memory by cp.async (a ring of 2-4 chunk buffers a group, the
// next chunk in flight while one sums) measured slower on every stream
// timed but the bf16 replan with absent rows, and stays in chip_smoke.py
// as a form of comparison. Device ms of the kernel, the walk of 8 before
// against the walk groups, in one run (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md §6): a general_asym() shard's 1,024 chunks 0.0146-0.0148 against
// 0.0038-0.0039 (bound 0.0022), cant_proxy() NONE 0.0159-0.0207 against
// 0.0093-0.0094 (0.0084), audikw_proxy() 0.0223-0.0224 against
// 0.0209-0.0218 (0.0151), the same in bf16 0.0150-0.0155 against
// 0.0129-0.0139 (0.0102).
//
// The other instances (B7, B15, B16) run bell2_spmv_kernel: one CTA of
// 128 threads (one per lane) walks kWalk consecutive chunks, a template
// argument: the TPU walks a K-chunk grid step in order on one core, but a
// K = 128 step count (63 steps for the audikw proxy) would leave most of
// the 132 SMs idle, so each step is split across K / kWalk CTAs. The float
// multi-RHS ones walk kInterleavedWalk (of walks 1, 2, 4 and 8 the fastest
// over audikw_proxy() and cant_proxy() NONE together at 8 planes, PERF.md
// §6); the double ones kDoubleWalk, one chunk a CTA: a walk of 8 left 3.9
// CTAs an SM on the 4,096 chunks of general_asym() in float64, and one
// chunk a CTA beat walks of 2, 4, 8 and the fewest that keep every CTA
// resident at once (walk_for below) on that stream and on
// audikw_proxy()'s 8,192 chunks, at 1 and 8 planes (PERF.md §6). The
// chunk's r2 fields go through shared memory (a lane needs lane q's
// field). Over planes the double instances read x as kRhs gathers from the
// planes, each of which may cost a 32-byte sector for 8 bytes. The float
// multi-RHS instances (kInterleaved) read an interleaved X instead, which
// holds an element's kRhs planes side by side (8, 16 or 32 bytes, one
// sector), in one 8- or 16-byte load or two: x then points at the group's
// (x_rows * 128, kRhs) block. At 8 planes on audikw_proxy() that took
// 0.0369 ms against 0.0646 for the gathers from the planes, and staging
// the chunk's window rows of x in shared memory 0.0812 (NVIDIA H100 80GB
// HBM3, 700 W, PERF.md §6). One plane is a plain plane and takes the SpMV
// instance.
//
// bell2_spmv_kernel keeps one register sum per plane while the target row
// stays the same and flushes them with one atomicAdd each when the row
// changes and at the walk's end, so a walk may start and end between any
// two chunks: blocks of different CTAs (and different grid steps) can
// target one row. Chunks are tile-sorted, so flushes are rare. K-padding
// chunks carry zero values and forward-filled meta, so they add exactly 0.
// Over planes the value, its packed word and its x row are decoded once
// and feed kRhs gathers, one from each plane's x tile, so a group reads
// the slot stream (6 bytes a slot in float, 10 in double) once.
//
// The zero pass runs first, in a launch of its own: the zero kernel below
// (one CTA per visited block), or, for a stream that visits every block of
// its output (the upload's ``covers``), cudaMemset2DAsync over the group's
// whole planes.
// ---------------------------------------------------------------------------
constexpr int kWalkGroups = 8;
constexpr int kInterleavedWalk = 2;
constexpr int kDoubleWalk = 1;

// Zeroes each output block the stream visits, once, in plane blockIdx.y:
// step_block ascends, so a block starts where the step's block differs
// from the previous step's. Unvisited blocks are left as they are (the TPU
// kernel leaves them unset).
template <typename T>
__global__ void bell2_zero_blocks_kernel(const int* __restrict__ step_block,
                                         int BT, T* __restrict__ y,
                                         int64_t ys) {
  const int g = blockIdx.x;
  if (g > 0 && step_block[g] == step_block[g - 1]) return;
  // 16-byte stores of zero bits, which are +0.0 in float and in double
  uint4* base = reinterpret_cast<uint4*>(
      y + blockIdx.y * ys + static_cast<int64_t>(step_block[g]) * BT * kLanes);
  const int n16 = BT * kLanes * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < n16; i += blockDim.x)
    base[i] = make_uint4(0u, 0u, 0u, 0u);
}

// One atomicAdd per live plane of a thread's running row sums.
template <int kRhs, typename T>
__device__ __forceinline__ void flush_rows(T* y, int64_t ys, int64_t at,
                                           const T (&acc)[kRhs], int nr) {
#pragma unroll
  for (int b = 0; b < kRhs; ++b)
    if (live<kRhs>(b, nr)) atomicAdd(y + b * ys + at, acc[b]);
}

template <bool kContig, int kRhs, typename T, int kWalk, bool kInterleaved,
          typename V = T>
__global__ void __launch_bounds__(kLanes)
bell2_spmv_kernel(const V* __restrict__ vals,
                  const int16_t* __restrict__ packed,
                  const int* __restrict__ meta,
                  const int* __restrict__ step_block, int64_t C, int K,
                  int BT, const T* __restrict__ x, int64_t xs,
                  T* __restrict__ y, int64_t ys, int nr) {
  static_assert(!kInterleaved || (std::is_same_v<T, float> && kRhs > 1),
                "interleaved X: float, two planes or more");
  __shared__ int r2s[kSublanes][kLanes];
  const int lane = threadIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kWalk;
  const int64_t c1 = c0 + kWalk < C ? c0 + kWalk : C;
  int64_t row = -1;  // y tile row of the running sums
  T acc[kRhs];
#pragma unroll
  for (int b = 0; b < kRhs; ++b) acc[b] = T(0);
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
    // On a new target row the sums of the last one are flushed and the
    // running sums start again. With one plane (SpMV) the chunk's products
    // first sum into a register of their own, so that its gathers start
    // without waiting for that branch, and join the running sum after it:
    // 0.0230 ms against 0.0289 for the form below on the audikw proxy's
    // far stream (NVIDIA H100 80GB HBM3, 700 W; PERF.md). With more planes
    // they go straight into the running sums, after the branch: a second
    // set of kRhs sums spilled in the double kRhs = 8 instance and was no
    // faster in float (0.0661-0.0689 ms against 0.0656-0.0661 at kRhs = 8).
    constexpr bool kOwnSum = kRhs == 1;
    auto new_row = [&]() {
      if (tgt == row) return;
      if (row >= 0) flush_rows<kRhs>(y, ys, row * kLanes + lane, acc, nr);
      row = tgt;
#pragma unroll
      for (int b = 0; b < kRhs; ++b) acc[b] = T(0);
    };
    if (!kOwnSum) new_row();
    T own = T(0);
#pragma unroll
    for (int i = 0; i < kSublanes; ++i) {
      const int q = pk[i] & 0x7F;
      const int r2 = r2s[i][q];
      const int xrow = kContig ? m[2] + r2 : m[2 + (r2 & 7)];
      const T v = widen(vals[slot0 + i * kLanes]);
      const T* xq = x + static_cast<int64_t>(xrow) * kLanes + q;
      if constexpr (kInterleaved) {
        T xv[kRhs];
        load_group<kRhs>(x + (static_cast<int64_t>(xrow) * kLanes + q) * kRhs,
                         xv);
#pragma unroll
        for (int b = 0; b < kRhs; ++b)
          if (live<kRhs>(b, nr)) acc[b] = mul_add(v, xv[b], acc[b]);
      } else if (kOwnSum) {
        own = mul_add(v, xq[0], own);
      } else {
#pragma unroll
        for (int b = 0; b < kRhs; ++b)
          if (live<kRhs>(b, nr)) acc[b] = mul_add(v, xq[b * xs], acc[b]);
      }
    }
    __syncthreads();
    if (kOwnSum) {
      new_row();
      acc[0] += own;
    }
  }
  if (row >= 0) flush_rows<kRhs>(y, ys, row * kLanes + lane, acc, nr);
}

// Group g's barrier: its 128 threads only.
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "n"(kLanes) : "memory");
}

// B2, one plane with float or bf16 values (V). A CTA of kGroups groups of
// 128 threads (one a lane); group g of CTA b walks the cpc consecutive
// chunks from w * cpc, w = b * kGroups + g, as bell2_spmv_kernel walks at
// one plane: each chunk's 8 packed words loaded, their r2 fields into the
// group's shared memory, the group's own barrier (bar.sync g + 1, so the
// groups run apart), the value loads and x gathers into a register sum of
// the chunk's own, then a second barrier; the chunk's sum joins the
// running row sum. cpc is the fewest chunks that keep every group resident
// at once (group_walk), so one wave covers the stream whatever its length.
//
// Flushes. A row whose chunks all lie in one walk is flushed by one
// atomicAdd when the target row changes. A walk's first and last rows may
// go on in the walks beside it: their sums are kept, and once every group
// is done the CTA adds them up in walk order, one atomicAdd per row and
// CTA. Sums that are exactly 0 are never added (K-padding chunks, whose
// values are 0, sum to +0). So a row whose nonzero chunks span at most
// kGroups * cpc + 1 chunks takes at most two adds, and y has the same bits
// in every run (0 + a + b = 0 + b + a), which a graphed solve needs to
// equal its eager run: 9 chunks or more at kWalkGroups, as the walk of 8
// chunks a CTA before it gave. Only a row spread over three CTAs sums in
// the order they finish.
template <bool kContig, typename V, int kGroups>
__global__ void __launch_bounds__(kLanes * kGroups, 1)
bell2_walks_kernel(const V* __restrict__ vals,
                   const int16_t* __restrict__ packed,
                   const int* __restrict__ meta,
                   const int* __restrict__ step_block, int64_t C, int K,
                   int BT, int cpc, const float* __restrict__ x,
                   float* __restrict__ y) {
  __shared__ int r2s[kGroups][kSublanes][kLanes];
  __shared__ int ends[kGroups][2];
  __shared__ float sums[kGroups][2][kLanes];
  const int g = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * kGroups + g) * cpc;
  const int n = c0 >= C ? 0 : static_cast<int>(C - c0 < cpc ? C - c0 : cpc);
  int head = -1, row = -1;
  float head_sum = 0.0f, acc = 0.0f;
  for (int j = 0; j < n; ++j) {
    const int64_t c = c0 + j;
    const int* m = meta + c * kMetaW;
    const int tgt = step_block[c / K] * BT + m[0];
    const int64_t slot0 = c * kSublanes * kLanes + lane;
    int pk[kSublanes];
#pragma unroll
    for (int i = 0; i < kSublanes; ++i) {
      pk[i] = packed[slot0 + i * kLanes];
      r2s[g][i][lane] = (pk[i] >> 7) & 0x1F;
    }
    group_sync(g);
    float own = 0.0f;
#pragma unroll
    for (int i = 0; i < kSublanes; ++i) {
      const int q = pk[i] & 0x7F;
      const int r2 = r2s[g][i][q];
      const int xrow = kContig ? m[2] + r2 : m[2 + (r2 & 7)];
      own = fmaf(widen(vals[slot0 + i * kLanes]),
                 x[static_cast<int64_t>(xrow) * kLanes + q], own);
    }
    group_sync(g);
    if (tgt != row) {
      if (row < 0)
        head = tgt;
      else if (row == head)
        head_sum = acc;
      else if (acc != 0.0f)
        atomicAdd(y + static_cast<int64_t>(row) * kLanes + lane, acc);
      row = tgt;
      acc = 0.0f;
    }
    acc += own;
  }
  const bool one_row = row == head;
  if (lane == 0) {
    ends[g][0] = head;
    ends[g][1] = one_row ? -1 : row;
  }
  sums[g][0][lane] = one_row ? acc : head_sum;
  sums[g][1][lane] = one_row ? 0.0f : acc;
  __syncthreads();
  if (g == 0) {
    int cur = -1;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 2 * kGroups; ++k) {
      const int r = ends[k / 2][k % 2];
      if (r < 0) continue;
      if (r != cur) {
        if (cur >= 0 && s != 0.0f)
          atomicAdd(y + static_cast<int64_t>(cur) * kLanes + lane, s);
        cur = r;
        s = 0.0f;
      }
      s += sums[k / 2][k % 2][lane];
    }
    if (cur >= 0 && s != 0.0f)
      atomicAdd(y + static_cast<int64_t>(cur) * kLanes + lane, s);
  }
}

// ---------------------------------------------------------------------------
// bell2_entries — replaces cfs_spmv_tpu/ops/bell2_kernel.py:
// bell2_spmv_tiles_accum (B4) and, over planes, bell2_spmm_tiles_accum (B8);
// with T = double, cfs_spmv_tpu/ops/bell2_df.py:bell2_spmv_tiles_df (B15)
// and bell2_spmm_tiles_df (B16) on a float64 peel residual or sparse stream.
//
// y += R x for the sparse residual R that the peels leave behind. The TPU
// kernel streams R in the (8, 128) chunk grid, which its scalar memory and
// DMA need; a residual fills under 1% of those slots (65,380 live entries in
// 7.86 million slots on the 65,536-row flagship, 120x padding), and walking
// the grid reads 6 bytes (10 in double) and gathers one x for every empty
// slot. Here the upload compacts the grid once into a row-sorted entry list
// (rows, cols: flat int32 indices into the y and x planes; vals), 12 bytes a
// live entry (16 in double), and nothing else of the stream reaches the card.
//
// One thread per entry: three coalesced loads, one x gather per plane, no
// shared memory, no zero pass. Entries are row-sorted, so the entries of
// one row are neighbouring lanes: a warp segmented sum (shuffle-down over
// runs of equal row) leaves each run's total in its first lane, which issues
// one atomicAdd per plane; a run that crosses a warp boundary costs one more
// atomic, and rows no entry names are never touched. Bound by bytes: 12 B an
// entry plus one 32-byte sector per x gather and per touched y row; at the
// flagship's 0.8 MB that is far under a microsecond, so in practice the
// kernel takes its launch plus one chain of dependent loads (col, then
// x[col], then the atomic), like the pure gather of unperm_gather. The
// double instance shuffles 64-bit sums and adds them with the native
// atomicAdd(double*); nothing else differs.
// ---------------------------------------------------------------------------
constexpr int kEntryThreads = 256;

template <int kRhs, typename T, typename V = T>
__global__ void __launch_bounds__(kEntryThreads)
bell2_entries_kernel(const int* __restrict__ rows,
                     const int* __restrict__ cols,
                     const V* __restrict__ vals, int64_t E,
                     const T* __restrict__ x, int64_t xs,
                     T* __restrict__ y, int64_t ys, int nr) {
  const int64_t e =
      static_cast<int64_t>(blockIdx.x) * kEntryThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // lanes past the end stay for the shuffles, in a run of their own
  const bool valid = e < E;
  const int row = valid ? rows[e] : -1;
  T acc[kRhs];
#pragma unroll
  for (int b = 0; b < kRhs; ++b) acc[b] = T(0);
  if (valid) {
    const T v = widen(vals[e]);
    const T* xc = x + cols[e];
#pragma unroll
    for (int b = 0; b < kRhs; ++b)
      if (live<kRhs>(b, nr)) acc[b] = v * xc[b * xs];
  }
  // before the step at distance d a lane holds the sum of its run's entries
  // in [lane, lane + d); rows ascend, so an equal row d lanes on means the
  // lanes between belong to the run too
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int other = __shfl_down_sync(0xffffffffu, row, d);
    const bool same = lane + d < 32 && other == row;
#pragma unroll
    for (int b = 0; b < kRhs; ++b) {
      const T add = __shfl_down_sync(0xffffffffu, acc[b], d);
      if (same) acc[b] += add;
    }
  }
  const int before = __shfl_up_sync(0xffffffffu, row, 1);
  if (valid && (lane == 0 || before != row)) {
#pragma unroll
    for (int b = 0; b < kRhs; ++b)
      if (live<kRhs>(b, nr)) atomicAdd(y + b * ys + row, acc[b]);
  }
}

// ---------------------------------------------------------------------------
// bell2_entries_kernel_rows — replaces cfs_spmv_tpu/ops/bell2_kernel.py:
// bell2_spmv_tiles_accum (B4) together with the seed D x that the
// reference's sbell_apply adds it into, for a symmetric float32 plan whose
// whole off-diagonal part is the far stream's entries (no paired stream, no
// diagonal stream): y = D x + R x, each row of y written once, x and y flat
// (n,), no padded copy of x, no seed, no zero pass.
//
// What bounds it on this card. At a Graph500 graph's size (31.4M entries
// over 1M rows at SCALE 20) two things: the entries' bytes from DRAM, 4 of
// cols and 4 of vals an entry read once (251 MB), the row pointers (4 B a
// row) and d, x, y (12 B a row); and the x gathers. x, d and the pointers
// fit the 50 MB L2, but a gather x[col] that misses the L1 moves a whole
// 32-byte L2 sector for 4 bytes: about 1 GB of L2 traffic an apply on
// that graph, which is what the time follows (every slice size measured
// within 3% once the shared memory was cut, and a third less shared memory
// a CTA, so more L1, took a fifth off the time; PERF.md §6).
// bell2_entries_kernel (one thread an entry) reads 12 B an entry, rows
// included, and keeps one dependent chain (col, x[col], the atomic) a
// thread in flight. The rows are skewed (hubs hundreds of times the mean
// degree, a third of the rows empty), so a split by rows would leave a hub
// row to one thread and an empty stretch to another.
//
// What the design does about it.
// - Row pointers (ptr, n + 1) in place of the row of every entry: 8 B an
//   entry. The entries keep their row-sorted order (EntryStream).
// - Merge-path split. The path walks rows and entries together (n + E
//   items: a row's entries, then its end); CTA b takes items [b P, (b + 1)
//   P), P = kRowsThreads * kIpt, and starts at the (row, entry) coordinate
//   tiles[b], which the upload computes once by a binary search of
//   ptr[i] + i (ops/bell2_kernel.entry_rows). A hub row spreads over many
//   CTAs and threads, a stretch of empty rows too; every CTA does the same
//   work.
// - Gathers in flight. A thread loads its kIpt entries' cols and vals
//   (coalesced, streamed past the L2: __ldcs), then issues their kIpt x
//   gathers together, and stores the products in shared memory.
// - Rows in shared memory. The CTA's row ends are staged; each thread finds
//   its kIpt-item stretch of the path by a binary search of them and walks
//   it, summing products and closing rows. Odd kIpt keeps the threads'
//   strided reads of shared memory free of bank conflicts. A closed row's
//   sum takes its end's slot, so the CTA holds two arrays of kRowsItems words
//   and the L1 keeps the rest of the SM's 256 KB for the gathers. A row
//   open across threads is joined by a segmented scan over the threads'
//   sums (warp shuffles, then the warps' totals), in a fixed order.
// - y written once, in the epilogue: y[r] = d[r] x[r] + sum for every row
//   the CTA closes, coalesced; a row with no entry reads d[r] x[r] exactly.
//   A row open at the CTA's end leaves its partial sum in the CTA's carry
//   (carry_row[b], carry_val[b]); bell2_entries_kernel_rows_carry adds a
//   row's carries, in CTA order, after the CTA that closed it has stored
//   it. No atomics: the result repeats bit for bit.
// ---------------------------------------------------------------------------
constexpr int kRowsThreads = 256;
constexpr int kRowsIpt = 5;  // path items a thread (odd: no bank conflicts)
constexpr int kRowsItems = kRowsThreads * kRowsIpt;
// The shared memory an SM sets aside (percent of its most), the rest its
// L1: 25 leaves 64 KB, six CTAs of 10 KB resident, and 192 KB of L1 for
// the gathers, where the default (eight CTAs) left about 156 KB and one
// more shared array 124 KB (PERF.md §6).
constexpr int kRowsCarveout = 25;
constexpr int kCarryThreads = 256;

// Inclusive segmented sum over the CTA's threads in thread order: the sum
// of v over the threads since the last one whose flag is set (that one
// included); the flags of the CTA's warps go through shared memory.
__device__ __forceinline__ float cta_segmented_sum(bool f, float v,
                                                   float* warp_v,
                                                   int* warp_f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float pv = __shfl_up_sync(0xffffffffu, v, d);
    const int pf = __shfl_up_sync(0xffffffffu, static_cast<int>(f), d);
    if (lane >= d) {
      if (!f) v = pv + v;
      f = f || pf;
    }
  }
  if (lane == 31) warp_v[warp] = v, warp_f[warp] = f;
  __syncthreads();
  if (!f) {  // open since an earlier warp: add the warps before, latest first
    float before = 0.0f;
    for (int w = warp - 1; w >= 0; --w) {
      before = warp_v[w] + before;
      if (warp_f[w]) break;
    }
    v = before + v;
  }
  return v;
}

__global__ void __launch_bounds__(kRowsThreads)
bell2_entries_kernel_rows(const int* __restrict__ ptr,
                          const int* __restrict__ cols,
                          const float* __restrict__ vals,
                          const int* __restrict__ tiles,
                          const float* __restrict__ diag,
                          const float* __restrict__ x, float* __restrict__ y,
                          int* __restrict__ carry_row,
                          float* __restrict__ carry_val) {
  constexpr int kThreads = kRowsThreads, kIpt = kRowsIpt;
  __shared__ float prod[kRowsItems];  // the CTA's entries' products
  // where each closed row ends (CTA entry), then, once read, its sum
  __shared__ union { int end; float sum; } rows[kRowsItems];
  __shared__ float warp_v[kThreads / 32];
  __shared__ int warp_f[kThreads / 32];
  const int t = threadIdx.x, b = blockIdx.x;
  const int i0 = tiles[2 * b], j0 = tiles[2 * b + 1];
  const int nrows = tiles[2 * b + 2] - i0, nent = tiles[2 * b + 3] - j0;

  int c[kIpt];
  float v[kIpt];
#pragma unroll
  for (int k = 0; k < kIpt; ++k) {
    const int e = t + k * kThreads;
    const bool in = e < nent;
    c[k] = in ? __ldcs(cols + j0 + e) : 0;
    v[k] = in ? __ldcs(vals + j0 + e) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kIpt; ++k) {
    const int e = t + k * kThreads;
    if (e < nent) prod[e] = v[k] * x[c[k]];
  }
#pragma unroll
  for (int k = 0; k < kIpt; ++k) {
    const int r = t + k * kThreads;
    if (r < nrows) rows[r].end = ptr[i0 + r + 1] - j0;
  }
  __syncthreads();

  // this thread's stretch of the path: items [k0, k1) of the CTA's, from
  // the coordinate (a, e) with a + e = k0, a the largest a with
  // end[a - 1] + a <= k0 (the rows before a close at or before it)
  const int k0 = t * kIpt, k1 = min(k0 + kIpt, nrows + nent);
  int lo = max(0, k0 - nent), hi = min(nrows, k0);
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (rows[mid - 1].end + mid <= k0)
      lo = mid;
    else
      hi = mid - 1;
  }
  // every search has read what it reads: a row's end becomes its sum once
  // the thread that opened the row closes it (no other thread reads it
  // then); a thread's first row, which an earlier thread opened, after the
  // segmented sum's barrier
  __syncthreads();
  int a = lo, e = k0 - lo, first = -1;
  float run = 0.0f, head = 0.0f;
  for (int k = k0; k < k1; ++k) {
    if (a < nrows && e >= rows[a].end) {  // row a closes here
      if (first < 0)
        first = a, head = run;
      else
        rows[a].sum = run;
      run = 0.0f;
      ++a;
    } else {
      run += prod[e++];
    }
  }
  // the sum of the row open at this thread's end, over the threads since
  // the last that closed a row; the one before this thread's is what this
  // thread's first row had before it
  const float open = cta_segmented_sum(first >= 0, run, warp_v, warp_f);
  const float before = __shfl_up_sync(0xffffffffu, open, 1);
  const int lane = t & 31, warp = t >> 5;
  float carried = lane ? before : 0.0f;
  if (lane == 0 && warp > 0) {  // the last thread of the warp before
    carried = 0.0f;
    for (int w = warp - 1; w >= 0; --w) {
      carried = warp_v[w] + carried;
      if (warp_f[w]) break;
    }
  }
  if (first >= 0) rows[first].sum = carried + head;
  if (t == kThreads - 1) carry_row[b] = i0 + nrows, carry_val[b] = open;
  __syncthreads();
  for (int r = t; r < nrows; r += kThreads)
    y[i0 + r] = fmaf(diag[i0 + r], x[i0 + r], rows[r].sum);
}

// A row's carries, in CTA order, into the y the CTA that closed it stored:
// one thread a run of equal carry rows (rows past n: the last CTA's end).
__global__ void __launch_bounds__(kCarryThreads)
bell2_entries_kernel_rows_carry(const int* __restrict__ carry_row,
                                const float* __restrict__ carry_val, int nb,
                                int n, float* __restrict__ y) {
  const int b = blockIdx.x * kCarryThreads + threadIdx.x;
  if (b >= nb) return;
  const int row = carry_row[b];
  if (row >= n || (b > 0 && carry_row[b - 1] == row)) return;
  float s = carry_val[b];
  for (int k = b + 1; k < nb && carry_row[k] == row; ++k) s += carry_val[k];
  if (s != 0.0f) y[row] += s;
}

// ---------------------------------------------------------------------------
// sbell_spmv — replaces cfs_spmv_tpu/ops/bell2_kernel.py:sbell_spmv_tiles
// (B5) and, over planes, sbell_spmm_tiles (B10).
//
// y = (L + L^T) x from the paired strict-lower stream: each stored value
// v at (r, c) drives y[r] += v x[c] and y[c] += v x[r]. Packed int32 word
// at slot (i, j): q in bits 0-6, the window r2 in bits 7-9 (7 = empty),
// the transpose source lane in bits 10-16. The chunk's TW (2 or 4)
// windows are meta[c, 2 .. 2 + TW); each is an x tile for the row side
// and a y tile of the same output block for the transpose side.
//
// - Row side: slot (i, l) gathers x[meta[c, 2 + r2]][q] with r2 the field
//   at lane q; a window index >= TW reads nothing. The 8 sublanes sum
//   into row tile step_block[c / K] * BT + meta[c, 0].
// - Transpose side: at slot (i, p) with r2 < TW, the product
//   vals[i, src] * x[row tile][src] (src = bits 10-16) lands on
//   y[meta[c, 2 + r2]][p].
//
// What bounds it on this card. Past the 50 MB L2 the stream's bytes do (8
// a slot, each value used twice). A stream that fits the L2 is bound by
// the chain of dependent loads of one chunk: the TPU kernel walks its
// chunks in grid order on one core and hides that chain in its pipeline;
// here nothing hides it but other CTAs, so a walk of many chunks a CTA
// leaves the SMs waiting. Over planes the transpose side's atomicAdds
// count as well: one per valid slot and plane, in partly filled 32-byte
// sectors.
//
// What the design does about it.
// - Short walks, one wave. A CTA of 128 threads (one per lane) walks cpc
//   consecutive chunks, a launch argument: the fewest that let every CTA
//   be resident at once, and at most kMaxWalk (chunks_per_cta below).
// - No global load behind the barrier. A chunk's windows are TW + 1 tiles
//   of x: its own (the transpose side's x[row tile]) and TW for the row
//   side. Their tile numbers are read once a chunk from meta, and the
//   tiles are staged in shared memory next to the chunk's r2 fields and
//   values, so after the one barrier every gather reads shared memory. That
//   is (TW + 1) coalesced loads a thread and plane in place of 16 gathers.
// - Transpose sums without atomics inside the CTA. Thread p is the only
//   writer of lane p of every window tile, so the sums per window slot
//   are private to it: in registers for one or two planes, and for four
//   or eight (where TW x kRhs registers more would halve the resident
//   CTAs) in a shared tile of which a thread touches its own lane only.
//   A slot's sums are handed over when the slot's target changes (the
//   planner keeps a target in its slot from chunk to chunk) and at the end
//   of the walk: into the running row sums when the target is the row's
//   own tile, else by one atomicAdd per plane, lanes holding 0 skipped.
// - The row sums are flushed the same way on a change of row tile, so a
//   walk may start and end between any two chunks.
//
// The double instance (T = double, the float64 distributed operator's
// paired shards) runs this kernel at one plane (B5 f64). Over planes it
// runs sbell_planes_kernel below (B10 f64), one launch and one zero pass a
// group of up to 8 planes.
//
// The TPU zeroes each block at its first grid step and relies on steps
// running in order; here the whole output is zeroed first in a launch of
// its own (cudaMemset2DAsync over the group's planes: a paired plan
// visits every output block), since another CTA's transpose atomics may
// land before a CTA of the same launch could zero them. K-padding chunks
// carry zero values and forward-filled meta, so they add exactly 0.
// ---------------------------------------------------------------------------
constexpr int kMaxWalk = 4;

// One atomicAdd per live plane whose sum is not 0.
template <int kRhs, typename T>
__device__ __forceinline__ void flush_sums(T* y, int64_t ys, int64_t at,
                                           const T (&s)[kRhs], int nr) {
#pragma unroll
  for (int b = 0; b < kRhs; ++b)
    if (live<kRhs>(b, nr) && s[b] != T(0)) atomicAdd(y + b * ys + at, s[b]);
}

// The sums s of a window slot whose target was tile wt leave the slot:
// they join the running row sums when wt is the row's tile, else go to y.
template <int kRhs, typename T>
__device__ __forceinline__ void hand_over(T* y, int64_t ys, int lane, int wt,
                                          int64_t row, const T (&s)[kRhs],
                                          T (&acc)[kRhs], int nr) {
  if (wt == row) {
#pragma unroll
    for (int b = 0; b < kRhs; ++b) acc[b] += s[b];
  } else if (wt >= 0) {
    flush_sums<kRhs>(y, ys, static_cast<int64_t>(wt) * kLanes + lane, s, nr);
  }
}

template <int TW, int kRhs, typename T = float, typename V = T>
__global__ void __launch_bounds__(kLanes)
sbell_spmv_kernel(const V* __restrict__ vals,
                  const int* __restrict__ packed,
                  const int* __restrict__ meta,
                  const int* __restrict__ step_block, int64_t C, int K,
                  int BT, int cpc, const T* __restrict__ x, int64_t xs,
                  T* __restrict__ y, int64_t ys, int nr) {
  // a double instance at 4 planes keeps its transpose sums in registers
  // too: its staged tiles take 32 KB, and the sums would take 16 KB more
  constexpr bool kRegSums = kRhs <= 2 || (sizeof(T) == 8 && kRhs <= 4);
  // at most 48 KB of static shared memory: a double instance serves up to
  // 4 planes (the port launches it at one; the 2- and 4-plane ones are the
  // form before sbell_planes_kernel, which chip_smoke.py times beside it)
  static_assert(sizeof(T) == 4 || kRhs <= 4, "too many planes in double");
  __shared__ int r2s[kSublanes][kLanes];
  __shared__ T vs[kSublanes][kLanes];
  __shared__ T xo[kRhs][kLanes];      // the chunk's own x tile
  __shared__ T xw[kRhs][TW][kLanes];  // its window tiles
  // transpose sums per window slot, where registers do not hold them
  __shared__ T tsm[kRegSums ? 1 : kRhs][kRegSums ? 1 : TW][kLanes];
  const int lane = threadIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * cpc;
  const int64_t c1 = c0 + cpc < C ? c0 + cpc : C;
  int64_t row = -1;  // y tile of the running row-side sums
  T acc[kRhs];
  int wt[TW];  // y tile of each window slot's running transpose sums
  T ts[kRegSums ? TW : 1][kRhs];
#pragma unroll
  for (int b = 0; b < kRhs; ++b) acc[b] = T(0);
#pragma unroll
  for (int t = 0; t < TW; ++t) {
    wt[t] = -1;
#pragma unroll
    for (int b = 0; b < kRhs; ++b) {
      if constexpr (kRegSums)
        ts[t][b] = T(0);
      else
        tsm[b][t][lane] = T(0);
    }
  }
  for (int64_t c = c0; c < c1; ++c) {
    const int* m = meta + c * kMetaW;
    int w[TW];
#pragma unroll
    for (int t = 0; t < TW; ++t) w[t] = m[2 + t];
    const int64_t tgt = static_cast<int64_t>(step_block[c / K]) * BT + m[0];
    const int64_t slot0 = c * kSublanes * kLanes + lane;
    int pk[kSublanes];
    T v[kSublanes];
#pragma unroll
    for (int i = 0; i < kSublanes; ++i) {
      pk[i] = packed[slot0 + i * kLanes];
      v[i] = widen(vals[slot0 + i * kLanes]);
      r2s[i][lane] = (pk[i] >> 7) & 7;
      vs[i][lane] = v[i];
    }
#pragma unroll
    for (int b = 0; b < kRhs; ++b)
      if (live<kRhs>(b, nr)) {
        const T* xb = x + b * xs + lane;
        xo[b][lane] = xb[tgt * kLanes];
#pragma unroll
        for (int t = 0; t < TW; ++t)
          xw[b][t][lane] = xb[static_cast<int64_t>(w[t]) * kLanes];
      }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < TW; ++t)
      if (w[t] != wt[t]) {
        T s[kRhs];
#pragma unroll
        for (int b = 0; b < kRhs; ++b) {
          if constexpr (kRegSums) {
            s[b] = ts[t][b];
            ts[t][b] = T(0);
          } else {
            s[b] = tsm[b][t][lane];
            tsm[b][t][lane] = T(0);
          }
        }
        hand_over<kRhs>(y, ys, lane, wt[t], row, s, acc, nr);
        wt[t] = w[t];
      }
    if (tgt != row) {
      if (row >= 0) flush_sums<kRhs>(y, ys, row * kLanes + lane, acc, nr);
      row = tgt;
#pragma unroll
      for (int b = 0; b < kRhs; ++b) acc[b] = T(0);
    }
#pragma unroll
    for (int i = 0; i < kSublanes; ++i) {
      const int q = pk[i] & 0x7F;
      const int r2 = r2s[i][q];
      if (r2 < TW) {
#pragma unroll
        for (int b = 0; b < kRhs; ++b)
          if (live<kRhs>(b, nr)) acc[b] = mul_add(v[i], xw[b][r2][q], acc[b]);
      }
      const int t2 = (pk[i] >> 7) & 7;
      if (t2 < TW) {
        const int src = (pk[i] >> 10) & 0x7F;
        const T tv = vs[i][src];
#pragma unroll
        for (int b = 0; b < kRhs; ++b)
          if (live<kRhs>(b, nr)) {
            const T p = tv * xo[b][src];
            if constexpr (kRegSums) {
#pragma unroll
              for (int t = 0; t < TW; ++t)
                if (t2 == t) ts[t][b] += p;
            } else {
              tsm[b][t2][lane] += p;
            }
          }
      }
    }
    __syncthreads();  // the next chunk overwrites the staged tiles
  }
#pragma unroll
  for (int t = 0; t < TW; ++t) {
    T s[kRhs];
#pragma unroll
    for (int b = 0; b < kRhs; ++b) {
      if constexpr (kRegSums)
        s[b] = ts[t][b];
      else
        s[b] = tsm[b][t][lane];
    }
    hand_over<kRhs>(y, ys, lane, wt[t], row, s, acc, nr);
  }
  if (row >= 0) flush_sums<kRhs>(y, ys, row * kLanes + lane, acc, nr);
}

// ---------------------------------------------------------------------------
// sbell_planes — the double instance of sbell_spmm_tiles (B10 f64, the
// float64 DistSpDMV's paired shards over planes): sbell_spmv_kernel's walk,
// staging and hand-overs over a group of up to 8 double planes.
//
// What bounds it on this card. A paired shard's stream fits the L2 (D5's
// shard 1: 1,024 chunks, 12 KB each); at 8 double planes each chunk also
// needs (TW + 1) x tiles of 8 KB, and each slot two gathers of 64 bytes
// from shared memory. The form before this one (sbell_spmv_kernel over
// double) took at most 4 planes a launch, its static shared memory capped
// at 48 KB, so a group of 8 was two launches and two zero passes that read
// the stream twice, and it restaged every x tile at every chunk.
//
// What the design does about it.
// - One launch and one zero pass a group of up to 8 planes: the chunk's
//   words, values and x tiles live in dynamic shared memory
//   (PlanesLayout::kBytes: 36 KB at TW = 2 and 8 planes; 84 KB at TW = 4,
//   whose transpose sums go there too), raised past 48 KB by
//   cudaFuncSetAttribute before each launch. A refused attribute or launch
//   is returned, and the wrapper raises.
// - x tiles staged on a change only: a chunk restages its own tile when its
//   row tile is not the previous chunk's of the walk, and window slot t's
//   tiles when the slot's tile changes, which is when the row sums and the
//   slot's transpose sums are handed over (on a paired shard a window
//   moves on by a tile at almost every chunk, so this saves little there).
// - x tiles read as 16-byte pairs of planes (PlanesTiles, kPairs): a
//   slot's gather of 8 planes is 4 loads, not 8, in a swizzle that keeps
//   8 lanes reading one pair in 8 places of a row of banks.
// - The walk is the fewest chunks a CTA that keep every CTA resident at
//   once, the occupancy counted with the dynamic shared memory
//   (walk_for), at most kMaxWalk.
// Sums and hand-overs are sbell_spmv_kernel's, plane by plane.
//
// Device ms on D5's shard 1 at 8 planes (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md §6): 0.0124-0.0128 and one zero pass of 0.0011-0.0012, where
// the form before took 0.0185-0.0188 in two launches and two zero passes
// of 0.0021-0.0022 together. That is about three times its bound: a chunk is
// a chain (meta, then its x tiles, a barrier, the gathers and sums, a
// barrier), and 127 registers a thread leave 4 CTAs an SM, too few to hide
// it; the x tiles change at almost every chunk (a window moves on by a
// tile), so keeping them saves little. Measured beside it and slower, as
// forms of comparison (chip_smoke.py's F64_FORMS_SRC): kPairs = false, x
// read plane by plane; kGroups = 2, two groups of 128 threads sharing a
// chunk's planes (79 registers, but each group repeats the chunk's chain);
// kKeep = false, every tile restaged at every chunk; walks of 1, 3, 4, 8.
// ---------------------------------------------------------------------------
template <int TW, int kRhs, int kGroups>
struct PlanesLayout {
  static constexpr int kPlanes = kRhs / kGroups;  // planes a thread serves
  static_assert(kPlanes * kGroups == kRhs, "planes split evenly");
  // transpose sums per window slot in registers where they fit
  static constexpr bool kRegSums = TW * kPlanes <= 16;
  // doubles: the chunk's values, its own x tile and its window tiles of
  // every plane, the transpose sums where registers do not hold them; then
  // the chunk's packed words
  static constexpr int kDoubles =
      (kSublanes + kRhs + kRhs * TW + (kRegSums ? 0 : kRhs * TW)) * kLanes;
  static constexpr size_t kBytes =
      kDoubles * sizeof(double) + kSublanes * kLanes * sizeof(int);
};

// The kP planes from b0 of a group of nr: one atomicAdd per live plane
// whose sum is not 0.
template <int kP>
__device__ __forceinline__ void flush_planes(double* y, int64_t ys,
                                             int64_t at, int b0,
                                             const double (&s)[kP], int nr) {
#pragma unroll
  for (int p = 0; p < kP; ++p)
    if (b0 + p < nr && s[p] != 0.0) atomicAdd(y + (b0 + p) * ys + at, s[p]);
}

// The staged x tiles of a chunk: tile 0 its own, tile 1 + t window slot
// t's, each kRhs planes of 128 lanes. Plane by plane (kPairs false), or
// (kPairs) as the 16-byte pairs of planes (2p, 2p + 1) of a lane side by
// side, pair p of lane l in place p ^ swz(l), so that 8 lanes reading one
// pair fall in 8 distinct places of a 128-byte row of banks.
template <int kRhs, bool kPairs>
struct PlanesTiles {
  static constexpr int kP2 = kRhs / 2;  // pairs of planes
  static_assert(!kPairs || (kRhs >= 2 && kRhs % 2 == 0), "pairs of planes");
  __device__ static __forceinline__ int swz(int l) {
    return kP2 > 1 ? (l / (8 / kP2)) & (kP2 - 1) : 0;
  }
  // plane b of lane l, in doubles from the tile's start
  __device__ static __forceinline__ int at(int l, int b) {
    if constexpr (kPairs)
      return 2 * (l * kP2 + ((b >> 1) ^ swz(l))) + (b & 1);
    else
      return b * kLanes + l;
  }
  // planes (2p, 2p + 1) of lane l of the tile at ``tile``
  __device__ static __forceinline__ double2 pair(const double* tile, int l,
                                                 int p) {
    return reinterpret_cast<const double2*>(tile)[l * kP2 + (p ^ swz(l))];
  }
};

// kPairs = true (what ships) reads x tiles as pairs of planes; kKeep =
// false (restaging every tile at every chunk), kPairs = false and kGroups
// = 2 are forms of comparison.
template <int TW, int kRhs, int kGroups, bool kKeep = true,
          bool kPairs = false>
__global__ void __launch_bounds__(kLanes * kGroups)
sbell_planes_kernel(const double* __restrict__ vals,
                    const int* __restrict__ packed,
                    const int* __restrict__ meta,
                    const int* __restrict__ step_block, int64_t C, int K,
                    int BT, int cpc, const double* __restrict__ x,
                    int64_t xs, double* __restrict__ y, int64_t ys, int nr) {
  using L = PlanesLayout<TW, kRhs, kGroups>;
  using X = PlanesTiles<kRhs, kPairs>;
  constexpr int kP = L::kPlanes;
  constexpr int kTile = kRhs * kLanes;  // doubles a staged tile
  static_assert(!kPairs || kGroups == 1, "pairs of planes: one group");
  extern __shared__ __align__(16) unsigned char planes_smem[];
  double* vs = reinterpret_cast<double*>(planes_smem);  // [8][128]
  double* xt = vs + kSublanes * kLanes;  // [1 + TW] tiles
  double* tsm = xt + (1 + TW) * kTile;   // [kRhs][TW][128], !kRegSums
  int* pks = reinterpret_cast<int*>(vs + L::kDoubles);  // [8][128]
  const int lane = threadIdx.x % kLanes, grp = threadIdx.x / kLanes;
  const int b0 = grp * kP;  // the first of this thread's planes
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * cpc;
  const int64_t c1 = c0 + cpc < C ? c0 + cpc : C;
  int64_t row = -1;  // y tile of the running row sums (and of tile 0)
  double acc[kP];
  int wt[TW];  // y tile of each window slot's sums (and of its tile)
  double ts[L::kRegSums ? TW : 1][kP];
  // x tile ``tile`` of every live plane into staged tile u (planes split
  // over the groups; 0 for planes past nr)
  auto stage = [&](int u, int64_t tile) {
    double* d = xt + u * kTile;
    const double* src = x + tile * kLanes + lane;
    if constexpr (kPairs) {
#pragma unroll
      for (int p = 0; p < X::kP2; ++p)
        reinterpret_cast<double2*>(d)[lane * X::kP2 + (p ^ X::swz(lane))] =
            make_double2(2 * p < nr ? src[2 * p * xs] : 0.0,
                         2 * p + 1 < nr ? src[(2 * p + 1) * xs] : 0.0);
    } else {
      for (int b = grp; b < kRhs && b < nr; b += kGroups)
        d[X::at(lane, b)] = src[b * xs];
    }
  };
#pragma unroll
  for (int p = 0; p < kP; ++p) acc[p] = 0.0;
#pragma unroll
  for (int t = 0; t < TW; ++t) {
    wt[t] = -1;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if constexpr (L::kRegSums)
        ts[t][p] = 0.0;
      else
        tsm[((b0 + p) * TW + t) * kLanes + lane] = 0.0;
    }
  }
  for (int64_t c = c0; c < c1; ++c) {
    const int* m = meta + c * kMetaW;
    int w[TW];
#pragma unroll
    for (int t = 0; t < TW; ++t) w[t] = m[2 + t];
    const int64_t tgt = static_cast<int64_t>(step_block[c / K]) * BT + m[0];
    const int64_t slot0 = c * kSublanes * kLanes + lane;
    for (int i = grp; i < kSublanes; i += kGroups) {
      pks[i * kLanes + lane] = packed[slot0 + i * kLanes];
      vs[i * kLanes + lane] = vals[slot0 + i * kLanes];
    }
    if (!kKeep || tgt != row) stage(0, tgt);
#pragma unroll
    for (int t = 0; t < TW; ++t)
      if (!kKeep || w[t] != wt[t]) stage(1 + t, w[t]);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < TW; ++t)
      if (w[t] != wt[t]) {
        double s[kP];
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          if constexpr (L::kRegSums) {
            s[p] = ts[t][p];
            ts[t][p] = 0.0;
          } else {
            double* at = tsm + ((b0 + p) * TW + t) * kLanes + lane;
            s[p] = *at;
            *at = 0.0;
          }
        }
        if (wt[t] == row) {
#pragma unroll
          for (int p = 0; p < kP; ++p) acc[p] += s[p];
        } else if (wt[t] >= 0) {
          flush_planes<kP>(y, ys, static_cast<int64_t>(wt[t]) * kLanes + lane,
                           b0, s, nr);
        }
        wt[t] = w[t];
      }
    if (tgt != row) {
      if (row >= 0) flush_planes<kP>(y, ys, row * kLanes + lane, b0, acc, nr);
      row = tgt;
#pragma unroll
      for (int p = 0; p < kP; ++p) acc[p] = 0.0;
    }
#pragma unroll
    for (int i = 0; i < kSublanes; ++i) {
      const int pk = pks[i * kLanes + lane];
      const double v = vs[i * kLanes + lane];
      const int q = pk & 0x7F;
      const int r2 = (pks[i * kLanes + q] >> 7) & 7;
      if (r2 < TW) {
        const double* tile = xt + (1 + r2) * kTile;
        if constexpr (kPairs) {
#pragma unroll
          for (int p = 0; p < X::kP2; ++p) {
            const double2 xv = X::pair(tile, q, p);
            acc[2 * p] = fma(v, xv.x, acc[2 * p]);
            acc[2 * p + 1] = fma(v, xv.y, acc[2 * p + 1]);
          }
        } else {
#pragma unroll
          for (int p = 0; p < kP; ++p)
            if (b0 + p < nr)
              acc[p] = fma(v, tile[X::at(q, b0 + p)], acc[p]);
        }
      }
      const int t2 = (pk >> 7) & 7;
      if (t2 < TW) {
        const int src = (pk >> 10) & 0x7F;
        const double tv = vs[i * kLanes + src];
        double prod[kP];
        if constexpr (kPairs) {
#pragma unroll
          for (int p = 0; p < X::kP2; ++p) {
            const double2 xv = X::pair(xt, src, p);
            prod[2 * p] = tv * xv.x;
            prod[2 * p + 1] = tv * xv.y;
          }
        } else {
#pragma unroll
          for (int p = 0; p < kP; ++p)
            prod[p] = b0 + p < nr ? tv * xt[X::at(src, b0 + p)] : 0.0;
        }
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          if constexpr (L::kRegSums) {
#pragma unroll
            for (int t = 0; t < TW; ++t)
              if (t2 == t) ts[t][p] += prod[p];
          } else {
            tsm[((b0 + p) * TW + t2) * kLanes + lane] += prod[p];
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the staged words
  }
#pragma unroll
  for (int t = 0; t < TW; ++t) {
    double s[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if constexpr (L::kRegSums)
        s[p] = ts[t][p];
      else
        s[p] = tsm[((b0 + p) * TW + t) * kLanes + lane];
    }
    if (wt[t] == row) {
#pragma unroll
      for (int p = 0; p < kP; ++p) acc[p] += s[p];
    } else if (wt[t] >= 0) {
      flush_planes<kP>(y, ys, static_cast<int64_t>(wt[t]) * kLanes + lane,
                       b0, s, nr);
    }
  }
  if (row >= 0) flush_planes<kP>(y, ys, row * kLanes + lane, b0, acc, nr);
}

// ---------------------------------------------------------------------------
// unperm_gather —replaces cfs_spmv_tpu/ops/bell2_kernel.py:
// unperm_gather_tiles (B3) and, over planes, unperm_gather_tiles_mm (B9).
//
// Original-order y from a degree-grouped stream's compact tiles: output row
// o < n_gather reads pk = pk2d[o]; pk < 0 gives exact 0, otherwise the value
// g[rows[o >> 10, pk >> 7], pk & 127]; rows o >= n_gather gather 0. One
// thread per output element decodes pk and its tile row once and serves
// each of the B planes (no sums, so no register array and no plane groups:
// one launch serves every plane). The pk and output accesses coalesce; the
// gathered reads land in the few tile rows each 1024-row block draws from
// (at most 16), which stay in L2.
//
// What bounds it on this card. About 1 MB on audikw_proxy(), which the card
// moves in a launch's fixed cost (0.0017 ms against a bound of 0.0003):
// the gather alone cannot get nearer, but the elementwise passes around it
// in the symmetric appliers were launches of their own. So the launch does
// their work too (kMode):
// - kGather: out = P g (bell2_apply, bell2_apply_mm);
// - kSeed: out[o] = diag[o] * x[o] + (P g)[o] over n_out rows, the seed
//   D x read in place (x at o * x_row + b * x_col, so an (m, B) X at its
//   own strides), 0 for the seed at o >= n_seed: what sbell_apply built
//   from the seed's pad, the pad of P g and an add;
// - kInto: out[o] += (P g)[o] over n_out rows, onto the paired stream's
//   tiles.
// Each fused form rounds as the composed ops do, product then sum
// (__fmul_rn, __fadd_rn: no contraction into an FMA), so it equals them
// bit for bit.
// ---------------------------------------------------------------------------
enum UnpermMode { kGather = 0, kSeed = 1, kInto = 2 };

template <int kMode>
__global__ void unperm_gather_kernel(const int* __restrict__ pk,
                                     const int* __restrict__ rows, int W,
                                     const float* __restrict__ g, int64_t gs,
                                     float* __restrict__ out, int64_t os,
                                     int64_t n_gather, int64_t n_out,
                                     const float* __restrict__ diag,
                                     const float* __restrict__ x,
                                     int64_t x_row, int64_t x_col,
                                     int64_t n_seed, int B) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  int64_t at = -1;
  if (o < n_gather) {
    const int p = pk[o];
    if (p >= 0)
      at = static_cast<int64_t>(rows[(o >> 10) * W + (p >> 7)]) * kLanes +
           (p & 0x7F);
  }
  const bool seeded = kMode == kSeed && o < n_seed;
  const float d = seeded ? diag[o] : 0.0f;
  for (int b = 0; b < B; ++b) {
    const float v = at < 0 ? 0.0f : g[b * gs + at];
    float* dst = out + b * os + o;
    if constexpr (kMode == kGather)
      *dst = v;
    else if constexpr (kMode == kSeed)
      *dst = __fadd_rn(seeded ? __fmul_rn(d, x[o * x_row + b * x_col]) : 0.0f,
                       v);
    else
      *dst = __fadd_rn(*dst, v);
  }
}

inline unsigned int blocks_for(int64_t n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

// Calls f(std::integral_constant<int, R>{}) for the smallest R of 1, 2, 4
// and 8 that holds nr planes; false (nothing launched) when nr is outside
// 1 .. kMax (kMaxRhs, or 4 for a kernel whose widest instance is 4).
template <int kMax = kMaxRhs, class F>
bool with_rhs(int nr, F&& f) {
  static_assert(kMax == 4 || kMax == 8, "the widest instance");
  if (nr < 1 || nr > kMax) return false;
  if (nr == 1) {
    f(std::integral_constant<int, 1>{});
  } else if (nr == 2) {
    f(std::integral_constant<int, 2>{});
  } else if (nr <= 4) {
    f(std::integral_constant<int, 4>{});
  } else if constexpr (kMax == 8) {
    f(std::integral_constant<int, 8>{});
  }
  return true;
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

// The launchers of the kernels that exist in more than one type; the entry
// points below name the type (V: the values' storage type).
// stage_x: over planes, stage the x rows within kSdiaHalo of a CTA's own
// (any value gives the same sums; one plane never stages).
template <typename T, typename V = T>
int launch_sdia_sym(const V* vals, const int* offsets, int D,
                    int64_t n_vals_rows, int64_t x_len, int64_t y_len,
                    int stage_x, const T* x, int64_t xs, T* y, int64_t ys,
                    int nr, cudaStream_t stream) {
  const bool ok = with_rhs(nr, [&](auto r) {
    constexpr int R = decltype(r)::value;
    // rows past the value rows get nothing
    const int64_t rows = y_len < n_vals_rows ? y_len : n_vals_rows;
    if (rows > 0 && D > 0)
      sdia_sym_kernel<T, R, V>
          <<<blocks_for(rows, kSdiaRows), kSdiaRows * kSdiaSlices, 0,
             stream>>>(vals, offsets, D, n_vals_rows, x, x_len, xs, y, y_len,
                       ys, nr, stage_x != 0);
  });
  return ok ? static_cast<int>(cudaGetLastError()) : invalid();
}

// The arguments of sdia_gen_kernel past its template ones.
template <typename T, typename V>
struct GenArgs {
  const V* vals;
  const int* offsets;
  int D;
  int64_t nv_rows, n_rows;
  const T* x;
  int64_t x_len;
  T* y;
  int64_t ys;
  int nr;
};

template <int R, int kSlices, bool kStore, typename T, typename V>
void launch_sdia_gen(const GenArgs<T, V>& a, cudaStream_t stream) {
  sdia_gen_kernel<R, kSlices, kStore, T, V>
      <<<blocks_for(a.n_rows, kGenThreads / kSlices), kGenThreads, 0,
         stream>>>(a.vals, a.offsets, a.D, a.nv_rows, a.n_rows, a.x, a.x_len,
                   a.y, a.ys, a.nr);
}

template <int R, int kSlices, bool kStore>
void launch_sdia_staged(const GenArgs<double, double>& a, int hi, int span,
                        cudaStream_t stream) {
  sdia_gen_staged_kernel<R, kSlices, kStore>
      <<<blocks_for(a.n_rows, kGenThreads / kSlices), kGenThreads, 0,
         stream>>>(a.vals, a.offsets, a.D, a.nv_rows, a.n_rows, a.x, a.x_len,
                   hi, span, a.y, a.ys, a.nr);
}

// sdia_gen_staged_kernel at 1, 2, 4 or 8 slices; false for another count.
template <int R, bool kStore>
bool launch_staged_slices(const GenArgs<double, double>& a, int slices,
                          int hi, int span, cudaStream_t stream) {
  switch (slices) {
    case 1: launch_sdia_staged<R, 1, kStore>(a, hi, span, stream); break;
    case 2: launch_sdia_staged<R, 2, kStore>(a, hi, span, stream); break;
    case 4: launch_sdia_staged<R, 4, kStore>(a, hi, span, stream); break;
    case 8: launch_sdia_staged<R, 8, kStore>(a, hi, span, stream); break;
    default: return false;
  }
  return true;
}

// slices: threads a row, 1 or 2 (sdia_kernel.gen_slices), or, staged, 1,
// 2, 4 or 8 (sdia_kernel.stage_slices); store: write the y_len rows of
// each plane (0 past nv_rows) instead of adding into the rows below
// nv_rows. x: the plane (nr = 1) or the group's interleaved (x_len, R)
// block, R the instance's width (xs is not read). span >= 0 (double only,
// at most kGenSpan): stage x over the offsets' window, hi the largest
// offset and span the largest less the smallest (sdia_kernel.gen_window).
template <typename T, typename V>
int run_sdia_gen(const V* vals, const int* offsets, int D, int64_t nv_rows,
                 int64_t y_len, int64_t x_len, int slices, int store, int hi,
                 int span, const T* x, T* y, int64_t ys, int nr,
                 cudaStream_t stream) {
  constexpr bool kDouble = std::is_same_v<T, double>;
  const bool staged = span >= 0;
  if (staged ? !kDouble || span > kGenSpan
             : slices != 1 && slices != 2)
    return invalid();
  const int64_t n_rows = store || y_len < nv_rows ? y_len : nv_rows;
  bool fit = true;
  const bool ok = with_rhs(nr, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (n_rows <= 0 || (D <= 0 && !store)) return;
    const GenArgs<T, V> a{vals, offsets, D, nv_rows, n_rows, x, x_len, y, ys,
                          nr};
    if constexpr (kDouble) {
      if (staged) {
        fit = store ? launch_staged_slices<R, true>(a, slices, hi, span,
                                                    stream)
                    : launch_staged_slices<R, false>(a, slices, hi, span,
                                                     stream);
        return;
      }
    }
    if (store)
      slices == 1 ? launch_sdia_gen<R, 1, true>(a, stream)
                  : launch_sdia_gen<R, 2, true>(a, stream);
    else
      slices == 1 ? launch_sdia_gen<R, 1, false>(a, stream)
                  : launch_sdia_gen<R, 2, false>(a, stream);
  });
  return ok && fit ? static_cast<int>(cudaGetLastError()) : invalid();
}

// Chunks a walk of ``kernel`` takes on a stream of C chunks, for CTAs of
// ``groups`` walks of 128 threads: the fewest that make every walk resident
// at once (one wave, no tail), and at most max_walk, past which a longer
// walk only lengthens its chain of dependent loads. ``threads`` (default
// 128 a walk) and ``smem`` (dynamic shared memory) of one CTA.
template <class Kernel>
int walk_for(Kernel kernel, int64_t C, int max_walk, int groups = 1,
             int threads = 0, size_t smem = 0) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads > 0 ? threads : kLanes * groups, smem);
  const int64_t resident = static_cast<int64_t>(sms) * per_sm * groups;
  if (resident <= 0 || C > resident * max_walk) return max_walk;
  return C <= resident ? 1 : static_cast<int>((C + resident - 1) / resident);
}

// The zero pass before the grid kernels. tiles: the rows of 128 of each
// output plane to zero with cudaMemset2DAsync (a stream that visits every
// block); 0 runs the zero kernel, which leaves unvisited blocks as they
// are.
template <typename T>
cudaError_t zero_pass(const int* step_block, int64_t C, int K, int BT,
                      int64_t tiles, T* y, int64_t ys, int nr,
                      cudaStream_t stream) {
  if (tiles > 0) {
    const size_t width = static_cast<size_t>(tiles) * kLanes * sizeof(T);
    return cudaMemset2DAsync(y, nr == 1 ? width : ys * sizeof(T), 0, width,
                             nr, stream);
  }
  bell2_zero_blocks_kernel<T>
      <<<dim3(static_cast<unsigned int>(C / K), nr), 256, 0, stream>>>(
          step_block, BT, y, ys);
  return cudaSuccess;
}

// Chunks a walk of bell2_walks_kernel takes on C chunks: as many as keep
// every walk resident, with no cap.
template <int kGroups, typename V>
int group_walk(int64_t C, int contig) {
  constexpr int kUncapped = 1 << 30;
  return contig ? walk_for(bell2_walks_kernel<true, V, kGroups>, C, kUncapped,
                           kGroups)
                : walk_for(bell2_walks_kernel<false, V, kGroups>, C,
                           kUncapped, kGroups);
}

template <int kGroups, typename V>
void launch_walks(const V* vals, const int16_t* packed, const int* meta,
                  const int* step_block, int64_t C, int K, int BT, int contig,
                  int cpc, const float* x, float* y, cudaStream_t stream) {
  const unsigned int grid = blocks_for(blocks_for(C, cpc), kGroups);
  if (contig)
    bell2_walks_kernel<true, V, kGroups>
        <<<grid, kLanes * kGroups, 0, stream>>>(vals, packed, meta,
                                                step_block, C, K, BT, cpc, x,
                                                y);
  else
    bell2_walks_kernel<false, V, kGroups>
        <<<grid, kLanes * kGroups, 0, stream>>>(vals, packed, meta,
                                                step_block, C, K, BT, cpc, x,
                                                y);
}

// One plane in float: bell2_walks_kernel (kWalkGroups walks a CTA).
// Otherwise bell2_spmv_kernel walking kWalk chunks a CTA over a group of R
// planes; kInterleaved: R > 1 planes are an interleaved block of R planes
// an element.
template <int R, typename T, int kWalk, bool kInterleaved, typename V>
void launch_grid(const V* vals, const int16_t* packed, const int* meta,
                 const int* step_block, int64_t C, int K, int BT, int contig,
                 const T* x, int64_t xs, T* y, int64_t ys, int nr,
                 cudaStream_t stream) {
  if constexpr (R == 1 && std::is_same_v<T, float>) {
    launch_walks<kWalkGroups>(vals, packed, meta, step_block, C, K, BT,
                              contig, group_walk<kWalkGroups, V>(C, contig),
                              x, y, stream);
  } else {
    constexpr bool X = R > 1 && kInterleaved;
    const unsigned int grid = blocks_for(C, kWalk);
    if (contig)
      bell2_spmv_kernel<true, R, T, kWalk, X, V>
          <<<grid, kLanes, 0, stream>>>(vals, packed, meta, step_block, C, K,
                                        BT, x, xs, y, ys, nr);
    else
      bell2_spmv_kernel<false, R, T, kWalk, X, V>
          <<<grid, kLanes, 0, stream>>>(vals, packed, meta, step_block, C, K,
                                        BT, x, xs, y, ys, nr);
  }
}

// The zero pass (tiles: as zero_pass), then launch_grid.
template <typename T, int kWalk, bool kInterleaved, typename V = T>
int launch_bell2_spmv(const V* vals, const int16_t* packed, const int* meta,
                      const int* step_block, int64_t C, int K, int BT,
                      int contig, int64_t tiles, const T* x, int64_t xs,
                      T* y, int64_t ys, int nr, cudaStream_t stream) {
  if (tiles < 0) return invalid();
  cudaError_t err = cudaSuccess;
  const bool ok = with_rhs(nr, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (C <= 0) return;
    err = zero_pass<T>(step_block, C, K, BT, tiles, y, ys, nr, stream);
    if (err != cudaSuccess) return;
    launch_grid<R, T, kWalk, kInterleaved>(vals, packed, meta, step_block, C,
                                           K, BT, contig, x, xs, y, ys, nr,
                                           stream);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return ok ? static_cast<int>(cudaGetLastError()) : invalid();
}

template <typename T, typename V = T>
int launch_bell2_entries(const int* rows, const int* cols, const V* vals,
                         int64_t E, const T* x, int64_t xs, T* y, int64_t ys,
                         int nr, cudaStream_t stream) {
  const bool ok = with_rhs(nr, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (E > 0)
      bell2_entries_kernel<R, T, V>
          <<<blocks_for(E, kEntryThreads), kEntryThreads, 0, stream>>>(
              rows, cols, vals, E, x, xs, y, ys, nr);
  });
  return ok ? static_cast<int>(cudaGetLastError()) : invalid();
}

// bell2_entries_kernel_rows over nb CTAs (tiles: nb + 1 coordinates), then,
// where there is more than one CTA, its carries.
int launch_entries_rows(const int* ptr, const int* cols, const float* vals,
                        const int* tiles, int64_t nb, const float* diag,
                        const float* x, float* y, int* carry_row,
                        float* carry_val, int64_t n, cudaStream_t stream) {
  if (nb < 1 || nb > INT32_MAX || n < 0 || n > INT32_MAX) return invalid();
  if (n == 0) return static_cast<int>(cudaGetLastError());
  // the carveout, once a device (a function's attribute is the current
  // device's), before any capture: the first apply on a device is eager
  static std::atomic<uint64_t> carved{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(carved.load() & bit)) {
    err = cudaFuncSetAttribute(bell2_entries_kernel_rows,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               kRowsCarveout);
    if (err != cudaSuccess) return static_cast<int>(err);
    carved.fetch_or(bit);
  }
  bell2_entries_kernel_rows<<<static_cast<unsigned int>(nb), kRowsThreads, 0,
                              stream>>>(
      ptr, cols, vals, tiles, diag, x, y, carry_row, carry_val);
  if (nb > 1)
    bell2_entries_kernel_rows_carry<<<blocks_for(nb, kCarryThreads),
                                      kCarryThreads, 0, stream>>>(
        carry_row, carry_val, static_cast<int>(nb), static_cast<int>(n), y);
  return static_cast<int>(cudaGetLastError());
}

// Chunks a CTA of sbell_spmv_kernel<TW, R, T, V> walks on a stream of C
// chunks.
template <int TW, int R, typename T = float, typename V = T>
int chunks_per_cta(int64_t C) {
  return walk_for(sbell_spmv_kernel<TW, R, T, V>, C, kMaxWalk);
}

template <int TW, int R, typename T, typename V>
void launch_sbell(const V* vals, const int* packed, const int* meta,
                  const int* step_block, int64_t C, int K, int BT, const T* x,
                  int64_t xs, T* y, int64_t ys, int nr, cudaStream_t stream) {
  const int cpc = chunks_per_cta<TW, R, T, V>(C);
  sbell_spmv_kernel<TW, R, T, V><<<blocks_for(C, cpc), kLanes, 0, stream>>>(
      vals, packed, meta, step_block, C, K, BT, cpc, x, xs, y, ys, nr);
}

// The form of sbell_planes_kernel that ships: one group of 128 threads a
// CTA (two, sharing the planes, measured slower), x read as pairs of planes
// (plane by plane measured slower; chip_smoke.py's F64_FORMS_SRC).
constexpr int kPlanesGroups = 1;
constexpr bool kPlanesPairs = true;

// Raises the dynamic shared memory sbell_planes_kernel<TW, R, G, kKeep>
// may take to what it takes (past the 48 KB a CTA has by default).
template <int TW, int R, int G, bool kKeep = true, bool kPairs = false>
cudaError_t planes_attr() {
  return cudaFuncSetAttribute(
      sbell_planes_kernel<TW, R, G, kKeep, kPairs>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(PlanesLayout<TW, R, G>::kBytes));
}

// Chunks a CTA of sbell_planes_kernel<TW, R, G, kKeep> walks on C chunks
// (after planes_attr).
template <int TW, int R, int G, bool kKeep = true, bool kPairs = false>
int planes_walk(int64_t C) {
  return walk_for(sbell_planes_kernel<TW, R, G, kKeep, kPairs>, C, kMaxWalk, 1,
                  kLanes * G, PlanesLayout<TW, R, G>::kBytes);
}

// sbell_planes_kernel over a group of nr <= R planes, walking cpc chunks
// a CTA (0: planes_walk); returns a refused attribute or launch.
template <int TW, int R, int G, bool kKeep = true, bool kPairs = false>
cudaError_t launch_sbell_planes(const double* vals, const int* packed,
                                const int* meta, const int* step_block,
                                int64_t C, int K, int BT, int cpc,
                                const double* x, int64_t xs, double* y,
                                int64_t ys, int nr, cudaStream_t stream) {
  const cudaError_t err = planes_attr<TW, R, G, kKeep, kPairs>();
  if (err != cudaSuccess) return err;
  if (cpc < 1) cpc = planes_walk<TW, R, G, kKeep, kPairs>(C);
  sbell_planes_kernel<TW, R, G, kKeep, kPairs>
      <<<blocks_for(C, cpc), kLanes * G, PlanesLayout<TW, R, G>::kBytes,
         stream>>>(vals, packed, meta, step_block, C, K, BT, cpc, x, xs, y,
                   ys, nr);
  return cudaGetLastError();
}

// tiles: the rows of 128 of each output plane, all zeroed first. One plane
// runs sbell_spmv_kernel; more than one in double sbell_planes_kernel.
template <typename T, typename V>
int run_sbell(const V* vals, const int* packed, const int* meta,
              const int* step_block, int64_t C, int K, int BT, int TW,
              int64_t tiles, const T* x, int64_t xs, T* y, int64_t ys, int nr,
              cudaStream_t stream) {
  if (TW != 2 && TW != 4) return invalid();
  cudaError_t err = cudaSuccess;
  const bool ok = with_rhs(nr, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (C <= 0) return;
    const size_t width = static_cast<size_t>(tiles) * kLanes * sizeof(T);
    err = cudaMemset2DAsync(y, nr == 1 ? width : ys * sizeof(T), 0, width,
                            nr, stream);
    if (err != cudaSuccess) return;
    if constexpr (std::is_same_v<T, double> && R > 1) {
      err = TW == 2
                ? launch_sbell_planes<2, R, kPlanesGroups, true, kPlanesPairs>(
                      vals, packed, meta, step_block, C, K, BT, 0, x, xs, y,
                      ys, nr, stream)
                : launch_sbell_planes<4, R, kPlanesGroups, true, kPlanesPairs>(
                      vals, packed, meta, step_block, C, K, BT, 0, x, xs, y,
                      ys, nr, stream);
    } else if (TW == 2) {
      launch_sbell<2, R, T>(vals, packed, meta, step_block, C, K, BT, x, xs,
                            y, ys, nr, stream);
    } else {
      launch_sbell<4, R, T>(vals, packed, meta, step_block, C, K, BT, x, xs,
                            y, ys, nr, stream);
    }
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return ok ? static_cast<int>(cudaGetLastError()) : invalid();
}

// Shared memory a CTA of ``kernel`` takes: its static arrays and ``dyn``.
template <class Kernel>
int smem_of(Kernel kernel, size_t dyn = 0) {
  cudaFuncAttributes fa{};
  if (cudaFuncGetAttributes(&fa, kernel) != cudaSuccess) return -1;
  return static_cast<int>(fa.sharedSizeBytes + dyn);
}

}  // namespace

extern "C" {

// Every stream entry point ends in (x, xs, y, ys, nr, stream): x and y as
// stacks of nr planes (nr = 1 for SpMV) at plane strides xs and ys, in
// elements. x_len and y_len are per-plane lengths.

int cfs_sdia_sym(const float* vals, const int* offsets, int D,
                 int64_t n_vals_rows, int64_t x_len, int64_t y_len,
                 int stage_x, const float* x, int64_t xs, float* y,
                 int64_t ys, int nr, cudaStream_t stream) {
  return launch_sdia_sym<float>(vals, offsets, D, n_vals_rows, x_len, y_len,
                                stage_x, x, xs, y, ys, nr, stream);
}

int cfs_sdia_sym_f64(const double* vals, const int* offsets, int D,
                     int64_t n_vals_rows, int64_t x_len, int64_t y_len,
                     int stage_x, const double* x, int64_t xs, double* y,
                     int64_t ys, int nr, cudaStream_t stream) {
  return launch_sdia_sym<double>(vals, offsets, D, n_vals_rows, x_len, y_len,
                                 stage_x, x, xs, y, ys, nr, stream);
}

int cfs_sdia_sym_bf16(const __nv_bfloat16* vals, const int* offsets, int D,
                      int64_t n_vals_rows, int64_t x_len, int64_t y_len,
                      int stage_x, const float* x, int64_t xs, float* y,
                      int64_t ys, int nr, cudaStream_t stream) {
  return launch_sdia_sym<float>(vals, offsets, D, n_vals_rows, x_len, y_len,
                                stage_x, x, xs, y, ys, nr, stream);
}

// The signed diagonal kernel (run_sdia_gen above) over float, double or
// bf16 values; xs is not read. In double, x is the plane or the group's
// interleaved block of doubles (read in 16-byte loads), and span >= 0
// stages it (hi, span: run_sdia_gen); float and bf16 take span = -1.
int cfs_sdia_gen(const float* vals, const int* offsets, int D, int64_t nv_rows,
                 int64_t y_len, int64_t x_len, int slices, int store, int hi,
                 int span, const float* x, int64_t xs, float* y, int64_t ys,
                 int nr, cudaStream_t stream) {
  return run_sdia_gen(vals, offsets, D, nv_rows, y_len, x_len, slices, store,
                      hi, span, x, y, ys, nr, stream);
}

int cfs_sdia_gen_f64(const double* vals, const int* offsets, int D,
                     int64_t nv_rows, int64_t y_len, int64_t x_len,
                     int slices, int store, int hi, int span,
                     const double* x, int64_t xs, double* y, int64_t ys,
                     int nr, cudaStream_t stream) {
  return run_sdia_gen(vals, offsets, D, nv_rows, y_len, x_len, slices, store,
                      hi, span, x, y, ys, nr, stream);
}

int cfs_sdia_gen_bf16(const __nv_bfloat16* vals, const int* offsets, int D,
                      int64_t nv_rows, int64_t y_len, int64_t x_len,
                      int slices, int store, int hi, int span,
                      const float* x, int64_t xs, float* y, int64_t ys,
                      int nr, cudaStream_t stream) {
  return run_sdia_gen(vals, offsets, D, nv_rows, y_len, x_len, slices, store,
                      hi, span, x, y, ys, nr, stream);
}

// The row-major diagonal kernel (sdia_sym_rows_kernel) over a group of an
// even nr <= 8 columns: X's and Y's rows at stride ld, x and y at the
// group's first column (xs and ys are not read).
int cfs_sdia_sym_rows_f64(const double* vals, const int* offsets, int D,
                          int64_t n_vals_rows, int64_t n, int64_t ld,
                          const double* x, int64_t xs, double* y, int64_t ys,
                          int nr, cudaStream_t stream) {
  if (nr < 2 || nr % 2) return invalid();
  const bool ok = with_rhs(nr, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if constexpr (R > 1) {
      if (n > 0)
        sdia_sym_rows_kernel<R><<<blocks_for(n, kRowsCta), kRowsCta, 0,
                                  stream>>>(vals, offsets, D, n_vals_rows, n,
                                            ld, x, y, nr);
    }
  });
  return ok ? static_cast<int>(cudaGetLastError()) : invalid();
}

// Shared memory a CTA of the double signed diagonal kernel takes for a
// group of nr planes at ``slices``, staged (1) or not (0); -1 for no
// instance.
int cfs_sdia_gen_smem_f64(int nr, int slices, int staged) {
  int bytes = -1;
  with_rhs(nr, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (staged) {
      if (slices == 1) bytes = smem_of(sdia_gen_staged_kernel<R, 1, false>);
      if (slices == 2) bytes = smem_of(sdia_gen_staged_kernel<R, 2, false>);
      if (slices == 4) bytes = smem_of(sdia_gen_staged_kernel<R, 4, false>);
      if (slices == 8) bytes = smem_of(sdia_gen_staged_kernel<R, 8, false>);
    } else {
      if (slices == 1) bytes = smem_of(sdia_gen_kernel<R, 1, false, double>);
      if (slices == 2) bytes = smem_of(sdia_gen_kernel<R, 2, false, double>);
    }
  });
  return bytes;
}

// The paired stream (run_sbell above) over float, double or bf16 values.
int cfs_sbell_spmv(const float* vals, const int* packed, const int* meta,
                   const int* step_block, int64_t C, int K, int BT, int TW,
                   int64_t tiles, const float* x, int64_t xs, float* y,
                   int64_t ys, int nr, cudaStream_t stream) {
  return run_sbell(vals, packed, meta, step_block, C, K, BT, TW, tiles, x, xs,
                   y, ys, nr, stream);
}

int cfs_sbell_spmv_f64(const double* vals, const int* packed,
                       const int* meta, const int* step_block, int64_t C,
                       int K, int BT, int TW, int64_t tiles, const double* x,
                       int64_t xs, double* y, int64_t ys, int nr,
                       cudaStream_t stream) {
  return run_sbell(vals, packed, meta, step_block, C, K, BT, TW, tiles, x, xs,
                   y, ys, nr, stream);
}

int cfs_sbell_spmv_bf16(const __nv_bfloat16* vals, const int* packed,
                        const int* meta, const int* step_block, int64_t C,
                        int K, int BT, int TW, int64_t tiles, const float* x,
                        int64_t xs, float* y, int64_t ys, int nr,
                        cudaStream_t stream) {
  return run_sbell(vals, packed, meta, step_block, C, K, BT, TW, tiles, x, xs,
                   y, ys, nr, stream);
}

// The walk of the float (double = 0) or double (double = 1) paired
// kernel on C chunks for a group of nr planes; 0 for no instance.
int cfs_sbell_chunks_per_cta(int64_t C, int TW, int nr, int dbl) {
  int cpc = 0;
  with_rhs(nr, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (!dbl) {
      cpc = TW == 2 ? chunks_per_cta<2, R>(C) : chunks_per_cta<4, R>(C);
    } else if constexpr (R == 1) {
      cpc = TW == 2 ? chunks_per_cta<2, 1, double>(C)
                    : chunks_per_cta<4, 1, double>(C);
    } else if (TW == 2) {
      if (planes_attr<2, R, kPlanesGroups, true, kPlanesPairs>() ==
          cudaSuccess)
        cpc = planes_walk<2, R, kPlanesGroups, true, kPlanesPairs>(C);
    } else if (planes_attr<4, R, kPlanesGroups, true, kPlanesPairs>() ==
               cudaSuccess) {
      cpc = planes_walk<4, R, kPlanesGroups, true, kPlanesPairs>(C);
    }
  });
  return cpc;
}

// Shared memory a CTA of the float (double = 0) or double (double = 1)
// paired kernel takes for a group of nr planes, dynamic included; -1 for
// no instance.
int cfs_sbell_smem(int TW, int nr, int dbl) {
  int bytes = -1;
  with_rhs(nr, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (!dbl) {
      bytes = TW == 2 ? smem_of(sbell_spmv_kernel<2, R>)
                      : smem_of(sbell_spmv_kernel<4, R>);
    } else if constexpr (R == 1) {
      bytes = TW == 2 ? smem_of(sbell_spmv_kernel<2, 1, double>)
                      : smem_of(sbell_spmv_kernel<4, 1, double>);
    } else if (TW == 2) {
      bytes = smem_of(
          sbell_planes_kernel<2, R, kPlanesGroups, true, kPlanesPairs>,
          PlanesLayout<2, R, kPlanesGroups>::kBytes);
    } else {
      bytes = smem_of(
          sbell_planes_kernel<4, R, kPlanesGroups, true, kPlanesPairs>,
          PlanesLayout<4, R, kPlanesGroups>::kBytes);
    }
  });
  return bytes;
}

// tiles > 0 (the rows of 128 of each output plane): the stream visits
// every block, and the whole planes are zeroed by cudaMemset2DAsync; 0:
// the zero kernel, visited blocks only. The float stream takes the walk
// groups for one plane and walks kInterleavedWalk chunks a CTA for more,
// and x is the plane (nr = 1) or the group's interleaved (x_rows * 128, R)
// block, R the instance's width: 2 for nr = 2, 4 for 3-4, 8 for 5-8 (xs is
// not read). The double one walks kDoubleWalk; x: planes at plane stride
// xs.
int cfs_bell2_spmv(const float* vals, const int16_t* packed, const int* meta,
                   const int* step_block, int64_t C, int K, int BT,
                   int contig, int64_t tiles, const float* x, int64_t xs,
                   float* y, int64_t ys, int nr, cudaStream_t stream) {
  return launch_bell2_spmv<float, kInterleavedWalk, true>(
      vals, packed, meta, step_block, C, K, BT, contig, tiles, x, xs, y, ys,
      nr, stream);
}

int cfs_bell2_spmv_f64(const double* vals, const int16_t* packed,
                       const int* meta, const int* step_block, int64_t C,
                       int K, int BT, int contig, int64_t tiles,
                       const double* x, int64_t xs, double* y, int64_t ys,
                       int nr, cudaStream_t stream) {
  return launch_bell2_spmv<double, kDoubleWalk, false>(
      vals, packed, meta, step_block, C, K, BT, contig, tiles, x, xs, y, ys,
      nr, stream);
}

int cfs_bell2_spmv_bf16(const __nv_bfloat16* vals, const int16_t* packed,
                        const int* meta, const int* step_block, int64_t C,
                        int K, int BT, int contig, int64_t tiles,
                        const float* x, int64_t xs, float* y, int64_t ys,
                        int nr, cudaStream_t stream) {
  return launch_bell2_spmv<float, kInterleavedWalk, true>(
      vals, packed, meta, step_block, C, K, BT, contig, tiles, x, xs, y, ys,
      nr, stream);
}

int cfs_bell2_entries(const int* rows, const int* cols, const float* vals,
                      int64_t E, const float* x, int64_t xs, float* y,
                      int64_t ys, int nr, cudaStream_t stream) {
  return launch_bell2_entries<float>(rows, cols, vals, E, x, xs, y, ys, nr,
                                     stream);
}

int cfs_bell2_entries_f64(const int* rows, const int* cols,
                          const double* vals, int64_t E, const double* x,
                          int64_t xs, double* y, int64_t ys, int nr,
                          cudaStream_t stream) {
  return launch_bell2_entries<double>(rows, cols, vals, E, x, xs, y, ys, nr,
                                      stream);
}

int cfs_bell2_entries_bf16(const int* rows, const int* cols,
                           const __nv_bfloat16* vals, int64_t E,
                           const float* x, int64_t xs, float* y, int64_t ys,
                           int nr, cudaStream_t stream) {
  return launch_bell2_entries<float>(rows, cols, vals, E, x, xs, y, ys, nr,
                                     stream);
}

// y (n,) = D x + R x, R the row-sorted entries (cols, vals) under the row
// pointers ptr (n + 1), over nb CTAs of kRowsItems path items starting at
// tiles (nb + 1, 2: row, entry), cut for items a CTA (which must be
// kRowsItems); carry_row and carry_val hold nb each. Launches 1 kernel, 2
// where nb > 1.
int cfs_bell2_entries_rows(const int* ptr, const int* cols, const float* vals,
                           const int* tiles, int64_t nb, const float* diag,
                           const float* x, float* y, int* carry_row,
                           float* carry_val, int64_t n, int items,
                           cudaStream_t stream) {
  if (items != kRowsItems) return invalid();
  return launch_entries_rows(ptr, cols, vals, tiles, nb, diag, x, y, carry_row,
                             carry_val, n, stream);
}

// mode 0: out = P g over n_gather rows; 1: out = diag x + P g over n_out
// rows (the seed at x[o * x_row + b * x_col] for o < n_seed); 2: out +=
// P g over n_out rows. Planes at strides gs and os.
int cfs_unperm_gather(const int* pk, const int* rows, int W, const float* g,
                      int64_t gs, float* out, int64_t os, int64_t n_gather,
                      int64_t n_out, const float* diag, const float* x,
                      int64_t x_row, int64_t x_col, int64_t n_seed, int mode,
                      int B, cudaStream_t stream) {
  if (B < 1 || mode < kGather || mode > kInto) return invalid();
  if (n_out > 0) {
    constexpr int kThreads = 256;
    const unsigned int grid = blocks_for(n_out, kThreads);
    if (mode == kGather)
      unperm_gather_kernel<kGather><<<grid, kThreads, 0, stream>>>(
          pk, rows, W, g, gs, out, os, n_gather, n_out, diag, x, x_row, x_col,
          n_seed, B);
    else if (mode == kSeed)
      unperm_gather_kernel<kSeed><<<grid, kThreads, 0, stream>>>(
          pk, rows, W, g, gs, out, os, n_gather, n_out, diag, x, x_row, x_col,
          n_seed, B);
    else
      unperm_gather_kernel<kInto><<<grid, kThreads, 0, stream>>>(
          pk, rows, W, g, gs, out, os, n_gather, n_out, diag, x, x_row, x_col,
          n_seed, B);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cfs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
