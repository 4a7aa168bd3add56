// DIA SpMV for Hopper (sm_90a): the resident and the column-tiled kernel.
//
// Replaces the TPU kernels src/repro/kernels/dia_spmv.py:58 (dia_spmv) and
// src/repro/kernels/dia_spmv.py:135 (dia_spmv_tiled).
//
// Bound: bytes. Each stored diagonal value is read once (ndiags * nrows *
// sizeof(T)), x once and y written once; 2 flops per value. At HPCG 104^3
// in f32 that is about 130 MB, 39 us at 3.35 TB/s. A masked call (one
// multicolor SymGS color) needs only its rows' values, the x words they
// read and y: an eighth of the values on the 27-point stencil.
//
// Design (resident, dia_resident_kernel). One thread per row, the offsets
// in shared memory. For a fixed diagonal the 32 threads of a warp read 32
// consecutive data values and 32 consecutive x values, so both loads
// coalesce; a bounds check on the column replaces the zero-padded copy of x
// the TPU wrapper builds.
//  - Load before adding. A thread takes its diagonals in batches of a
//    compile-time size B and issues every data and x load of a batch before
//    the batch's first add, so a row has 2B loads in flight instead of one
//    pair: the adds must stay in ascending d, separately rounded, and a
//    loop that adds as it loads waits out one round trip per diagonal. The
//    27-point stencil (27 diagonals) is one batch, fully unrolled in
//    registers; other counts take batches of 8, the last one cut short.
//  - Stream what L2 cannot keep. When the values exceed half of L2 they
//    are read with __ldcs (evict first), so the x words that 27 rows share
//    stay in L2: 10% off at 104^3, and 14% more at 52^3, where the values
//    stay in L2 between calls if read as usual (PERF.md, PR 16).
//  - Spread small grids over the card. A CTA has 256 threads when the grid
//    then has at least two CTAs per SM, else 128, 64 or 32: HPCG's 13^3
//    level (2,197 rows) runs 69 CTAs of one warp instead of 9 of 256.
//  - The row mask (one byte per row) goes into the kernel: a masked-out row
//    loads nothing and writes 0, so one multicolor SymGS color runs without
//    a masked copy of data. A color of the 27-point stencil keeps every
//    other row of every fourth x-line, so a warp of consecutive rows has at
//    most 16 of its 32 lanes at work, and most warps none. With the list of
//    the mask's rows (built once per mask on the device and cached by the
//    wrapper), thread t computes the list's row t and writes 0 to row t
//    when it is masked out: every lane of a working warp works. The values
//    a color needs lie every other word, so the sectors it reads hold
//    twice the bytes it needs either way. The wrapper takes the list from
//    65,536 rows (PERF.md, PR 16: 15-20% faster at 52^3 and 104^3, 1-4%
//    slower at 26^3 and 13^3).
//
// Design (tiled, dia_tiled_kernel). The TPU grid visits every (row block,
// column tile) pair and carries partial y across the sequential tile axis.
// Here one thread owns one row and walks, in ascending tile order, the
// tiles its warp's active rows can reach, [(i + min_off) / ct, (i +
// max_off) / ct]; in each it sums the tile's slots into acc_t in slot order
// and then adds acc_t to y (__fadd_rn): the reference's association. x is
// read directly; no haloed copies are built. A slot is added for row i
// when its window position p = i + off - t * ct lies in [0, min(ct, ncols
// - t * ct)); a slot out of range is skipped, not added as 0.
//  - A row needs only 27 of the ~63 slots of the 2-3 tiles it reaches
//    (HPCG 104^3 under 1 << 18 columns: ct = 16,384, 69 tiles, max_d 27, a
//    band of +-10,921; a tile holds 9 or 18 of a row's diagonals). So per
//    tile the warp first votes which slots any of its rows needs (lane l
//    tests slot l against the warp's row range), and each lane then loads
//    the needed slots in batches of 9, every in-range load of a batch
//    before its first add: three batches a row.
//  - A warp whose rows the mask all drops does nothing but write 0.
//  - The offsets of the tiles a CTA reaches go into shared memory once (at
//    most 3 tiles for 256 rows at 104^3); where they exceed 48 KB the CTA
//    takes its tiles in groups that fit.
//  - Windows that exceed half of L2 are read with __ldcs, as the resident
//    kernel's values, and small grids take small CTAs.
//  - What registers allow sets the pace (examples/dia_kernel_ab.py at
//    104^3, device time, H100 80GB HBM3 at 700 W; PERF.md): a batch of all
//    27 slots a tile, fully unrolled, each behind its own predicate, took
//    139 registers (one CTA of 256 an SM) and 0.330 ms, 3.3x the loop it
//    replaced (0.099); with the next tile's loads issued before the current
//    tile's adds 0.197, with a warp skipping slots none of its lanes needs
//    0.193. With the vote: batches of 8 (46 registers) 0.063, 9 (48)
//    0.0599, 12 (54) 0.0645, 16 (64) 0.0664, 32 (96) 0.102; asking L2 for
//    every tile's values first, 0.090; one walk of batches across tiles,
//    0.097-0.17; batches of 9 under 40 registers, 0.0571.
// The bound is the resident kernel's: the plan's windows hold each stored
// value once (plus the slots that pad a tile to max_d), read once.
//
// Both kernels accumulate in f32 with separately rounded multiply and add
// (common.cuh: mul_add_rn), in the order of the plain PyTorch versions in
// kernels/dia_spmv.py, and write y in the storage type.

#include <algorithm>
#include <cstdlib>

#include "common.cuh"

namespace repro {

// Adds the products of diagonals [d0, d0 + nd) of row i to acc in
// ascending d (nd <= B): every load first, then the adds. kStream reads
// the values as a stream that L2 keeps last (__ldcs).
template <typename T, int B, bool kStream>
__device__ __forceinline__ float dia_batch(float acc, const int32_t* s_off,
                                           const T* __restrict__ data,
                                           const float* __restrict__ x, int d0, int nd,
                                           int64_t i, int64_t nrows, int64_t ncols) {
  float v[B], xv[B];
  bool in[B];
#pragma unroll
  for (int u = 0; u < B; ++u) {
    in[u] = false;
    v[u] = xv[u] = 0.f;
    if (u < nd) {
      const int64_t k = i + s_off[d0 + u];
      in[u] = k >= 0 && k < ncols;
      const T* p = data + static_cast<int64_t>(d0 + u) * nrows + i;
      v[u] = to_f32(kStream ? __ldcs(p) : *p);
      if (in[u]) xv[u] = __ldg(x + k);
    }
  }
#pragma unroll
  for (int u = 0; u < B; ++u)
    if (in[u]) acc = mul_add_rn(acc, v[u], xv[u]);
  return acc;
}

// kFixed: ndiags == B, one batch with no bound on it.
template <typename T, int B, bool kFixed, bool kStream>
__global__ void dia_resident_kernel(const int32_t* __restrict__ offsets,
                                    const T* __restrict__ data,
                                    const float* __restrict__ x,
                                    const uint8_t* __restrict__ mask,
                                    const int32_t* __restrict__ rows, int64_t nlist,
                                    T* __restrict__ y, int ndiags,
                                    int64_t nrows, int64_t ncols) {
  extern __shared__ int32_t s_off[];
  for (int d = threadIdx.x; d < ndiags; d += blockDim.x) s_off[d] = offsets[d];
  __syncthreads();
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t i = t;
  if (rows != nullptr) {
    // a list of the mask's rows: thread t writes 0 to row t when it is
    // masked out, and computes the list's row t
    if (t < nrows && !mask[t]) y[t] = from_f32<T>(0.f);
    if (t >= nlist) return;
    i = rows[t];
  } else {
    if (i >= nrows) return;
    if (mask != nullptr && !mask[i]) {
      y[i] = from_f32<T>(0.f);
      return;
    }
  }
  float acc = 0.f;
  if (kFixed) {
    acc = dia_batch<T, B, kStream>(acc, s_off, data, x, 0, B, i, nrows, ncols);
  } else {
    for (int d0 = 0; d0 < ndiags; d0 += B)
      acc = dia_batch<T, B, kStream>(acc, s_off, data, x, d0, min(B, ndiags - d0), i, nrows,
                                     ncols);
  }
  y[i] = from_f32<T>(acc);
}

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// floor(a / ct), the tile of column a, clamped to the tiles [0, ntiles).
__device__ __forceinline__ int tile_of(int64_t a, int ct, int ntiles) {
  const int64_t t = floor_div(a, ct);
  return t < 0 ? 0 : (t >= ntiles ? ntiles - 1 : static_cast<int>(t));
}

constexpr unsigned kFull = 0xffffffffu;

// The slots [c0, c0 + 32) of a tile that any of the warp's rows [r_lo,
// r_hi] needs, one bit each: lane l tests slot c0 + l. so: the tile's
// offsets; t_ct = t * ct; lim = min(ct, ncols - t * ct). Slot d is in
// range for row r when r + off_d - t_ct lies in [0, lim).
__device__ __forceinline__ unsigned needed_slots(const int32_t* so, int c0, int max_d,
                                                 int lane, int t_ct, int lim, int r_lo,
                                                 int r_hi) {
  bool need = false;
  if (c0 + lane < max_d) {
    const int q = so[c0 + lane] - t_ct;
    need = r_hi + q >= 0 && r_lo + q < lim;
  }
  return __ballot_sync(kFull, need);
}

// One row's products of tile t added to acc in ascending slot order: the
// lane takes the slots the warp needs in batches of B, every in-range load
// of a batch before its first add.
template <typename T, int B, bool kStream>
__device__ __forceinline__ float tile_sum(const int32_t* so, const T* __restrict__ dat_w,
                                          const float* __restrict__ x, int64_t base,
                                          int max_d, int ct, int i, int p0, int lim,
                                          int r_lo, int r_hi, int t_ct, bool active,
                                          int lane) {
  float acc = 0.f;
  for (int c0 = 0; c0 < max_d; c0 += 32) {
    unsigned bits = needed_slots(so, c0, max_d, lane, t_ct, lim, r_lo, r_hi);
    while (bits != 0) {
      float v[B], xv[B];
      unsigned in = 0;
#pragma unroll
      for (int u = 0; u < B; ++u) {
        v[u] = xv[u] = 0.f;
        if (bits != 0) {
          const int d = c0 + __ffs(bits) - 1;
          bits &= bits - 1;
          const int off = so[d];
          const int p = p0 + off;
          if (active && static_cast<unsigned>(p) < static_cast<unsigned>(lim)) {
            in |= 1u << u;
            const T* q = dat_w + base + (d * ct + p);
            v[u] = to_f32(kStream ? __ldcs(q) : *q);
            xv[u] = __ldg(x + (i + off));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < B; ++u)
        if (in & (1u << u)) acc = mul_add_rn(acc, v[u], xv[u]);
    }
  }
  return acc;
}

// At most 40 registers a thread, six CTAs of 256 an SM: 4% faster at 104^3
// than the 48 it takes uncapped (16 bytes spill; at 32, 7% slower).
template <typename T, int B, bool kStream>
__global__ void __launch_bounds__(256, 6) dia_tiled_kernel(const int32_t* __restrict__ offs_t,
                                 const T* __restrict__ dat_w,
                                 const float* __restrict__ x,
                                 const uint8_t* __restrict__ mask,
                                 T* __restrict__ y, int ntiles, int max_d, int group,
                                 int ct, int nrows, int ncols, int min_off, int max_off) {
  extern __shared__ int32_t s_off[];
  const int first = blockIdx.x * blockDim.x;
  const int i = first + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool active = i < nrows && (mask == nullptr || mask[i]);
  // the warp's first and last active rows, and the tiles they reach
  const unsigned act = __ballot_sync(kFull, active);
  const int w0 = i - lane;
  const int r_lo = w0 + __ffs(act) - 1, r_hi = w0 + 31 - __clz(act);
  const int w_lo = tile_of(int64_t{r_lo} + min_off, ct, ntiles);
  const int w_hi = act == 0 ? -1 : tile_of(int64_t{r_hi} + max_off, ct, ntiles);
  // the tiles the CTA's rows reach
  const int last = min(first + static_cast<int>(blockDim.x), nrows) - 1;
  const int c_lo = tile_of(int64_t{first} + min_off, ct, ntiles);
  const int c_hi = tile_of(int64_t{last} + max_off, ct, ntiles);
  float y_acc = 0.f;
  for (int g0 = c_lo; g0 <= c_hi; g0 += group) {  // tiles whose offsets fit at once
    const int g1 = min(g0 + group, c_hi + 1);
    if (g0 != c_lo) __syncthreads();
    const int n = (g1 - g0) * max_d;
    const int32_t* src = offs_t + static_cast<int64_t>(g0) * max_d;
    for (int k = threadIdx.x; k < n; k += blockDim.x) s_off[k] = src[k];
    __syncthreads();
    const int t0 = max(w_lo, g0), t1 = min(w_hi, g1 - 1);
    for (int t = t0; t <= t1; ++t) {
      const int t_ct = t * ct;
      const float acc = tile_sum<T, B, kStream>(
          s_off + (t - g0) * max_d, dat_w, x, static_cast<int64_t>(t) * max_d * ct, max_d, ct,
          i, i - t_ct, max(0, min(ct, ncols - t_ct)), r_lo, r_hi, t_ct, active, lane);
      y_acc = __fadd_rn(y_acc, acc);
    }
  }
  if (i < nrows) y[i] = from_f32<T>(y_acc);
}

constexpr int kStencilDiags = 27;  // one fully unrolled batch
constexpr int kBatch = 8;          // the batch of every other count
constexpr int kOffsetInts = 12288;  // 48 KB of tile offsets a CTA holds at once
constexpr int kTiledBatch = 9;      // needed slots of a tile a lane loads at once

template <typename T, bool kStream>
auto resident_kernel(int ndiags) {
  return ndiags == kStencilDiags ? dia_resident_kernel<T, kStencilDiags, true, kStream>
                                 : dia_resident_kernel<T, kBatch, false, kStream>;
}

template <typename T>
cudaError_t launch_resident(const void* offsets, const void* data, const void* x,
                            const void* mask, const void* rows, int64_t nlist, void* y,
                            int ndiags, int64_t nrows, int64_t ncols, cudaStream_t stream) {
  const int threads = spread_threads(nrows);
  const unsigned blocks = static_cast<unsigned>((nrows + threads - 1) / threads);
  const size_t smem = static_cast<size_t>(ndiags) * sizeof(int32_t);
  // values that cannot stay in L2 between calls (HPCG 104^3: 121 MB) are
  // streamed past it, which leaves x there; at 52^3 (15 MB) they stay
  const int64_t bytes = static_cast<int64_t>(ndiags) * nrows * static_cast<int64_t>(sizeof(T));
  auto kernel = bytes > card().l2 / 2 ? resident_kernel<T, true>(ndiags)
                                      : resident_kernel<T, false>(ndiags);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const int32_t*>(offsets), static_cast<const T*>(data),
      static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(rows), nlist, static_cast<T*>(y), ndiags, nrows, ncols);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tiled(const void* offs_t, const void* dat_w, const void* x,
                         const void* mask, void* y, int ntiles, int max_d,
                         int64_t ct, int64_t nrows, int64_t ncols, int64_t min_off,
                         int64_t max_off, cudaStream_t stream) {
  // rows, columns, the band and positions in 32 bits
  const int64_t band = std::max(std::abs(min_off), std::abs(max_off));
  if (max_d <= 0 || max_d > kOffsetInts || ntiles <= 0 || ct <= 0 || min_off > max_off ||
      std::max({nrows, ncols, ct * ntiles, ct * max_d}) + band + ct >= INT32_MAX)
    return cudaErrorInvalidValue;
  const int threads = spread_threads(nrows);
  const unsigned blocks = static_cast<unsigned>((nrows + threads - 1) / threads);
  const int64_t reach = (threads - 1 + max_off - min_off) / ct + 2;  // tiles a CTA reaches
  const int group = static_cast<int>(std::min<int64_t>(reach, kOffsetInts / max_d));
  const size_t smem = static_cast<size_t>(group) * max_d * sizeof(int32_t);
  // windows that cannot stay in L2 between calls are streamed past it
  const int64_t bytes = static_cast<int64_t>(ntiles) * max_d * ct * sizeof(T);
  auto kernel = bytes > card().l2 / 2 ? dia_tiled_kernel<T, kTiledBatch, true>
                                      : dia_tiled_kernel<T, kTiledBatch, false>;
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const int32_t*>(offs_t), static_cast<const T*>(dat_w),
      static_cast<const float*>(x), static_cast<const uint8_t*>(mask), static_cast<T*>(y),
      ntiles, max_d, group, static_cast<int>(ct), static_cast<int>(nrows),
      static_cast<int>(ncols), static_cast<int>(min_off), static_cast<int>(max_off));
  return cudaGetLastError();
}

}  // namespace repro

// y = A @ x over the resident DIA arrays; mask may be null.
extern "C" int repro_dia_spmv(const void* offsets, const void* data, const void* x,
                              const void* mask, void* y, int ndiags,
                              long long nrows, long long ncols, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nrows == 0) return 0;
  switch (dtype) {
    case repro::kF32:
      return repro::launch_resident<float>(offsets, data, x, mask, nullptr, 0, y, ndiags,
                                           nrows, ncols, s);
    case repro::kBF16:
      return repro::launch_resident<__nv_bfloat16>(offsets, data, x, mask, nullptr, 0, y,
                                                   ndiags, nrows, ncols, s);
    case repro::kF16:
      return repro::launch_resident<__half>(offsets, data, x, mask, nullptr, 0, y, ndiags,
                                            nrows, ncols, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same masked, with rows (nlist,) int32 the rows of mask, ascending:
// the kernel computes those and writes 0 to the others.
extern "C" int repro_dia_spmv_listed(const void* offsets, const void* data, const void* x,
                                     const void* mask, const void* rows, long long nlist,
                                     void* y, int ndiags, long long nrows, long long ncols,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nrows == 0) return 0;
  if (mask == nullptr || rows == nullptr || nlist < 0 || nlist > nrows)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case repro::kF32:
      return repro::launch_resident<float>(offsets, data, x, mask, rows, nlist, y, ndiags,
                                           nrows, ncols, s);
    case repro::kBF16:
      return repro::launch_resident<__nv_bfloat16>(offsets, data, x, mask, rows, nlist, y,
                                                   ndiags, nrows, ncols, s);
    case repro::kF16:
      return repro::launch_resident<__half>(offsets, data, x, mask, rows, nlist, y, ndiags,
                                            nrows, ncols, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int repro_dia_spmv_tiled(const void* offs_t, const void* dat_w, const void* x,
                                    const void* mask, void* y, int ntiles, int max_d,
                                    long long ct, long long nrows, long long ncols,
                                    long long min_off, long long max_off, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nrows == 0) return 0;
  switch (dtype) {
    case repro::kF32:
      return repro::launch_tiled<float>(offs_t, dat_w, x, mask, y, ntiles, max_d, ct,
                                        nrows, ncols, min_off, max_off, s);
    case repro::kBF16:
      return repro::launch_tiled<__nv_bfloat16>(offs_t, dat_w, x, mask, y, ntiles, max_d,
                                                ct, nrows, ncols, min_off, max_off, s);
    case repro::kF16:
      return repro::launch_tiled<__half>(offs_t, dat_w, x, mask, y, ntiles, max_d, ct,
                                         nrows, ncols, min_off, max_off, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
