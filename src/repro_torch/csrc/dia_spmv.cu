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
// Design (tiled): the TPU grid visits every (row block, column tile) pair and
// carries partial y across the sequential tile axis. Here each thread owns
// one row and loops, in ascending tile order, over only the tiles its band
// can reach, [(i + min_off) / ct, (i + max_off) / ct]; within a tile it sums
// the tile's diagonal slots into acc_t and then adds acc_t to y — the
// reference's association. x is read directly; no haloed copies are built.
//
// Both kernels accumulate in f32 with separately rounded multiply and add
// (common.cuh: mul_add_rn), in the order of the plain PyTorch versions in
// kernels/dia_spmv.py, and write y in the storage type.

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

template <typename T>
__global__ void dia_tiled_kernel(const int32_t* __restrict__ offs_t,
                                 const T* __restrict__ dat_w,
                                 const float* __restrict__ x,
                                 const uint8_t* __restrict__ mask,
                                 T* __restrict__ y, int ntiles, int max_d,
                                 int64_t ct, int64_t nrows, int64_t ncols,
                                 int64_t min_off, int64_t max_off) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nrows) return;
  float y_acc = 0.f;
  if (mask == nullptr || mask[i]) {
    int64_t t_lo = floor_div(i + min_off, ct);
    int64_t t_hi = floor_div(i + max_off, ct);
    if (t_lo < 0) t_lo = 0;
    if (t_hi > ntiles - 1) t_hi = ntiles - 1;
    for (int64_t t = t_lo; t <= t_hi; ++t) {
      float acc = 0.f;
      const int32_t* offs = offs_t + t * max_d;
      const T* win = dat_w + t * max_d * ct;
      for (int d = 0; d < max_d; ++d) {
        const int64_t col = i + offs[d];
        const int64_t p = col - t * ct;  // position in the tile's window
        if (p >= 0 && p < ct && col < ncols)
          acc = mul_add_rn(acc, to_f32(win[static_cast<int64_t>(d) * ct + p]), x[col]);
      }
      y_acc = __fadd_rn(y_acc, acc);
    }
  }
  y[i] = from_f32<T>(y_acc);
}

constexpr int kThreads = 256;
constexpr int kStencilDiags = 27;  // one fully unrolled batch
constexpr int kBatch = 8;          // the batch of every other count

// The card's SMs and L2 bytes, read once.
struct Card {
  int sms = 132;
  int64_t l2 = 50 << 20;
  Card() {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess && n > 0)
      sms = n;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrL2CacheSize, dev) == cudaSuccess && n > 0) l2 = n;
  }
};
inline const Card& card() {
  static const Card c;
  return c;
}

// Threads per CTA of the resident kernel: 256 when the grid then has at
// least two CTAs per SM, else halved down to one warp.
inline int resident_threads(int64_t nrows) {
  int threads = kThreads;
  while (threads > 32 && (nrows + threads - 1) / threads < 2 * card().sms) threads /= 2;
  return threads;
}

template <typename T, bool kStream>
auto resident_kernel(int ndiags) {
  return ndiags == kStencilDiags ? dia_resident_kernel<T, kStencilDiags, true, kStream>
                                 : dia_resident_kernel<T, kBatch, false, kStream>;
}

template <typename T>
cudaError_t launch_resident(const void* offsets, const void* data, const void* x,
                            const void* mask, const void* rows, int64_t nlist, void* y,
                            int ndiags, int64_t nrows, int64_t ncols, cudaStream_t stream) {
  const int threads = resident_threads(nrows);
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
  const unsigned blocks = static_cast<unsigned>((nrows + kThreads - 1) / kThreads);
  dia_tiled_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(offs_t), static_cast<const T*>(dat_w),
      static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
      static_cast<T*>(y), ntiles, max_d, ct, nrows, ncols, min_off, max_off);
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
