// DIA SpMV for Hopper (sm_90a): the resident and the column-tiled kernel.
//
// Replaces the TPU kernels src/repro/kernels/dia_spmv.py:58 (dia_spmv) and
// src/repro/kernels/dia_spmv.py:135 (dia_spmv_tiled).
//
// Bound: bytes. Each stored diagonal value is read once (ndiags * nrows *
// sizeof(T)), x once and y written once; 2 flops per value. At HPCG 104^3
// in f32 that is about 130 MB, 39 us at 3.35 TB/s.
//
// Design (resident): one thread per row, the diagonal offsets in shared
// memory. For a fixed diagonal the 32 threads of a warp read 32 consecutive
// data values and 32 consecutive x values, so both loads coalesce. A bounds
// check on the column replaces the zero-padded copy of x the TPU wrapper
// builds. The optional row mask (one byte per row) skips masked rows and
// writes 0 there: one multicolor SymGS color without a masked copy of data.
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

template <typename T>
__global__ void dia_resident_kernel(const int32_t* __restrict__ offsets,
                                    const T* __restrict__ data,
                                    const float* __restrict__ x,
                                    const uint8_t* __restrict__ mask,
                                    T* __restrict__ y, int ndiags,
                                    int64_t nrows, int64_t ncols) {
  extern __shared__ int32_t s_off[];
  for (int d = threadIdx.x; d < ndiags; d += blockDim.x) s_off[d] = offsets[d];
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nrows) return;
  float acc = 0.f;
  if (mask == nullptr || mask[i]) {
    for (int d = 0; d < ndiags; ++d) {
      const int64_t k = i + s_off[d];
      if (k >= 0 && k < ncols)
        acc = mul_add_rn(acc, to_f32(data[static_cast<int64_t>(d) * nrows + i]), x[k]);
    }
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

template <typename T>
cudaError_t launch_resident(const void* offsets, const void* data, const void* x,
                            const void* mask, void* y, int ndiags, int64_t nrows,
                            int64_t ncols, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((nrows + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(ndiags) * sizeof(int32_t);
  dia_resident_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(offsets), static_cast<const T*>(data),
      static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
      static_cast<T*>(y), ndiags, nrows, ncols);
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

extern "C" int repro_dia_spmv(const void* offsets, const void* data, const void* x,
                              const void* mask, void* y, int ndiags,
                              long long nrows, long long ncols, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nrows == 0) return 0;
  switch (dtype) {
    case repro::kF32:
      return repro::launch_resident<float>(offsets, data, x, mask, y, ndiags, nrows, ncols, s);
    case repro::kBF16:
      return repro::launch_resident<__nv_bfloat16>(offsets, data, x, mask, y, ndiags, nrows, ncols, s);
    case repro::kF16:
      return repro::launch_resident<__half>(offsets, data, x, mask, y, ndiags, nrows, ncols, s);
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
