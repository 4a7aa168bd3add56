// ELL SpMV for Hopper (sm_90a): the resident and the column-tiled kernel,
// with an optional row mask.
//
// Replaces the TPU kernels src/repro/kernels/ell_spmv.py:43 (ell_spmv) and
// src/repro/kernels/ell_spmv.py:92 (ell_spmv_tiled), and the masked ELL
// wrapper of src/repro/kernels/ops.py:217.
//
// Bound: bytes. Every index slot is read once (the -1 padding included: the
// kernel cannot know where it is without reading it), the value of every
// real slot once, x and y once; 2 flops per real slot. At HPCG 52^3
// (resident, W = 27, int32 ids, f32 values) that is about 31.5 MB, 9.4 us at
// 3.35 TB/s. The tiled "ell-cols" plan of HPCG 104^3 is dense in (tile, row):
// 69 tiles x 1,124,864 rows x W = 18 slots for 29.8 M nonzeros (47x), so its
// 2.79 GB of int16 ids bound it near 0.87 ms, and 2.50 ms if its 5.59 GB of
// values were read in full.
//
// Design. The container is row-major (nrows, W), so one thread per row
// reading its own slots would stride by W across a warp. Instead a CTA owns
// kRows consecutive rows, whose slots are one contiguous run of the array:
// the CTA copies them to shared memory with coalesced loads, kChunk slots
// per row at a time (ids widened to int32, values to f32, rows padded to
// kChunk + 1 words against bank conflicts), and then each thread sums its
// row's staged slots in ascending k. A value is loaded only where its id is
// >= 0, and a masked-out row loads nothing and writes 0: the mask goes into
// the kernel, with no masked copy of data. The tiled kernel is the same loop
// once per column tile, in ascending tile order, with tile-local ids offset
// by t * ct; each tile's sum is added to the row's total, the reference's
// initialise-then-accumulate done inside one thread instead of across a
// sequential grid axis. The resident kernel is the tiled one with one tile
// and ct = 0. x is read directly; no padded copy is built.
//
// Products and sums are rounded separately (common.cuh: mul_add_rn), in the
// order of the plain PyTorch versions in kernels/ell_spmv.py, so f32 results
// are equal to theirs bit for bit; y is written in the storage type.

#include "common.cuh"

namespace repro {

constexpr int kRows = 128;   // rows (threads) per CTA
constexpr int kChunk = 32;   // slots per row staged at a time
constexpr int kStride = kChunk + 1;

template <typename T, typename I>
__global__ void ell_kernel(const I* __restrict__ idx, const T* __restrict__ data,
                           const float* __restrict__ x,
                           const uint8_t* __restrict__ mask, T* __restrict__ y,
                           int64_t nrows, int width, int ntiles, int64_t ct) {
  __shared__ int32_t s_idx[kRows * kStride];
  __shared__ float s_val[kRows * kStride];
  __shared__ uint8_t s_on[kRows];

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = nrows - r0 < kRows ? static_cast<int>(nrows - r0) : kRows;
  const int tid = threadIdx.x;
  if (tid < rows) s_on[tid] = (mask == nullptr || mask[r0 + tid]) ? 1 : 0;
  __syncthreads();
  const bool on = tid < rows && s_on[tid];

  float total = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int64_t slab = static_cast<int64_t>(t) * nrows * width;
    const I* it = idx + slab + r0 * width;
    const T* dt = data + slab + r0 * width;
    const float* xt = x + static_cast<int64_t>(t) * ct;
    float acc = 0.f;
    for (int k0 = 0; k0 < width; k0 += kChunk) {
      const int kw = min(kChunk, width - k0);
      __syncthreads();  // the previous chunk has been consumed
      for (int e = tid; e < rows * kw; e += kRows) {
        const int rr = e / kw, kk = e - rr * kw;
        int32_t c = -1;
        float v = 0.f;
        if (s_on[rr]) {
          const int64_t src = static_cast<int64_t>(rr) * width + k0 + kk;
          c = static_cast<int32_t>(it[src]);
          if (c >= 0) v = to_f32(dt[src]);
        }
        s_idx[rr * kStride + kk] = c;
        s_val[rr * kStride + kk] = v;
      }
      __syncthreads();
      if (on) {
        for (int kk = 0; kk < kw; ++kk) {
          const int32_t c = s_idx[tid * kStride + kk];
          if (c >= 0) acc = mul_add_rn(acc, s_val[tid * kStride + kk], xt[c]);
        }
      }
    }
    total = __fadd_rn(total, acc);
  }
  if (tid < rows) y[r0 + tid] = from_f32<T>(total);
}

template <typename T, typename I>
cudaError_t launch_ell(const void* idx, const void* data, const void* x,
                       const void* mask, void* y, int64_t nrows, int width,
                       int ntiles, int64_t ct, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((nrows + kRows - 1) / kRows);
  ell_kernel<T, I><<<blocks, kRows, 0, stream>>>(
      static_cast<const I*>(idx), static_cast<const T*>(data),
      static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
      static_cast<T*>(y), nrows, width, ntiles, ct);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ell_index(int itype, const void* idx, const void* data,
                             const void* x, const void* mask, void* y,
                             int64_t nrows, int width, int ntiles, int64_t ct,
                             cudaStream_t stream) {
  switch (itype) {
    case kI8:
      return launch_ell<T, int8_t>(idx, data, x, mask, y, nrows, width, ntiles, ct, stream);
    case kI16:
      return launch_ell<T, int16_t>(idx, data, x, mask, y, nrows, width, ntiles, ct, stream);
    case kI32:
      return launch_ell<T, int32_t>(idx, data, x, mask, y, nrows, width, ntiles, ct, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace repro

// y = A @ x over ELL slabs idx/data (ntiles, nrows, width); the resident
// container is ntiles = 1 with ct = 0 (global ids), a "ell-cols" plan has
// tile-local ids and ct its column-tile width. mask may be null.
extern "C" int repro_ell_spmv(const void* idx, const void* data, const void* x,
                              const void* mask, void* y, long long nrows, int width,
                              int ntiles, long long ct, int dtype, int itype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width <= 0 || ntiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nrows == 0) return 0;
  switch (dtype) {
    case repro::kF32:
      return repro::launch_ell_index<float>(itype, idx, data, x, mask, y, nrows, width,
                                            ntiles, ct, s);
    case repro::kBF16:
      return repro::launch_ell_index<__nv_bfloat16>(itype, idx, data, x, mask, y, nrows,
                                                    width, ntiles, ct, s);
    case repro::kF16:
      return repro::launch_ell_index<__half>(itype, idx, data, x, mask, y, nrows, width,
                                             ntiles, ct, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
