// SELL-C-sigma SpMV for Hopper (sm_90a) over the "scs" plan stream.
//
// Replaces the TPU kernel src/repro/kernels/sell_spmv.py:64 (scs_spmv), which
// serves both the csr and the sell formats.
//
// Bound: bytes. The kernel reads each plan array once — btile (B) and the
// window run starts, lsl (B*jb), idx2 (B*jb*C, int8/int16/int32), dat2
// (B*jb*C values), perm — and x, and writes y once; 2 flops per stored value.
// At HPCG 104^3 (tiled plan, int16 indices, f32 values) that is about 321 MB,
// 96 us at 3.35 TB/s.
//
// Design. The TPU grid walks blocks in order and relies on it: a block whose
// output window differs from the previous block's initialises the window,
// otherwise it accumulates. Here one warp owns one output window (sw slices
// of C rows, 32 rows at the defaults C=8, sw=4) and walks that window's
// contiguous run of blocks in order; the run boundaries are computed once per
// plan (run_start, from the sorted bwin). In each step the 32 lanes take
// Q = 32/C consecutive j-steps of C lanes each — one coalesced load of
// 32 indices and 32 values — and add each product to the register sum of its
// j-step's slice (lsl). At the end of a block, a butterfly over the Q lane
// groups totals each (slice, lane) sum, and the window sum accumulates the
// block totals in block order: the reference's init-then-accumulate, without
// float atomics, so the result is the same on every run. The warp then writes
// y[perm[p]] for each of its rows p that is a real row.

#include "common.cuh"

namespace repro {

constexpr int kMaxSW = 8;      // slices per window a warp can hold in registers
constexpr int kWarpsPerBlock = 8;

template <typename T, typename I>
__global__ void scs_kernel(const int32_t* __restrict__ btile,
                           const int32_t* __restrict__ lsl,
                           const I* __restrict__ idx2, const T* __restrict__ dat2,
                           const int32_t* __restrict__ perm,
                           const int32_t* __restrict__ run_start,
                           const float* __restrict__ x, T* __restrict__ y,
                           int nwin, int C, int sw, int jb, int64_t ct,
                           int64_t nrows, int64_t nrows_pad) {
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= nwin) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const int Q = 32 / C;
  const int q = lane / C, c = lane - q * C;
  float win[kMaxSW];
#pragma unroll
  for (int k = 0; k < kMaxSW; ++k) win[k] = 0.f;

  const int b0 = run_start[warp], b1 = run_start[warp + 1];
  for (int b = b0; b < b1; ++b) {
    float blk[kMaxSW];
#pragma unroll
    for (int k = 0; k < kMaxSW; ++k) blk[k] = 0.f;
    const float* xt = x + static_cast<int64_t>(btile[b]) * ct;
    for (int j0 = 0; j0 < jb; j0 += Q) {
      const int j = j0 + q;
      if (j < jb) {
        const int64_t r = static_cast<int64_t>(b) * jb + j;
        const int col = static_cast<int>(idx2[r * C + c]);
        if (col >= 0) {
          const float v = __fmul_rn(to_f32(dat2[r * C + c]), xt[col]);
          const int s = lsl[r];
#pragma unroll
          for (int k = 0; k < kMaxSW; ++k)
            if (k == s) blk[k] = __fadd_rn(blk[k], v);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxSW; ++k) {
      float v = blk[k];
      for (int o = C; o < 32; o <<= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
      win[k] = __fadd_rn(win[k], v);
    }
  }
  if (q == 0) {
#pragma unroll
    for (int k = 0; k < kMaxSW; ++k) {
      if (k >= sw) break;
      const int64_t p = (static_cast<int64_t>(warp) * sw + k) * C + c;
      if (p < nrows_pad) {
        const int row = perm[p];
        if (row < nrows) y[row] = from_f32<T>(win[k]);
      }
    }
  }
}

template <typename T, typename I>
cudaError_t launch(const void* btile, const void* lsl, const void* idx2,
                   const void* dat2, const void* perm, const void* run_start,
                   const void* x, void* y, int nwin, int C, int sw, int jb,
                   int64_t ct, int64_t nrows, int64_t nrows_pad, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((nwin + kWarpsPerBlock - 1) / kWarpsPerBlock);
  scs_kernel<T, I><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const int32_t*>(btile), static_cast<const int32_t*>(lsl),
      static_cast<const I*>(idx2), static_cast<const T*>(dat2),
      static_cast<const int32_t*>(perm), static_cast<const int32_t*>(run_start),
      static_cast<const float*>(x), static_cast<T*>(y), nwin, C, sw, jb, ct,
      nrows, nrows_pad);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_index(int itype, const void* btile, const void* lsl,
                         const void* idx2, const void* dat2, const void* perm,
                         const void* run_start, const void* x, void* y, int nwin,
                         int C, int sw, int jb, int64_t ct, int64_t nrows,
                         int64_t nrows_pad, cudaStream_t stream) {
  switch (itype) {
    case kI8:
      return launch<T, int8_t>(btile, lsl, idx2, dat2, perm, run_start, x, y, nwin,
                               C, sw, jb, ct, nrows, nrows_pad, stream);
    case kI16:
      return launch<T, int16_t>(btile, lsl, idx2, dat2, perm, run_start, x, y, nwin,
                                C, sw, jb, ct, nrows, nrows_pad, stream);
    case kI32:
      return launch<T, int32_t>(btile, lsl, idx2, dat2, perm, run_start, x, y, nwin,
                                C, sw, jb, ct, nrows, nrows_pad, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace repro

extern "C" int repro_scs_spmv(const void* btile, const void* lsl, const void* idx2,
                              const void* dat2, const void* perm, const void* run_start,
                              const void* x, void* y, int nwin, int C, int sw, int jb,
                              long long ct, long long nrows, long long nrows_pad,
                              int dtype, int itype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0 || C > 32 || (32 % C) != 0 || sw <= 0 || sw > repro::kMaxSW)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nwin == 0 || nrows == 0) return 0;
  switch (dtype) {
    case repro::kF32:
      return repro::launch_index<float>(itype, btile, lsl, idx2, dat2, perm, run_start,
                                        x, y, nwin, C, sw, jb, ct, nrows, nrows_pad, s);
    case repro::kBF16:
      return repro::launch_index<__nv_bfloat16>(itype, btile, lsl, idx2, dat2, perm,
                                                run_start, x, y, nwin, C, sw, jb, ct,
                                                nrows, nrows_pad, s);
    case repro::kF16:
      return repro::launch_index<__half>(itype, btile, lsl, idx2, dat2, perm, run_start,
                                         x, y, nwin, C, sw, jb, ct, nrows, nrows_pad, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
