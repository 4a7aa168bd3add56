// BSR SpMM for Hopper (sm_90a): Y = A @ X over the ELL-of-blocks container
// (bcols (nbrows, bwidth) int32, blocks (nbrows, bwidth, bs, bs)), with an
// optional row mask. SpMV is the SpMM of one column.
//
// Replaces the TPU kernel src/repro/kernels/bsr_spmm.py:44 (bsr_spmm), which
// carries the bsr/pallas SpMM, SpMV and masked SpMV.
//
// Bound. Each real block (bcol in [0, nbcols)) is read once, bcols once, X
// once and Y written once; 2 * bs^2 * nf flops per real block. For one
// column that is bytes: the block matrix block_random(65536, 32,
// 16/2048) holds 34,699 real blocks, 142 MB in f32, 42 us at 3.35 TB/s.
// For 128 columns it is operations: 9.1 GFLOP, 136 us at 67 TFLOP/s of f32
// on the CUDA cores, against 209 MB (62 us).
//
// Design. The TPU grid is (block row, feature tile, w) with w innermost and
// sequential, so the y tile accumulates across w. Here one CTA owns one
// (block row, feature tile of NFT columns) and walks w in ascending order
// itself: no sum crosses CTAs and nothing is atomic, so two launches give
// equal bits. For each real block the CTA stages the block, upcast to f32,
// and the bs rows of X it multiplies (rows at or past ncols read as zero,
// which replaces the reference's padded copy of X) in shared memory; a
// block id < 0 or >= nbcols is skipped before anything is read. Each thread
// keeps its outputs (one column, bs * NFT / 256 rows) in f32 registers,
// adds the products with fused multiply-adds in ascending column order, and
// writes Y once. X is read as f32: a bf16/f16 block multiplies an f32 X,
// as the reference upcasts both operands. The row mask (SymGS colors) goes
// in: a masked row's block entries are not loaded, a block row that is
// masked whole reads nothing, and masked rows are written as 0, so the
// kept rows equal the unmasked result bit for bit. NFT is 8, 32 or 64,
// the smallest that covers nf (a whole tile at 64), so SpMV wastes little.
// No tensor cores yet: a later redesign.

#include "common.cuh"

namespace repro {

constexpr int kBsrThreads = 256;

template <typename T, int BS, int NFT>
__global__ void __launch_bounds__(kBsrThreads)
bsr_spmm_kernel(const int32_t* __restrict__ bcols, const T* __restrict__ blocks,
                const float* __restrict__ X, const bool* __restrict__ mask,
                float* __restrict__ Y, int bwidth, int64_t nbcols, int64_t ncols,
                int64_t nf) {
  constexpr int kRowsPerPass = kBsrThreads / NFT;
  constexpr int kRows = (BS + kRowsPerPass - 1) / kRowsPerPass;
  __shared__ float s_blk[BS][BS + 1];  // +1: rows of a warp fall in other banks
  __shared__ float s_x[BS][NFT];
  __shared__ bool s_keep[BS];

  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t f0 = static_cast<int64_t>(blockIdx.y) * NFT;
  const int f = t % NFT;
  const int i0 = t / NFT;
  const int64_t row0 = b * BS;

  if (t < BS) s_keep[t] = mask == nullptr || mask[row0 + t];
  const bool keep_any = __syncthreads_or(t < BS && s_keep[t]);

  float acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = 0.f;

  for (int w = 0; keep_any && w < bwidth; ++w) {
    const int32_t bc = bcols[b * bwidth + w];
    if (bc < 0 || bc >= nbcols) continue;  // the same for every thread
    __syncthreads();  // the previous block's products are done
    const T* blk = blocks + (b * bwidth + w) * (BS * BS);
    for (int e = t; e < BS * BS; e += kBsrThreads) {
      const int i = e / BS;
      s_blk[i][e % BS] = s_keep[i] ? to_f32(blk[e]) : 0.f;
    }
    const int64_t xr0 = static_cast<int64_t>(bc) * BS;
    for (int e = t; e < BS * NFT; e += kBsrThreads) {
      const int j = e / NFT;
      const int64_t r = xr0 + j, c = f0 + e % NFT;
      s_x[j][e % NFT] = (r < ncols && c < nf) ? X[r * nf + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < BS; ++j) {
      const float xv = s_x[j][f];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int i = i0 + k * kRowsPerPass;
        if (i < BS) acc[k] = fmaf(s_blk[i][j], xv, acc[k]);
      }
    }
  }
  if (f0 + f >= nf) return;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = i0 + k * kRowsPerPass;
    if (i < BS) Y[(row0 + i) * nf + f0 + f] = s_keep[i] ? acc[k] : 0.f;
  }
}

template <typename T, int BS, int NFT>
cudaError_t launch_bsr(const void* bcols, const void* blocks, const void* x,
                       const void* mask, void* y, int64_t nbrows, int bwidth,
                       int64_t ncols, int64_t nf, cudaStream_t stream) {
  const int64_t nftiles = (nf + NFT - 1) / NFT;
  if (nbrows > 0x7fffffffLL || nftiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(nbrows), static_cast<unsigned>(nftiles));
  const int64_t nbcols = (ncols + BS - 1) / BS;
  bsr_spmm_kernel<T, BS, NFT><<<grid, kBsrThreads, 0, stream>>>(
      static_cast<const int32_t*>(bcols), static_cast<const T*>(blocks),
      static_cast<const float*>(x), static_cast<const bool*>(mask), static_cast<float*>(y),
      bwidth, nbcols, ncols, nf);
  return cudaGetLastError();
}

template <typename T, int BS>
cudaError_t launch_bsr_nft(const void* bcols, const void* blocks, const void* x,
                           const void* mask, void* y, int64_t nbrows, int bwidth,
                           int64_t ncols, int64_t nf, cudaStream_t stream) {
  if (nf <= 8)
    return launch_bsr<T, BS, 8>(bcols, blocks, x, mask, y, nbrows, bwidth, ncols, nf, stream);
  if (nf <= 32)
    return launch_bsr<T, BS, 32>(bcols, blocks, x, mask, y, nbrows, bwidth, ncols, nf, stream);
  return launch_bsr<T, BS, 64>(bcols, blocks, x, mask, y, nbrows, bwidth, ncols, nf, stream);
}

template <typename T>
cudaError_t launch_bsr_bs(int bs, const void* bcols, const void* blocks, const void* x,
                          const void* mask, void* y, int64_t nbrows, int bwidth,
                          int64_t ncols, int64_t nf, cudaStream_t stream) {
  switch (bs) {
    case 8:
      return launch_bsr_nft<T, 8>(bcols, blocks, x, mask, y, nbrows, bwidth, ncols, nf, stream);
    case 16:
      return launch_bsr_nft<T, 16>(bcols, blocks, x, mask, y, nbrows, bwidth, ncols, nf, stream);
    case 32:
      return launch_bsr_nft<T, 32>(bcols, blocks, x, mask, y, nbrows, bwidth, ncols, nf, stream);
    case 64:
      return launch_bsr_nft<T, 64>(bcols, blocks, x, mask, y, nbrows, bwidth, ncols, nf, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace repro

// bcols (nbrows, bwidth) int32, blocks (nbrows, bwidth, bs, bs), x (ncols, nf)
// f32, mask (nbrows * bs,) bool or null, y (nbrows * bs, nf) f32.
extern "C" int repro_bsr_spmm(const void* bcols, const void* blocks, const void* x,
                              const void* mask, void* y, long long nbrows, int bwidth,
                              int bs, long long ncols, long long nf, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbrows == 0 || nf == 0) return 0;
  switch (dtype) {
    case repro::kF32:
      return repro::launch_bsr_bs<float>(bs, bcols, blocks, x, mask, y, nbrows, bwidth,
                                         ncols, nf, s);
    case repro::kBF16:
      return repro::launch_bsr_bs<__nv_bfloat16>(bs, bcols, blocks, x, mask, y, nbrows,
                                                 bwidth, ncols, nf, s);
    case repro::kF16:
      return repro::launch_bsr_bs<__half>(bs, bcols, blocks, x, mask, y, nbrows, bwidth,
                                          ncols, nf, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
