// BSR SpMM for Hopper (sm_90a): Y = A @ X over the ELL-of-blocks container
// (bcols (nbrows, bwidth) int32, blocks (nbrows, bwidth, bs, bs)), with an
// optional row mask. SpMV is the SpMM of one column.
//
// Replaces the TPU kernel src/repro/kernels/bsr_spmm.py:44 (bsr_spmm), which
// carries the bsr/pallas SpMM, SpMV and masked SpMV.
//
// Bound. Each real block (bcol in [0, nbcols)) is read once, bcols once, X
// once and Y written once; 2 * bs^2 * nf flops per real block. The block
// matrix block_random(65536, 32, 16/2048) holds 34,699 real blocks, 142 MB
// in f32: 42 us at 3.35 TB/s for one column. At 128 columns its 9.1 GFLOP
// take 55 us on the tensor cores in 3xTF32 (165 TFLOP/s, the fastest rate
// that keeps f32 accuracy), against 209 MB (62 us) of bytes.
//
// Design. The TPU grid is (block row, feature tile, w) with w innermost and
// sequential, so the y tile accumulates across w. Here one CTA owns one
// (block row, feature tile of NFT columns) and walks the row's real blocks
// in ascending w itself: no sum crosses CTAs and nothing is atomic, so two
// launches give equal bits. Each block and the bs rows of X it multiplies
// are staged in shared memory with cp.async into a ring of stages, so the
// next blocks arrive while this one multiplies; rows of X at or past ncols
// are filled with zeros by the copy (no padded copy of X), and a block id
// < 0 or >= nbcols is skipped before anything is read. Two ways to multiply:
//
//  - Tensor cores (bs 16/32/64, nf >= 8): the bs x NFT output is cut into
//    m16n8k8 TF32 tiles shared out over 8 warps, f32 accumulators in
//    registers. One TF32 pass keeps 11 bits, which misses rtol 2e-4, so an
//    f32 block and X are split into hi + lo TF32 parts and three products
//    are added (lo*hi, hi*lo, hi*hi); a bf16/f16 block is exact in TF32, so
//    only X is split (two products). The mma instructions add one block's
//    products into a partial that starts at zero, and the partial goes into
//    the row's running sum with a separately rounded f32 add: accumulating
//    every block inside the tensor core erred 5x more than the CUDA cores
//    (PERF.md, PR 16).
//  - CUDA cores (bs 8, or nf < 8, SpMV among them): TPR threads share a
//    block row, each adds its slice of the block's columns with fused
//    multiply-adds over the whole walk, and a butterfly over the TPR lanes
//    totals them at the end. 4 stages keep several blocks in flight.
//
// X is read as f32: a bf16/f16 block multiplies an f32 X, as the reference
// upcasts both operands. The row mask goes in: a block row masked whole
// reads nothing, and masked rows are written as 0; every output row is
// computed from its own block row alone, so kept rows equal the unmasked
// result bit for bit.

#include <type_traits>

#include "async_tf32.cuh"
#include "common.cuh"

namespace repro {

constexpr int kBsrThreads = 256;

// The tensor-core kernel takes bs 16/32/64 at 8 columns or more; bs 8 and
// SpMV-like widths take the CUDA-core one.
__host__ __device__ constexpr bool tensor_cores(int bs, int64_t nf) { return bs >= 16 && nf >= 8; }

// Shared-memory layout of one kernel instance: S stages of a block (BS rows
// of LDA T, padded by 16 bytes a row) and the X rows it multiplies (BS rows
// of LDX f32).
template <typename T, int BS, int NFT, int LDX_, int S_>
struct Layout {
  static constexpr int S = S_;
  static constexpr int LDA = BS + 16 / static_cast<int>(sizeof(T));
  static constexpr int LDX = LDX_;
  static constexpr int kABytes = BS * LDA * static_cast<int>(sizeof(T));
  static constexpr int kXBytes = BS * LDX * 4;
  static constexpr int kStage = kABytes + kXBytes;
  static constexpr int kBytes = S * kStage;
};

// The tensor-core kernel's ring with X rows padded by 8 floats, which keeps
// the fragment loads free of bank conflicts, and the CUDA-core kernel's.
// Stages: 2 and 4 (examples/bsr_kernel_ab.py: 3 tensor-core stages read 3%
// slower at 128 columns, 6 CUDA-core stages 1% slower at one).
constexpr int kTcStages = 2;
constexpr int kCcStages = 4;
template <typename T, int BS, int NFT>
using TcLayout = Layout<T, BS, NFT, NFT + 8, kTcStages>;
template <typename T, int BS, int NFT>
using CcLayout = Layout<T, BS, NFT, NFT, kCcStages>;
// Threads that share a block row in the CUDA-core kernel.
__host__ __device__ constexpr int cc_rows_threads(int bs) {
  return bs < kBsrThreads / bs ? bs : kBsrThreads / bs;
}

struct Walk {
  const int32_t* bcols;  // this block row's bwidth slots
  int bwidth;
  int64_t nbcols;
  int next = 0;  // next slot to scan
  // The next real block's slot, or -1; the same on every thread.
  __device__ __forceinline__ int advance() {
    for (; next < bwidth; ++next) {
      const int32_t bc = bcols[next];
      if (bc >= 0 && bc < nbcols) return next++;
    }
    return -1;
  }
};

// Stage slot w of block row b (its block and X rows [bc*BS, bc*BS+BS) x
// columns [f0, f0+NFT)) into stage `st`.
template <typename T, int BS, int NFT, typename L, int NT>
__device__ __forceinline__ void stage_block(unsigned char* smem, int st, const T* blocks,
                                            const float* X, int64_t slot, int32_t bc,
                                            int64_t ncols, int64_t nf, int64_t f0, int t,
                                            bool x16) {
  unsigned char* As = smem + st * L::kStage;
  float* Xs = reinterpret_cast<float*>(As + L::kABytes);
  constexpr int kRowChunks = BS * static_cast<int>(sizeof(T)) / 16;
  const unsigned char* blk =
      reinterpret_cast<const unsigned char*>(blocks + slot * (BS * BS));
  for (int e = t; e < BS * kRowChunks; e += NT) {
    const int i = e / kRowChunks, k = e - i * kRowChunks;
    cp_async16(As + i * L::LDA * static_cast<int>(sizeof(T)) + k * 16, blk + e * 16, 16);
  }
  const int64_t xr0 = static_cast<int64_t>(bc) * BS;
  if (NFT == 1 && nf == 1) {  // the rows are contiguous: BS / 4 chunks
    for (int e = t; e < BS / 4; e += NT) {
      const int64_t left = (ncols - xr0 - 4 * e) * 4;
      cp_async16(Xs + 4 * e, left > 0 ? X + xr0 + 4 * e : X,
                 left >= 16 ? 16 : (left > 0 ? static_cast<int>(left) : 0));
    }
  } else if (x16) {  // nf % 4 == 0: whole 16-byte chunks of a row, or none
    constexpr int kChunks = NFT / 4;
    for (int e = t; e < BS * kChunks; e += NT) {
      const int j = e / kChunks, f = (e - j * kChunks) * 4;
      const bool ok = xr0 + j < ncols && f0 + f < nf;
      cp_async16(Xs + j * L::LDX + f, ok ? X + (xr0 + j) * nf + f0 + f : X, ok ? 16 : 0);
    }
  } else {
    for (int e = t; e < BS * NFT; e += NT) {
      const int j = e / NFT, f = e - j * NFT;
      const bool ok = xr0 + j < ncols && f0 + f < nf;
      cp_async4(Xs + j * L::LDX + f, ok ? X + (xr0 + j) * nf + f0 + f : X, ok ? 4 : 0);
    }
  }
}

// The ring: stage the first S - 1 real blocks, then for each block wait for
// it, stage the block S - 1 ahead into the slot freed last round, and hand
// the staged block to `mul`.
template <typename T, int BS, int NFT, typename L, int NT, typename Mul>
__device__ __forceinline__ void walk_blocks(unsigned char* smem, Walk& walk, const T* blocks,
                                            const float* X, int64_t b, int64_t ncols,
                                            int64_t nf, int64_t f0, bool x16, Mul&& mul) {
  const int t = threadIdx.x;
  int pending = 0, put = 0, take = 0;
  auto issue = [&]() {
    const int w = walk.advance();
    if (w >= 0) {
      stage_block<T, BS, NFT, L, NT>(smem, put, blocks, X, b * walk.bwidth + w,
                                     walk.bcols[w], ncols, nf, f0, t, x16);
      ++pending;
    }
    put = put + 1 == L::S ? 0 : put + 1;
    cp_async_commit();
  };
  for (int s = 0; s < L::S - 1; ++s) issue();
  while (pending > 0) {
    cp_async_wait<L::S - 2>();
    __syncthreads();  // block `take` is here, and every thread is done with the slot `put`
    issue();
    const unsigned char* As = smem + take * L::kStage;
    mul(reinterpret_cast<const T*>(As), reinterpret_cast<const float*>(As + L::kABytes));
    --pending;
    take = take + 1 == L::S ? 0 : take + 1;
  }
}

// Tensor cores: MT x NT tiles of 16 x 8; warp (wm, wn) of WM x WN warps owns
// m-tiles wm, wm + WM, ... and n-tiles wn, wn + WN, ...
template <typename T, int BS, int NFT>
__global__ void __launch_bounds__(kBsrThreads)
bsr_spmm_tc_kernel(const int32_t* __restrict__ bcols, const T* __restrict__ blocks,
                   const float* __restrict__ X, const bool* __restrict__ mask,
                   float* __restrict__ Y, int bwidth, int64_t nbcols, int64_t ncols,
                   int64_t nf, bool x16) {
  using L = TcLayout<T, BS, NFT>;
  constexpr int MT = BS / 16, NT = NFT / 8;
  constexpr int WN = NT < 8 ? NT : 8, WM = 8 / WN;
  constexpr int MPW = (MT + WM - 1) / WM, NPW = NT / WN;
  constexpr bool kExactA = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool s_keep[BS];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int64_t b = blockIdx.x;
  const int64_t f0 = static_cast<int64_t>(blockIdx.y) * NFT;
  const int64_t row0 = b * BS;

  if (t < BS) s_keep[t] = mask == nullptr || mask[row0 + t];
  const bool keep_any = __syncthreads_or(t < BS && s_keep[t]);

  float acc[MPW][NPW][4];
#pragma unroll
  for (int mi = 0; mi < MPW; ++mi)
#pragma unroll
    for (int ni = 0; ni < NPW; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  // An f32 block is split into TF32 hi (in place) and lo parts once, by the
  // whole CTA, rather than by each warp that reads the same fragments
  // (examples/bsr_kernel_ab.py: 5% faster at 128 columns).
  unsigned* a_lo = reinterpret_cast<unsigned*>(smem + L::kBytes);
  auto mul = [&](const T* As, const float* Xs) {
    if constexpr (!kExactA) {
      float* aw = const_cast<float*>(reinterpret_cast<const float*>(As));
      for (int e = t; e < BS * BS; e += kBsrThreads) {
        const int at = (e / BS) * L::LDA + e % BS;
        unsigned hi, lo;
        split_tf32(aw[at], hi, lo);
        aw[at] = __uint_as_float(hi);
        a_lo[at] = lo;
      }
      __syncthreads();
    }
    // The block's products go to a partial of their own, which is added to
    // the running sum with a separately rounded add, outside the tensor
    // core: its f32 accumulation of mma results into a large sum loses
    // bits the add keeps.
    float part[MPW][NPW][4];
#pragma unroll
    for (int mi = 0; mi < MPW; ++mi)
#pragma unroll
      for (int ni = 0; ni < NPW; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[mi][ni][r] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < BS; k0 += 8) {
      unsigned bh[NPW][2], bl[NPW][2];
#pragma unroll
      for (int ni = 0; ni < NPW; ++ni) {
        const int n = (wn + ni * WN) * 8 + g;
        split_tf32(Xs[(k0 + tq) * L::LDX + n], bh[ni][0], bl[ni][0]);
        split_tf32(Xs[(k0 + tq + 4) * L::LDX + n], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MPW; ++mi) {
        const int m = wm + mi * WM;
        if (m >= MT) continue;
        const int r = m * 16 + g;
        const int at[4] = {r * L::LDA + k0 + tq, (r + 8) * L::LDA + k0 + tq,
                           r * L::LDA + k0 + tq + 4, (r + 8) * L::LDA + k0 + tq + 4};
        unsigned ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = __float_as_uint(to_f32(As[at[e]]));
          if (!kExactA) al[e] = a_lo[at[e]];
        }
#pragma unroll
        for (int ni = 0; ni < NPW; ++ni) {
          if (!kExactA) mma_tf32(part[mi][ni], al, bh[ni]);
          mma_tf32(part[mi][ni], ah, bl[ni]);
          mma_tf32(part[mi][ni], ah, bh[ni]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MPW; ++mi)
#pragma unroll
      for (int ni = 0; ni < NPW; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = __fadd_rn(acc[mi][ni][r], part[mi][ni][r]);
  };
  if (keep_any) {
    Walk walk{bcols + b * bwidth, bwidth, nbcols};
    walk_blocks<T, BS, NFT, L, kBsrThreads>(smem, walk, blocks, X, b, ncols, nf, f0, x16, mul);
  }
#pragma unroll
  for (int mi = 0; mi < MPW; ++mi) {
    const int m = wm + mi * WM;
    if (m >= MT) continue;
#pragma unroll
    for (int ni = 0; ni < NPW; ++ni) {
      const int64_t col = f0 + (wn + ni * WN) * 8 + 2 * tq;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = m * 16 + g + (r >= 2 ? 8 : 0);
        const int64_t c = col + (r & 1);
        if (c < nf) Y[(row0 + i) * nf + c] = s_keep[i] ? acc[mi][ni][r] : 0.f;
      }
    }
  }
}

// CUDA cores: TPR threads a block row, each over JS = BS / TPR columns of
// the block, NFT (1 or 8) columns of X.
template <typename T, int BS, int NFT>
__global__ void __launch_bounds__(kBsrThreads)
bsr_spmm_cc_kernel(const int32_t* __restrict__ bcols, const T* __restrict__ blocks,
                   const float* __restrict__ X, const bool* __restrict__ mask,
                   float* __restrict__ Y, int bwidth, int64_t nbcols, int64_t ncols,
                   int64_t nf, bool x16) {
  constexpr int TPR = cc_rows_threads(BS);
  constexpr int NTH = BS * TPR, JS = BS / TPR;
  using L = CcLayout<T, BS, NFT>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool s_keep[BS];

  const int t = threadIdx.x;
  const int i = t / TPR, js = t % TPR;
  const int64_t b = blockIdx.x;
  const int64_t f0 = static_cast<int64_t>(blockIdx.y) * NFT;
  const int64_t row0 = b * BS;

  if (t < BS) s_keep[t] = mask == nullptr || mask[row0 + t];
  const bool keep_any = __syncthreads_or(t < BS && s_keep[t]);

  float acc[NFT];
#pragma unroll
  for (int f = 0; f < NFT; ++f) acc[f] = 0.f;
  auto mul = [&](const T* As, const float* Xs) {
#pragma unroll
    for (int jj = 0; jj < JS; ++jj) {
      const int j = js * JS + jj;
      const float a = to_f32(As[i * L::LDA + j]);
#pragma unroll
      for (int f = 0; f < NFT; ++f) acc[f] = fmaf(a, Xs[j * L::LDX + f], acc[f]);
    }
  };
  if (keep_any) {
    Walk walk{bcols + b * bwidth, bwidth, nbcols};
    walk_blocks<T, BS, NFT, L, NTH>(smem, walk, blocks, X, b, ncols, nf, f0, x16, mul);
  }
#pragma unroll
  for (int f = 0; f < NFT; ++f)
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1)
      acc[f] = __fadd_rn(acc[f], __shfl_xor_sync(0xffffffffu, acc[f], o));
  const int64_t row = row0 + i;
#pragma unroll
  for (int f = 0; f < NFT; ++f)
    if (f % TPR == js && f0 + f < nf) Y[row * nf + f0 + f] = s_keep[i] ? acc[f] : 0.f;
}

struct BsrArgs {
  const void *bcols, *blocks, *x, *mask;
  void* y;
  int64_t nbrows;
  int bwidth;
  int64_t ncols, nf;
  bool x16;
  cudaStream_t stream;
};

template <typename T, int BS, int NFT, typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int smem, const BsrArgs& a) {
  const int64_t nftiles = (a.nf + NFT - 1) / NFT;
  if (a.nbrows > 0x7fffffffLL || nftiles > 65535) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(a.nbrows), static_cast<unsigned>(nftiles));
  const int64_t nbcols = (a.ncols + BS - 1) / BS;
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const int32_t*>(a.bcols), static_cast<const T*>(a.blocks),
      static_cast<const float*>(a.x), static_cast<const bool*>(a.mask),
      static_cast<float*>(a.y), a.bwidth, nbcols, a.ncols, a.nf, a.x16);
  return cudaGetLastError();
}

template <typename T, int BS, int NFT>
cudaError_t launch_tc(const BsrArgs& a) {
  using L = TcLayout<T, BS, NFT>;
  const int lo_bytes = std::is_same<T, float>::value ? BS * L::LDA * 4 : 0;
  return launch<T, BS, NFT>(bsr_spmm_tc_kernel<T, BS, NFT>, kBsrThreads, L::kBytes + lo_bytes,
                            a);
}

template <typename T, int BS, int NFT>
cudaError_t launch_cc(const BsrArgs& a) {
  return launch<T, BS, NFT>(bsr_spmm_cc_kernel<T, BS, NFT>, BS * cc_rows_threads(BS),
                            CcLayout<T, BS, NFT>::kBytes, a);
}

template <typename T, int BS>
cudaError_t launch_path(const BsrArgs& a) {
  if constexpr (tensor_cores(BS, 8)) {
    if (tensor_cores(BS, a.nf))
      return a.nf <= 32 ? launch_tc<T, BS, 32>(a) : launch_tc<T, BS, 128>(a);
  }
  return a.nf == 1 ? launch_cc<T, BS, 1>(a) : launch_cc<T, BS, 8>(a);
}

template <typename T>
cudaError_t launch_bs(int bs, const BsrArgs& a) {
  switch (bs) {
    case 8: return launch_path<T, 8>(a);
    case 16: return launch_path<T, 16>(a);
    case 32: return launch_path<T, 32>(a);
    case 64: return launch_path<T, 64>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace repro

// 1 when bsr_spmm at block edge bs and nf columns runs on the tensor cores,
// 0 when it runs on the CUDA cores.
extern "C" int repro_bsr_spmm_tensor_cores(int bs, long long nf) {
  return repro::tensor_cores(bs, nf);
}

// bcols (nbrows, bwidth) int32, blocks (nbrows, bwidth, bs, bs), x (ncols, nf)
// f32, mask (nbrows * bs,) bool or null, y (nbrows * bs, nf) f32. blocks and x
// start on 16-byte boundaries.
extern "C" int repro_bsr_spmm(const void* bcols, const void* blocks, const void* x,
                              const void* mask, void* y, long long nbrows, int bwidth,
                              int bs, long long ncols, long long nf, int dtype,
                              void* stream) {
  if (nbrows == 0 || nf == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(blocks) | reinterpret_cast<uintptr_t>(x)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const repro::BsrArgs a{bcols, blocks, x,  mask,   y,
                         nbrows, bwidth, ncols, nf, nf % 4 == 0,
                         static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case repro::kF32: return repro::launch_bs<float>(bs, a);
    case repro::kBF16: return repro::launch_bs<__nv_bfloat16>(bs, a);
    case repro::kF16: return repro::launch_bs<__half>(bs, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
