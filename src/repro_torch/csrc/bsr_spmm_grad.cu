// The backward of bsr_spmm (Y = A @ X over bs x bs blocks) for Hopper
// (sm_90a): two kernels, one for each operand's gradient.
//
//  - bsr_spmm_t:  dX = A^T @ dY, (ncols, nf) f32.
//  - bsr_sddmm:   dB[s] = dY[rows of block row r] @ X[rows of block column
//                 bcols[s]]^T for every stored block s, (bs, bs) f32: dY X^T
//                 sampled at the stored blocks. A block id < 0 or >= nbcols
//                 gets a zero gradient.
//
// Replaces no TPU kernel: the reference's bsr/pallas key has no gradient
// (under jax.grad it raises NotImplementedError and dispatch falls back to
// bsr/plain). These kernels give the port's bsr_spmm its backward on the
// card, so the MoE 'bsr' lane trains there: the dispatch needs dX, the
// combine dX and dB (its block values are the router's gates).
//
// Bound. Each kernel reads every stored block (spmm_t) or writes it (sddmm),
// reads dY and X (sddmm) once and writes its output once; both do 2 * bs^2
// * nf flops per stored block. At qwen3-moe-235b-a22b's training shapes
// (T = 1,024 tokens, 128 experts top-8, C = 80, bs 8, nf 4,096) the
// combine's sddmm holds 8,192 blocks: 4.3 GFLOP, 64 us at the f32 CUDA-core
// rate (67 TFLOP/s) against 185 MB of bytes (55 us at 3.35 TB/s).
//
// Design. Both walk the stored blocks in one work list: the slots sorted
// stably by block column on the device (a sort and a searchsorted, no host
// read), invalid slots last, with segment_starts over it (kernels/_launch.py),
// as a work list steers the SELL kernel (csrc/sell_spmv.cu).
//  - bsr_spmm_t is a gather: one CTA owns one block column c and a tile of
//    FT features, walks c's run of blocks in the list's order and adds each
//    block's B^T dY into registers with fused multiply-adds (a block staged
//    in shared memory, read by a warp as one broadcast). No sum crosses
//    CTAs and nothing is atomic, so two launches give equal bits, and no
//    transposed container is built (its width would need a host read or
//    the worst-case padding).
//  - bsr_sddmm: one CTA per listed block. dY's and X's bs rows are staged
//    in shared memory FT features at a time; each thread owns outputs of
//    the bs x bs tile and, at bs 8 (64 outputs for 256 threads), a quarter
//    of the features; the quarters are added in a fixed order at the end.
//    Consecutive CTAs take blocks of one column, so X's rows come from L2.
// CUDA cores and f32 throughout: at bs 8 each block is a 64-entry tile.

#include "common.cuh"

namespace repro {

constexpr int kGradThreads = 256;

// dX: CTA (c, feature tile); thread (g, fl) owns feature f0 + fl and rows
// c*BS + g + jj*G of dX for jj < BS / G.
template <typename T, int BS, int FT>
__global__ void __launch_bounds__(kGradThreads)
bsr_spmm_t_kernel(const int32_t* __restrict__ order, const int32_t* __restrict__ starts,
                  const T* __restrict__ blocks, const float* __restrict__ dy,
                  float* __restrict__ dx, int bwidth, int64_t ncols, int64_t nf) {
  constexpr int G = kGradThreads / FT;
  constexpr int JPT = BS / G;
  static_assert(JPT * G == BS, "BS must be a multiple of the row groups");
  __shared__ float bsm[BS * BS];
  const int t = threadIdx.x;
  const int fl = t % FT, g = t / FT;
  const int64_t c = blockIdx.x;
  const int64_t f = static_cast<int64_t>(blockIdx.y) * FT + fl;
  const bool fok = f < nf;
  float acc[JPT];
#pragma unroll
  for (int jj = 0; jj < JPT; ++jj) acc[jj] = 0.f;
  const int k1 = starts[c + 1];
  for (int k = starts[c]; k < k1; ++k) {
    const int64_t s = order[k];
    const int64_t r = s / bwidth;
    const T* blk = blocks + s * (BS * BS);
    __syncthreads();  // every thread is done with the previous block
    for (int e = t; e < BS * BS; e += kGradThreads) bsm[e] = to_f32(blk[e]);
    __syncthreads();
    if (fok) {
      const float* dyr = dy + r * BS * nf + f;
#pragma unroll
      for (int i = 0; i < BS; ++i) {
        const float y = dyr[i * nf];
#pragma unroll
        for (int jj = 0; jj < JPT; ++jj) acc[jj] = fmaf(bsm[i * BS + g + jj * G], y, acc[jj]);
      }
    }
  }
  if (!fok) return;
#pragma unroll
  for (int jj = 0; jj < JPT; ++jj) {
    const int64_t row = c * BS + g + jj * G;
    if (row < ncols) dx[row * nf + f] = acc[jj];
  }
}

// dB: CTA k takes slot order[k]. At BS 8 thread t owns output t % 64 and
// features q, q + P, ... of each staged tile (q = t / 64, P = 4); at BS >=
// 16 it owns outputs t, t + 256, ... over every feature.
template <int BS, int FT>
__global__ void __launch_bounds__(kGradThreads)
bsr_sddmm_kernel(const int32_t* __restrict__ order, const int32_t* __restrict__ bcols,
                 const float* __restrict__ dy, const float* __restrict__ x,
                 float* __restrict__ db, int bwidth, int64_t nbcols, int64_t ncols,
                 int64_t nf) {
  constexpr int OUT = BS * BS;
  constexpr int P = OUT >= kGradThreads ? 1 : kGradThreads / OUT;
  constexpr int OPT = OUT >= kGradThreads ? OUT / kGradThreads : 1;
  constexpr int LD = FT + 1;  // rows padded by one word: no bank conflicts
  __shared__ float ys[BS * LD];
  __shared__ float xs[BS * LD];
  __shared__ float part[P > 1 ? P * OUT : 1];
  const int t = threadIdx.x;
  const int64_t s = order[blockIdx.x];
  const int64_t r = s / bwidth;
  const int64_t bc = bcols[s];
  float* out = db + s * OUT;
  if (bc < 0 || bc >= nbcols) {
    for (int e = t; e < OUT; e += kGradThreads) out[e] = 0.f;
    return;
  }
  const int q = P > 1 ? t / OUT : 0;
  const int o0 = P > 1 ? t % OUT : t;
  float acc[OPT];
#pragma unroll
  for (int m = 0; m < OPT; ++m) acc[m] = 0.f;
  const float* dyb = dy + r * BS * nf;
  const int64_t xr0 = bc * BS;
  for (int64_t f0 = 0; f0 < nf; f0 += FT) {
    for (int e = t; e < BS * FT; e += kGradThreads) {
      const int i = e / FT, ff = e - i * FT;
      const int64_t f = f0 + ff;
      const bool fok = f < nf;
      ys[i * LD + ff] = fok ? dyb[i * nf + f] : 0.f;
      xs[i * LD + ff] = fok && xr0 + i < ncols ? x[(xr0 + i) * nf + f] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < OPT; ++m) {
      const int o = o0 + m * kGradThreads;
      const float* yr = ys + (o / BS) * LD;
      const float* xr = xs + (o % BS) * LD;
      for (int ff = q; ff < FT; ff += P) acc[m] = fmaf(yr[ff], xr[ff], acc[m]);
    }
    __syncthreads();
  }
  if constexpr (P > 1) {
    part[q * OUT + o0] = acc[0];
    __syncthreads();
    if (t < OUT) {
      float v = part[t];
#pragma unroll
      for (int p = 1; p < P; ++p) v = __fadd_rn(v, part[p * OUT + t]);
      out[t] = v;
    }
  } else {
#pragma unroll
    for (int m = 0; m < OPT; ++m) out[o0 + m * kGradThreads] = acc[m];
  }
}

// The dX kernel's operands (the C entry's arguments, typed).
struct SpmmTArgs {
  const void *order, *starts, *blocks, *dy;
  void* dx;
  int64_t nbcols;
  int bwidth;
  int64_t ncols, nf;
  cudaStream_t stream;
};

template <typename T, int BS, int FT>
cudaError_t launch_spmm_t(const SpmmTArgs& a) {
  const int64_t ftiles = (a.nf + FT - 1) / FT;
  if (a.nbcols > 0x7fffffffLL || ftiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(a.nbcols), static_cast<unsigned>(ftiles));
  bsr_spmm_t_kernel<T, BS, FT><<<grid, kGradThreads, 0, a.stream>>>(
      static_cast<const int32_t*>(a.order), static_cast<const int32_t*>(a.starts),
      static_cast<const T*>(a.blocks), static_cast<const float*>(a.dy),
      static_cast<float*>(a.dx), a.bwidth, a.ncols, a.nf);
  return cudaGetLastError();
}

// 32 features a CTA (8 row groups) up to 32 columns, else 128 (2 groups).
template <typename T, int BS>
cudaError_t spmm_t_features(const SpmmTArgs& a) {
  return a.nf <= 32 ? launch_spmm_t<T, BS, 32>(a) : launch_spmm_t<T, BS, 128>(a);
}

template <typename T>
cudaError_t spmm_t_bs(int bs, const SpmmTArgs& a) {
  switch (bs) {
    case 8: return spmm_t_features<T, 8>(a);
    case 16: return spmm_t_features<T, 16>(a);
    case 32: return spmm_t_features<T, 32>(a);
    case 64: return spmm_t_features<T, 64>(a);
  }
  return cudaErrorInvalidValue;
}

// The dB kernel's operands.
struct SddmmArgs {
  const void *order, *bcols, *dy, *x;
  void* db;
  int64_t nslots;
  int bwidth;
  int64_t ncols, nf;
  cudaStream_t stream;
};

// Features staged a tile: 128 at bs 8 and 16, 64 at bs 32 and 64 (the two
// staged tiles stay under the 48 KB of static shared memory).
template <int BS>
cudaError_t launch_sddmm(const SddmmArgs& a) {
  constexpr int FT = BS <= 16 ? 128 : 64;
  if (a.nslots > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int64_t nbcols = (a.ncols + BS - 1) / BS;
  bsr_sddmm_kernel<BS, FT><<<static_cast<unsigned>(a.nslots), kGradThreads, 0, a.stream>>>(
      static_cast<const int32_t*>(a.order), static_cast<const int32_t*>(a.bcols),
      static_cast<const float*>(a.dy), static_cast<const float*>(a.x),
      static_cast<float*>(a.db), a.bwidth, nbcols, a.ncols, a.nf);
  return cudaGetLastError();
}

}  // namespace repro

// order (nslots,) int32: the slots sorted stably by block column, invalid
// slots last; starts (nbcols + 1,) int32: column c's run is [starts[c],
// starts[c + 1]). blocks (nslots, bs, bs) of dtype, dy (nbrows * bs, nf) f32,
// dx (ncols, nf) f32, written whole.
extern "C" int repro_bsr_spmm_t(const void* order, const void* starts, const void* blocks,
                                const void* dy, void* dx, long long nbcols, int bwidth, int bs,
                                long long ncols, long long nf, int dtype, void* stream) {
  if (ncols == 0 || nf == 0) return 0;
  const repro::SpmmTArgs a{order, starts, blocks, dy, dx, nbcols, bwidth, ncols, nf,
                           static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case repro::kF32: return repro::spmm_t_bs<float>(bs, a);
    case repro::kBF16: return repro::spmm_t_bs<__nv_bfloat16>(bs, a);
    case repro::kF16: return repro::spmm_t_bs<__half>(bs, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// order (nslots,) int32 as above, bcols (nbrows, bwidth) int32, dy (nbrows *
// bs, nf) f32, x (ncols, nf) f32, db (nslots, bs, bs) f32, written whole.
extern "C" int repro_bsr_sddmm(const void* order, const void* bcols, const void* dy,
                               const void* x, void* db, long long nslots, int bwidth, int bs,
                               long long ncols, long long nf, void* stream) {
  if (nslots == 0) return 0;
  const repro::SddmmArgs a{order, bcols, dy, x, db, nslots, bwidth, ncols, nf,
                           static_cast<cudaStream_t>(stream)};
  switch (bs) {
    case 8: return repro::launch_sddmm<8>(a);
    case 16: return repro::launch_sddmm<16>(a);
    case 32: return repro::launch_sddmm<32>(a);
    case 64: return repro::launch_sddmm<64>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
