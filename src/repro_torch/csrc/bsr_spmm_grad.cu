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
// Bound. Each kernel reads every stored block (spmm_t) or writes every slot
// (sddmm), reads dY and X (sddmm) once and writes its output once; both do
// 2 * bs^2 * nf flops per stored block, 165 TFLOP/s in 3xTF32 (the fastest
// rate at rtol 2e-4). At qwen3-moe-235b-a22b's training shapes (T = 1,024
// tokens, 128 experts top-8, C = 80, bs 8, nf 4,096) all are set by bytes:
// the combine's dB reads 185 MB (55 us at 3.35 TB/s) for 4.3 GFLOP (26 us).
// What the bound does not count sets the time: a gather by block column
// reads a block row of dY (bs x nf) once per block, 1.07 GB at the MoE
// shapes, from L2 where the other blocks of that row left it.
//
// Design. Both walk one work list: the slots sorted stably by block column
// on the device (a sort and a searchsorted, no host read), pads last, with
// column c's run [starts[c], starts[c + 1]) (kernels/bsr_spmm.py,
// bsr_column_order). A CTA takes a block column's run, or a chunk of it,
// and walks it in the list's order. Runs are long where a column is
// shared: the dispatch's token blocks hold ~64 blocks each, and the MoE
// combine's overflow column holds a block for every dropped pick (4,135
// of 8,192 in the training step's first steps). So the dB kernel, and the
// dX kernel at bs 8, cut a run in chunks, and a CTA finds its column by a
// binary search of the chunks' prefix over the runs; the dX kernel at bs
// >= 16 walks a whole run. Each C entry builds its own prefix from
// `starts`, in the caller's scratch, with one small kernel (one CTA that
// scans the runs 1,024 at a time) ahead of its own: the chunk sizes are
// decided here and nowhere else, and the caller asks for the scratch's
// size (repro_bsr_spmm_t_scratch, repro_bsr_sddmm_scratch).
// Nothing is atomic, and a sum crosses CTAs only in a fixed order: two
// launches give equal bits.
//  - bsr_spmm_t at bs 16/32/64 is the forward's tensor-core kernel
//    (csrc/bsr_spmm.cu) with the roles swapped: a cp.async ring of (block,
//    dY rows) stages, one barrier a block, each block read transposed from
//    shared memory as the m16n8k8 A operand (rows padded by 8 elements so
//    the transposed reads miss no bank), 3xTF32 products into a per-block
//    partial added to the running sum with a rounded f32 add.
//  - bsr_spmm_t at bs 8 stays on the CUDA cores: a CTA takes a chunk of 64
//    entries of a run and a feature tile; thread t owns 4 features and the
//    8 rows of dX_c (32 f32 sums). The CTA stages 32 of the chunk's blocks
//    at a time in shared memory, upcast to f32 (two barriers a batch, none
//    a block); each thread then reads its block row of dY with 16-byte
//    loads, the next block's in flight while this one multiplies, and each
//    block value it reads (a broadcast) feeds 4 fused multiply-adds. A run
//    of one chunk writes dX_c; a longer one writes each chunk's partial
//    sum to scratch, and a second kernel adds them in chunk order.
//  - bsr_sddmm: a CTA of 4 warps takes a chunk of a column's run, 4
//    m-groups, one a warp: two blocks of the run at bs 8 (their 16 dY rows
//    share X_c's 8 rows as one m16n8k8 tile), one 16-row slice of a block
//    at bs >= 16. Each block's dB is its own, so chunks need no sum. It
//    streams K (the features) in tiles: X_c's tile through a cp.async ring
//    of two stages, split once into TF32 hi + lo by the threads that copied
//    it, one barrier a tile; each warp's dY rows come straight from global
//    memory with 16-byte loads (a dY value meets one warp). The features
//    of a 16-wide group are taken in the order a lane's 16-byte load gives
//    them, the same for dY and X, which a sum over K allows. Each K tile's
//    3xTF32 products go to a fresh partial, added to the f32 sum with a
//    rounded add. X_c is read once a chunk instead of once a block, and pad
//    slots are written as zeros by the CTAs in turn.
// bf16/f16 blocks are read as they are and upcast; sums are f32. Rows of X
// past ncols read as zero; features past nf are zero-filled; nf not a
// multiple of 4, or dY / X off a 16-byte boundary, take 4-byte loads.

#include <type_traits>

#include "async_tf32.cuh"
#include "common.cuh"

namespace repro {

// A float4 of p[0..3] (features f..f+3 of a row of nf): one 16-byte load
// when `vec`, else four loads that read zero at f + q >= nf.
__device__ __forceinline__ float4 load4(const float* p, int64_t f, int64_t nf, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(f < nf ? p[0] : 0.f, f + 1 < nf ? p[1] : 0.f, f + 2 < nf ? p[2] : 0.f,
                     f + 3 < nf ? p[3] : 0.f);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4], int64_t f, int64_t nf,
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (f + q < nf) p[q] = v[q];
}

constexpr int kPrefixThreads = 1024;

// Inclusive sums over a warp's lanes, two at once.
__device__ __forceinline__ int2 warp_scan(int2 v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, v.x, d), b = __shfl_up_sync(0xffffffffu, v.y, d);
    if (lane >= d) {
      v.x += a;
      v.y += b;
    }
  }
  return v;
}

// The chunks' prefix, by one CTA of kPrefixThreads: column c's run cut in
// chunks of `per` entries holds chunks [first[c], first[c + 1]); mfirst
// (when given) is the prefix of the chunk counts of the runs of more than
// one chunk. Columns are scanned kPrefixThreads at a time, in order.
__device__ void chunk_prefix(const int32_t* __restrict__ starts, int64_t nbcols, int per,
                             int32_t* __restrict__ first, int32_t* __restrict__ mfirst) {
  __shared__ int2 sums[kPrefixThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    first[0] = 0;
    if (mfirst != nullptr) mfirst[0] = 0;
  }
  int2 carry = make_int2(0, 0);
  for (int64_t base = 0; base < nbcols; base += kPrefixThreads) {
    const int64_t c = base + t;
    const int n = c < nbcols ? (starts[c + 1] - starts[c] + per - 1) / per : 0;
    int2 v = warp_scan(make_int2(n, n > 1 ? n : 0), lane);
    if (lane == 31) sums[warp] = v;
    __syncthreads();
    if (warp == 0) sums[lane] = warp_scan(sums[lane], lane);
    __syncthreads();
    if (warp > 0) {
      v.x += sums[warp - 1].x;
      v.y += sums[warp - 1].y;
    }
    if (c < nbcols) {
      first[c + 1] = carry.x + v.x;
      if (mfirst != nullptr) mfirst[c + 1] = carry.y + v.y;
    }
    carry.x += sums[kPrefixThreads / 32 - 1].x;
    carry.y += sums[kPrefixThreads / 32 - 1].y;
    __syncthreads();  // every thread has read sums before the next tile writes it
  }
}

// The column whose chunks hold chunk i: first[c] <= i < first[c + 1], by a
// binary search of the chunk prefix (first[0] = 0 <= i < first[nbcols]).
__device__ __forceinline__ int64_t chunk_column(const int32_t* first, int64_t nbcols,
                                                int64_t i) {
  int64_t c = 0, hi = nbcols;
  while (hi - c > 1) {
    const int64_t mid = (c + hi) / 2;
    if (first[mid] <= i) c = mid; else hi = mid;
  }
  return c;
}

// ------------------------------------------------------ dX, CUDA cores ----

constexpr int kCcThreads = 128;  // at most: fewer when nf < 512
constexpr int kCcBatch = 32;     // blocks staged a batch
constexpr int kCcChunk = 64;     // entries of a run a CTA takes

__global__ void __launch_bounds__(kPrefixThreads)
bsr_spmm_t_chunks_kernel(const int32_t* __restrict__ starts, int64_t nbcols,
                         int32_t* __restrict__ first, int32_t* __restrict__ mfirst) {
  chunk_prefix(starts, nbcols, kCcChunk, first, mfirst);
}

// CTA (i, feature tile) takes chunk i of a column's run (first: the chunk
// prefix); thread t owns features f .. f + 3, f = 4 *
// (tile * blockDim + t), of the 8 rows. A run of one chunk writes dX_c; a
// longer one writes its chunks' partial sums to part (row mfirst[c] + j
// for chunk j), which bsr_spmm_t_sum_kernel adds in chunk order.
template <typename T>
__global__ void __launch_bounds__(kCcThreads, 4)
bsr_spmm_t_cc_kernel(const int32_t* __restrict__ order, const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ first, const int32_t* __restrict__ mfirst,
                     const T* __restrict__ blocks, const float* __restrict__ dy,
                     float* __restrict__ dx, float* __restrict__ part, int bwidth,
                     int64_t nbcols, int64_t ncols, int64_t nf, bool vec) {
  constexpr int BS = 8, BB = BS * BS;
  __shared__ __align__(16) float bsm[kCcBatch][BB];
  __shared__ int64_t yoff[kCcBatch];  // the dY offset of each staged block's row r * BS
  const int t = threadIdx.x;
  const int64_t chunk = blockIdx.x;
  if (chunk >= first[nbcols]) return;  // the grid is a bound on the chunks
  const int64_t c = chunk_column(first, nbcols, chunk);
  const int j0 = static_cast<int>(chunk - first[c]);
  const int64_t f = 4 * (static_cast<int64_t>(blockIdx.y) * blockDim.x + t);
  const bool fok = f < nf;
  float acc[BS][4];
#pragma unroll
  for (int j = 0; j < BS; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  float4 ya[BS], yb[BS];
  auto load = [&](float4 (&y)[BS], int b) {
    const float* p = dy + yoff[b] + f;
#pragma unroll
    for (int i = 0; i < BS; ++i) y[i] = load4(p + i * nf, f, nf, vec);
  };
  auto mul = [&](const float4 (&y)[BS], int b) {
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      const float4 w0 = *reinterpret_cast<const float4*>(&bsm[b][i * BS]);
      const float4 w1 = *reinterpret_cast<const float4*>(&bsm[b][i * BS + 4]);
      const float w[BS] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        acc[j][0] = fmaf(w[j], y[i].x, acc[j][0]);
        acc[j][1] = fmaf(w[j], y[i].y, acc[j][1]);
        acc[j][2] = fmaf(w[j], y[i].z, acc[j][2]);
        acc[j][3] = fmaf(w[j], y[i].w, acc[j][3]);
      }
    }
  };
  const int k0 = starts[c] + j0 * kCcChunk, k1 = min(k0 + kCcChunk, starts[c + 1]);
  for (int kb = k0; kb < k1; kb += kCcBatch) {
    const int n = min(kCcBatch, k1 - kb);
    __syncthreads();  // every thread is done with the previous batch
    for (int e = t; e < n * BB; e += blockDim.x) {
      const int64_t s = order[kb + e / BB];
      bsm[e / BB][e % BB] = to_f32(blocks[s * BB + e % BB]);
    }
    for (int e = t; e < n; e += blockDim.x)
      yoff[e] = static_cast<int64_t>(order[kb + e] / bwidth) * BS * nf;
    __syncthreads();
    if (!fok) continue;
    // Two register sets: block b + 1's dY rows load while block b multiplies.
    load(ya, 0);
    for (int b = 0; b < n; b += 2) {
      if (b + 1 < n) load(yb, b + 1);
      mul(ya, b);
      if (b + 1 >= n) break;
      if (b + 2 < n) load(ya, b + 2);
      mul(yb, b + 1);
    }
  }
  if (!fok) return;
  const bool whole = first[c + 1] - first[c] == 1;
  float* out = whole ? dx + c * BS * nf : part + (mfirst[c] + j0) * BS * nf;
#pragma unroll
  for (int j = 0; j < BS; ++j)
    if (!whole || c * BS + j < ncols) store4(out + j * nf + f, acc[j], f, nf, vec);
}

// dX_c of a column whose run is not one chunk (CTA (c, feature tile), the
// cc kernel's threads): its chunks' partial sums added in chunk order, or
// zeros for an empty column.
__global__ void __launch_bounds__(kCcThreads)
bsr_spmm_t_sum_kernel(const int32_t* __restrict__ first, const int32_t* __restrict__ mfirst,
                      const float* __restrict__ part, float* __restrict__ dx, int64_t ncols,
                      int64_t nf, bool vec) {
  constexpr int BS = 8;
  const int64_t c = blockIdx.x;
  const int64_t f = 4 * (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x);
  const int n = first[c + 1] - first[c];
  if (n == 1 || f >= nf) return;
  const float* p = part + static_cast<int64_t>(mfirst[c]) * BS * nf + f;
  for (int j = 0; j < BS && c * BS + j < ncols; ++j) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < n; ++k) {
      const float4 q = load4(p + (k * BS + j) * nf, f, nf, vec);
      v[0] = __fadd_rn(v[0], q.x);
      v[1] = __fadd_rn(v[1], q.y);
      v[2] = __fadd_rn(v[2], q.z);
      v[3] = __fadd_rn(v[3], q.w);
    }
    store4(dx + (c * BS + j) * nf + f, v, f, nf, vec);
  }
}

// ----------------------------------------------------- dX, tensor cores ----

constexpr int kTcThreads = 256;

// The ring: 2 stages of a block (BS rows of LDA T) and the dY rows of its
// block row (BS rows of LDY f32, NFT features), and the lo parts of an f32
// block. LDA = BS + 8 elements keeps the transposed A reads (lanes tq * LDA
// + g) on distinct banks; LDY = NFT + 8 the B reads, as in the forward.
template <typename T, int BS, int NFT>
struct TLayout {
  static constexpr int S = 2;
  static constexpr int LDA = BS + 8;
  static constexpr int LDY = NFT + 8;
  static constexpr int kABytes = BS * LDA * static_cast<int>(sizeof(T));
  static constexpr int kStage = kABytes + BS * LDY * 4;
  static constexpr int kLoBytes = std::is_same<T, float>::value ? BS * LDA * 4 : 0;
  static constexpr int kBytes = S * kStage + kLoBytes;
};

// CTA (c, feature tile of NFT): the output's MT x NT tiles of 16 x 8 (dX_c's
// rows x features); warp (wm, wn) owns m-tiles wm, wm + WM, ... and n-tiles
// wn, wn + WN, ...
template <typename T, int BS, int NFT>
__global__ void __launch_bounds__(kTcThreads)
bsr_spmm_t_tc_kernel(const int32_t* __restrict__ order, const int32_t* __restrict__ starts,
                     const T* __restrict__ blocks, const float* __restrict__ dy,
                     float* __restrict__ dx, int bwidth, int64_t ncols, int64_t nf, bool y16) {
  using L = TLayout<T, BS, NFT>;
  constexpr int MT = BS / 16, NT = NFT / 8;
  constexpr int WN = NT < 8 ? NT : 8, WM = 8 / WN;
  constexpr int MPW = (MT + WM - 1) / WM, NPW = NT / WN;
  constexpr bool kExactA = !std::is_same<T, float>::value;
  constexpr int kRowChunks = BS * static_cast<int>(sizeof(T)) / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* a_lo = reinterpret_cast<unsigned*>(smem + L::S * L::kStage);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int64_t c = blockIdx.x;
  const int64_t f0 = static_cast<int64_t>(blockIdx.y) * NFT;

  float acc[MPW][NPW][4];
#pragma unroll
  for (int mi = 0; mi < MPW; ++mi)
#pragma unroll
    for (int ni = 0; ni < NPW; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  auto stage = [&](int st, int64_t slot) {
    unsigned char* As = smem + st * L::kStage;
    float* Ys = reinterpret_cast<float*>(As + L::kABytes);
    const unsigned char* blk = reinterpret_cast<const unsigned char*>(blocks + slot * BS * BS);
    for (int e = t; e < BS * kRowChunks; e += kTcThreads) {
      const int i = e / kRowChunks, k = e - i * kRowChunks;
      cp_async16(As + i * L::LDA * static_cast<int>(sizeof(T)) + k * 16, blk + e * 16, 16);
    }
    const float* yr = dy + (slot / bwidth) * BS * nf + f0;
    if (y16) {  // nf % 4 == 0: whole 16-byte chunks of a row, or none
      for (int e = t; e < BS * (NFT / 4); e += kTcThreads) {
        const int i = e / (NFT / 4), f = (e - i * (NFT / 4)) * 4;
        const bool ok = f0 + f < nf;
        cp_async16(Ys + i * L::LDY + f, ok ? yr + i * nf + f : dy, ok ? 16 : 0);
      }
    } else {
      for (int e = t; e < BS * NFT; e += kTcThreads) {
        const int i = e / NFT, f = e - i * NFT;
        const bool ok = f0 + f < nf;
        cp_async4(Ys + i * L::LDY + f, ok ? yr + i * nf + f : dy, ok ? 4 : 0);
      }
    }
  };
  auto mul = [&](const T* As, const float* Ys) {
    if constexpr (!kExactA) {  // split the f32 block once, hi in place
      float* aw = const_cast<float*>(reinterpret_cast<const float*>(As));
      for (int e = t; e < BS * BS; e += kTcThreads) {
        const int at = (e / BS) * L::LDA + e % BS;
        unsigned hi, lo;
        split_tf32(aw[at], hi, lo);
        aw[at] = __uint_as_float(hi);
        a_lo[at] = lo;
      }
      __syncthreads();
    }
    float part[MPW][NPW][4];
#pragma unroll
    for (int mi = 0; mi < MPW; ++mi)
#pragma unroll
      for (int ni = 0; ni < NPW; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[mi][ni][r] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < BS; k0 += 8) {  // k: the block's row i = dY's row
      unsigned bh[NPW][2], bl[NPW][2];
#pragma unroll
      for (int ni = 0; ni < NPW; ++ni) {
        const int n = (wn + ni * WN) * 8 + g;
        split_tf32(Ys[(k0 + tq) * L::LDY + n], bh[ni][0], bl[ni][0]);
        split_tf32(Ys[(k0 + tq + 4) * L::LDY + n], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MPW; ++mi) {
        const int m = wm + mi * WM;
        if (m >= MT) continue;
        const int j = m * 16 + g;  // A[j][i] = block[i][j]: read transposed
        const int at[4] = {(k0 + tq) * L::LDA + j, (k0 + tq) * L::LDA + j + 8,
                           (k0 + tq + 4) * L::LDA + j, (k0 + tq + 4) * L::LDA + j + 8};
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

  // Stage block k + 1 while block k multiplies: one barrier a block (the
  // f32 split adds one).
  const int kb = starts[c], ke = starts[c + 1];
  int put = 0, next = kb;
  auto refill = [&]() {
    if (next < ke) stage(put, order[next++]);
    put ^= 1;
    cp_async_commit();
  };
  refill();
  for (int k = kb; k < ke; ++k) {
    cp_async_wait<0>();
    __syncthreads();  // block k is here, and every thread is done with block k - 1's stage
    refill();
    const unsigned char* As = smem + ((k - kb) & 1) * L::kStage;
    mul(reinterpret_cast<const T*>(As), reinterpret_cast<const float*>(As + L::kABytes));
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
        const int64_t row = c * BS + m * 16 + g + (r >= 2 ? 8 : 0);
        const int64_t cc = col + (r & 1);
        if (row < ncols && cc < nf) dx[row * nf + cc] = acc[mi][ni][r];
      }
    }
  }
}

// -------------------------------------------------------------- dB ----

constexpr int kSdWarps = 4;
constexpr int kSdThreads = 32 * kSdWarps;

// The dB kernel's shapes at block edge BS: KT features a staged tile of
// X_c, rows padded to LDX = KT + 16 floats (a quarter-warp's 16-byte reads,
// rows g and g + 1, miss no bank); NT n8-tiles of X_c's rows; BPC blocks a
// chunk of the run (4 m-groups of 16 dY rows).
template <int BS>
struct SdShape {
  static constexpr int KT = BS == 8 ? 128 : BS == 16 ? 64 : 32;
  static constexpr int LDX = KT + 16;
  static constexpr int NT = BS / 8;
  static constexpr int MT = BS < 16 ? 1 : BS / 16;
  static constexpr int BPC = BS == 8 ? 2 * kSdWarps : kSdWarps / MT;
  static constexpr int S = 2;
  static constexpr int kTile = BS * LDX;  // floats of one stage's hi (or lo) tile
  static constexpr int kBytes = S * 2 * kTile * 4;
  static constexpr int kChunks = BS * KT / 4;  // 16-byte chunks of a tile
};

template <int BS>
__global__ void __launch_bounds__(kPrefixThreads)
bsr_sddmm_chunks_kernel(const int32_t* __restrict__ starts, int64_t nbcols,
                        int32_t* __restrict__ first) {
  chunk_prefix(starts, nbcols, SdShape<BS>::BPC, first, nullptr);
}

// CTA i takes chunk i: column c's run cut in chunks of BPC entries holds
// chunks [first[c], first[c + 1]) (a long run spreads over many CTAs, and
// no sum crosses them: each block's dB is its own). Warp w's m-group in a
// chunk starting at entry ch: at bs 8 entries ch + 2w (rows 0-7 of the
// tile) and ch + 2w + 1 (rows 8-15), at bs >= 16 rows 16 (w % MT) .. + 15
// of entry ch + w / MT.
template <int BS>
__global__ void __launch_bounds__(kSdThreads)
bsr_sddmm_kernel(const int32_t* __restrict__ order, const int32_t* __restrict__ starts,
                 const int32_t* __restrict__ first, const float* __restrict__ dy,
                 const float* __restrict__ x, float* __restrict__ db, int bwidth,
                 int64_t nslots, int64_t nbcols, int64_t ncols, int64_t nf, bool vec) {
  using Sh = SdShape<BS>;
  constexpr int KT = Sh::KT, LDX = Sh::LDX, NT = Sh::NT, MT = Sh::MT, U = KT / 16;
  extern __shared__ __align__(16) float xs[];  // stage st: hi tile, then lo tile
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int64_t i = blockIdx.x;

  // Pad slots (listed last) get zeros, every gridDim.x-th one here.
  for (int64_t k = starts[nbcols] + i; k < nslots; k += gridDim.x) {
    float4* out = reinterpret_cast<float4*>(db + static_cast<int64_t>(order[k]) * BS * BS);
    for (int e = t; e < BS * BS / 4; e += kSdThreads) out[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (i >= first[nbcols]) return;  // the grid is a bound on the chunks
  const int64_t c = chunk_column(first, nbcols, i);

  const int64_t xr0 = c * BS;
  const int ntiles = static_cast<int>((nf + KT - 1) / KT);
  // Stage X_c's rows, features [kt * KT, kt * KT + KT), into stage st:
  // thread t copies the 16-byte chunks t, t + 128, ... (and splits them).
  auto stage = [&](int st, int kt) {
    float* hi = xs + st * 2 * Sh::kTile;
    for (int e = t; e < Sh::kChunks; e += kSdThreads) {
      const int j = e / (KT / 4), q = (e - j * (KT / 4)) * 4;
      const int64_t f = static_cast<int64_t>(kt) * KT + q;
      const bool row_ok = xr0 + j < ncols;
      const float* src = x + (xr0 + j) * nf + f;
      if (vec) {
        const bool ok = row_ok && f < nf;
        cp_async16(hi + j * LDX + q, ok ? src : x, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const bool ok = row_ok && f + p < nf;
          cp_async4(hi + j * LDX + q + p, ok ? src + p : x, ok ? 4 : 0);
        }
      }
    }
  };
  auto split = [&](int st) {  // this thread's chunks of stage st: hi in place, lo beside
    float* hi = xs + st * 2 * Sh::kTile;
    float* lo = hi + Sh::kTile;
    for (int e = t; e < Sh::kChunks; e += kSdThreads) {
      const int j = e / (KT / 4), q = (e - j * (KT / 4)) * 4;
      float4 v = *reinterpret_cast<float4*>(hi + j * LDX + q);
      unsigned h[4], l[4];
      split_tf32(v.x, h[0], l[0]);
      split_tf32(v.y, h[1], l[1]);
      split_tf32(v.z, h[2], l[2]);
      split_tf32(v.w, h[3], l[3]);
      *reinterpret_cast<uint4*>(hi + j * LDX + q) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + j * LDX + q) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  };

  const int ke = starts[c + 1];
  const int ch = starts[c] + static_cast<int>(i - first[c]) * Sh::BPC;
  // This warp's two 8-row halves of its m-group: dY rows and dB rows.
  const float *ylo = nullptr, *yhi = nullptr;
  float *olo = nullptr, *ohi = nullptr;
  if constexpr (BS == 8) {
    const int e0 = ch + 2 * warp;
    if (e0 < ke) {
      const int64_t s = order[e0];
      ylo = dy + ((s / bwidth) * BS + g) * nf;
      olo = db + s * BS * BS + g * BS;
    }
    if (e0 + 1 < ke) {
      const int64_t s = order[e0 + 1];
      yhi = dy + ((s / bwidth) * BS + g) * nf;
      ohi = db + s * BS * BS + g * BS;
    }
  } else {
    const int e = ch + warp / MT, m = warp % MT;
    if (e < ke) {
      const int64_t s = order[e];
      ylo = dy + ((s / bwidth) * BS + m * 16 + g) * nf;
      yhi = ylo + 8 * nf;
      olo = db + s * BS * BS + (m * 16 + g) * BS;
      ohi = olo + 8 * BS;
    }
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;

  stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ntiles; ++kt) {
    // This tile's dY features: lane (g, tq) takes f = 16u + 4tq .. + 3 of
    // rows g (lo) and g + 8 (hi); they load while X_c's tile lands.
    float4 alo[U], ahi[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t f = static_cast<int64_t>(kt) * KT + 16 * u + 4 * tq;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      alo[u] = ylo != nullptr && f < nf ? load4(ylo + f, f, nf, vec) : z;
      ahi[u] = yhi != nullptr && f < nf ? load4(yhi + f, f, nf, vec) : z;
    }
    cp_async_wait<0>();
    split(kt & 1);
    __syncthreads();  // tile kt is split, and every warp is done with tile kt - 1
    if (kt + 1 < ntiles) stage((kt + 1) & 1, kt + 1);
    cp_async_commit();
    if (ylo == nullptr) continue;
    const float* xh = xs + (kt & 1) * 2 * Sh::kTile;
    const float* xl = xh + Sh::kTile;
    float part[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[n][r] = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      unsigned lh[4], ll[4], hh[4], hl[4];
      const float lv[4] = {alo[u].x, alo[u].y, alo[u].z, alo[u].w};
      const float hv[4] = {ahi[u].x, ahi[u].y, ahi[u].z, ahi[u].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        split_tf32(lv[q], lh[q], ll[q]);
        split_tf32(hv[q], hh[q], hl[q]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int at = (n * 8 + g) * LDX + 16 * u + 4 * tq;
        const uint4 bh = *reinterpret_cast<const uint4*>(xh + at);
        const uint4 bl = *reinterpret_cast<const uint4*>(xl + at);
        const unsigned bhv[4] = {bh.x, bh.y, bh.z, bh.w}, blv[4] = {bl.x, bl.y, bl.z, bl.w};
#pragma unroll
        for (int s = 0; s < 2; ++s) {  // k = tq <-> feature 2s, k = tq + 4 <-> 2s + 1
          const unsigned a_h[4] = {lh[2 * s], hh[2 * s], lh[2 * s + 1], hh[2 * s + 1]};
          const unsigned a_l[4] = {ll[2 * s], hl[2 * s], ll[2 * s + 1], hl[2 * s + 1]};
          const unsigned b_h[2] = {bhv[2 * s], bhv[2 * s + 1]};
          const unsigned b_l[2] = {blv[2 * s], blv[2 * s + 1]};
          mma_tf32(part[n], a_l, b_h);
          mma_tf32(part[n], a_h, b_l);
          mma_tf32(part[n], a_h, b_h);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[n][r] = __fadd_rn(acc[n][r], part[n][r]);
  }
  // C fragment: rows g (lo) and g + 8 (hi), X rows n * 8 + 2tq, + 1.
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (olo != nullptr)
      *reinterpret_cast<float2*>(olo + n * 8 + 2 * tq) = make_float2(acc[n][0], acc[n][1]);
    if (ohi != nullptr)
      *reinterpret_cast<float2*>(ohi + n * 8 + 2 * tq) = make_float2(acc[n][2], acc[n][3]);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------- launches ----

// Dynamic shared memory above the default 48 KB needs the kernel's consent.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The dX kernels' operands (the C entry's arguments, typed).
struct SpmmTArgs {
  const int32_t *order, *starts;
  int32_t *first, *mfirst;  // bs 8: the chunks' prefixes, in the scratch
  const void* blocks;
  const float* dy;
  float *dx, *part;
  int64_t nslots, nbcols;
  int bwidth;
  int64_t ncols, nf;
  bool vec;  // nf % 4 == 0 and dY, dX on 16-byte boundaries
  cudaStream_t stream;
};

// The scratch at bs 8: first and mfirst, (nbcols + 1) int32 each, then
// part on a 16-byte boundary, 8 rows of nf for each chunk of a run cut in
// more than one (a run of len > kCcChunk entries has ceil(len / kCcChunk)
// < 2 len / kCcChunk chunks, so at most 2 ceil(nslots / kCcChunk) in all).
inline int64_t spmm_t_part_offset(int64_t nbcols) {
  return (2 * (nbcols + 1) * 4 + 15) / 16 * 16;
}
inline int64_t spmm_t_scratch_bytes(int64_t nslots, int64_t nbcols, int64_t nf) {
  return spmm_t_part_offset(nbcols) + 2 * ((nslots + kCcChunk - 1) / kCcChunk) * 8 * nf * 4;
}

// The chunks' prefix, then at most ceil(nslots / kCcChunk) + nbcols
// chunks (one partial chunk a column), then the sums of the runs cut in
// chunks.
template <typename T>
cudaError_t launch_spmm_t_cc(const SpmmTArgs& a) {
  const int64_t quads = (a.nf + 3) / 4;
  const int threads = quads >= kCcThreads ? kCcThreads : static_cast<int>((quads + 31) / 32 * 32);
  const int64_t ftiles = (quads + threads - 1) / threads;
  const int64_t chunks = (a.nslots + kCcChunk - 1) / kCcChunk + a.nbcols;
  if (ftiles > 65535 || chunks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bsr_spmm_t_chunks_kernel<<<1, kPrefixThreads, 0, a.stream>>>(a.starts, a.nbcols, a.first,
                                                               a.mfirst);
  const cudaError_t perr = cudaGetLastError();
  if (perr != cudaSuccess) return perr;
  if (chunks > 0) {
    bsr_spmm_t_cc_kernel<T><<<dim3(static_cast<unsigned>(chunks), static_cast<unsigned>(ftiles)),
                              threads, 0, a.stream>>>(
        a.order, a.starts, a.first, a.mfirst, static_cast<const T*>(a.blocks), a.dy, a.dx,
        a.part, a.bwidth, a.nbcols, a.ncols, a.nf, a.vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  bsr_spmm_t_sum_kernel<<<dim3(static_cast<unsigned>(a.nbcols), static_cast<unsigned>(ftiles)),
                          threads, 0, a.stream>>>(a.first, a.mfirst, a.part, a.dx, a.ncols,
                                                  a.nf, a.vec);
  return cudaGetLastError();
}

template <typename T, int BS, int NFT>
cudaError_t launch_spmm_t_tc(const SpmmTArgs& a) {
  using L = TLayout<T, BS, NFT>;
  const int64_t ftiles = (a.nf + NFT - 1) / NFT;
  if (ftiles > 65535) return cudaErrorInvalidConfiguration;
  auto kernel = bsr_spmm_t_tc_kernel<T, BS, NFT>;
  const cudaError_t err = allow_smem(kernel, L::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(a.nbcols), static_cast<unsigned>(ftiles)), kTcThreads,
           L::kBytes, a.stream>>>(a.order, a.starts, static_cast<const T*>(a.blocks), a.dy,
                                  a.dx, a.bwidth, a.ncols, a.nf, a.vec);
  return cudaGetLastError();
}

// bs 8 on the CUDA cores; bs 16/32/64 on the tensor cores, 32 features a
// CTA up to 32 columns, else 128.
template <typename T>
cudaError_t spmm_t_bs(int bs, const SpmmTArgs& a) {
  const bool narrow = a.nf <= 32;
  switch (bs) {
    case 8: return launch_spmm_t_cc<T>(a);
    case 16: return narrow ? launch_spmm_t_tc<T, 16, 32>(a) : launch_spmm_t_tc<T, 16, 128>(a);
    case 32: return narrow ? launch_spmm_t_tc<T, 32, 32>(a) : launch_spmm_t_tc<T, 32, 128>(a);
    case 64: return narrow ? launch_spmm_t_tc<T, 64, 32>(a) : launch_spmm_t_tc<T, 64, 128>(a);
  }
  return cudaErrorInvalidValue;
}

// The dB kernel's operands.
struct SddmmArgs {
  const int32_t *order, *starts;
  int32_t* first;  // the chunks' prefix, the scratch
  const float *dy, *x;
  float* db;
  int64_t nslots;
  int bwidth;
  int64_t ncols, nf;
  bool vec;  // nf % 4 == 0 and dY, X on 16-byte boundaries
  cudaStream_t stream;
};

// The chunks' prefix, then the chunks.
template <int BS>
cudaError_t launch_sddmm(const SddmmArgs& a) {
  using Sh = SdShape<BS>;
  const int64_t nbcols = (a.ncols + BS - 1) / BS;
  // At most ceil(nslots / BPC) + nbcols chunks (one partial chunk a column);
  // at least one CTA, which zeroes the pads.
  const int64_t grid = (a.nslots + Sh::BPC - 1) / Sh::BPC + nbcols;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  auto kernel = bsr_sddmm_kernel<BS>;
  cudaError_t err = allow_smem(kernel, Sh::kBytes);
  if (err != cudaSuccess) return err;
  bsr_sddmm_chunks_kernel<BS><<<1, kPrefixThreads, 0, a.stream>>>(a.starts, nbcols, a.first);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(grid), kSdThreads, Sh::kBytes, a.stream>>>(
      a.order, a.starts, a.first, a.dy, a.x, a.db, a.bwidth, a.nslots, nbcols, a.ncols, a.nf,
      a.vec);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace repro

// Bytes of the scratch repro_bsr_spmm_t needs (0 at bs 16/32/64).
extern "C" long long repro_bsr_spmm_t_scratch(long long nslots, long long nbcols, int bs,
                                              long long nf) {
  return bs == 8 ? repro::spmm_t_scratch_bytes(nslots, nbcols, nf) : 0;
}

// order (nslots,) int32: the slots sorted stably by block column, pad slots
// last; starts (nbcols + 1,) int32: column c's run is [starts[c], starts[c +
// 1]). blocks (nslots, bs, bs) of dtype on a 16-byte boundary, dy (nbrows *
// bs, nf) f32, dx (ncols, nf) f32, written whole; scratch on a 16-byte
// boundary, of repro_bsr_spmm_t_scratch's bytes.
extern "C" int repro_bsr_spmm_t(const void* order, const void* starts, const void* blocks,
                                const void* dy, void* dx, void* scratch, long long nslots,
                                long long nbcols, int bwidth, int bs, long long ncols,
                                long long nf, int dtype, void* stream) {
  if (ncols == 0 || nf == 0) return 0;
  if (!repro::aligned16(blocks) || !repro::aligned16(scratch))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (nbcols > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  int32_t* first = static_cast<int32_t*>(scratch);
  float* part = reinterpret_cast<float*>(static_cast<char*>(scratch) +
                                         repro::spmm_t_part_offset(nbcols));
  const repro::SpmmTArgs a{static_cast<const int32_t*>(order),
                           static_cast<const int32_t*>(starts),
                           first,
                           first + nbcols + 1,
                           blocks,
                           static_cast<const float*>(dy),
                           static_cast<float*>(dx),
                           part,
                           nslots,
                           nbcols,
                           bwidth,
                           ncols,
                           nf,
                           nf % 4 == 0 && repro::aligned16(dy) && repro::aligned16(dx),
                           static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case repro::kF32: return repro::spmm_t_bs<float>(bs, a);
    case repro::kBF16: return repro::spmm_t_bs<__nv_bfloat16>(bs, a);
    case repro::kF16: return repro::spmm_t_bs<__half>(bs, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of the scratch repro_bsr_sddmm needs: the chunks' prefix.
extern "C" long long repro_bsr_sddmm_scratch(long long nbcols) { return (nbcols + 1) * 4; }

// order and starts as above (nbcols = ceil(ncols / bs)); dy (nbrows * bs,
// nf) f32, x (ncols, nf) f32, db (nslots, bs, bs) f32 on a 16-byte
// boundary, written whole; scratch of repro_bsr_sddmm_scratch's bytes.
extern "C" int repro_bsr_sddmm(const void* order, const void* starts, const void* dy,
                               const void* x, void* db, void* scratch, long long nslots,
                               int bwidth, int bs, long long ncols, long long nf,
                               void* stream) {
  if (nslots == 0) return 0;
  if (!repro::aligned16(db)) return static_cast<int>(cudaErrorMisalignedAddress);
  const repro::SddmmArgs a{static_cast<const int32_t*>(order),
                           static_cast<const int32_t*>(starts),
                           static_cast<int32_t*>(scratch),
                           static_cast<const float*>(dy),
                           static_cast<const float*>(x),
                           static_cast<float*>(db),
                           nslots,
                           bwidth,
                           ncols,
                           nf,
                           nf % 4 == 0 && repro::aligned16(dy) && repro::aligned16(x),
                           static_cast<cudaStream_t>(stream)};
  switch (bs) {
    case 8: return repro::launch_sddmm<8>(a);
    case 16: return repro::launch_sddmm<16>(a);
    case 32: return repro::launch_sddmm<32>(a);
    case 64: return repro::launch_sddmm<64>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
