// SELL-C-sigma SpMV for Hopper (sm_90a) over the "scs" plan stream.
//
// Replaces the TPU kernel src/repro/kernels/sell_spmv.py:64 (scs_spmv), which
// serves both the csr and the sell formats.
//
// Bound: bytes. The function needs each stored entry's id (int8/int16/int32)
// and value once, x, perm and the cached index (per-block real j-steps, the
// chunk list), and writes y once; 2 flops per stored value. At HPCG 104^3
// (tiled plan, int16 ids, f32 values) that is about 192 MB, 57 us at 3.35
// TB/s. The kernel reads more: whole real j-steps (C slots each, pad slots
// included), their slices and each block's tile, about 210 MB; every slot of
// the plan, padding included, is 320 MB.
//
// Design. The plan stores window-major blocks of jb j-steps of C lanes; a
// window (sw slices of C rows) owns a contiguous run of blocks. A window can
// hold thousands of blocks (a power-law row of 543,351 entries makes one of
// 16,980), so the unit of work is a chunk: at most 32 consecutive blocks of
// one window (8 in the port's work lists), from a work list built once per
// plan and cached beside it (kernels/sell_spmv.py: scs_work_list). One warp
// takes one chunk.
// The padding of each (window, tile) bucket is a suffix of its last block;
// the warp reads only each block's real prefix (nreal, cached too).
//
// A warp stages its chunk's blocks with 16-byte cp.async copies into a
// ring of kRing slots in shared memory, up to three blocks ahead of the one
// it reads, so several blocks' ids, values and slices are in flight at once.
// Each lane owns rows of the window (row r = lane + 32 m: slice r / C, lane
// r % C; one row a lane at the defaults C = 8, sw = 4). The slices of a
// block's real j-steps never go down, so one ballot per slice over the
// staged slices gives each slice's j-step range; the lane walks its row's
// entries in it, kAhead at a time, and keeps the row's f32 sum in a
// register over the whole chunk. The next block's ranges and first kAhead
// entries (and their x) are gathered before this block's are added. The order of every sum
// (blocks in order, j-steps in order) is fixed by the plan and the chunk
// list alone, so two launches give equal bits and int8/int16 ids give the
// int32 result. A window of one chunk writes y[perm[p]] directly; a window
// of several writes one (sw x C) partial per chunk, and a second kernel adds
// those partials in a fixed order: parts of chunks, each summed in chunk
// order, then the parts in order.
// No float atomics.

#include "common.cuh"

namespace repro {

constexpr int kMaxWarpsPerCta = 8;
constexpr int kMergeThreads = 512;
// Blocks of a warp's ring in shared memory: the block being read, and up
// to three staged ahead of it (a ring of 3 read 1% slower at 104^3).
constexpr int kRing = 4;
// Entries of a row whose x a lane gathers before it adds them (8 read 9%
// slower at 104^3; examples/scs_kernel_ab.py).
constexpr int kAhead = 4;
// Shared memory a CTA's rings may take (4 CTAs an SM at C = 8, int16/f32).
constexpr int kRingBytesPerCta = 56 * 1024;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A ring slot holds one block's ids (jb x C), values (jb x C) and slices
// (jb); only the real j-steps are copied, rounded up to 16 bytes, which
// stays inside the block.
template <typename T, typename I>
struct Slot {
  int jb, C;
  __device__ __forceinline__ int vals_off() const { return jb * C * static_cast<int>(sizeof(I)); }
  __device__ __forceinline__ int lsl_off() const {
    return vals_off() + jb * C * static_cast<int>(sizeof(T));
  }
  __device__ __forceinline__ int bytes() const { return lsl_off() + jb * 4; }
};

// RPL rows of the window per lane: row r = lane + 32 m is slice r / C,
// lane r % C of that slice.
template <typename T, typename I, int RPL>
__global__ void __launch_bounds__(32 * kMaxWarpsPerCta)
scs_chunk_kernel(const int32_t* __restrict__ chunk_block,
                 const int32_t* __restrict__ chunk_win,
                 const int32_t* __restrict__ win_chunk,
                 const int32_t* __restrict__ btile, const int32_t* __restrict__ nreal,
                 const int32_t* __restrict__ lsl, const I* __restrict__ idx2,
                 const T* __restrict__ dat2, const int32_t* __restrict__ perm,
                 const float* __restrict__ x, T* __restrict__ y, float* __restrict__ partial,
                 int nchunks, int C, int sw, int jb, int64_t ct, int64_t nrows,
                 int64_t nrows_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * (blockDim.x >> 5) + wid;
  if (chunk >= nchunks) return;  // uniform over the warp; the kernel has no CTA barrier
  const Slot<T, I> sl{jb, C};
  unsigned char* ring = smem + wid * kRing * sl.bytes();
  const int R = sw * C;

  const int b0 = chunk_block[chunk], nb = chunk_block[chunk + 1] - b0;  // nb <= 32
  const int my_nreal = lane < nb ? nreal[b0 + lane] : 0;
  const int my_tile = lane < nb ? btile[b0 + lane] : 0;
  auto slot = [&](int i) { return ring + (i % kRing) * sl.bytes(); };

  // One commit group per call, empty past the chunk's last block.
  auto stage = [&](int i) {
    if (i < nb) {
      const int n = __shfl_sync(0xffffffffu, my_nreal, i);
      unsigned char* s = slot(i);
      const int64_t r0 = static_cast<int64_t>(b0 + i) * jb;
      const int ni = (n * C * static_cast<int>(sizeof(I)) + 15) >> 4;
      const int nv = (n * C * static_cast<int>(sizeof(T)) + 15) >> 4;
      const int nl = (n * 4 + 15) >> 4;
      const unsigned char* gi = reinterpret_cast<const unsigned char*>(idx2 + r0 * C);
      const unsigned char* gv = reinterpret_cast<const unsigned char*>(dat2 + r0 * C);
      const unsigned char* gl = reinterpret_cast<const unsigned char*>(lsl + r0);
      for (int e = lane; e < ni + nv + nl; e += 32) {
        if (e < ni) {
          cp_async16(s + 16 * e, gi + 16 * e);
        } else if (e < ni + nv) {
          cp_async16(s + sl.vals_off() + 16 * (e - ni), gv + 16 * (e - ni));
        } else {
          cp_async16(s + sl.lsl_off() + 16 * (e - ni - nv), gl + 16 * (e - ni - nv));
        }
      }
    }
    cp_async_commit();
  };

  int slice[RPL], c[RPL];
  float acc[RPL];
#pragma unroll
  for (int m = 0; m < RPL; ++m) {
    const int r = lane + 32 * m;
    slice[m] = r < R ? r / C : sw;  // a lane past the window's rows owns no j-step
    c[m] = r - (r / C) * C;
    acc[m] = 0.f;
  }

  // A block's first kAhead entries of each row, gathered ahead: the slice
  // ranges of the block's real j-steps and those entries' values and x.
  struct Ahead {
    const float* xt;  // x's column tile of the block
    int lo[RPL], hi[RPL];
    float vv[RPL][kAhead], xv[RPL][kAhead];
  };
  // No warp-wide step in here: finish() calls it a number of times that
  // differs from lane to lane.
  auto entries = [&](int i, const Ahead& ah, int off, float (&vv)[RPL][kAhead],
                     float (&xv)[RPL][kAhead]) {
    const unsigned char* s = slot(i);
    const I* sid = reinterpret_cast<const I*>(s);
    const T* sv = reinterpret_cast<const T*>(s + sl.vals_off());
    const float* xt = ah.xt;
    const int (&lo)[RPL] = ah.lo;
    const int (&hi)[RPL] = ah.hi;
#pragma unroll
    for (int m = 0; m < RPL; ++m)
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int j = lo[m] + off + u;
        const int col = j < hi[m] ? static_cast<int>(sid[j * C + c[m]]) : -1;
        vv[m][u] = j < hi[m] ? to_f32(sv[j * C + c[m]]) : 0.f;
        xv[m][u] = col >= 0 ? xt[col] : 0.f;
      }
  };
  // The slices of a block's real j-steps do not go down (the plan lays a
  // bucket out slice after slice), so slice k's j-steps are [lo_k, lo_k+1)
  // with lo_k the count of j-steps whose slice is below k.
  auto prepare = [&](int i, Ahead& ah) {
    const int n = __shfl_sync(0xffffffffu, my_nreal, i);
    const int32_t* ss = reinterpret_cast<const int32_t*>(slot(i) + sl.lsl_off());
    ah.xt = x + static_cast<int64_t>(__shfl_sync(0xffffffffu, my_tile, i)) * ct;
#pragma unroll
    for (int m = 0; m < RPL; ++m) ah.lo[m] = ah.hi[m] = 0;
    for (int g = 0; g < n; g += 32) {
      const int v = g + lane < n ? ss[g + lane] : 0x7fffffff;
      for (int k = 0; k <= sw; ++k) {
        const int cnt = __popc(__ballot_sync(0xffffffffu, v < k));
#pragma unroll
        for (int m = 0; m < RPL; ++m) {
          if (k == slice[m]) ah.lo[m] += cnt;
          if (k == slice[m] + 1) ah.hi[m] += cnt;
        }
      }
    }
    entries(i, ah, 0, ah.vv, ah.xv);
  };
  // Adds block i's entries in order: the gathered ones, then the rest in
  // batches of kAhead. A pad id inside a real j-step has value 0 and x 0:
  // it adds +0 to a sum that is never -0, which changes nothing.
  auto finish = [&](int i, const Ahead& ah) {
#pragma unroll
    for (int m = 0; m < RPL; ++m)
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        if (ah.lo[m] + u < ah.hi[m]) acc[m] = __fadd_rn(acc[m], __fmul_rn(ah.vv[m][u], ah.xv[m][u]));
    int longest = 0;
#pragma unroll
    for (int m = 0; m < RPL; ++m) longest = max(longest, ah.hi[m] - ah.lo[m]);
    for (int off = kAhead; off < longest; off += kAhead) {
      float vv[RPL][kAhead], xv[RPL][kAhead];
      entries(i, ah, off, vv, xv);
#pragma unroll
      for (int m = 0; m < RPL; ++m)
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
          if (ah.lo[m] + off + u < ah.hi[m])
            acc[m] = __fadd_rn(acc[m], __fmul_rn(vv[m][u], xv[m][u]));
    }
  };

  // The ring: blocks 0 .. kRing - 2 in flight first. Step i stages block
  // i + kRing - 1 into the slot block i - 1 freed, waits for block i + 1
  // (kRing - 2 younger groups may be outstanding), gathers its first
  // entries, and only then adds block i's.
  for (int i = 0; i < kRing - 1; ++i) stage(i);
  Ahead cur, nxt;
  cp_async_wait<kRing - 2>();
  __syncwarp();
  if (nb > 0) prepare(0, cur);
  for (int i = 0; i < nb; ++i) {
    stage(i + kRing - 1);
    if (i + 1 < nb) {
      cp_async_wait<kRing - 2>();
      __syncwarp();
      prepare(i + 1, nxt);
    }
    finish(i, cur);
    __syncwarp();  // every lane is done with block i's slot
    cur = nxt;
  }

  const int w = chunk_win[chunk];
  const bool alone = win_chunk[w + 1] - win_chunk[w] == 1;
#pragma unroll
  for (int m = 0; m < RPL; ++m) {
    const int r = lane + 32 * m;
    if (r >= R) continue;
    if (!alone) {
      partial[static_cast<int64_t>(chunk) * R + r] = acc[m];
      continue;
    }
    const int64_t p = static_cast<int64_t>(w) * R + r;
    if (p < nrows_pad) {
      const int row = perm[p];
      if (row < nrows) y[row] = from_f32<T>(acc[m]);
    }
  }
}

// One CTA per window of several chunks: kMergeThreads / R parts per row
// (R = sw * C rounded up to a power of two), part t summing chunks t, t +
// parts, ... in chunk order, then the parts added in order.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
scs_merge_kernel(const int32_t* __restrict__ split_win, const int32_t* __restrict__ win_chunk,
                 const float* __restrict__ partial, const int32_t* __restrict__ perm,
                 T* __restrict__ y, int rows_pow2, int C, int sw, int64_t nrows,
                 int64_t nrows_pad) {
  __shared__ float s_part[kMergeThreads];
  const int w = split_win[blockIdx.x];
  const int R = sw * C, parts = kMergeThreads / rows_pow2;
  const int t = threadIdx.x, p = t % rows_pow2, part = t / rows_pow2;
  const int c0 = win_chunk[w], c1 = win_chunk[w + 1];
  float sum = 0.f;
  if (p < R) {
#pragma unroll 8
    for (int c = c0 + part; c < c1; c += parts)
      sum = __fadd_rn(sum, partial[static_cast<int64_t>(c) * R + p]);
  }
  s_part[t] = sum;
  __syncthreads();
  if (part != 0 || p >= R) return;
  float total = s_part[p];
  for (int k = 1; k < parts; ++k) total = __fadd_rn(total, s_part[k * rows_pow2 + p]);
  const int64_t g = static_cast<int64_t>(w) * R + p;
  if (g < nrows_pad) {
    const int row = perm[g];
    if (row < nrows) y[row] = from_f32<T>(total);
  }
}

struct ScsArgs {
  const void *chunk_block, *chunk_win, *win_chunk, *split_win, *btile, *nreal, *lsl, *idx2,
      *dat2, *perm, *x;
  void *y, *partial;
  int nchunks, nsplit, C, sw, jb;
  int64_t ct, nrows, nrows_pad;
  cudaStream_t stream;
};

template <typename T, typename I, int RPL>
cudaError_t launch(const ScsArgs& a) {
  const int slot = a.jb * a.C * static_cast<int>(sizeof(I) + sizeof(T)) + a.jb * 4;
  int warps = kRingBytesPerCta / (kRing * slot);
  warps = warps < 1 ? 1 : (warps > kMaxWarpsPerCta ? kMaxWarpsPerCta : warps);
  const int smem = warps * kRing * slot;
  auto kernel = scs_chunk_kernel<T, I, RPL>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned ctas = static_cast<unsigned>((a.nchunks + warps - 1) / warps);
  kernel<<<ctas, 32 * warps, smem, a.stream>>>(
      static_cast<const int32_t*>(a.chunk_block), static_cast<const int32_t*>(a.chunk_win),
      static_cast<const int32_t*>(a.win_chunk), static_cast<const int32_t*>(a.btile),
      static_cast<const int32_t*>(a.nreal), static_cast<const int32_t*>(a.lsl),
      static_cast<const I*>(a.idx2), static_cast<const T*>(a.dat2),
      static_cast<const int32_t*>(a.perm), static_cast<const float*>(a.x),
      static_cast<T*>(a.y), static_cast<float*>(a.partial), a.nchunks, a.C, a.sw, a.jb,
      a.ct, a.nrows, a.nrows_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 0) return err;
  int rows_pow2 = 1;
  while (rows_pow2 < a.sw * a.C) rows_pow2 <<= 1;
  scs_merge_kernel<T><<<static_cast<unsigned>(a.nsplit), kMergeThreads, 0, a.stream>>>(
      static_cast<const int32_t*>(a.split_win), static_cast<const int32_t*>(a.win_chunk),
      static_cast<const float*>(a.partial), static_cast<const int32_t*>(a.perm),
      static_cast<T*>(a.y), rows_pow2, a.C, a.sw, a.nrows, a.nrows_pad);
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t launch_rows(const ScsArgs& a) {
  const int rows = a.sw * a.C;
  if (rows <= 32) return launch<T, I, 1>(a);
  if (rows <= 64) return launch<T, I, 2>(a);
  if (rows <= 128) return launch<T, I, 4>(a);
  return launch<T, I, 8>(a);
}

template <typename T>
cudaError_t launch_index(int itype, const ScsArgs& a) {
  switch (itype) {
    case kI8: return launch_rows<T, int8_t>(a);
    case kI16: return launch_rows<T, int16_t>(a);
    case kI32: return launch_rows<T, int32_t>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace repro

// The chunk list (chunk_block (nchunks + 1), chunk_win (nchunks), win_chunk
// (nwin + 1), split_win (nsplit); chunks of at most 32 blocks) and nreal (B,)
// come from kernels/sell_spmv.py; partial holds nchunks * sw * C floats when
// nsplit > 0, and may be null otherwise.
extern "C" int repro_scs_spmv_chunked(
    const void* chunk_block, const void* chunk_win, const void* win_chunk,
    const void* split_win, const void* btile, const void* nreal, const void* lsl,
    const void* idx2, const void* dat2, const void* perm, const void* x, void* y,
    void* partial, int nchunks, int nsplit, int C, int sw, int jb, long long ct,
    long long nrows, long long nrows_pad, int dtype, int itype, void* stream) {
  if (C <= 0 || C > 32 || (32 % C) != 0 || sw <= 0 || sw > 8 || jb <= 0 || jb % 16 != 0 ||
      sw * C > repro::kMergeThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nchunks == 0 || nrows == 0) return 0;
  const repro::ScsArgs a{chunk_block, chunk_win, win_chunk, split_win, btile, nreal, lsl,
                         idx2, dat2, perm, x, y, partial, nchunks, nsplit, C, sw, jb, ct,
                         nrows, nrows_pad, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case repro::kF32: return repro::launch_index<float>(itype, a);
    case repro::kBF16: return repro::launch_index<__nv_bfloat16>(itype, a);
    case repro::kF16: return repro::launch_index<__half>(itype, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
