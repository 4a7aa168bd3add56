// COO SpMV for Hopper (sm_90a): the full-window kernel over row-sorted
// entries and the sliced kernel, over the "coo-cols" plan or over the
// build_scoo layout without column tiles.
//
// Replaces the TPU kernels src/repro/kernels/coo_spmv.py:85 (coo_spmv),
// src/repro/kernels/coo_spmv.py:141 (scoo_spmv) and
// src/repro/kernels/coo_spmv.py:200 (scoo_spmv_tiled).
//
// Bound: bytes. Each entry's row, column and value is read once, x once and
// y written once; 2 flops per entry. At HPCG 13^3 (full window) that is
// about 0.63 MB, 0.2 us at 3.35 TB/s, far below a launch: the launch is
// what this kernel costs there. The "coo-cols" plan of HPCG 104^3 (30.2 M
// entries in 59,044 blocks of 512, int16 ids, f32 values) is about 312 MB
// with sid, ctile, x and y: 93 us.
//
// Design (full window, coo_rows_kernel). The TPU kernel contracts each tile
// of entries with a one-hot matrix over every row of y, which lives in
// VMEM. Here the rows are sorted, so each row's entries are one segment;
// the wrapper finds the segment starts once per container (a device
// searchsorted, cached with the container's checks) and one thread per row
// sums its segment in entry order. No float atomics, and the order is that
// of the plain PyTorch version, so f32 results are equal.
//  - A CTA's rows own one contiguous entry range, [row_start[r0],
//    row_start[r0 + T]). The CTA stages it through shared memory in passes
//    of kStage (2,048) entries: each thread takes 4 consecutive entries at
//    a time (16-byte loads of the columns, and of the values by their
//    width, where the arrays are aligned), kGroups (8) such groups a step,
//    every load of a step issued before its x gathers and every gather
//    before the products; it stores the products (__fmul_rn) in the stage.
//    A CTA has at most kStage / (kPerLane * kGroups) = 64 threads, so that
//    a step stages at most one pass and HPCG's 13^3 level (23 entries a
//    row) stages a CTA's range in one step. A column outside x stores +0,
//    which adds nothing: a sum that starts at +0 is never -0.
//  - After a barrier each thread adds its own segment's products from the
//    stage in entry order (__fadd_rn); a row longer than a pass goes on
//    in the next one.
//  - Small grids take small CTAs, as the resident DIA kernel does: HPCG's
//    13^3 level runs 69 CTAs of one warp, and so does every grid of up to
//    8,447 rows (the default max_onehot_rows is 8,192).
//  - Measured on HPCG's 13^3 level (examples/coo_kernel_ab.py, device
//    time, H100 80GB HBM3 at 700 W; PERF.md): one thread per row summing
//    its segment from device memory, 0.00455 ms; this design 0.00366 with
//    4 groups a step in every CTA (a one-warp CTA's range then takes two
//    steps), 0.00341-0.00343 with 8.
// Sentinel entries (row == nrows) lie past the last segment and are never
// read.
//
// Design (sliced). The TPU grid walks blocks in order: a block whose slice
// differs from the previous one initialises that slice's y window,
// otherwise it accumulates. Here one CTA owns one slice of slice_rows rows.
// Its run of blocks (run starts from the sorted sid, computed once per plan)
// is cut into P contiguous shares of warp steps, one per warp, by the
// layout alone (the run's length and P, which follows from slice_rows): P
// is 8, or fewer where 8 windows of slice_rows f32 would pass 48 KB. Each
// warp sums its share into its own window of the slice in shared memory;
// after one barrier the CTA adds the P windows of each row in warp order
// and writes y once. A step is 128 consecutive entries, 4 per lane, read
// with 16-byte loads of rows and values (and of ids, by their width) where
// the layout is aligned, scalar loads where it is not; the next step's
// loads are issued before the current step is summed. Each lane forms its
// products with x read directly at ctile * ct + col (a bounds check on the
// last, partial tile replaces the reference's padded x copy), adds its own
// runs of equal rows, and one segmented scan over lanes (shuffles) carries
// each lane's last run into the lanes that continue it; every run is added
// to the window once, at the entry where it ends. Where the rows of a step
// do not go down, those runs hold distinct rows and store at once. Where a
// row goes down, a row may end several runs of the step: the group's pad
// entries (row = slice start, value 0, which add 0 as in the reference)
// beside the slice's first row, or entries in any order. Then, for each of
// a lane's four entries in turn, the runs of one row (__match_any_sync)
// store one after another in lane order, each behind a __syncwarp, in a
// function kept out of line. So the windows need no atomics, every sum is
// taken in an order fixed by the layout (the index width plays no part)
// and two launches give equal bits, whatever the order of the entries
// inside a slice.
//
// Sliced without column tiles (scoo_spmv): the same kernel over the
// build_scoo layout, with global int32 column ids and no ctile array (every
// block's column offset is 0; the bounds check on x stays). build_scoo keeps
// each slice's entries in input order and pads the slice's last block with
// entries on its first row and value 0, and an empty slice with one whole
// block of them. At HPCG 104^3 (slices and blocks of 512) that is 30.3 M
// entries of row, column and value, about 363 MB: 108 us at 3.35 TB/s.

#include <climits>
#include <cstring>

#include "common.cuh"

namespace repro {

constexpr int kMaxSliceWarps = 8;      // warps (shares) per slice at most
constexpr int kPerLane = 4;            // consecutive entries of one lane
constexpr int kStep = 32 * kPerLane;   // entries of one warp step
constexpr int kWindowBytes = 48 * 1024;  // the warps' windows of one slice
constexpr unsigned kFull = 0xffffffffu;

// Warps per slice: kMaxSliceWarps, or as many windows of slice_rows f32 as
// kWindowBytes holds.
inline int slice_warps(int slice_rows) {
  const int fit = kWindowBytes / (slice_rows * static_cast<int>(sizeof(float)));
  return fit < kMaxSliceWarps ? fit : kMaxSliceWarps;
}

// The runs that end at one entry slot of a warp step whose rows may recur (a
// row went down inside the step) store one after another, in lane order.
// Out of line, so that the common step, whose runs hold distinct rows,
// stays short.
__device__ __noinline__ void store_in_turns(float* win, int64_t lr, float v, int32_t r,
                                            bool store, int lane) {
  const unsigned same = __match_any_sync(0xffffffffu, r) & __ballot_sync(0xffffffffu, store);
  const int turn = __popc(same & ((1u << lane) - 1u));
  for (int k = 0; __any_sync(0xffffffffu, store && turn >= k); ++k) {
    if (store && turn == k) win[lr] = __fadd_rn(win[lr], v);
    __syncwarp();
  }
}

template <int N> struct RawVec;
template <> struct RawVec<4> { using type = unsigned int; };
template <> struct RawVec<8> { using type = uint2; };
template <> struct RawVec<16> { using type = uint4; };

// out[u] = p[u] for the kPerLane elements at p, one vector load (p aligned
// to kPerLane * sizeof(E)).
template <typename E>
__device__ __forceinline__ void load_vec(const E* __restrict__ p, E (&out)[kPerLane]) {
  using R = typename RawVec<kPerLane * sizeof(E)>::type;
  const R raw = __ldg(reinterpret_cast<const R*>(p));
  memcpy(out, &raw, sizeof(R));
}

constexpr int kStage = 2048;  // products a CTA stages in one pass (8 KB)
constexpr int kGroups = 8;    // groups of kPerLane entries a thread takes a step
constexpr int kMaxRowsCta = kStage / (kPerLane * kGroups);  // threads a CTA at most

template <typename T>
__global__ void coo_rows_kernel(const int32_t* __restrict__ row_start,
                                const int32_t* __restrict__ col,
                                const T* __restrict__ val,
                                const float* __restrict__ x, T* __restrict__ y,
                                int64_t nrows, int64_t ncols, bool vec) {
  __shared__ __align__(16) float s_prod[kStage];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int64_t i = first + threadIdx.x;
  const int64_t c0 = row_start[first];
  const int64_t end = first + blockDim.x < nrows ? first + blockDim.x : nrows;
  const int64_t c1 = row_start[end];
  int64_t s = 0, e = 0;
  if (i < nrows) {
    s = row_start[i];
    e = row_start[i + 1];
  }
  float acc = 0.f;
  // passes start on a multiple of kPerLane; the up to 3 entries before c0
  // that the first one stages belong to earlier rows and are not added
  const int64_t base = c0 & ~static_cast<int64_t>(kPerLane - 1);
  for (int64_t cb = base; cb < c1; cb += kStage) {
    const int64_t ce = cb + kStage < c1 ? cb + kStage : c1;
    if (cb != base) __syncthreads();
    const int64_t step = static_cast<int64_t>(kPerLane) * kGroups * blockDim.x;
    for (int64_t g0 = cb + kPerLane * threadIdx.x; g0 < ce; g0 += step) {
      int32_t c[kGroups][kPerLane];
      T v[kGroups][kPerLane];
      float xv[kGroups][kPerLane];
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        const int64_t g = g0 + static_cast<int64_t>(q) * kPerLane * blockDim.x;
        if (vec && g + kPerLane <= ce) {
          load_vec(col + g, c[q]);
          load_vec(val + g, v[q]);
        } else {
#pragma unroll
          for (int u = 0; u < kPerLane; ++u) {
            c[q][u] = -1;
            if (g + u < ce) {
              c[q][u] = col[g + u];
              v[q][u] = val[g + u];
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kGroups; ++q)
#pragma unroll
        for (int u = 0; u < kPerLane; ++u)
          xv[q][u] = c[q][u] >= 0 && c[q][u] < ncols ? __ldg(x + c[q][u]) : 0.f;
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        const int64_t g = g0 + static_cast<int64_t>(q) * kPerLane * blockDim.x;
        if (g >= ce) break;
        float pr[kPerLane];
#pragma unroll
        for (int u = 0; u < kPerLane; ++u)
          pr[u] = c[q][u] >= 0 && c[q][u] < ncols ? __fmul_rn(to_f32(v[q][u]), xv[q][u])
                                                  : 0.f;
        *reinterpret_cast<float4*>(s_prod + (g - cb)) =
            make_float4(pr[0], pr[1], pr[2], pr[3]);
      }
    }
    __syncthreads();
    const int64_t k1 = e < ce ? e : ce;
    for (int64_t k = s > cb ? s : cb; k < k1; ++k) acc = __fadd_rn(acc, s_prod[k - cb]);
  }
  if (i < nrows) y[i] = from_f32<T>(acc);
}

// The block of the entry at offset o of a slice's run (32-bit division
// where the offset allows it).
__device__ __forceinline__ int block_of(int64_t o, int tile) {
  return o <= INT_MAX ? static_cast<int>(static_cast<unsigned>(o) / static_cast<unsigned>(tile))
                      : static_cast<int>(o / tile);
}

// One lane's entries of one warp step as loaded: rows (INT_MAX past the
// slice's run, which ends no stored run), global columns (-1 where the
// tile-local id is negative) and values.
struct LaneEntries {
  int32_t r[kPerLane];
  int64_t c[kPerLane];
  float v[kPerLane];
};

template <typename T, typename I>
__device__ __forceinline__ LaneEntries load_lane(const int32_t* __restrict__ row,
                                                 const I* __restrict__ col,
                                                 const T* __restrict__ val,
                                                 const int32_t* __restrict__ ctile,
                                                 int64_t ct, int tile, int b0, int64_t e0,
                                                 int64_t o, int64_t total, bool vec) {
  LaneEntries le;
  const int64_t e = e0 + o;  // the lane's first entry; o its offset in the slice's run
  if (vec && o + kPerLane <= total) {
    I c[kPerLane];
    T v[kPerLane];
    load_vec(row + e, le.r);
    load_vec(col + e, c);
    load_vec(val + e, v);
    const int64_t tcol =
        ctile == nullptr ? 0 : static_cast<int64_t>(__ldg(ctile + b0 + block_of(o, tile))) * ct;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      le.c[u] = c[u] >= 0 ? tcol + static_cast<int64_t>(c[u]) : -1;
      le.v[u] = to_f32(v[u]);
    }
    return le;
  }
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    le.r[u] = INT_MAX;
    le.c[u] = -1;
    le.v[u] = 0.f;
    if (o + u < total) {
      const int64_t tcol =
          ctile == nullptr ? 0 : static_cast<int64_t>(__ldg(ctile + b0 + block_of(o + u, tile))) * ct;
      const I c = col[e + u];
      le.r[u] = row[e + u];
      le.c[u] = c >= 0 ? tcol + static_cast<int64_t>(c) : -1;
      le.v[u] = to_f32(val[e + u]);
    }
  }
  return le;
}

// One warp step: the lane's products, its runs, the scan over lanes, and
// each run added to the window where it ends.
__device__ __forceinline__ void sum_step(const LaneEntries& le, const float* __restrict__ x,
                                         int64_t ncols, float* win, int64_t w0,
                                         int slice_rows, int lane) {
  float s[kPerLane];    // the lane's run sums so far, entry by entry
  bool head[kPerLane];  // the entry's run began at the lane's first entry
  int32_t rn[kPerLane + 1];  // the rows, then the next lane's first
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    const int64_t c = le.c[u];
    s[u] = c >= 0 && c < ncols ? __fmul_rn(le.v[u], __ldg(x + c)) : 0.f;
    head[u] = true;
    rn[u] = le.r[u];
  }
#pragma unroll
  for (int u = 1; u < kPerLane; ++u) {
    const bool same = rn[u] == rn[u - 1];
    if (same) s[u] = __fadd_rn(s[u - 1], s[u]);
    head[u] = head[u - 1] && same;
  }
  const int32_t prev_last = __shfl_up_sync(kFull, rn[kPerLane - 1], 1);  // lane 0: its own
  rn[kPerLane] = __shfl_down_sync(kFull, rn[0], 1);                     // lane 31: its own
  const bool carried = lane > 0 && rn[0] == prev_last;  // the first run goes on
  // segmented inclusive scan of the lanes' last runs over the lanes that
  // continue them (a lane that holds one run of the previous lane's row)
  const unsigned starts = __ballot_sync(kFull, !(carried && head[kPerLane - 1]));
  const unsigned le_mask = lane == 31 ? kFull : ((1u << (lane + 1)) - 1u);
  const int seg_start = 31 - __clz(starts & le_mask);
  float last = s[kPerLane - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kFull, last, off);
    if (lane - off >= seg_start) last = __fadd_rn(last, up);
  }
  const float carry = __shfl_up_sync(kFull, last, 1);

  bool down = false;
  float sum[kPerLane];
  bool store[kPerLane];
  int64_t lr[kPerLane];
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    const bool at_end = u == kPerLane - 1 && lane == 31;  // the step's last entry
    const bool ends = at_end || rn[u + 1] != rn[u];
    down = down || (!at_end && rn[u + 1] < rn[u]);
    sum[u] = u == kPerLane - 1 ? last : (head[u] && carried ? __fadd_rn(carry, s[u]) : s[u]);
    lr[u] = static_cast<int64_t>(rn[u]) - w0;
    store[u] = ends && lr[u] >= 0 && lr[u] < slice_rows;
  }
  if (!__any_sync(kFull, down)) {
#pragma unroll
    for (int u = 0; u < kPerLane; ++u)  // the runs' rows are distinct
      if (store[u]) win[lr[u]] = __fadd_rn(win[lr[u]], sum[u]);
  } else {
#pragma unroll
    for (int u = 0; u < kPerLane; ++u)
      store_in_turns(win, lr[u], sum[u], le.r[u], store[u], lane);
  }
  __syncwarp();
}

// At most 64 registers a thread, so that four CTAs of eight warps share an
// SM (78 without the cap: 4-7% slower on the layouts of HPCG 104^3 on an
// H100 80GB HBM3 at 700 W; examples/scoo_kernel_ab.py).
template <typename T, typename I>
__global__ void __launch_bounds__(kMaxSliceWarps * 32, 4)
scoo_tiled_kernel(const int32_t* __restrict__ row, const I* __restrict__ col,
                  const T* __restrict__ val, const int32_t* __restrict__ ctile,
                  const int32_t* __restrict__ run_start, const float* __restrict__ x,
                  T* __restrict__ y, int tile, int slice_rows, int64_t ct, int64_t nrows,
                  int64_t ncols, bool vec) {
  extern __shared__ float s_win[];
  const int warps = blockDim.x >> 5;
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slice = blockIdx.x;
  for (int i = threadIdx.x; i < warps * slice_rows; i += blockDim.x) s_win[i] = 0.f;
  __syncthreads();

  const int b0 = run_start[slice];
  const int64_t e0 = static_cast<int64_t>(b0) * tile;
  const int64_t total = static_cast<int64_t>(run_start[slice + 1] - b0) * tile;
  const int64_t nsteps = (total + kStep - 1) / kStep;
  const int64_t w0 = static_cast<int64_t>(slice) * slice_rows;
  float* win = s_win + wib * slice_rows;
  int64_t st = nsteps * wib / warps;  // this warp's share of the steps
  const int64_t st_end = nsteps * (wib + 1) / warps;
  const int64_t lane_off = static_cast<int64_t>(lane) * kPerLane;
  LaneEntries cur{};
  if (st < st_end)
    cur = load_lane(row, col, val, ctile, ct, tile, b0, e0, st * kStep + lane_off, total, vec);
  for (; st < st_end; ++st) {
    LaneEntries next{};
    if (st + 1 < st_end)
      next = load_lane(row, col, val, ctile, ct, tile, b0, e0, (st + 1) * kStep + lane_off,
                       total, vec);
    sum_step(cur, x, ncols, win, w0, slice_rows, lane);
    cur = next;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < slice_rows; i += blockDim.x) {
    float acc = s_win[i];
    for (int w = 1; w < warps; ++w) acc = __fadd_rn(acc, s_win[w * slice_rows + i]);
    if (w0 + i < nrows) y[w0 + i] = from_f32<T>(acc);
  }
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
cudaError_t launch_coo(const void* row_start, const void* col, const void* val,
                       const void* x, void* y, int64_t nrows, int64_t ncols,
                       cudaStream_t stream) {
  const int spread = spread_threads(nrows);
  const int threads = spread < kMaxRowsCta ? spread : kMaxRowsCta;
  const unsigned blocks = static_cast<unsigned>((nrows + threads - 1) / threads);
  const bool vec = aligned(col, kPerLane * sizeof(int32_t)) && aligned(val, kPerLane * sizeof(T));
  coo_rows_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(row_start), static_cast<const int32_t*>(col),
      static_cast<const T*>(val), static_cast<const float*>(x), static_cast<T*>(y),
      nrows, ncols, vec);
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t launch_scoo(const void* row, const void* col, const void* val,
                        const void* ctile, const void* run_start, const void* x,
                        void* y, int nslices, int tile, int slice_rows, int64_t ct,
                        int64_t nrows, int64_t ncols, cudaStream_t stream) {
  const int warps = slice_warps(slice_rows);
  const size_t smem = static_cast<size_t>(warps) * slice_rows * sizeof(float);
  const bool vec = tile % kPerLane == 0 && aligned(row, kPerLane * sizeof(int32_t)) &&
                   aligned(col, kPerLane * sizeof(I)) && aligned(val, kPerLane * sizeof(T));
  scoo_tiled_kernel<T, I><<<nslices, 32 * warps, smem, stream>>>(
      static_cast<const int32_t*>(row), static_cast<const I*>(col),
      static_cast<const T*>(val), static_cast<const int32_t*>(ctile),
      static_cast<const int32_t*>(run_start), static_cast<const float*>(x),
      static_cast<T*>(y), tile, slice_rows, ct, nrows, ncols, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scoo_index(int itype, const void* row, const void* col,
                              const void* val, const void* ctile, const void* run_start,
                              const void* x, void* y, int nslices, int tile,
                              int slice_rows, int64_t ct, int64_t nrows, int64_t ncols,
                              cudaStream_t stream) {
  switch (itype) {
    case kI8:
      return launch_scoo<T, int8_t>(row, col, val, ctile, run_start, x, y, nslices, tile,
                                    slice_rows, ct, nrows, ncols, stream);
    case kI16:
      return launch_scoo<T, int16_t>(row, col, val, ctile, run_start, x, y, nslices, tile,
                                     slice_rows, ct, nrows, ncols, stream);
    case kI32:
      return launch_scoo<T, int32_t>(row, col, val, ctile, run_start, x, y, nslices, tile,
                                     slice_rows, ct, nrows, ncols, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace repro

// Full window: row_start (nrows + 1,) int32 segment starts of the row-sorted
// entries, col (nnz,) int32 global columns, val (nnz,).
extern "C" int repro_coo_spmv(const void* row_start, const void* col, const void* val,
                              const void* x, void* y, long long nrows, long long ncols,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nrows == 0) return 0;
  switch (dtype) {
    case repro::kF32:
      return repro::launch_coo<float>(row_start, col, val, x, y, nrows, ncols, s);
    case repro::kBF16:
      return repro::launch_coo<__nv_bfloat16>(row_start, col, val, x, y, nrows, ncols, s);
    case repro::kF16:
      return repro::launch_coo<__half>(row_start, col, val, x, y, nrows, ncols, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Sliced over a "coo-cols" plan: row (B * tile,) int32 global rows, col
// tile-local (int8/int16/int32), val, ctile (B,) int32, run_start
// (nslices + 1,) int32 block runs of each slice.
extern "C" int repro_scoo_spmv_tiled(const void* row, const void* col, const void* val,
                                     const void* ctile, const void* run_start,
                                     const void* x, void* y, int nslices, int tile,
                                     int slice_rows, long long ct, long long nrows,
                                     long long ncols, int dtype, int itype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile <= 0 || slice_rows <= 0 ||
      static_cast<size_t>(slice_rows) * sizeof(float) > repro::kWindowBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nslices == 0 || nrows == 0) return 0;
  switch (dtype) {
    case repro::kF32:
      return repro::launch_scoo_index<float>(itype, row, col, val, ctile, run_start, x, y,
                                             nslices, tile, slice_rows, ct, nrows, ncols, s);
    case repro::kBF16:
      return repro::launch_scoo_index<__nv_bfloat16>(itype, row, col, val, ctile, run_start,
                                                     x, y, nslices, tile, slice_rows, ct,
                                                     nrows, ncols, s);
    case repro::kF16:
      return repro::launch_scoo_index<__half>(itype, row, col, val, ctile, run_start, x, y,
                                              nslices, tile, slice_rows, ct, nrows, ncols, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Sliced over a build_scoo layout: row, col (B * tile,) int32 global rows
// and columns, val, run_start (nslices + 1,) int32 block runs of each slice.
extern "C" int repro_scoo_spmv(const void* row, const void* col, const void* val,
                               const void* run_start, const void* x, void* y, int nslices,
                               int tile, int slice_rows, long long nrows, long long ncols,
                               int dtype, void* stream) {
  return repro_scoo_spmv_tiled(row, col, val, nullptr, run_start, x, y, nslices, tile,
                               slice_rows, 0, nrows, ncols, dtype, repro::kI32, stream);
}
