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
// Design (full window). The TPU kernel contracts each tile of entries with
// a one-hot matrix over every row of y, which lives in VMEM. Here the rows
// are sorted, so each row's entries are one segment; the wrapper finds the
// segment starts once per container (a device searchsorted, cached) and
// one thread per row sums its segment in entry order. No float atomics, and
// the order is that of the plain PyTorch version, so f32 results are equal.
// Sentinel entries (row == nrows) lie past the last segment and are never
// read.
//
// Design (sliced). The TPU grid walks blocks in order: a block whose slice
// differs from the previous one initialises that slice's y window,
// otherwise it accumulates. Here one warp owns one slice of slice_rows rows
// and walks that slice's contiguous run of blocks in order (run starts from
// the sorted sid, computed once per plan), with the slice's y window in
// shared memory. 32 entries at a time: each lane forms its product with x
// read directly at ctile * ct + col (a bounds check on the last, partial
// tile replaces the reference's padded x copy), a segmented scan over lanes
// with equal rows (shuffles) combines each run of one row, and the last lane
// of each run adds the run's sum to the window. Where the rows of a step do
// not go down, its runs hold distinct rows and store at once. Where a row
// goes down, a row may recur in several runs of the step: the group's pad
// entries (row = slice start, value 0, which add 0 as in the reference)
// beside the slice's first row, or entries in any order. Then the runs of
// one row (__match_any_sync) store one after another in lane order, each
// behind a __syncwarp, in a function kept out of line (inlined, it slowed
// the kernel by about 2% on the row-sorted layouts of HPCG 104^3 on an
// H100; examples/scoo_kernel_ab.py). So the window needs no atomics, every
// sum is taken in a fixed order and two launches give equal bits, whatever
// the order of the entries inside a slice. The window is written to y once,
// at the end.
//
// Sliced without column tiles (scoo_spmv): the same kernel over the
// build_scoo layout, with global int32 column ids and no ctile array (every
// block's column offset is 0; the bounds check on x stays). build_scoo keeps
// each slice's entries in input order and pads the slice's last block with
// entries on its first row and value 0, and an empty slice with one whole
// block of them. At HPCG 104^3 (slices and blocks of 512) that is 30.3 M
// entries of row, column and value, about 363 MB: 108 us at 3.35 TB/s.

#include "common.cuh"

namespace repro {

constexpr int kCooThreads = 256;
constexpr int kSliceWarps = 4;  // slices (warps) per CTA

template <typename T>
__global__ void coo_rows_kernel(const int32_t* __restrict__ row_start,
                                const int32_t* __restrict__ col,
                                const T* __restrict__ val,
                                const float* __restrict__ x, T* __restrict__ y,
                                int64_t nrows, int64_t ncols) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nrows) return;
  float acc = 0.f;
  for (int64_t e = row_start[i]; e < row_start[i + 1]; ++e) {
    const int32_t c = col[e];
    if (c >= 0 && c < ncols) acc = mul_add_rn(acc, to_f32(val[e]), x[c]);
  }
  y[i] = from_f32<T>(acc);
}

// The runs of one warp step whose rows may recur (a row went down inside the
// step) store one after another, in lane order. Out of line, so that the
// common step, whose runs hold distinct rows, stays as short as it was.
__device__ __noinline__ void store_in_turns(float* win, int64_t lr, float v, int32_t r,
                                            bool store, int lane) {
  const unsigned same = __match_any_sync(0xffffffffu, r) & __ballot_sync(0xffffffffu, store);
  const int turn = __popc(same & ((1u << lane) - 1u));
  for (int k = 0; __any_sync(0xffffffffu, store && turn >= k); ++k) {
    if (store && turn == k) win[lr] = __fadd_rn(win[lr], v);
    __syncwarp();
  }
}

template <typename T, typename I>
__global__ void scoo_tiled_kernel(const int32_t* __restrict__ row,
                                  const I* __restrict__ col,
                                  const T* __restrict__ val,
                                  const int32_t* __restrict__ ctile,
                                  const int32_t* __restrict__ run_start,
                                  const float* __restrict__ x, T* __restrict__ y,
                                  int nslices, int tile, int slice_rows, int64_t ct,
                                  int64_t nrows, int64_t ncols) {
  extern __shared__ float s_win[];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slice = blockIdx.x * kSliceWarps + wib;
  if (slice >= nslices) return;  // uniform over the warp; no CTA barrier below
  float* win = s_win + wib * slice_rows;
  for (int i = lane; i < slice_rows; i += 32) win[i] = 0.f;
  __syncwarp();

  const int64_t w0 = static_cast<int64_t>(slice) * slice_rows;
  const unsigned le_mask = lane == 31 ? 0xffffffffu : ((1u << (lane + 1)) - 1u);
  for (int b = run_start[slice]; b < run_start[slice + 1]; ++b) {
    const int64_t tile_col = ctile == nullptr ? 0 : static_cast<int64_t>(ctile[b]) * ct;
    const int64_t base = static_cast<int64_t>(b) * tile;
    for (int e0 = 0; e0 < tile; e0 += 32) {
      const bool in = e0 + lane < tile;
      int32_t r = -1;
      float v = 0.f;
      if (in) {
        const int64_t e = base + e0 + lane;
        r = row[e];
        const int64_t c = tile_col + static_cast<int64_t>(col[e]);
        if (c >= tile_col && c < ncols) v = __fmul_rn(to_f32(val[e]), x[c]);
      }
      const int32_t r_prev = __shfl_up_sync(0xffffffffu, r, 1);  // lane 0: its own
      // segmented inclusive scan over lanes that hold the same row
      const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || r_prev != r);
      const int seg_start = 31 - __clz(heads & le_mask);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, v, off);
        if (lane - off >= seg_start) v = __fadd_rn(v, up);
      }
      const int32_t r_next = __shfl_down_sync(0xffffffffu, r, 1);
      const int64_t lr = static_cast<int64_t>(r) - w0;
      const bool store = in && (lane == 31 || r_next != r) && lr >= 0 && lr < slice_rows;
      if (__ballot_sync(0xffffffffu, in && r < r_prev) == 0) {
        if (store) win[lr] = __fadd_rn(win[lr], v);  // the runs' rows are distinct
      } else {
        store_in_turns(win, lr, v, r, store, lane);
      }
      __syncwarp();
    }
  }
  for (int i = lane; i < slice_rows; i += 32) {
    if (w0 + i < nrows) y[w0 + i] = from_f32<T>(win[i]);
  }
}

template <typename T>
cudaError_t launch_coo(const void* row_start, const void* col, const void* val,
                       const void* x, void* y, int64_t nrows, int64_t ncols,
                       cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((nrows + kCooThreads - 1) / kCooThreads);
  coo_rows_kernel<T><<<blocks, kCooThreads, 0, stream>>>(
      static_cast<const int32_t*>(row_start), static_cast<const int32_t*>(col),
      static_cast<const T*>(val), static_cast<const float*>(x), static_cast<T*>(y),
      nrows, ncols);
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t launch_scoo(const void* row, const void* col, const void* val,
                        const void* ctile, const void* run_start, const void* x,
                        void* y, int nslices, int tile, int slice_rows, int64_t ct,
                        int64_t nrows, int64_t ncols, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((nslices + kSliceWarps - 1) / kSliceWarps);
  const size_t smem = static_cast<size_t>(kSliceWarps) * slice_rows * sizeof(float);
  scoo_tiled_kernel<T, I><<<blocks, 32 * kSliceWarps, smem, stream>>>(
      static_cast<const int32_t*>(row), static_cast<const I*>(col),
      static_cast<const T*>(val), static_cast<const int32_t*>(ctile),
      static_cast<const int32_t*>(run_start), static_cast<const float*>(x),
      static_cast<T*>(y), nslices, tile, slice_rows, ct, nrows, ncols);
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
      static_cast<size_t>(repro::kSliceWarps) * slice_rows * sizeof(float) > 48 * 1024)
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
