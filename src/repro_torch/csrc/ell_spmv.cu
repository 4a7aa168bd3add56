// ELL SpMV for Hopper (sm_90a): one kernel for the resident arrays and the
// column-tiled plan, walking only the (row chunk, column tile) pairs that
// hold entries, with the optional row mask.
//
// Replaces the TPU kernels src/repro/kernels/ell_spmv.py:43 (ell_spmv) and
// src/repro/kernels/ell_spmv.py:92 (ell_spmv_tiled), and the masked ELL
// wrapper of src/repro/kernels/ops.py:217.
//
// Bound: bytes. The resident arrays need every index slot once (the -1
// padding included: no one knows where it is without reading it), the
// value of every real slot once, x and y once; 2 flops per real slot. At
// HPCG 52^3 (W = 27, int32 ids, f32 values) that is about 31.5 MB, 9.4 us
// at 3.35 TB/s. The tiled "ell-cols" plan of HPCG 104^3 is dense in (tile,
// row): 69 tiles x 1,124,864 rows x W = 18 slots for 29.8 M nonzeros (47x),
// but a chunk of 128 rows has entries in only 2 or 3 of the 69 column tiles
// (the 27-point stencil reaches +-10,921 columns, a tile is 16,384 wide).
// What the data needs is the real ids and values, x and y: about 188 MB,
// 56 us.
//
// Design (ell_listed_kernel). The wrapper hands over an index of the tiles
// each chunk of kRows rows has entries in, as a CSR pair (tile_ptr,
// tile_ids), built once on the device from the ids. The resident arrays
// are the one-tile case (ids global, tile 0 at column 0), so one kernel
// serves both. One CTA per chunk walks only its listed tiles, in ascending
// order. For each, the chunk's slots are one contiguous run of rows x W ids
// and values (the container is row-major, so one thread per row reading
// its own slots would stride by W across a warp). The CTA copies the run
// to shared memory as it lies: raw ids and values, 16-byte cp.async copies
// between a scalar head and tail, no division per element, kRows x min(W,
// kChunk) slots at a time, so a W above kChunk is staged in several
// segments of the run. cp.async puts every copy of a thread in flight
// without holding the data in registers: vector loads through registers
// raised the kernel from 40 to 48 registers (10 CTAs an SM, not 12) and
// slowed runs that are mostly padding by 18% (PERF.md, PR 16). Values are loaded
// without waiting on their ids: a pad's value is staged but never added.
// Each thread then sums its row's staged slots in ascending k, kUnroll x
// gathers in flight, and adds the tile's sum to the row's total in
// ascending tile order. A chunk whose rows are all masked out stages
// nothing; a masked-out row of another chunk is staged with its neighbours
// but not summed, and writes 0: the mask goes into the kernel, with no
// masked copy of data. Loading a value vector only where one of its ids is
// >= 0 needs the ids first, and each such variant measured was slower
// than staging the run whole, on the stencil and on scattered columns
// alike, where the runs are mostly padding (PERF.md).
//
// Why skipping a tile keeps the bits. The plain version adds every tile's
// sum, the empty ones included, and an empty tile's sum is +0. A row's
// total starts at +0 and is never -0 (under round to nearest, +0 + -0 and
// x + -x are +0), so adding +0 leaves it unchanged: summing only the listed
// tiles gives the same total bit for bit, and the resident sum taken as a
// tile's gives the plain resident sum.
//
// Products and sums are rounded separately (common.cuh: mul_add_rn), in the
// order of the plain PyTorch versions in kernels/ell_spmv.py, so f32 results
// are equal to theirs bit for bit; y is written in the storage type.

#include "common.cuh"

namespace repro {

constexpr int kRows = 128;   // rows (threads) per CTA
constexpr int kChunk = 32;   // slots per row staged at a time

// Copies g[0, n) into shared memory at s[pad + j], where pad is g's offset
// from a 16-byte boundary in elements, so that every aligned 16 bytes of g
// lands on aligned 16 bytes of s (s is 16-byte aligned and holds n + 16 /
// sizeof(E) elements). Returns pad. The aligned part goes by cp.async: the
// caller waits for it (cp.async.wait_all) before the barrier that
// publishes the run.
template <typename E>
__device__ __forceinline__ int stage_run(E* __restrict__ s, const E* __restrict__ g, int n) {
  constexpr int kVec = 16 / sizeof(E);
  const int pad = static_cast<int>((reinterpret_cast<uintptr_t>(g) & 15) / sizeof(E));
  E* d = s + pad;
  const int head = min(n, (kVec - pad) & (kVec - 1));
  const int nvec = (n - head) / kVec;
  const uint4* gv = reinterpret_cast<const uint4*>(g + head);
  uint4* dv = reinterpret_cast<uint4*>(d + head);
  const int step = blockDim.x;
  for (int i = threadIdx.x; i < nvec; i += step) {  // no registers hold the copy
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dv + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gv + i));
  }
  for (int j = threadIdx.x; j < head; j += step) d[j] = g[j];
  for (int j = head + nvec * kVec + threadIdx.x; j < n; j += step) d[j] = g[j];
  return pad;
}

constexpr int kUnroll = 8;  // slots whose x loads are in flight together

// Bytes of a shared buffer that stage_run fills with up to `stage`
// elements of E, rounded up to 16 so the next buffer is aligned too.
template <typename E>
__host__ __device__ constexpr size_t stage_bytes(int stage) {
  return (static_cast<size_t>(stage) * sizeof(E) + 16 + 15) / 16 * 16;
}

template <typename T, typename I>
__global__ void ell_listed_kernel(const I* __restrict__ idx, const T* __restrict__ data,
                                  const float* __restrict__ x,
                                  const uint8_t* __restrict__ mask,
                                  const int32_t* __restrict__ tile_ptr,
                                  const int32_t* __restrict__ tile_ids, T* __restrict__ y,
                                  int64_t nrows, int width, int64_t ct, int stage) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  I* s_idx = reinterpret_cast<I*>(s_raw);
  T* s_val = reinterpret_cast<T*>(s_raw + stage_bytes<I>(stage));

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = nrows - r0 < kRows ? static_cast<int>(nrows - r0) : kRows;
  const int tid = threadIdx.x;
  const bool on = tid < rows && (mask == nullptr || mask[r0 + tid]);

  float total = 0.f;
  if (__syncthreads_or(on)) {
    const int run = rows * width;
    const int rw = tid * width;  // this row's first slot in the run
    for (int p = tile_ptr[blockIdx.x]; p < tile_ptr[blockIdx.x + 1]; ++p) {
      const int t = tile_ids[p];
      const int64_t off = (static_cast<int64_t>(t) * nrows + r0) * width;
      const float* xt = x + static_cast<int64_t>(t) * ct;
      float acc = 0.f;
      for (int a = 0; a < run; a += stage) {
        const int n = min(stage, run - a);
        __syncthreads();  // the previous segment has been consumed
        const int pi = stage_run(s_idx, idx + off + a, n);
        const int pv = stage_run(s_val, data + off + a, n);
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
        if (!on) continue;
        const int bi = pi - a, bv = pv - a;  // slot j of the run: s_idx[bi + j]
        int j = max(a, rw);
        const int j1 = min(a + n, rw + width);
        for (; j + kUnroll <= j1; j += kUnroll) {
          int32_t c[kUnroll];
          float xv[kUnroll], v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) c[u] = static_cast<int32_t>(s_idx[bi + j + u]);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            xv[u] = c[u] >= 0 ? __ldg(xt + c[u]) : 0.f;
            v[u] = to_f32(s_val[bv + j + u]);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (c[u] >= 0) acc = mul_add_rn(acc, v[u], xv[u]);
        }
        for (; j < j1; ++j) {
          const int32_t c = static_cast<int32_t>(s_idx[bi + j]);
          if (c >= 0) acc = mul_add_rn(acc, to_f32(s_val[bv + j]), __ldg(xt + c));
        }
      }
      total = __fadd_rn(total, acc);
    }
  }
  if (tid < rows) y[r0 + tid] = from_f32<T>(total);
}

template <typename T, typename I>
cudaError_t launch_ell_listed(const void* idx, const void* data, const void* x,
                              const void* mask, const void* tile_ptr, const void* tile_ids,
                              void* y, int64_t nrows, int width, int64_t ct,
                              cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((nrows + kRows - 1) / kRows);
  const int stage = kRows * min(width, kChunk);
  const size_t smem = stage_bytes<I>(stage) + stage_bytes<T>(stage);
  ell_listed_kernel<T, I><<<blocks, kRows, smem, stream>>>(
      static_cast<const I*>(idx), static_cast<const T*>(data),
      static_cast<const float*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(tile_ptr), static_cast<const int32_t*>(tile_ids),
      static_cast<T*>(y), nrows, width, ct, stage);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ell_listed_index(int itype, const void* idx, const void* data,
                                    const void* x, const void* mask, const void* tile_ptr,
                                    const void* tile_ids, void* y, int64_t nrows, int width,
                                    int64_t ct, cudaStream_t stream) {
  switch (itype) {
    case kI8:
      return launch_ell_listed<T, int8_t>(idx, data, x, mask, tile_ptr, tile_ids, y, nrows,
                                          width, ct, stream);
    case kI16:
      return launch_ell_listed<T, int16_t>(idx, data, x, mask, tile_ptr, tile_ids, y, nrows,
                                           width, ct, stream);
    case kI32:
      return launch_ell_listed<T, int32_t>(idx, data, x, mask, tile_ptr, tile_ids, y, nrows,
                                           width, ct, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace repro

// y = A @ x over an "ell-cols" plan idx/data (ntiles, nrows, width) with
// tile-local ids, walking for each chunk of 128 rows only the tiles that
// tile_ptr (nchunks + 1,) / tile_ids (npairs,) int32 list for it, in
// ascending order; ct is the column-tile width. The resident arrays are
// the plan of one tile (ids global). mask may be null.
extern "C" int repro_ell_spmv_listed(const void* idx, const void* data, const void* x,
                                     const void* mask, const void* tile_ptr,
                                     const void* tile_ids, void* y, long long nrows,
                                     int width, long long ct, int dtype, int itype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nrows == 0) return 0;
  switch (dtype) {
    case repro::kF32:
      return repro::launch_ell_listed_index<float>(itype, idx, data, x, mask, tile_ptr,
                                                   tile_ids, y, nrows, width, ct, s);
    case repro::kBF16:
      return repro::launch_ell_listed_index<__nv_bfloat16>(itype, idx, data, x, mask,
                                                           tile_ptr, tile_ids, y, nrows,
                                                           width, ct, s);
    case repro::kF16:
      return repro::launch_ell_listed_index<__half>(itype, idx, data, x, mask, tile_ptr,
                                                    tile_ids, y, nrows, width, ct, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
