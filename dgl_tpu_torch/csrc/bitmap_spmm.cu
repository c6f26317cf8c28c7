// Bitmap copy_u_sum for Hopper (sm_90a): out = A @ x with A a plane-packed
// adjacency bitmap.
//
// Replaces the Pallas kernel dgl_tpu/ops/bitmap_spmm.py::_bitmap_matmul_pallas.
// It computes, for every dst row d < n_rows,
//
//   out[d, f] = sum_{s : bit (d, s) set} float(x[s, f])
//
// with x in bf16 (compute_dtype "bfloat16") or f32 ("float32", the exact
// mode) and the sum in f32. Layout (the reference's): a bitmap row
// holds row_bytes bytes; within each 512-byte block (4096 sources), byte b
// carries bit j for source block*4096 + j*512 + b.
//
// What bounds it on this card: bytes. Every call must read the whole bitmap
// (Reddit: 233,472 rows x 29,184 B = 6.81 GB, about 2.0 ms at 3.35 TB/s);
// x at F = 16 in bf16 is 7.5 MB and stays in L2. The TPU kernel expands each
// tile to a dense bf16 matrix and feeds the MXU, which costs N^2 * F
// multiply-adds. Here a warp skips zero words and visits only the set bits,
// O(N^2 / 32 + E * F) work, so the bitmap stream is the only large cost.
//
// Design: one warp owns one dst row and walks its set bits with
// bitmap_walk.cuh (16-byte streaming loads of the bitmap, U blocks in
// flight, sources queued in shared memory). A pass covers 8 * G features:
// each source goes to G lanes, each of which adds 8 features of the row
// (one 16-byte load of bf16, two of f32; the G lanes' loads together one
// coalesced row) into 8 f32 registers. At the end the lanes that share a
// feature slot sum with shuffles and G lanes write the f32 row. Features beyond 8 * G run as
// further passes (blockIdx.y); x arrives padded to a multiple of 8 * G
// columns. No tensor cores: each bit is used once. The f32 instantiation
// reads twice the row bytes, which at F = 16 still sit in L2; the bitmap
// stream is the same.
//
// Plain C interface, bound from Python with ctypes
// (dgl_tpu_torch/_kernels.py); the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitmap_walk.cuh"

namespace {

constexpr int kWarps = 8;   // rows (warps) per thread block
constexpr int kUnroll = 4;  // 16-byte bitmap loads in flight per lane

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Adds 8 consecutive features of a row of x into acc, in order.
__device__ __forceinline__ void add8(const uint16_t* __restrict__ row,
                                     float (&acc)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(row));
  acc[0] += bf16_lo(v.x); acc[1] += bf16_hi(v.x);
  acc[2] += bf16_lo(v.y); acc[3] += bf16_hi(v.y);
  acc[4] += bf16_lo(v.z); acc[5] += bf16_hi(v.z);
  acc[6] += bf16_lo(v.w); acc[7] += bf16_hi(v.w);
}

__device__ __forceinline__ void add8(const float* __restrict__ row,
                                     float (&acc)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row));
  const float4 b = __ldg(reinterpret_cast<const float4*>(row + 4));
  acc[0] += a.x; acc[1] += a.y; acc[2] += a.z; acc[3] += a.w;
  acc[4] += b.x; acc[5] += b.y; acc[6] += b.z; acc[7] += b.w;
}

// T: uint16_t (bf16 x) or float.
template <typename T, int G>
__global__ void __launch_bounds__(kWarps * 32) bitmap_spmm_kernel(
    const uint8_t* __restrict__ bits, int64_t n_rows, int64_t row_bytes,
    const T* __restrict__ x, int64_t n_src, int64_t x_stride,
    int64_t feat, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warps leave together
  // this lane's 8 features of the pass
  const int64_t f0 = static_cast<int64_t>(blockIdx.y) * (8 * G) +
                     (lane % G) * 8;
  const T* xf = x + f0;

  __shared__ int queue[kWarps][bitmap_walk::kQueue];
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  bitmap_walk::walk_row<G, kUnroll>(
      bits + row * row_bytes, row_bytes / bitmap_walk::kBlockBytes, n_src,
      queue[threadIdx.x >> 5], [&](int s) { add8(xf + s * x_stride, acc); });

#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int o = 16; o >= G; o >>= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  }
  if (lane < G) {
    float* orow = out + row * feat;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (f0 + i < feat) orow[f0 + i] = acc[i];
  }
}

template <typename T, int G>
cudaError_t launch(const void* bits, int64_t n_rows, int64_t row_bytes,
                   const void* x, int64_t n_src, int64_t x_stride,
                   int64_t feat, void* out, cudaStream_t s) {
  const int64_t grid_x = (n_rows + kWarps - 1) / kWarps;
  const int64_t grid_y = (feat + 8 * G - 1) / (8 * G);
  if (grid_x > 0x7fffffffLL || grid_y > 65535 || x_stride < grid_y * 8 * G)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y));
  bitmap_spmm_kernel<T, G><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const uint8_t*>(bits), n_rows, row_bytes,
      static_cast<const T*>(x), n_src, x_stride, feat,
      static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_lanes(const void* bits, int64_t n_rows, int64_t row_bytes,
                         const void* x, int64_t n_src, int64_t x_stride,
                         int64_t feat, int lanes, void* out, cudaStream_t s) {
  switch (lanes) {
    case 1: return launch<T, 1>(bits, n_rows, row_bytes, x, n_src, x_stride, feat, out, s);
    case 2: return launch<T, 2>(bits, n_rows, row_bytes, x, n_src, x_stride, feat, out, s);
    case 4: return launch<T, 4>(bits, n_rows, row_bytes, x, n_src, x_stride, feat, out, s);
    case 8: return launch<T, 8>(bits, n_rows, row_bytes, x, n_src, x_stride, feat, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bits: (>= n_rows, row_bytes) uint8, row_bytes a multiple of 512, rows
// 16-byte aligned. x: (n_src, x_stride) bf16 (bf16 = 1) or f32 (0),
// x_stride a multiple of 8 * lanes, 16-byte aligned. out: (n_rows, feat)
// f32. lanes (per source): 1, 2, 4 or 8. Returns a cudaError_t as int; 0
// means launched.
extern "C" int dgl_bitmap_spmm(const void* bits, int64_t n_rows,
                               int64_t row_bytes, const void* x, int bf16,
                               int64_t n_src, int64_t x_stride, int64_t feat,
                               int lanes, void* out, void* stream) {
  if (row_bytes % bitmap_walk::kBlockBytes != 0 ||
      row_bytes * 8 > 0x7fffffffLL)  // source ids are queued as int32
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0 || feat == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_lanes<uint16_t>(bits, n_rows, row_bytes, x, n_src,
                                    x_stride, feat, lanes, out, s)
           : launch_lanes<float>(bits, n_rows, row_bytes, x, n_src, x_stride,
                                 feat, lanes, out, s);
  return static_cast<int>(e);
}
