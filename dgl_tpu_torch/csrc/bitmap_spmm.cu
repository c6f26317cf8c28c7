// Bitmap copy_u_sum for Hopper (sm_90a): out = A @ x, each destination row
// walking its edge list from the relation's index.
//
// Replaces the Pallas kernel dgl_tpu/ops/bitmap_spmm.py::_bitmap_matmul_pallas
// (the matmul of the plan's bitmap by x, forward over bits and backward over
// bits_rev). It computes, for every output row d < n_rows,
//
//   out[d, f] = sum_{s in indices[indptr[d] .. indptr[d + 1])} float(x[s, f])
//
// with x in bf16 (compute_dtype "bfloat16") or f32 ("float32", the exact
// mode) and the sum in f32. The forward gets the relation's CSC (csc_indptr /
// csc_indices: the in-edges of each destination), the backward, du = A^T dz,
// its CSR (the out-edges of each source). The plan refuses multi-edges, so
// the index names exactly the pairs of the plan's bits (bits_rev for the
// CSR). An id outside [0, n_src) (a padded edge at the sink) is skipped.
//
// What bounds it on this card: the gathers. The bytes that must move once
// are few (Reddit at F = 16 in bf16: 0.447 GB of int32 ids, 0.93 MB of
// indptr, 7.5 MB of x and 14.9 MB of out, 0.140 ms at 3.35 TB/s; one f32 add
// per edge and feature, 0.027 ms at 67 TFLOP/s), but every edge gathers one
// row of x, 32 bytes at that shape (64 in f32), 3.57 GB a call, from L2: x
// (7.5 MB, 14.9 MB in f32) fits its 50 MB. The id stream is the part that
// comes from device memory, read once. On the H100 the bf16 call takes
// about as long as the f32 one, whose rows are twice the bytes in the same
// 128-byte lines: the number of rows requested, not their bytes, is what
// binds it (PERF.md). The kernel this one replaces walked the plan's
// bitmap: it streamed and decoded all 6.81 GB of it on every call (2.036 ms
// of bytes alone), whatever the density.
//
// Design: one warp owns one output row and walks its edge list in chunks of
// C = 32 K ids; the ids reach the warp's shared-memory ring by cp.async
// (edge_ring.cuh's walk_ids, which B3, B4 and B5's walk shares), two chunks
// ahead and evict-first in L2, so the id stream neither waits on the gathers
// nor pushes x out of L2 (b2_variants.py times it against a plain load of
// each chunk's ids where they are used: the ring is the faster, most in
// f32). A pass covers 8 * G features: a source goes to G lanes, each of
// which adds 8 features of its row (one 16-byte load of bf16, two of f32;
// the G lanes' loads together one coalesced row), so the warp takes 32 / G
// sources a step and a lane issues all kSteps gathers of its chunk (8 loads
// of 16 bytes) before the first add. The f32 accumulators stay in registers;
// at the end the lanes that share a feature slot add theirs with shuffles
// and G lanes write the row. Features beyond 8 * G run as further passes
// (blockIdx.y); x arrives padded to a multiple of 8 * G columns. Every
// output row belongs to one warp: no atomics, and the sums run in the same
// order on every launch. No tensor cores: each edge is used once.
//
// Plain C interface, bound from Python with ctypes
// (dgl_tpu_torch/_kernels.py); the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_ring.cuh"

namespace {

constexpr int kWarps = 8;  // rows (warps) per thread block
constexpr int kLoads = 8;  // 16-byte gathers in flight per lane

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// 8 consecutive features of a row of x, as loaded: L 16-byte loads
template <typename T>
struct Piece;

template <>
struct Piece<uint16_t> {
  static constexpr int L = 1;
  uint4 v;
  __device__ __forceinline__ void load(const uint16_t* row) {
    v = __ldg(reinterpret_cast<const uint4*>(row));
  }
  __device__ __forceinline__ void zero() { v = make_uint4(0u, 0u, 0u, 0u); }
  // adds the 8 features into acc, in order
  __device__ __forceinline__ void add(float (&acc)[8]) const {
    acc[0] += bf16_lo(v.x); acc[1] += bf16_hi(v.x);
    acc[2] += bf16_lo(v.y); acc[3] += bf16_hi(v.y);
    acc[4] += bf16_lo(v.z); acc[5] += bf16_hi(v.z);
    acc[6] += bf16_lo(v.w); acc[7] += bf16_hi(v.w);
  }
};

template <>
struct Piece<float> {
  static constexpr int L = 2;
  float4 a, b;
  __device__ __forceinline__ void load(const float* row) {
    a = __ldg(reinterpret_cast<const float4*>(row));
    b = __ldg(reinterpret_cast<const float4*>(row + 4));
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void add(float (&acc)[8]) const {
    acc[0] += a.x; acc[1] += a.y; acc[2] += a.z; acc[3] += a.w;
    acc[4] += b.x; acc[5] += b.y; acc[6] += b.z; acc[7] += b.w;
  }
};

// T: uint16_t (bf16 x) or float; G lanes per source
template <typename T, int G>
struct Shape {
  // gather steps a chunk: kLoads 16-byte loads a lane, at least one source
  // a lane-group slot
  static constexpr int kSteps =
      kLoads / Piece<T>::L > G ? kLoads / Piece<T>::L : G;
  static constexpr int P = 32 / G;       // sources a step
  static constexpr int K = kSteps / G;   // ids a lane fetches a chunk
  static constexpr int C = 32 * K;       // ids a chunk
};

template <typename T, int G>
__global__ void __launch_bounds__(kWarps * 32) bitmap_spmm_kernel(
    const int* __restrict__ indptr, const int* __restrict__ indices,
    int64_t n_rows, const T* __restrict__ x, int n_src, int64_t x_stride,
    int64_t feat, float* __restrict__ out) {
  using S = Shape<T, G>;
  constexpr int kSteps = S::kSteps, P = S::P, C = S::C;
  __shared__ int ids_sh[kWarps][3][C];  // per warp: the ids of 3 chunks
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (row >= n_rows) return;  // whole warps leave together
  // this lane's 8 features of the pass
  const int64_t f0 = static_cast<int64_t>(blockIdx.y) * (8 * G) +
                     (lane % G) * 8;
  const T* xf = x + f0;
  const int beg = __ldg(indptr + row), end = __ldg(indptr + row + 1);

  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  // the chunk's ids (-1 past end): every gather before the first add
  auto chunk = [&](int c0, const int* ids) {
    Piece<T> v[kSteps];
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      const int s = ids[t * P + lane / G];
      if (static_cast<unsigned>(s) < static_cast<unsigned>(n_src))
        v[t].load(xf + s * x_stride);
      else
        v[t].zero();
    }
#pragma unroll
    for (int t = 0; t < kSteps; ++t) v[t].add(acc);
  };
  if (beg < end)  // the same on every lane
    edge_ring::walk_ids<C>(ids_sh[warp], indices, beg, end, lane, chunk);

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
cudaError_t launch(const void* indptr, const void* indices, int64_t n_rows,
                   const void* x, int n_src, int64_t x_stride, int64_t feat,
                   void* out, cudaStream_t s) {
  const int64_t grid_x = (n_rows + kWarps - 1) / kWarps;
  const int64_t grid_y = (feat + 8 * G - 1) / (8 * G);
  if (grid_x > 0x7fffffffLL || grid_y > 65535 || x_stride < grid_y * 8 * G)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y));
  bitmap_spmm_kernel<T, G><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      n_rows, static_cast<const T*>(x), n_src, x_stride, feat,
      static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_lanes(const void* indptr, const void* indices,
                         int64_t n_rows, const void* x, int n_src,
                         int64_t x_stride, int64_t feat, int lanes, void* out,
                         cudaStream_t s) {
  switch (lanes) {
    case 1: return launch<T, 1>(indptr, indices, n_rows, x, n_src, x_stride, feat, out, s);
    case 2: return launch<T, 2>(indptr, indices, n_rows, x, n_src, x_stride, feat, out, s);
    case 4: return launch<T, 4>(indptr, indices, n_rows, x, n_src, x_stride, feat, out, s);
    case 8: return launch<T, 8>(indptr, indices, n_rows, x, n_src, x_stride, feat, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// indptr: (n_rows + 1,) int32, indices: int32, the relation's CSC (forward)
// or CSR (backward), with indices.numel() + 4096 < 2^31 (the walk reads two
// chunks ahead). x: (n_src, x_stride) bf16 (bf16 = 1) or f32 (0), x_stride
// a multiple of 8 * lanes, 16-byte aligned. out: (n_rows, feat) f32. lanes
// (per source): 1, 2, 4 or 8. Returns a cudaError_t as int; 0 means
// launched.
extern "C" int dgl_bitmap_spmm(const void* indptr, const void* indices,
                               int64_t n_rows, const void* x, int bf16,
                               int64_t n_src, int64_t x_stride, int64_t feat,
                               int lanes, void* out, void* stream) {
  if (n_src < 0 || n_src > 0x7fffffffLL)  // source ids are int32
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0 || feat == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ns = static_cast<int>(n_src);
  const cudaError_t e =
      bf16 ? launch_lanes<uint16_t>(indptr, indices, n_rows, x, ns, x_stride,
                                    feat, lanes, out, s)
           : launch_lanes<float>(indptr, indices, n_rows, x, ns, x_stride,
                                 feat, lanes, out, s);
  return static_cast<int>(e);
}
