// Bitmap-flash GAT backward, src-major part, for Hopper (sm_90a).
//
// Replaces the Pallas kernel dgl_tpu/ops/bitmap_gat.py::_gat_bwd_src_pallas.
// It walks the transpose bitmap, whose rows are sources and whose set bits
// are each source's destinations. For every source row s < n_rows and head h
//
//   z[d]     = el[s, h] + er[d, h]                   for bit (s, d) set
//   a[d]     = exp(leaky(z[d]) - lse[d, h]),  b[d] = a[d] * leaky'(z[d])
//   dh[s, h, :] = sum_d a[d] * dz[d, h, :]
//   del[s, h]   = sum_d b[d] * (h[s, h, :] . dz[d, h, :])  -  sum_d b[d] * c[d, h]
//
// which is the reference's dh = alpha^T dz and del = h . (B^T dz) - B^T c.
// h and dz arrive in bf16, as the TPU path hands them to its kernel
// (dgl_tpu/ops/bitmap_gat.py:466-468); c was taken from the f32 dz.
// Everything else is f32 (the TPU kernel also rounds alpha and B to bf16).
//
// What bounds it on this card: bytes in the bound (the transpose bitmap, the
// per-source el and h, the per-destination er, lse, c and dz read once, del
// and dh written once). The TPU kernel builds dense (C, S) tiles of alpha
// for every head (N^2 * H exponentials); a walk over the set bits needs
// E * H. In fact latency bounds it, as in bitmap_gat_bwd_dst.cu, with
// larger gathers: every edge reads the destination's (er, lse, c) and dz[d]
// from L2, 128 + 128 bytes at H = 8, O = 8. In bf16 the dz table is 29.8 MB
// at Reddit scale, where in f32 it was 59.6 MB, more than the 50 MB L2 by
// itself; beside the 29.8 MB (er, lse, c) table it still exceeds L2.
//
// Design: B4's walk (bitmap_walk.cuh) over the transpose bitmap, one warp
// per source row. A pass covers NH heads, each destination going to
// G = NH * NF / 8 lanes with 8 features each. The destination's er, lse and
// c arrive packed as one float4 per (d, h) (the wrapper builds the table),
// so a lane makes two 16-byte gathers per edge: (er, lse, c) and 8 bf16 of
// dz. h[s] is the same for every edge of the row: a lane keeps its 8 values
// in registers and adds b * (h[s] . dz[d]) into one scalar, beside its 8 dh
// accumulators. At the end of a walk the lanes that share a slot add their
// dh accumulators with shuffles and G lanes write the row's dh; the del
// scalars add over the lanes of a head after the last walk. Features beyond
// NF run as further walks inside the warp, heads beyond NH as further
// blocks: every output belongs to one warp, so no atomics.
//
// Occupancy and bytes in flight: as in bitmap_gat_bwd_dst.cu, 1 KB of
// bitmap in flight a warp while it loads; the 8 dh accumulators cost
// registers, so an SM holds fewer blocks than B4's (chip_smoke.py prints
// ptxas -v's figures and the blocks an SM holds).
//
// Plain C interface, bound from Python with ctypes
// (dgl_tpu_torch/_kernels.py); the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bitmap_walk.cuh"

namespace {

constexpr int kWarps = 8;   // rows (warps) per thread block
constexpr int kUnroll = 2;  // 16-byte bitmap loads in flight per lane

__device__ __forceinline__ void bf16x8(uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <int NH, int NF>
__global__ void __launch_bounds__(kWarps * 32) gat_bwd_src_kernel(
    const uint8_t* __restrict__ bits_t, int64_t n_rows, int64_t row_bytes,
    const float* __restrict__ el, const uint16_t* __restrict__ h,
    const float4* __restrict__ ed, const uint16_t* __restrict__ dz,
    int64_t n_dst, int heads, int odim, int h_pad, int o_pad, float slope,
    float* __restrict__ del, float* __restrict__ dh) {
  constexpr int G = NH * NF / 8;  // lanes per destination, 8 features each
  constexpr int C = NF / 8;       // lanes of one head within a destination
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warps leave together
  const int slot = lane % G;
  const int hh = blockIdx.y * NH + slot / C;  // this lane's head
  const int64_t rh = row * h_pad + hh;
  const float el_r = __ldg(el + rh);
  const float4* ed_h = ed + hh;
  const int64_t d_stride = static_cast<int64_t>(h_pad) * o_pad;

  float t = 0.f;  // sum of b * (h[s] . dz[d]) over this lane's features
  float u = 0.f;  // sum of b * c[d] over this lane's destinations
  __shared__ int queue[kWarps][bitmap_walk::kQueue];
  for (int fg = 0; fg < o_pad / NF; ++fg) {
    const int f0 = fg * NF + (slot % C) * 8;
    float hs[8];
    bf16x8(__ldg(reinterpret_cast<const uint4*>(h + rh * o_pad + f0)), hs);
    const uint16_t* dz_hf = dz + static_cast<int64_t>(hh) * o_pad + f0;
    const bool first = fg == 0;  // sum b * c once, on the first walk
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    bitmap_walk::walk_row<G, kUnroll>(
        bits_t + row * row_bytes, row_bytes / bitmap_walk::kBlockBytes,
        n_dst, queue[threadIdx.x >> 5], [&](int d) {
          const float4 e = __ldg(ed_h + static_cast<int64_t>(d) * h_pad);
          const float zp = el_r + e.x;  // e = (er, lse, c, 0)
          const bool pos = zp > 0.f;
          const float a = expf((pos ? zp : zp * slope) - e.y);
          const float b = pos ? a : a * slope;
          float dv[8];
          bf16x8(__ldg(reinterpret_cast<const uint4*>(dz_hf + d * d_stride)),
                 dv);
          float dot = 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            acc[k] += a * dv[k];
            dot += hs[k] * dv[k];
          }
          t += b * dot;
          if (first) u += b * e.z;
        });

    // dh of these features: add over the lanes that share this slot
#pragma unroll
    for (int o = 16; o >= G; o >>= 1) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
    }
    if (lane < G && hh < heads) {
      float* drow = dh + (row * heads + hh) * static_cast<int64_t>(odim);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (f0 + k < odim) drow[f0 + k] = acc[k];
    }
  }

  // del: add over the lanes that share this slot, then the partial dots
  // over the C slots of this head
#pragma unroll
  for (int o = 16; o >= G; o >>= 1) {
    t += __shfl_xor_sync(0xffffffffu, t, o);
    u += __shfl_xor_sync(0xffffffffu, u, o);
  }
#pragma unroll
  for (int o = C / 2; o >= 1; o >>= 1)
    t += __shfl_xor_sync(0xffffffffu, t, o);
  if (lane < G && slot % C == 0 && hh < heads) del[row * heads + hh] = t - u;
}

template <int NH, int NF>
cudaError_t launch(const void* bits_t, int64_t n_rows, int64_t row_bytes,
                   const void* el, const void* h, const void* ed,
                   const void* dz, int64_t n_dst, int heads, int odim,
                   int h_pad, int o_pad, float slope, void* del, void* dh,
                   cudaStream_t s) {
  if (h_pad % NH != 0 || o_pad % NF != 0 || h_pad < heads || o_pad < odim)
    return cudaErrorInvalidValue;
  const int64_t grid_x = (n_rows + kWarps - 1) / kWarps;
  const int64_t grid_y = h_pad / NH;
  if (grid_x > 0x7fffffffLL || grid_y > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y));
  gat_bwd_src_kernel<NH, NF><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const uint8_t*>(bits_t), n_rows, row_bytes,
      static_cast<const float*>(el), static_cast<const uint16_t*>(h),
      static_cast<const float4*>(ed), static_cast<const uint16_t*>(dz),
      n_dst, heads, odim, h_pad, o_pad, slope, static_cast<float*>(del),
      static_cast<float*>(dh));
  return cudaGetLastError();
}

}  // namespace

#define DGL_GAT_CASES(X)                                             \
  X(1, 8) X(2, 8) X(4, 8) X(8, 8) X(1, 16) X(2, 16) X(4, 16) X(1, 32) \
  X(2, 32) X(1, 64)

// bits_t: (>= n_rows, row_bytes) uint8 transpose bitmap (rows = sources),
// row_bytes a multiple of 512, rows 16-byte aligned; n_dst <= 8 * row_bytes.
// el: (n_rows, h_pad) f32. h: (n_rows, h_pad, o_pad) bf16. ed: (n_dst,
// h_pad) float4 of (er, guarded lse, c, 0). dz: (n_dst, h_pad, o_pad) bf16.
// h, ed and dz 16-byte aligned. del: (n_rows, heads) f32. dh: (n_rows,
// heads, odim) f32. (nh, nf) as for dgl_bitmap_gat_fwd. Returns a
// cudaError_t as int.
extern "C" int dgl_bitmap_gat_bwd_src(const void* bits_t, int64_t n_rows,
                                      int64_t row_bytes, const void* el,
                                      const void* h, const void* ed,
                                      const void* dz, int64_t n_dst,
                                      int heads, int odim, int h_pad,
                                      int o_pad, int nh, int nf, float slope,
                                      void* del, void* dh, void* stream) {
  if (row_bytes % bitmap_walk::kBlockBytes != 0 ||
      row_bytes * 8 > 0x7fffffffLL)  // destination ids are queued as int32
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0 || heads == 0 || odim == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DGL_GAT_CASE(NH, NF)                                                  \
  if (nh == NH && nf == NF)                                                   \
    return static_cast<int>(launch<NH, NF>(bits_t, n_rows, row_bytes, el, h,  \
                                           ed, dz, n_dst, heads, odim, h_pad, \
                                           o_pad, slope, del, dh, s));
  DGL_GAT_CASES(DGL_GAT_CASE)
#undef DGL_GAT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The (nh, nf) kernel's registers, static shared bytes, local bytes per
// thread, resident blocks per SM and bitmap bytes in flight per SM
// (bitmap_walk::walk_occupancy), into out[0..4]. Returns a cudaError_t as
// int.
extern "C" int dgl_bitmap_gat_bwd_src_occupancy(int nh, int nf, int* out) {
#define DGL_GAT_CASE(NH, NF)                                 \
  if (nh == NH && nf == NF)                                  \
    return static_cast<int>(bitmap_walk::walk_occupancy(     \
        gat_bwd_src_kernel<NH, NF>, kWarps * 32, kUnroll, out));
  DGL_GAT_CASES(DGL_GAT_CASE)
#undef DGL_GAT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
