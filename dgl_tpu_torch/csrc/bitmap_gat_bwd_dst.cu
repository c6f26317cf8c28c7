// Bitmap-flash GAT backward, dst-major part, for Hopper (sm_90a).
//
// Replaces the Pallas kernel dgl_tpu/ops/bitmap_gat.py::_gat_bwd_dst_pallas.
// For every dst row d < n_rows and head h, with the forward's lse known,
//
//   z[s]   = er[d, h] + el[s, h]                     for bit (d, s) set
//   b[s]   = exp(leaky(z[s]) - lse[d, h]) * leaky'(z[s])
//   der[d, h] = sum_s b[s] * (h[s, h, :] . dz[d, h, :])  -  c[d, h] * sum_s b[s]
//
// which is the reference's dz[d] . (B @ h)[d] - c[d] * rowsum(B)[d] with
// B = alpha * leaky'(raw). h and dz arrive in bf16, as the TPU path hands
// them to its kernel (dgl_tpu/ops/bitmap_gat.py:453-456); c was taken from
// the f32 dz. Everything else is f32 (the TPU kernel also rounds B to
// bf16). lse arrives already guarded (a row with lse near -1e30 carries
// +1e30).
//
// What bounds it on this card: bytes in the bound. Every call reads the
// whole bitmap (Reddit: 6.81 GB, about 2.0 ms at 3.35 TB/s) plus el, er,
// lse, c, h and dz once. The TPU kernel recomputes the dense (C, S) tile of
// alpha for every head, N^2 * H exponentials; a walk over the set bits
// needs E * H. In fact latency bounds it: a warp loads, decodes and drains
// one after the other, and a drain is a chain of L2 round trips (el[s],
// then h[s]: 32 + 128 bytes an edge at H = 8, O = 8) with no bitmap load
// in flight (PERF.md, PR 5).
//
// Design: the set-bit walk of bitmap_walk.cuh with lse known, so there is
// no running max and no rescale. One warp owns one dst row; a pass covers NH
// heads, each source going to G = NH * NF / 8 lanes with 8 features each.
// dz[d] is the same for every edge of the row, so a lane keeps its 8 dz
// values in registers and adds b * (h[s] . dz[d]) over its 8 features into
// one scalar: no per-edge shuffle, one f32 of state instead of 8. At the
// end the lanes that share a head add their scalars and their sum of b with
// shuffles, and one lane writes der. Features beyond NF run as further walks
// of the row inside the warp (their partial dots add into the same scalar),
// heads beyond NH as further blocks (blockIdx.y): every output belongs to
// one warp, so no atomics and no second pass.
//
// Occupancy and bytes in flight: a block is kWarps = 8 warps with 8 KB of
// queues, so the registers (ptxas -v; chip_smoke.py prints them) decide how
// many blocks an SM holds. While they load, each lane has kUnroll = 2
// 16-byte loads in flight, 1 KB a warp: 40 KB an SM at 5 blocks, more than
// the 25 KB that 3.35 TB/s at about 1 us of latency asks of each of the 132
// SMs. During a drain a warp has none.
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

template <int NH, int NF>
__global__ void __launch_bounds__(kWarps * 32) gat_bwd_dst_kernel(
    const uint8_t* __restrict__ bits, int64_t n_rows, int64_t row_bytes,
    const float* __restrict__ el, const float* __restrict__ er,
    const float* __restrict__ lse, const float* __restrict__ cc,
    const uint16_t* __restrict__ h, const uint16_t* __restrict__ dz,
    int64_t n_src, int heads, int h_pad, int o_pad, float slope,
    float* __restrict__ der) {
  constexpr int G = NH * NF / 8;  // lanes per source, 8 features each
  constexpr int C = NF / 8;       // lanes of one head within a source
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warps leave together
  const int slot = lane % G;
  const int hh = blockIdx.y * NH + slot / C;  // this lane's head
  const int64_t rh = row * h_pad + hh;
  const float er_r = __ldg(er + rh);
  const float lse_r = __ldg(lse + rh);
  const float* el_h = el + hh;
  const int64_t h_stride = static_cast<int64_t>(h_pad) * o_pad;

  float t = 0.f;   // sum of b * (h[s] . dz[d]) over this lane's features
  float sb = 0.f;  // sum of b over this lane's sources
  __shared__ int queue[kWarps][bitmap_walk::kQueue];
  for (int fg = 0; fg < o_pad / NF; ++fg) {
    const int f0 = fg * NF + (slot % C) * 8;
    const uint4 dq =
        __ldg(reinterpret_cast<const uint4*>(dz + rh * o_pad + f0));
    const uint32_t dw[4] = {dq.x, dq.y, dq.z, dq.w};
    float dv[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      dv[2 * k] = __uint_as_float(dw[k] << 16);
      dv[2 * k + 1] = __uint_as_float(dw[k] & 0xffff0000u);
    }
    const uint16_t* h_hf = h + static_cast<int64_t>(hh) * o_pad + f0;
    const bool first = fg == 0;  // sum b once, on the first walk
    bitmap_walk::walk_row<G, kUnroll>(
        bits + row * row_bytes, row_bytes / bitmap_walk::kBlockBytes, n_src,
        queue[threadIdx.x >> 5], [&](int s) {
          const float zp = er_r + __ldg(el_h + static_cast<int64_t>(s) * h_pad);
          const bool pos = zp > 0.f;
          const float b = expf((pos ? zp : zp * slope) - lse_r) *
                          (pos ? 1.f : slope);
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(
              h_hf + s * h_stride));
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
          float dot = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            dot += __uint_as_float(w[k] << 16) * dv[2 * k];
            dot += __uint_as_float(w[k] & 0xffff0000u) * dv[2 * k + 1];
          }
          t += b * dot;
          if (first) sb += b;
        });
  }

  // add over the lanes that share this slot (they visited other sources),
  // then the partial dots over the C slots of this head
#pragma unroll
  for (int o = 16; o >= G; o >>= 1) {
    t += __shfl_xor_sync(0xffffffffu, t, o);
    sb += __shfl_xor_sync(0xffffffffu, sb, o);
  }
#pragma unroll
  for (int o = C / 2; o >= 1; o >>= 1)
    t += __shfl_xor_sync(0xffffffffu, t, o);
  if (lane < G && slot % C == 0 && hh < heads)
    der[row * heads + hh] = t - __ldg(cc + rh) * sb;
}

template <int NH, int NF>
cudaError_t launch(const void* bits, int64_t n_rows, int64_t row_bytes,
                   const void* el, const void* er, const void* lse,
                   const void* cc, const void* h, const void* dz,
                   int64_t n_src, int heads, int h_pad, int o_pad,
                   float slope, void* der, cudaStream_t s) {
  if (h_pad % NH != 0 || o_pad % NF != 0 || h_pad < heads)
    return cudaErrorInvalidValue;
  const int64_t grid_x = (n_rows + kWarps - 1) / kWarps;
  const int64_t grid_y = h_pad / NH;
  if (grid_x > 0x7fffffffLL || grid_y > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y));
  gat_bwd_dst_kernel<NH, NF><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const uint8_t*>(bits), n_rows, row_bytes,
      static_cast<const float*>(el), static_cast<const float*>(er),
      static_cast<const float*>(lse), static_cast<const float*>(cc),
      static_cast<const uint16_t*>(h), static_cast<const uint16_t*>(dz),
      n_src, heads, h_pad, o_pad, slope, static_cast<float*>(der));
  return cudaGetLastError();
}

}  // namespace

#define DGL_GAT_CASES(X)                                             \
  X(1, 8) X(2, 8) X(4, 8) X(8, 8) X(1, 16) X(2, 16) X(4, 16) X(1, 32) \
  X(2, 32) X(1, 64)

// bits: (>= n_rows, row_bytes) uint8, row_bytes a multiple of 512, rows
// 16-byte aligned. el: (n_src, h_pad) f32. er, lse (guarded), c:
// (n_rows, h_pad) f32. h: (n_src, h_pad, o_pad) bf16, dz: (n_rows, h_pad,
// o_pad) bf16, both 16-byte aligned. der: (n_rows, heads) f32. (nh, nf) as
// for dgl_bitmap_gat_fwd: nh in {1, 2, 4, 8}, nf in {8, 16, 32, 64},
// nh * nf <= 64. Returns a cudaError_t as int.
extern "C" int dgl_bitmap_gat_bwd_dst(const void* bits, int64_t n_rows,
                                      int64_t row_bytes, const void* el,
                                      const void* er, const void* lse,
                                      const void* c, const void* h,
                                      const void* dz, int64_t n_src,
                                      int heads, int h_pad, int o_pad,
                                      int nh, int nf, float slope, void* der,
                                      void* stream) {
  if (row_bytes % bitmap_walk::kBlockBytes != 0 ||
      row_bytes * 8 > 0x7fffffffLL)  // source ids are queued as int32
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0 || heads == 0 || o_pad == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DGL_GAT_CASE(NH, NF)                                                \
  if (nh == NH && nf == NF)                                                 \
    return static_cast<int>(launch<NH, NF>(bits, n_rows, row_bytes, el, er, \
                                           lse, c, h, dz, n_src, heads,     \
                                           h_pad, o_pad, slope, der, s));
  DGL_GAT_CASES(DGL_GAT_CASE)
#undef DGL_GAT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The (nh, nf) kernel's registers, static shared bytes, local bytes per
// thread, resident blocks per SM and bitmap bytes in flight per SM
// (bitmap_walk::walk_occupancy), into out[0..4]. Returns a cudaError_t as
// int.
extern "C" int dgl_bitmap_gat_bwd_dst_occupancy(int nh, int nf, int* out) {
#define DGL_GAT_CASE(NH, NF)                                 \
  if (nh == NH && nf == NF)                                  \
    return static_cast<int>(bitmap_walk::walk_occupancy(     \
        gat_bwd_dst_kernel<NH, NF>, kWarps * 32, kUnroll, out));
  DGL_GAT_CASES(DGL_GAT_CASE)
#undef DGL_GAT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
