// Bitmap-flash GAT forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel dgl_tpu/ops/bitmap_gat.py::_gat_fwd_pallas.
// For every dst row d < n_rows and head h it computes the edge softmax of
// the rank-1 logits over the row's set bits and the weighted sum
//
//   z[s]      = leaky(er[d, h] + el[s, h])          for bit (d, s) set
//   m         = max_s z[s],  p[s] = exp(z[s] - m),  S = sum_s p[s]
//   out[d, h] = sum_s p[s] * float(h[s, h, :]) / max(S, 1e-30)
//   lse[d, h] = m + log(max(S, 1e-30))
//
// in f32 with h in bf16, as the reference's CPU path _gat_xla defines them
// (p stays f32; the TPU kernel rounds p to bf16 before its dot). A row with
// no set bit gives out = 0 and lse = log(1e-30), as _gat_xla does.
//
// What bounds it on this card: bytes. Every call reads the whole bitmap
// (Reddit: 6.81 GB, about 2.0 ms at 3.35 TB/s) plus el, er and h. The TPU
// kernel builds the dense (C, S) logit tile for every head, N^2 * H
// exponentials (4.3e11 at Reddit, ~0.1 s per layer at the SFU's rate); a
// walk over the set bits needs E * H of them (0.9e9).
//
// Design: one warp owns one dst row and walks its set bits with
// bitmap_walk.cuh (sources queued in shared memory). A pass covers NH heads
// and NF features of each, split into G = NH * NF / 8 slots of 8 features:
// each source goes to G lanes, one slot each, so the gather of h's row is
// one coalesced load and el's is one float per lane. A lane carries, for
// its head, a running max, sum and 8-wide accumulator over the sources it
// visits (flash-attention's online softmax). At the end the lanes that
// share a slot merge their states with the same rule (rescale each by
// exp(m_l - M) to the larger max M, then add), with shuffles, and G lanes
// write the row. More heads or features run as further passes
// (blockIdx.y). h arrives as (n_src, H_pad, O_pad) bf16 and el, er as
// (*, H_pad) f32, padded by the wrapper to whole passes. No per-head masked
// merges and no full-width dot: they existed only for Mosaic.
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
__global__ void __launch_bounds__(kWarps * 32) gat_fwd_kernel(
    const uint8_t* __restrict__ bits, int64_t n_rows, int64_t row_bytes,
    const float* __restrict__ el, const float* __restrict__ er,
    const uint16_t* __restrict__ h, int64_t n_src, int heads, int odim,
    int h_pad, int o_pad, float slope, float* __restrict__ out,
    float* __restrict__ lse) {
  constexpr int G = NH * NF / 8;  // lanes per source, 8 features each
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warps leave together
  const int n_fg = o_pad / NF;
  const int slot = lane % G;
  const int hh = (blockIdx.y / n_fg) * NH + slot / (NF / 8);  // this head
  const int f0 = (blockIdx.y % n_fg) * NF + (slot % (NF / 8)) * 8;
  const float er_r = __ldg(er + row * h_pad + hh);
  const float* el_h = el + hh;
  const uint16_t* h_hf = h + static_cast<int64_t>(hh) * o_pad + f0;
  const int64_t h_stride = static_cast<int64_t>(h_pad) * o_pad;

  float m = -INFINITY, sum = 0.f, acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  __shared__ int queue[kWarps][bitmap_walk::kQueue];
  bitmap_walk::walk_row<G, kUnroll>(
      bits + row * row_bytes, row_bytes / bitmap_walk::kBlockBytes, n_src,
      queue[threadIdx.x >> 5], [&](int s) {
        float z = er_r + __ldg(el_h + static_cast<int64_t>(s) * h_pad);
        z = z > 0.f ? z : z * slope;
        if (z > m) {  // new running max: rescale what this lane holds
          const float r = expf(m - z);
          sum *= r;
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] *= r;
          m = z;
        }
        const float p = expf(z - m);
        sum += p;
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
            h_hf + s * h_stride));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[2 * k] += p * __uint_as_float(w[k] << 16);
          acc[2 * k + 1] += p * __uint_as_float(w[k] & 0xffff0000u);
        }
      });

  // merge the states of the lanes that share this slot
#pragma unroll
  for (int o = 16; o >= G; o >>= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, o);
    const float s_o = __shfl_xor_sync(0xffffffffu, sum, o);
    const float M = fmaxf(m, m_o);
    const float r = m == -INFINITY ? 0.f : expf(m - M);
    const float r_o = m_o == -INFINITY ? 0.f : expf(m_o - M);
    sum = sum * r + s_o * r_o;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float a_o = __shfl_xor_sync(0xffffffffu, acc[k], o);
      acc[k] = acc[k] * r + a_o * r_o;
    }
    m = M;
  }
  if (lane < G && hh < heads) {
    const bool empty = m == -INFINITY;  // the row has no in-edge
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    float* orow = out + (row * heads + hh) * static_cast<int64_t>(odim);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (f0 + k < odim) orow[f0 + k] = acc[k] * inv;
    if (f0 == 0)
      lse[row * heads + hh] = (empty ? 0.f : m) + logf(fmaxf(sum, 1e-30f));
  }
}

template <int NH, int NF>
cudaError_t launch(const void* bits, int64_t n_rows, int64_t row_bytes,
                   const void* el, const void* er, const void* h,
                   int64_t n_src, int heads, int odim, int h_pad, int o_pad,
                   float slope, void* out, void* lse, cudaStream_t s) {
  if (h_pad % NH != 0 || o_pad % NF != 0 || h_pad < heads || o_pad < odim)
    return cudaErrorInvalidValue;
  const int64_t grid_x = (n_rows + kWarps - 1) / kWarps;
  const int64_t grid_y = static_cast<int64_t>(h_pad / NH) * (o_pad / NF);
  if (grid_x > 0x7fffffffLL || grid_y > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y));
  gat_fwd_kernel<NH, NF><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const uint8_t*>(bits), n_rows, row_bytes,
      static_cast<const float*>(el), static_cast<const float*>(er),
      static_cast<const uint16_t*>(h), n_src, heads, odim, h_pad, o_pad,
      slope, static_cast<float*>(out), static_cast<float*>(lse));
  return cudaGetLastError();
}

}  // namespace

// bits: (>= n_rows, row_bytes) uint8, row_bytes a multiple of 512, rows
// 16-byte aligned. el: (n_src, h_pad) f32. er: (n_rows, h_pad) f32.
// h: (n_src, h_pad, o_pad) bf16, 16-byte aligned. out: (n_rows, heads,
// odim) f32. lse: (n_rows, heads) f32. (nh, nf) is one of (8, 8), (4, 16),
// (2, 32), (1, 64) or a pass with fewer heads: nh in {1, 2, 4, 8},
// nf in {8, 16, 32, 64}, nh * nf <= 64. Returns a cudaError_t as int.
extern "C" int dgl_bitmap_gat_fwd(const void* bits, int64_t n_rows,
                                  int64_t row_bytes, const void* el,
                                  const void* er, const void* h,
                                  int64_t n_src, int heads, int odim,
                                  int h_pad, int o_pad, int nh, int nf,
                                  float slope, void* out, void* lse,
                                  void* stream) {
  if (row_bytes % bitmap_walk::kBlockBytes != 0 ||
      row_bytes * 8 > 0x7fffffffLL)  // source ids are queued as int32
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0 || heads == 0 || odim == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DGL_GAT_CASE(NH, NF)                                              \
  if (nh == NH && nf == NF)                                               \
    return static_cast<int>(launch<NH, NF>(bits, n_rows, row_bytes, el,   \
                                           er, h, n_src, heads, odim,     \
                                           h_pad, o_pad, slope, out, lse, \
                                           s));
  DGL_GAT_CASE(1, 8) DGL_GAT_CASE(2, 8) DGL_GAT_CASE(4, 8) DGL_GAT_CASE(8, 8)
  DGL_GAT_CASE(1, 16) DGL_GAT_CASE(2, 16) DGL_GAT_CASE(4, 16)
  DGL_GAT_CASE(1, 32) DGL_GAT_CASE(2, 32)
  DGL_GAT_CASE(1, 64)
#undef DGL_GAT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
