// Bitmap-flash GAT backward, src-major part, for Hopper (sm_90a): each
// source row walks its out-edge list from the relation's CSR.
//
// Replaces the Pallas kernel dgl_tpu/ops/bitmap_gat.py::_gat_bwd_src_pallas.
// For every source row s < n_rows and head h
//
//   z[d]     = el[s, h] + er[d, h]                   for each out-edge (s, d)
//   a[d]     = exp(leaky(z[d]) - lse[d, h]),  b[d] = a[d] * leaky'(z[d])
//   dh[s, h, :] = sum_d a[d] * dz[d, h, :]
//   del[s, h]   = sum_d b[d] * (h[s, h, :] . dz[d, h, :])  -  sum_d b[d] * c[d, h]
//
// which is the reference's dh = alpha^T dz and del = h . (B^T dz) - B^T c.
// h and dz arrive in bf16, as the TPU path hands them to its kernel
// (dgl_tpu/ops/bitmap_gat.py:466-468); c was taken from the f32 dz.
// Everything else is f32 (the TPU kernel also rounds alpha and B to bf16).
// The out-neighbours of source s are indices[indptr[s] .. indptr[s + 1]),
// the relation's csr_indptr / csr_indices, which name exactly the (s, d)
// pairs of the plan's transpose bitmap (bits_rev, or bits when the relation
// is symmetric). An index outside [0, n_dst) (a padded edge at the sink) is
// skipped.
//
// What bounds it on this card: the gathers. The bytes that must move once
// are few (Reddit at H = 8, O = 8: 0.447 GB of int32 ids and 0.16 GB of
// tables and outputs; 4 f32 operations per edge and feature, 0.44 ms at 67
// TFLOP/s), but every edge gathers the destination's (er, lse, c) and
// dz[d], 128 + 128 bytes at that shape. Those two tables are 29.8 MB each
// at Reddit scale, more than the 50 MB L2 together, so some of the gathers
// reach device memory; the wrapper can instead run the heads as passes of
// fewer heads (nh), each pass's tables inside L2, at the cost of reading
// the ids once a pass. The kernel this one replaces walked the plan's
// transpose bitmap (a walk of its set bits, since deleted), streaming and
// decoding all 6.81 GB of it on every call.
//
// Design: B3's walk (edge_ring.cuh) over the CSR, one warp per source row,
// in chunks of 32 K destinations. The ids and the destinations' (er, lse,
// c, 0) float4s (the wrapper packs the table) reach the warp's shared ring
// by cp.async. A pass covers NH heads and NF features of each, a
// destination going to G = NH * NF / 8 lanes with 8 features each, K = 8 /
// G. h[s] and el[s] are the row's own, so they stay in registers, beside
// 8 dh accumulators a lane. Per chunk:
//
//  1. each lane issues all kSteps = 8 gathers of dz (16 bytes each);
//  2. while they arrive, it computes (a, b) over the chunk's (destination,
//     head) pairs p = i * 32 + lane (head p % NH = lane % NH, so el[s] of
//     that head stays in a register), writes them over the float4 in the
//     ring and adds b * c into its sum;
//  3. it adds a * dz[d] into its 8 accumulators and b * (h[s] . dz[d])
//     into one scalar.
//
// At the end of a walk the lanes that share a slot add their dh
// accumulators and G lanes write the row's dh; the del scalars add over
// the lanes of a head after the last walk. Features beyond NF run as
// further walks inside the warp, heads beyond NH as further blocks
// (blockIdx.y, which the card runs after the blocks of the pass before):
// every output belongs to one warp, so no atomics.
//
// Plain C interface, bound from Python with ctypes
// (dgl_tpu_torch/_kernels.py); the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "edge_ring.cuh"

namespace {

constexpr int kWarps = 4;      // rows (warps) per thread block
constexpr int kSteps = 8;      // 16-byte gathers in flight per lane
constexpr int kMinBlocks = 5;  // resident blocks per SM: at most 96 registers

__device__ __forceinline__ void bf16x8(uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <int NH, int NF>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks) gat_bwd_src_kernel(
    const int* __restrict__ indptr, const int* __restrict__ indices,
    int64_t n_rows, const float* __restrict__ el,
    const uint16_t* __restrict__ h, const float4* __restrict__ ed,
    const uint16_t* __restrict__ dz, int n_dst, int heads, int odim,
    int h_pad, int o_pad, float slope, float* __restrict__ del,
    float* __restrict__ dh) {
  constexpr int G = NH * NF / 8;  // lanes per destination, 8 features each
  constexpr int P = 32 / G;       // destinations per gather step
  constexpr int K = kSteps / G;   // a chunk is 32 K destinations
  constexpr int C = 32 * K;
  constexpr int L = NF / 8;       // lanes of one head within a destination
  static_assert(G * K == kSteps, "NH * NF must be at most 64");
  // per warp: the ids of 3 chunks, (er, lse, c, 0) (then (a, b)) of 2;
  // 8.4 KB at NF = 8
  __shared__ int ids_sh[kWarps][3][C];
  __shared__ __align__(16) float ed_sh[kWarps][2][C * NH * 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (row >= n_rows) return;  // whole warps leave together
  const int head0 = blockIdx.y * NH;
  const int slot = lane % G;
  const int hk = slot / L;   // the head whose features this lane sums
  const int hl = lane % NH;  // the head whose (a, b) this lane computes
  const int64_t rh = row * h_pad + head0;
  const int64_t d_stride = static_cast<int64_t>(h_pad) * o_pad;
  const int beg = __ldg(indptr + row), end = __ldg(indptr + row + 1);
  const float el_l = __ldg(el + rh + hl);
  auto is_dst = [n_dst](int d) {
    return static_cast<unsigned>(d) < static_cast<unsigned>(n_dst);
  };

  float t = 0.f;  // sum of b * (h[s] . dz[d]) over this lane's features
  float u = 0.f;  // sum of b * c[d] over this lane's pairs, head hl
  for (int fg = 0; fg < o_pad / NF; ++fg) {
    const int f0 = fg * NF + (slot % L) * 8;
    float hs[8], acc[8];
    bf16x8(__ldg(reinterpret_cast<const uint4*>(h + (rh + hk) * o_pad + f0)),
           hs);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    if (beg < end) {  // the same on every lane
      const uint16_t* dz_hf =
          dz + static_cast<int64_t>(head0 + hk) * o_pad + f0;
      const bool first = fg == 0;  // sum b * c once, on the first walk
      edge_ring::walk<C, NH * 4>(
          ids_sh[warp], ed_sh[warp], indices, beg, end,
          reinterpret_cast<const float*>(ed), h_pad * 4, head0 * 4, n_dst,
          lane, [&](int c0, const int* ids, float* ring) {
            float4* pe = reinterpret_cast<float4*>(ring);
            // 1. every gather of the chunk before the first FMA
            const int n_steps = min(kSteps, (end - c0 + P - 1) / P);
            uint4 v[kSteps];
#pragma unroll
            for (int q = 0; q < kSteps; ++q) {
              const int d = ids[q * P + lane / G];
              v[q] = q < n_steps && is_dst(d)
                         ? __ldg(reinterpret_cast<const uint4*>(
                               dz_hf + d * d_stride))
                         : make_uint4(0u, 0u, 0u, 0u);
            }
            // 2. (a, b) of the chunk's (destination, head) pairs, over
            // (er, lse) in place
#pragma unroll
            for (int i = 0; i < K * NH; ++i) {
              const int p = i * 32 + lane;
              const float4 e = pe[p];  // (er, lse, c, 0)
              const float z = el_l + e.x;
              const bool pos = z > 0.f;
              const float a = is_dst(ids[p / NH])
                                  ? expf((pos ? z : z * slope) - e.y)
                                  : 0.f;
              const float b = pos ? a : a * slope;
              pe[p].x = a;
              pe[p].y = b;
              if (first) u += b * e.z;
            }
            __syncwarp();
            // 3. a * dz[d] into dh, b * (h[s] . dz[d]) into del
#pragma unroll
            for (int q = 0; q < kSteps; ++q) {
              if (q < n_steps) {
                const float2 ab = *reinterpret_cast<const float2*>(
                    &pe[(q * P + lane / G) * NH + hk]);
                float dv[8];
                bf16x8(v[q], dv);
                float dot = 0.f;
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                  acc[k] += ab.x * dv[k];
                  dot += hs[k] * dv[k];
                }
                t += ab.y * dot;
              }
            }
          });
    }

    // dh of these features: add over the lanes that share this slot
#pragma unroll
    for (int o = 16; o >= G; o >>= 1) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
    }
    const int hh = head0 + hk;
    if (lane < G && hh < heads) {
      float* drow = dh + (row * heads + hh) * static_cast<int64_t>(odim);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (f0 + k < odim) drow[f0 + k] = acc[k];
    }
  }

  // t: add over the lanes that share this slot, then the partial dots over
  // the L slots of this head; u: add over the lanes of head hl, then fetch
  // head hk's from lane hk
#pragma unroll
  for (int o = 16; o >= G; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
#pragma unroll
  for (int o = L / 2; o >= 1; o >>= 1)
    t += __shfl_xor_sync(0xffffffffu, t, o);
#pragma unroll
  for (int o = 16; o >= NH; o >>= 1) u += __shfl_xor_sync(0xffffffffu, u, o);
  u = __shfl_sync(0xffffffffu, u, hk);
  const int hh = head0 + hk;
  if (lane < G && slot % L == 0 && hh < heads) del[row * heads + hh] = t - u;
}

template <int NH, int NF>
cudaError_t launch(const void* indptr, const void* indices, int64_t n_rows,
                   const void* el, const void* h, const void* ed,
                   const void* dz, int n_dst, int heads, int odim, int h_pad,
                   int o_pad, float slope, void* del, void* dh,
                   cudaStream_t s) {
  if (h_pad % NH != 0 || o_pad % NF != 0 || h_pad < heads || o_pad < odim)
    return cudaErrorInvalidValue;
  const int64_t grid_x = (n_rows + kWarps - 1) / kWarps;
  const int64_t grid_y = h_pad / NH;
  if (grid_x > 0x7fffffffLL || grid_y > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y));
  gat_bwd_src_kernel<NH, NF><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      n_rows, static_cast<const float*>(el),
      static_cast<const uint16_t*>(h), static_cast<const float4*>(ed),
      static_cast<const uint16_t*>(dz), n_dst, heads, odim, h_pad, o_pad,
      slope, static_cast<float*>(del), static_cast<float*>(dh));
  return cudaGetLastError();
}

}  // namespace

#define DGL_GAT_CASES(X)                                             \
  X(1, 8) X(2, 8) X(4, 8) X(8, 8) X(1, 16) X(2, 16) X(4, 16) X(1, 32) \
  X(2, 32) X(1, 64)

// indptr: (n_rows + 1,) int32, indices: int32, the relation's CSR (rows =
// sources), with indices.numel() + 4096 < 2^31. el: (n_rows, h_pad) f32.
// h: (n_rows, h_pad, o_pad) bf16. ed: (n_dst, h_pad) float4 of (er,
// guarded lse, c, 0). dz: (n_dst, h_pad, o_pad) bf16. h, ed and dz 16-byte
// aligned. del: (n_rows, heads) f32. dh: (n_rows, heads, odim) f32. (nh,
// nf) as for dgl_bitmap_gat_fwd. Returns a cudaError_t as int.
extern "C" int dgl_bitmap_gat_bwd_src(const void* indptr, const void* indices,
                                      int64_t n_rows, const void* el,
                                      const void* h, const void* ed,
                                      const void* dz, int64_t n_dst,
                                      int heads, int odim, int h_pad,
                                      int o_pad, int nh, int nf, float slope,
                                      void* del, void* dh, void* stream) {
  if (n_dst < 0 || n_dst > 0x7fffffffLL)  // destination ids are int32
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0 || heads == 0 || odim == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DGL_GAT_CASE(NH, NF)                                                  \
  if (nh == NH && nf == NF)                                                   \
    return static_cast<int>(launch<NH, NF>(                                   \
        indptr, indices, n_rows, el, h, ed, dz, static_cast<int>(n_dst),      \
        heads, odim, h_pad, o_pad, slope, del, dh, s));
  DGL_GAT_CASES(DGL_GAT_CASE)
#undef DGL_GAT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The (nh, nf) kernel's registers, static shared bytes, local bytes per
// thread, resident blocks per SM and gather bytes of dz in flight per SM,
// into out[0..4]. Returns a cudaError_t as int.
extern "C" int dgl_bitmap_gat_bwd_src_occupancy(int nh, int nf, int* out) {
#define DGL_GAT_CASE(NH, NF)                      \
  if (nh == NH && nf == NF)                       \
    return static_cast<int>(edge_ring::occupancy( \
        gat_bwd_src_kernel<NH, NF>, kWarps * 32, kSteps, out));
  DGL_GAT_CASES(DGL_GAT_CASE)
#undef DGL_GAT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
