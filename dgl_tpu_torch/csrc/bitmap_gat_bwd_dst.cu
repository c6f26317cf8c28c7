// Bitmap-flash GAT backward, dst-major part, for Hopper (sm_90a): each
// destination row walks its in-edge list from the relation's CSC.
//
// Replaces the Pallas kernel dgl_tpu/ops/bitmap_gat.py::_gat_bwd_dst_pallas.
// For every dst row d < n_rows and head h, with the forward's lse known,
//
//   z[s]   = er[d, h] + el[s, h]                     for each in-edge (s, d)
//   b[s]   = exp(leaky(z[s]) - lse[d, h]) * leaky'(z[s])
//   der[d, h] = sum_s b[s] * (h[s, h, :] . dz[d, h, :])  -  c[d, h] * sum_s b[s]
//
// which is the reference's dz[d] . (B @ h)[d] - c[d] * rowsum(B)[d] with
// B = alpha * leaky'(raw). h and dz arrive in bf16, as the TPU path hands
// them to its kernel (dgl_tpu/ops/bitmap_gat.py:453-456); c was taken from
// the f32 dz. Everything else is f32 (the TPU kernel also rounds B to
// bf16). lse arrives already guarded (a row with lse near -1e30 carries
// +1e30). The in-neighbours of row d are indices[indptr[d] .. indptr[d +
// 1]), the relation's csc_indptr / csc_indices: the plan refuses
// multi-edges, so they name exactly the (d, s) pairs of the plan's bits.
// An index outside [0, n_src) (a padded edge at the sink) is skipped.
//
// What bounds it on this card: the gathers, as in B3 (bitmap_gat_fwd.cu),
// which gathers the same rows. The bytes that must move once are few
// (Reddit at H = 8, O = 8: 0.447 GB of int32 ids and 0.1 GB of tables, 0.16
// ms at 3.35 TB/s; 2 f32 operations per edge and feature, 0.22 ms at 67
// TFLOP/s), but every edge gathers el[s] and h[s], 32 + 128 bytes at that
// shape, mostly from L2 (both fit its 50 MB). The kernel this one replaces
// walked the plan's bitmap (a walk of its set bits, since deleted): it
// streamed and decoded all 6.81 GB of it on every call, and drained the decoded sources with no
// bitmap load in flight.
//
// Design: B3's walk (edge_ring.cuh) with lse known, so no running max and no
// rescale. One warp owns one dst row and walks its in-edge list in chunks of
// 32 K sources; the ids and el reach the warp's shared ring by cp.async. A
// pass covers NH heads and NF features of each, a source going to G = NH *
// NF / 8 lanes with 8 bf16 features (16 bytes) each, K = 8 / G, so a lane
// gathers kSteps = 8 rows of h a chunk, 4 KB a warp. Per chunk:
//
//  1. each lane issues all kSteps gathers of h (the ids from the ring);
//  2. while they arrive, it computes b over the chunk's (source, head)
//     pairs p = i * 32 + lane (head p % NH = lane % NH, so er[d] and lse[d]
//     of that head stay in registers), writes b over el in the ring and
//     adds it into its sum of b;
//  3. it adds b * (h[s] . dz[d]) over its 8 features into one scalar; dz[d]
//     is the row's own, so its 8 values stay in registers.
//
// At the end the lanes that share a slot add their scalars, then the
// slots of a head their partial dots, and one lane a head writes der with
// the head's sum of b. Features beyond NF run as further walks of the row
// inside the warp (their partial dots add into the same scalar), heads
// beyond NH as further blocks (blockIdx.y): every output belongs to one
// warp, so no atomics and no second pass.
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
constexpr int kMinBlocks = 6;  // resident blocks per SM: at most 80 registers

template <int NH, int NF>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks) gat_bwd_dst_kernel(
    const int* __restrict__ indptr, const int* __restrict__ indices,
    int64_t n_rows, const float* __restrict__ el,
    const float* __restrict__ er, const float* __restrict__ lse,
    const float* __restrict__ cc, const uint16_t* __restrict__ h,
    const uint16_t* __restrict__ dz, int n_src, int heads, int h_pad,
    int o_pad, float slope, float* __restrict__ der) {
  constexpr int G = NH * NF / 8;  // lanes per source, 8 features each
  constexpr int P = 32 / G;       // sources per gather step
  constexpr int K = kSteps / G;   // a chunk is 32 K sources
  constexpr int C = 32 * K;
  constexpr int L = NF / 8;       // lanes of one head within a source
  static_assert(G * K == kSteps, "NH * NF must be at most 64");
  // per warp: the ids of 3 chunks, el (then b) of 2; 2.4 KB at NF = 8
  __shared__ int ids_sh[kWarps][3][C];
  __shared__ __align__(16) float el_sh[kWarps][2][C * NH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (row >= n_rows) return;  // whole warps leave together
  const int head0 = blockIdx.y * NH;
  const int slot = lane % G;
  const int hk = slot / L;   // the head whose features this lane gathers
  const int hl = lane % NH;  // the head whose b this lane computes
  const int64_t rh = row * h_pad + head0;
  const int64_t h_stride = static_cast<int64_t>(h_pad) * o_pad;
  const int beg = __ldg(indptr + row), end = __ldg(indptr + row + 1);

  float t = 0.f;   // sum of b * (h[s] . dz[d]) over this lane's features
  float sb = 0.f;  // sum of b over this lane's pairs, head hl
  if (beg < end) {  // the same on every lane
    const float er_l = __ldg(er + rh + hl), lse_l = __ldg(lse + rh + hl);
    auto is_src = [n_src](int s) {
      return static_cast<unsigned>(s) < static_cast<unsigned>(n_src);
    };
    for (int fg = 0; fg < o_pad / NF; ++fg) {
      const int f0 = fg * NF + (slot % L) * 8;
      const uint4 dq = __ldg(
          reinterpret_cast<const uint4*>(dz + (rh + hk) * o_pad + f0));
      const uint32_t dw[4] = {dq.x, dq.y, dq.z, dq.w};
      float dv[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dv[2 * k] = __uint_as_float(dw[k] << 16);
        dv[2 * k + 1] = __uint_as_float(dw[k] & 0xffff0000u);
      }
      const uint16_t* h_hf =
          h + static_cast<int64_t>(head0 + hk) * o_pad + f0;
      const bool first = fg == 0;  // sum b once, on the first walk
      edge_ring::walk<C, NH>(
          ids_sh[warp], el_sh[warp], indices, beg, end, el, h_pad, head0,
          n_src, lane, [&](int c0, const int* ids, float* pw) {
            // 1. every gather of the chunk before the first FMA
            const int n_steps = min(kSteps, (end - c0 + P - 1) / P);
            uint4 v[kSteps];
#pragma unroll
            for (int u = 0; u < kSteps; ++u) {
              const int s = ids[u * P + lane / G];
              v[u] = u < n_steps && is_src(s)
                         ? __ldg(reinterpret_cast<const uint4*>(
                               h_hf + s * h_stride))
                         : make_uint4(0u, 0u, 0u, 0u);
            }
            // 2. b of the chunk's (source, head) pairs, over el in place
#pragma unroll
            for (int i = 0; i < K * NH; ++i) {
              const int p = i * 32 + lane;
              const float z = er_l + pw[p];
              const bool pos = z > 0.f;
              const float b =
                  is_src(ids[p / NH])
                      ? expf((pos ? z : z * slope) - lse_l) *
                            (pos ? 1.f : slope)
                      : 0.f;
              pw[p] = b;
              if (first) sb += b;
            }
            __syncwarp();
            // 3. b * (h[s] . dz[d]) over this lane's 8 features
#pragma unroll
            for (int u = 0; u < kSteps; ++u) {
              if (u < n_steps) {
                const float b = pw[(u * P + lane / G) * NH + hk];
                const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
                float dot = 0.f;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  dot += __uint_as_float(w[k] << 16) * dv[2 * k];
                  dot += __uint_as_float(w[k] & 0xffff0000u) * dv[2 * k + 1];
                }
                t += b * dot;
              }
            }
          });
    }
  }

  // t: add over the lanes that share this slot (they visited other
  // sources), then the partial dots over the L slots of this head; sb: add
  // over the lanes of head hl, then fetch head hk's from lane hk
#pragma unroll
  for (int o = 16; o >= G; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
#pragma unroll
  for (int o = L / 2; o >= 1; o >>= 1)
    t += __shfl_xor_sync(0xffffffffu, t, o);
#pragma unroll
  for (int o = 16; o >= NH; o >>= 1)
    sb += __shfl_xor_sync(0xffffffffu, sb, o);
  sb = __shfl_sync(0xffffffffu, sb, hk);
  const int hh = head0 + hk;
  if (lane < G && slot % L == 0 && hh < heads)
    der[row * heads + hh] = t - __ldg(cc + rh + hk) * sb;
}

template <int NH, int NF>
cudaError_t launch(const void* indptr, const void* indices, int64_t n_rows,
                   const void* el, const void* er, const void* lse,
                   const void* cc, const void* h, const void* dz, int n_src,
                   int heads, int h_pad, int o_pad, float slope, void* der,
                   cudaStream_t s) {
  if (h_pad % NH != 0 || o_pad % NF != 0 || h_pad < heads)
    return cudaErrorInvalidValue;
  const int64_t grid_x = (n_rows + kWarps - 1) / kWarps;
  const int64_t grid_y = h_pad / NH;
  if (grid_x > 0x7fffffffLL || grid_y > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y));
  gat_bwd_dst_kernel<NH, NF><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      n_rows, static_cast<const float*>(el), static_cast<const float*>(er),
      static_cast<const float*>(lse), static_cast<const float*>(cc),
      static_cast<const uint16_t*>(h), static_cast<const uint16_t*>(dz),
      n_src, heads, h_pad, o_pad, slope, static_cast<float*>(der));
  return cudaGetLastError();
}

}  // namespace

#define DGL_GAT_CASES(X)                                             \
  X(1, 8) X(2, 8) X(4, 8) X(8, 8) X(1, 16) X(2, 16) X(4, 16) X(1, 32) \
  X(2, 32) X(1, 64)

// indptr: (n_rows + 1,) int32, indices: int32, the relation's CSC, with
// indices.numel() + 4096 < 2^31 (the walk reads two chunks ahead). el:
// (n_src, h_pad) f32. er, lse (guarded), c: (n_rows, h_pad) f32. h: (n_src,
// h_pad, o_pad) bf16, dz: (n_rows, h_pad, o_pad) bf16. el, h and dz 16-byte
// aligned. der: (n_rows, heads) f32. (nh, nf) as for dgl_bitmap_gat_fwd:
// nh in {1, 2, 4, 8}, nf in {8, 16, 32, 64}, nh * nf <= 64. Returns a
// cudaError_t as int.
extern "C" int dgl_bitmap_gat_bwd_dst(const void* indptr, const void* indices,
                                      int64_t n_rows, const void* el,
                                      const void* er, const void* lse,
                                      const void* c, const void* h,
                                      const void* dz, int64_t n_src,
                                      int heads, int h_pad, int o_pad,
                                      int nh, int nf, float slope, void* der,
                                      void* stream) {
  if (n_src < 0 || n_src > 0x7fffffffLL)  // source ids are int32
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0 || heads == 0 || o_pad == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DGL_GAT_CASE(NH, NF)                                                  \
  if (nh == NH && nf == NF)                                                   \
    return static_cast<int>(launch<NH, NF>(                                   \
        indptr, indices, n_rows, el, er, lse, c, h, dz,                       \
        static_cast<int>(n_src), heads, h_pad, o_pad, slope, der, s));
  DGL_GAT_CASES(DGL_GAT_CASE)
#undef DGL_GAT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The (nh, nf) kernel's registers, static shared bytes, local bytes per
// thread, resident blocks per SM and gather bytes of h in flight per SM,
// into out[0..4]. Returns a cudaError_t as int.
extern "C" int dgl_bitmap_gat_bwd_dst_occupancy(int nh, int nf, int* out) {
#define DGL_GAT_CASE(NH, NF)                      \
  if (nh == NH && nf == NF)                       \
    return static_cast<int>(edge_ring::occupancy( \
        gat_bwd_dst_kernel<NH, NF>, kWarps * 32, kSteps, out));
  DGL_GAT_CASES(DGL_GAT_CASE)
#undef DGL_GAT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
