// GAT forward over a bitmap plan's relation, for Hopper (sm_90a): each
// destination row walks its in-edge list from the relation's CSC.
//
// Replaces the Pallas kernel dgl_tpu/ops/bitmap_gat.py::_gat_fwd_pallas.
// For every dst row d < n_rows and head h it computes the edge softmax of
// the rank-1 logits over the row's in-neighbours s and the weighted sum
//
//   z[s]      = leaky(er[d, h] + el[s, h])
//   m         = max_s z[s],  p[s] = exp(z[s] - m),  S = sum_s p[s]
//   out[d, h] = sum_s p[s] * float(h[s, h, :]) / max(S, 1e-30)
//   lse[d, h] = m + log(max(S, 1e-30))
//
// in f32 with h in bf16, as the reference's CPU path _gat_xla defines them
// (p stays f32; the TPU kernel rounds p to bf16 before its dot). A row with
// no in-edge gives out = 0 and lse = log(1e-30), as _gat_xla does. The
// in-neighbours of row d are indices[indptr[d] .. indptr[d + 1]), the
// relation's csc_indptr / csc_indices: the plan refuses multi-edges, so
// they name exactly the (d, s) pairs the plan's bits name. An index outside
// [0, n_src) (a padded edge at the sink row n_src) is skipped. Nothing E-
// or N^2-sized is written to device memory.
//
// What bounds it on this card: the gathers. The bytes that must move once
// are few (Reddit at H = 8, O = 8: 0.447 GB of int32 ids, 0.1 GB of el, er,
// h, out and lse, 0.17 ms at 3.35 TB/s), but every edge gathers el[s] and
// h[s], 32 + 128 bytes at that shape, 17.9 GB a call, mostly from L2 (h and
// el together fit its 50 MB). What limits them is how many are in flight a
// warp and what an edge costs in instructions. The bitmap walk this kernel
// replaces streamed the 6.81 GB bitmap, decoded its bits into a queue and
// drained the queue with about 640 bytes of gathers in flight a warp, each
// phase after the other.
//
// Design: one warp owns one dst row and walks its in-edge list in chunks of
// 32 K sources, lane owning sources k * 32 + lane (k < K). A pass covers NH
// heads and NF features of each, split into G = NH * NF / 8 slots of 8 bf16
// features (16 bytes): a source goes to G lanes, one slot each, and K = 8 /
// G, so every lane gathers kSteps = 8 rows of 16 bytes a chunk, 4 KB a warp.
// The ids and el arrive through a ring in the warp's shared memory, by
// cp.async: the ids two chunks ahead (evict-first in L2, so the 0.447 GB id
// stream does not push h and el out), el one chunk ahead (its ids are in
// the ring by then). Prefetched into registers instead, they would be
// copied from buffer to buffer at the end of every chunk, and the copy
// waits for the load: a round trip to device memory a chunk.
//
//  1. Logits: the lane computes the NH logits of each source it owns from
//     el in the ring. A warp max per head over the chunk raises the running
//     max once a chunk, and the lane writes p = exp(z - m) over el.
//  2. Gathers: each lane issues all kSteps gathers of the chunk (the ids
//     from the ring) before its first FMA.
//  3. While they arrive, the lane rescales its accumulators to the new max
//     of its head (once a chunk, no per-source branch).
//  4. It adds p * h[s] over its 8 features and p into its sum.
//
// Every lane holds the warp's running maxima, so at the end the lanes that
// share a slot add their states with shuffles and G lanes write the row.
// More heads or features run as further passes (blockIdx.y). A pass
// re-reads the ids and el and repeats every edge's logits, which costs
// more than the gathers it saves: the wrapper takes the fewest passes
// (H = 1, O = 41 as one pass of 64 features, not three of 16). h arrives as
// (n_src, H_pad, O_pad) bf16 and el, er as (*, H_pad) f32, padded by the
// wrapper to whole passes.
//
// Plain C interface, bound from Python with ctypes
// (dgl_tpu_torch/_kernels.py); the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;      // rows (warps) per thread block
constexpr int kSteps = 8;      // 16-byte gathers in flight per lane
constexpr int kMinBlocks = 6;  // resident blocks per SM: at most 80 registers

// B bytes from global src to shared dst without a register; zeros and no
// read when !ok
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(B), "r"(ok ? B : 0)
               : "memory");
}
// the same for 4 bytes read once: L2 evicts the line first (policy)
__device__ __forceinline__ void cp_async_once(void* dst, const void* src,
                                              bool ok, uint64_t policy) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2, %3;\n"
      ::"r"(d), "l"(src), "r"(ok ? 4 : 0), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's newest groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v[j] = the max of v[j] over the warp, on every lane, for j < NH: a
// reduce-scatter (each step keeps half of the heads, chosen by one lane
// bit, and swaps the other half), the last head's lanes reduced, then
// each head fetched from a lane that holds it: 17 shuffles at NH = 8,
// against 40 for a butterfly of each head
template <int NH>
__device__ __forceinline__ void warp_max_heads(float (&v)[NH], int lane) {
  float a[NH];
#pragma unroll
  for (int j = 0; j < NH; ++j) a[j] = v[j];
#pragma unroll
  for (int n = NH / 2, o = 16; n >= 1; n /= 2, o /= 2) {
    const bool up = lane & o;  // keep heads [n, 2n) of what is left
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = up ? a[i] : a[i + n];
      const float keep = up ? a[i + n] : a[i];
      a[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, o));
    }
  }
  // a[0]: the head whose bits are this lane's top log2(NH) bits
#pragma unroll
  for (int o = 16 / NH; o >= 1; o /= 2)
    a[0] = fmaxf(a[0], __shfl_xor_sync(0xffffffffu, a[0], o));
  if constexpr (NH == 1) {
    v[0] = a[0];
  } else {
#pragma unroll
    for (int j = 0; j < NH; ++j)
      v[j] = __shfl_sync(0xffffffffu, a[0], j * (32 / NH));
  }
}

// v[hk] for a lane-dependent hk without indexing registers dynamically
template <int NH>
__device__ __forceinline__ float pick(const float (&v)[NH], int hk) {
  float r = v[0];
#pragma unroll
  for (int k = 1; k < NH; ++k) r = hk == k ? v[k] : r;
  return r;
}

template <int NH, int NF>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks) gat_fwd_kernel(
    const int* __restrict__ indptr, const int* __restrict__ indices,
    int64_t n_rows, const float* __restrict__ el,
    const float* __restrict__ er, const uint16_t* __restrict__ h, int n_src,
    int heads, int odim, int h_pad, int o_pad, float slope,
    float* __restrict__ out, float* __restrict__ lse) {
  constexpr int G = NH * NF / 8;  // lanes per source, 8 features each
  constexpr int P = 32 / G;       // sources per gather step
  constexpr int K = kSteps / G;   // sources a lane owns: a chunk is 32 K
  constexpr int C = 32 * K;
  static_assert(G * K == kSteps, "NH * NF must be at most 64");
  // per warp: the ids of 3 chunks, el (then p) of 2; 2.4 KB at NF = 8
  __shared__ int ids_sh[kWarps][3][C];
  __shared__ __align__(16) float el_sh[kWarps][2][C * NH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (row >= n_rows) return;  // whole warps leave together
  const int n_fg = o_pad / NF;
  const int head0 = (blockIdx.y / n_fg) * NH;
  const int slot = lane % G;
  const int hk = slot / (NF / 8);  // the head this lane sums, in the pass
  const int f0 = (blockIdx.y % n_fg) * NF + (slot % (NF / 8)) * 8;
  const uint16_t* h_hf = h + static_cast<int64_t>(head0 + hk) * o_pad + f0;
  const int64_t h_stride = static_cast<int64_t>(h_pad) * o_pad;
  const int beg = __ldg(indptr + row), end = __ldg(indptr + row + 1);

  float m[NH];  // the running max of each head, the same on every lane
#pragma unroll
  for (int j = 0; j < NH; ++j) m[j] = -INFINITY;
  float sum = 0.f, acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;

  if (beg < end) {  // the same on every lane
    float er_r[NH];
#pragma unroll
    for (int j = 0; j < NH; ++j)
      er_r[j] = __ldg(er + row * h_pad + head0 + j);
    uint64_t once;  // the id stream must not push h and el out of L2
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(once));
    auto is_src = [n_src](int s) {
      return static_cast<unsigned>(s) < static_cast<unsigned>(n_src);
    };
    // lane owns sources k * 32 + lane of a chunk; -1 past the row's end
    auto fetch_ids = [&](int c0, int r) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = c0 + k * 32 + lane;
        if (i < end)
          cp_async_once(&ids_sh[warp][r][k * 32 + lane], indices + i, true,
                        once);
        else
          ids_sh[warp][r][k * 32 + lane] = -1;
      }
      cp_commit();
    };
    auto fetch_el = [&](int r, int e) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = ids_sh[warp][r][k * 32 + lane];
        const bool ok = is_src(s);
        const float* src =
            el + static_cast<int64_t>(ok ? s : 0) * h_pad + head0;
        float* dst = &el_sh[warp][e][(k * 32 + lane) * NH];
        if constexpr (NH >= 4) {
#pragma unroll
          for (int q = 0; q < NH; q += 4) cp_async<16>(dst + q, src + q, ok);
        } else {
          cp_async<4 * NH>(dst, src, ok);
        }
      }
      cp_commit();
    };

    // the ring: ids two chunks ahead, el one chunk ahead
    fetch_ids(beg, 0);
    fetch_ids(beg + C, 1);
    cp_wait<1>();
    __syncwarp();
    fetch_el(0, 0);
    int it = 0;
    for (int c0 = beg; c0 < end; c0 += C, ++it) {
      const int* ids = ids_sh[warp][it % 3];
      float* pw = el_sh[warp][it & 1];
      fetch_ids(c0 + 2 * C, (it + 2) % 3);
      cp_wait<1>();  // this chunk's el and the next chunk's ids are here
      __syncwarp();
      fetch_el((it + 1) % 3, (it + 1) & 1);

      // 1. logits of the sources this lane owns; the max rises once a chunk
      float z[K][NH], m_new[NH];
      unsigned ok = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        ok |= static_cast<unsigned>(is_src(ids[k * 32 + lane])) << k;
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          const float t = er_r[j] + pw[(k * 32 + lane) * NH + j];
          z[k][j] = t > 0.f ? t : t * slope;
        }
      }
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        m_new[j] = -INFINITY;
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (ok >> k & 1u) m_new[j] = fmaxf(m_new[j], z[k][j]);
      }
      warp_max_heads<NH>(m_new, lane);
#pragma unroll
      for (int j = 0; j < NH; ++j) m_new[j] = fmaxf(m[j], m_new[j]);
      // p over el, in place: (source, head) at source * NH + head
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int j = 0; j < NH; ++j)
          pw[(k * 32 + lane) * NH + j] =
              ok >> k & 1u ? __expf(z[k][j] - m_new[j]) : 0.f;
      }
      __syncwarp();

      // 2. every gather of the chunk before the first FMA
      const int n_steps = min(kSteps, (end - c0 + P - 1) / P);
      uint4 v[kSteps];
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        const int j = t * P + lane / G;  // the source, in the chunk
        const int s = ids[j];
        v[t] = t < n_steps && is_src(s)
                   ? __ldg(reinterpret_cast<const uint4*>(h_hf + s * h_stride))
                   : make_uint4(0u, 0u, 0u, 0u);
      }

      // 3. this lane's state to the new max of its head
      const float m_old = pick<NH>(m, hk), m_now = pick<NH>(m_new, hk);
      const float r = m_now == -INFINITY ? 1.f : __expf(m_old - m_now);
      sum *= r;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] *= r;
#pragma unroll
      for (int j = 0; j < NH; ++j) m[j] = m_new[j];

      // 4. p * h[s] over this lane's 8 features
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        if (t < n_steps) {
          const float p = pw[(t * P + lane / G) * NH + hk];
          sum += p;
          const uint32_t w[4] = {v[t].x, v[t].y, v[t].z, v[t].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[2 * k] += p * __uint_as_float(w[k] << 16);
            acc[2 * k + 1] += p * __uint_as_float(w[k] & 0xffff0000u);
          }
        }
      }
      __syncwarp();  // the ring's slots are written again
    }
    cp_wait<0>();  // no copy may land after the warp has left
  }

  // the lanes that share this slot hold the same max: add their states
#pragma unroll
  for (int o = 16; o >= G; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
  }
  const int hh = head0 + hk;
  if (lane < G && hh < heads) {
    const float mh = pick<NH>(m, hk);
    const bool empty = mh == -INFINITY;  // the row has no in-edge
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    float* orow = out + (row * heads + hh) * static_cast<int64_t>(odim);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (f0 + k < odim) orow[f0 + k] = acc[k] * inv;
    if (f0 == 0)
      lse[row * heads + hh] = (empty ? 0.f : mh) + logf(fmaxf(sum, 1e-30f));
  }
}

template <int NH, int NF>
cudaError_t launch(const void* indptr, const void* indices, int64_t n_rows,
                   const void* el, const void* er, const void* h, int n_src,
                   int heads, int odim, int h_pad, int o_pad, float slope,
                   void* out, void* lse, cudaStream_t s) {
  if (h_pad % NH != 0 || o_pad % NF != 0 || h_pad < heads || o_pad < odim)
    return cudaErrorInvalidValue;
  const int64_t grid_x = (n_rows + kWarps - 1) / kWarps;
  const int64_t grid_y = static_cast<int64_t>(h_pad / NH) * (o_pad / NF);
  if (grid_x > 0x7fffffffLL || grid_y > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y));
  gat_fwd_kernel<NH, NF><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      n_rows, static_cast<const float*>(el), static_cast<const float*>(er),
      static_cast<const uint16_t*>(h), n_src, heads, odim, h_pad, o_pad,
      slope, static_cast<float*>(out), static_cast<float*>(lse));
  return cudaGetLastError();
}

// Registers, static shared bytes and local (stack and spill) bytes per
// thread of one instantiation, its resident blocks per SM, and the gather
// bytes an SM has in flight while all those warps gather (kSteps 16-byte
// loads a lane), into out[0..4].
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    kWarps * 32, 0);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = blocks;
  out[4] = blocks * kWarps * 32 * kSteps * 16;
  return cudaSuccess;
}

}  // namespace

#define DGL_GAT_CASES(X)                                             \
  X(1, 8) X(2, 8) X(4, 8) X(8, 8) X(1, 16) X(2, 16) X(4, 16) X(1, 32) \
  X(2, 32) X(1, 64)

// indptr: (n_rows + 1,) int32, indices: int32, the relation's CSC, with
// indices.numel() + 4096 < 2^31 (the walk reads two chunks ahead). el:
// (n_src, h_pad) f32, er: (n_rows, h_pad) f32, both 16-byte aligned.
// h: (n_src, h_pad, o_pad) bf16, 16-byte aligned. out: (n_rows, heads,
// odim) f32. lse: (n_rows, heads) f32. (nh, nf): nh in {1, 2, 4, 8}, nf in
// {8, 16, 32, 64}, nh * nf <= 64. Returns a cudaError_t as int.
extern "C" int dgl_bitmap_gat_fwd(const void* indptr, const void* indices,
                                  int64_t n_rows, const void* el,
                                  const void* er, const void* h,
                                  int64_t n_src, int heads, int odim,
                                  int h_pad, int o_pad, int nh, int nf,
                                  float slope, void* out, void* lse,
                                  void* stream) {
  if (n_src < 0 || n_src > 0x7fffffffLL)  // source ids are int32
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0 || heads == 0 || odim == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DGL_GAT_CASE(NH, NF)                                                \
  if (nh == NH && nf == NF)                                                 \
    return static_cast<int>(launch<NH, NF>(                                 \
        indptr, indices, n_rows, el, er, h, static_cast<int>(n_src), heads, \
        odim, h_pad, o_pad, slope, out, lse, s));
  DGL_GAT_CASES(DGL_GAT_CASE)
#undef DGL_GAT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The (nh, nf) kernel's registers, static shared bytes, local bytes per
// thread, resident blocks per SM and gather bytes in flight per SM, into
// out[0..4]. Returns a cudaError_t as int.
extern "C" int dgl_bitmap_gat_fwd_occupancy(int nh, int nf, int* out) {
#define DGL_GAT_CASE(NH, NF) \
  if (nh == NH && nf == NF)  \
    return static_cast<int>(occupancy(gat_fwd_kernel<NH, NF>, out));
  DGL_GAT_CASES(DGL_GAT_CASE)
#undef DGL_GAT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
