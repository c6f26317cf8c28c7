// Hub-table row gather for Hopper (sm_90a): kernel B6.
//
// Replaces the Pallas kernel dgl_tpu/ops/pallas_hub.py::hub_gather (body
// _make_hub_gather_kernel). It computes
//
//   out[i, :] = hub_x[slots[i], :]   if 0 <= slots[i] < H
//   out[i, :] = 0                    otherwise (the sentinel slot H)
//
// for an (H, F) f32 or bf16 table; with bf16 precision each value is rounded
// to bf16 (__float2bfloat16, round to nearest even) and widened back, which
// is what the TPU's one-hot bf16 product yields for a single nonzero.
//
// Why not the one-hot product: on the TPU a row-granular gather from VMEM
// was not expressible, so each 2048-edge block multiplied a one-hot
// (2048, 256) matrix by every 256-row chunk of the resident table: H/256
// matmuls per block, E*H*F multiply-adds for E*F selected values. On Hopper
// a row gather is a plain load, so the kernel moves the selected bytes only.
//
// What bounds it: bytes. The table (1 MB at H = 1024, F = 256, f32) does not
// fit in a block's 227 KB of shared memory but stays in the 50 MB L2, so the
// device-memory traffic is the (E, F) output written once plus the slots read
// once: about 1.2 GB at E = 1.17M, F = 256, f32, 0.36 ms at 3.35 TB/s.
//
// Design, simple first: one thread moves 16 bytes of one output row (a
// float4 of f32 or 8 bf16 when VEC > 1, else one value); neighbouring
// threads own neighbouring chunks of the same row, so a warp's loads and
// stores coalesce over the row. Offsets are int64. No shared memory.
//
// Plain C interface, bound from Python with ctypes
// (dgl_tpu_torch/_kernels.py); the launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// f32 table: VEC is 4 (one float4) or 1.
template <int VEC>
__global__ void hub_gather_f32_kernel(const float* __restrict__ hub,
                                      int64_t H, int64_t feat,
                                      const int32_t* __restrict__ slots,
                                      int64_t E, int round,
                                      float* __restrict__ out) {
  const int64_t n_vec = feat / VEC;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= E * n_vec) return;
  const int64_t i = t / n_vec;
  const int64_t c = (t - i * n_vec) * VEC;
  const int64_t s = __ldg(slots + i);
  float v[VEC];
  if (s < 0 || s >= H) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = 0.f;
  } else if constexpr (VEC == 4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(hub + s * feat + c));
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
    v[0] = __ldg(hub + s * feat + c);
  }
  if (round) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = round_bf16(v[j]);
  }
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(out + i * feat + c) =
        make_float4(v[0], v[1], v[2], v[3]);
  } else {
    out[i * feat + c] = v[0];
  }
}

// bf16 table: the values are bf16 already, so both precisions select them as
// they are. VEC is 8 (one 16-byte uint4) or 1.
template <int VEC>
__global__ void hub_gather_bf16_kernel(const uint16_t* __restrict__ hub,
                                       int64_t H, int64_t feat,
                                       const int32_t* __restrict__ slots,
                                       int64_t E, uint16_t* __restrict__ out) {
  const int64_t n_vec = feat / VEC;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= E * n_vec) return;
  const int64_t i = t / n_vec;
  const int64_t c = (t - i * n_vec) * VEC;
  const int64_t s = __ldg(slots + i);
  const bool hit = s >= 0 && s < H;
  if constexpr (VEC == 8) {
    const uint4 w = hit ? __ldg(reinterpret_cast<const uint4*>(hub + s * feat + c))
                        : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(out + i * feat + c) = w;
  } else {
    out[i * feat + c] = hit ? __ldg(hub + s * feat + c) : uint16_t(0);
  }
}

constexpr int kThreads = 256;

}  // namespace

// is_bf16: the table and the output are bf16 (else f32). round: bf16
// precision for an f32 table. vec: 16 bytes a thread (4 f32 or 8 bf16; the
// caller checks feat % vec == 0 and 16-byte alignment) or 1. Returns a
// cudaError_t as int; 0 means launched.
extern "C" int dgl_hub_gather(const void* hub, int64_t H, int64_t feat,
                              int is_bf16, const void* slots, int64_t E,
                              int round, void* out, int vec, void* stream) {
  const int wide = is_bf16 ? 8 : 4;
  if (vec != wide && vec != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t work = E * (feat / vec);
  if (work == 0) return 0;
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sl = static_cast<const int32_t*>(slots);
  const unsigned nb = static_cast<unsigned>(blocks);
  if (is_bf16) {
    const auto* h = static_cast<const uint16_t*>(hub);
    auto* o = static_cast<uint16_t*>(out);
    if (vec == 8) {
      hub_gather_bf16_kernel<8><<<nb, kThreads, 0, st>>>(h, H, feat, sl, E, o);
    } else {
      hub_gather_bf16_kernel<1><<<nb, kThreads, 0, st>>>(h, H, feat, sl, E, o);
    }
  } else {
    const auto* h = static_cast<const float*>(hub);
    auto* o = static_cast<float*>(out);
    if (vec == 4) {
      hub_gather_f32_kernel<4><<<nb, kThreads, 0, st>>>(h, H, feat, sl, E,
                                                         round, o);
    } else {
      hub_gather_f32_kernel<1><<<nb, kThreads, 0, st>>>(h, H, feat, sl, E,
                                                         round, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
