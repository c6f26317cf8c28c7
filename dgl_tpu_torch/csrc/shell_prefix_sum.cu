// Shell prefix sum with the row gather fused in, for Hopper (sm_90a).
//
// Replaces the Pallas kernel dgl_tpu/ops/shell_pallas.py::
// shell_prefix_sum_pallas together with the jnp.take(mode="fill") gather
// that feeds it (dgl_tpu/ops/hub_spmm.py::_shell_sum). It computes
//
//   out[r, :] = base[r, :] (or 0) + sum_{k : r < m_k} float(table[idx[off_k + r], :])
//
// over the nested-prefix shell levels k (sizes m_k non-increasing). An index
// outside [0, n_table) reads as zero: the shell builder pads each level with
// the index n_table. The sum is f32, base first, then the levels in order,
// which is the order of the Pallas kernel and of shell_spmm.prefix_reduce.
//
// What bounds it: bytes. Each (row, level) pair reads one index (4 B) and one
// bf16 table row (2F B); the output row is written once in f32 (4F B). On
// the TPU the gather could not be fused, so the piece stream went through
// HBM twice; here row-granular loads are legal, the pieces live only in
// registers, and the accumulator never leaves them.
//
// Design, simple first: one thread owns VEC consecutive features of one
// output row (16-byte bf16 loads when VEC == 8), neighbouring threads own
// neighbouring chunks of the same row so a warp's loads coalesce over the
// row, and the level loop stops at the first level that does not reach the
// row (the m_k do not increase). Offsets are computed in int64. No shared
// memory, no tensor cores: the work has no reuse inside a block.
//
// Plain C interface, bound from Python with ctypes
// (dgl_tpu_torch/_kernels.py); the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <int VEC>
__global__ void shell_prefix_sum_kernel(
    const uint16_t* __restrict__ table, int64_t n_table, int64_t feat,
    const int32_t* __restrict__ idx, const int64_t* __restrict__ level_off,
    const int64_t* __restrict__ level_rows, int n_levels,
    const float* __restrict__ base, float* __restrict__ out, int64_t n_out) {
  const int64_t n_vec = feat / VEC;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_out * n_vec) return;
  const int64_t r = t / n_vec;
  const int64_t c = (t - r * n_vec) * VEC;
  const int64_t o = r * feat + c;

  float acc[VEC];
  if (base != nullptr) {
    if constexpr (VEC == 8) {
      const float4 b0 = *reinterpret_cast<const float4*>(base + o);
      const float4 b1 = *reinterpret_cast<const float4*>(base + o + 4);
      acc[0] = b0.x; acc[1] = b0.y; acc[2] = b0.z; acc[3] = b0.w;
      acc[4] = b1.x; acc[5] = b1.y; acc[6] = b1.z; acc[7] = b1.w;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = base[o + j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  }

  for (int k = 0; k < n_levels; ++k) {
    if (r >= __ldg(level_rows + k)) break;
    const int64_t s = __ldg(idx + __ldg(level_off + k) + r);
    if (s < 0 || s >= n_table) continue;
    const uint16_t* row = table + s * feat + c;
    if constexpr (VEC == 8) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row));
      acc[0] += bf16_lo(v.x); acc[1] += bf16_hi(v.x);
      acc[2] += bf16_lo(v.y); acc[3] += bf16_hi(v.y);
      acc[4] += bf16_lo(v.z); acc[5] += bf16_hi(v.z);
      acc[6] += bf16_lo(v.w); acc[7] += bf16_hi(v.w);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[j] += __uint_as_float(static_cast<uint32_t>(__ldg(row + j)) << 16);
    }
  }

  if constexpr (VEC == 8) {
    *reinterpret_cast<float4*>(out + o) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(out + o + 4) =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[o + j] = acc[j];
  }
}

constexpr int kThreads = 256;

}  // namespace

// vec must be 8 (feat % 8 == 0 and every pointer 16-byte aligned, checked by
// the caller) or 1. Returns a cudaError_t as int; 0 means launched.
extern "C" int dgl_shell_prefix_sum(
    const void* table, int64_t n_table, int64_t feat, const void* idx,
    const void* level_off, const void* level_rows, int n_levels,
    const void* base, void* out, int64_t n_out, int vec, void* stream) {
  if (vec != 8 && vec != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t work = n_out * (feat / vec);
  if (work == 0) return 0;
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const uint16_t*>(table);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* lo = static_cast<const int64_t*>(level_off);
  const auto* lr = static_cast<const int64_t*>(level_rows);
  const auto* b = static_cast<const float*>(base);
  auto* o = static_cast<float*>(out);
  if (vec == 8) {
    shell_prefix_sum_kernel<8><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        t, n_table, feat, i, lo, lr, n_levels, b, o, n_out);
  } else {
    shell_prefix_sum_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        t, n_table, feat, i, lo, lr, n_levels, b, o, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}
