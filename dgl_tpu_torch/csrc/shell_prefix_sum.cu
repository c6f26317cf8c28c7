// Shell prefix sums with the row gather fused in, for Hopper (sm_90a).
//
// Replaces the Pallas kernel dgl_tpu/ops/shell_pallas.py::
// shell_prefix_sum_pallas in both of its callers.
//
// 1. dgl_shell_prefix_sum, with the jnp.take(mode="fill") gather that feeds
//    it in the hub SpMM's cold tail (dgl_tpu/ops/hub_spmm.py::_shell_sum):
//
//      out[r, :] = base[r, :] (or 0) + sum_{k : r < m_k} float(table[idx[off_k + r], :])
//
//    over the nested-prefix shell levels k (sizes m_k non-increasing). An
//    index outside [0, n_table) reads as zero: the hub plan pads each level
//    with the index n_table.
//
// 2. dgl_shell_prefix_gspmm, with the message build that feeds it in the
//    weighted shell g-SpMM (dgl_tpu/ops/shell_spmm.py::_shell_accumulate,
//    msg_of then the masked where):
//
//      out[r, j] = base[r, j] (or 0) + sum_{k : r < n_k} f32(round_T(op(
//                      lhs[nidx[off_k + r], j'], rhs[eidx[off_k + r], j''])))
//
//    op is add, sub, mul, div, copy_lhs or copy_rhs; the tables are bf16 or
//    f32 (T), the message is computed in f32 and rounded to T, as the
//    reference computes it on T operands. n_k is the level's real row
//    count: the weighted plan pads its levels with row 0 and edge 0, real
//    data (a division by edge 0 may give inf), so the walk stops by the
//    count and never reads a padded slot. j' and j'' follow the operands'
//    broadcast: the whole row, one value a row, or one run of the output's
//    dims, column (j / div) % mod.
//
// Both sum in f32, base first, then the levels in order: the order of the
// Pallas kernel and of shell_spmm.prefix_reduce. Every add and message op
// is an explicitly rounded intrinsic, so no fused multiply-add changes a
// bit and the kernels agree with their plain versions exactly.
//
// What bounds them: bytes. Each (row, level) pair reads its indices (4 or
// 8 B) and its gathered rows (2 or 4 B a value); the output row is written
// once in f32. On the TPU the gather (and the message) could not be fused,
// so the piece stream went through HBM twice; here row-granular loads are
// legal, the pieces live only in registers, and the accumulator never
// leaves them.
//
// Design, simple first: one thread owns VEC consecutive output columns of
// one output row (16-byte loads of whole-row operands when VEC == 8),
// neighbouring threads own neighbouring chunks of the same row so a warp's
// loads coalesce over the row, and the level walk (walk_levels, shared by
// both kernels) stops at the first level that does not reach the row (the
// level sizes do not increase). Offsets are computed in int64. No shared
// memory, no tensor cores: the work has no reuse inside a block.
//
// Plain C interface, bound from Python with ctypes
// (dgl_tpu_torch/_kernels.py); each launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Calls visit(k, position in the flat index vector) for each level k that
// reaches row r, in level order.
template <typename Visit>
__device__ __forceinline__ void walk_levels(
    int64_t r, const int64_t* __restrict__ level_off,
    const int64_t* __restrict__ level_rows, int n_levels, Visit visit) {
  for (int k = 0; k < n_levels; ++k) {
    if (r >= __ldg(level_rows + k)) break;
    visit(k, __ldg(level_off + k) + r);
  }
}

template <int VEC>
__device__ __forceinline__ void load_base(const float* __restrict__ base,
                                          int64_t o, float (&acc)[VEC]) {
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
}

template <int VEC>
__device__ __forceinline__ void store_out(float* __restrict__ out, int64_t o,
                                          const float (&acc)[VEC]) {
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
  load_base<VEC>(base, o, acc);
  walk_levels(r, level_off, level_rows, n_levels, [&](int, int64_t p) {
    const int64_t s = __ldg(idx + p);
    if (s < 0 || s >= n_table) return;
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
  });
  store_out<VEC>(out, o, acc);
}

// ---- the weighted caller ---------------------------------------------------

enum Op { kAdd = 0, kSub = 1, kMul = 2, kDiv = 3, kCopyLhs = 4, kCopyRhs = 5 };

// How an operand reads output column j: kind 0 the whole row (column j),
// 1 one value a row (column 0), 2 column (j / div) % mod. Its row stride is
// mod (its own feature count).
struct Operand {
  const void* ptr;
  int kind;
  int64_t div;
  int64_t mod;
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ld(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_row(const Operand& a, int64_t row,
                                         int64_t c, float (&v)[VEC]) {
  const T* base = static_cast<const T*>(a.ptr) + row * a.mod;
  if (a.kind == 0) {
    const T* p = base + c;
    if constexpr (VEC == 8 && sizeof(T) == 2) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
      v[0] = bf16_lo(w.x); v[1] = bf16_hi(w.x);
      v[2] = bf16_lo(w.y); v[3] = bf16_hi(w.y);
      v[4] = bf16_lo(w.z); v[5] = bf16_hi(w.z);
      v[6] = bf16_lo(w.w); v[7] = bf16_hi(w.w);
    } else if constexpr (VEC == 8) {
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(p));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(p) + 1);
      v[0] = w0.x; v[1] = w0.y; v[2] = w0.z; v[3] = w0.w;
      v[4] = w1.x; v[5] = w1.y; v[6] = w1.z; v[7] = w1.w;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = ld(p + j);
    }
  } else if (a.kind == 1) {
    const float x = ld(base);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = x;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = ld(base + ((c + j) / a.div) % a.mod);
  }
}

template <int OP>
__device__ __forceinline__ float apply_op(float a, float b) {
  if constexpr (OP == kAdd) return __fadd_rn(a, b);
  if constexpr (OP == kSub) return __fsub_rn(a, b);
  if constexpr (OP == kMul) return __fmul_rn(a, b);
  if constexpr (OP == kDiv) return __fdiv_rn(a, b);
  if constexpr (OP == kCopyLhs) return a;
  return b;
}

// The message rounded to the tables' type, as op on T operands returns T.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }

__device__ __forceinline__ float round_to(float x, const uint16_t*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, int VEC, int OP>
__global__ void shell_prefix_gspmm_kernel(
    Operand lhs, Operand rhs, const int32_t* __restrict__ nidx,
    const int32_t* __restrict__ eidx, const int64_t* __restrict__ level_off,
    const int64_t* __restrict__ level_real, int n_levels,
    const float* __restrict__ base, float* __restrict__ out, int64_t n_out,
    int64_t feat) {
  const int64_t n_vec = feat / VEC;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_out * n_vec) return;
  const int64_t r = t / n_vec;
  const int64_t c = (t - r * n_vec) * VEC;
  const int64_t o = r * feat + c;

  float acc[VEC];
  load_base<VEC>(base, o, acc);
  walk_levels(r, level_off, level_real, n_levels, [&](int, int64_t p) {
    float a[VEC], b[VEC];
    if constexpr (OP != kCopyRhs) load_row<T, VEC>(lhs, __ldg(nidx + p), c, a);
    if constexpr (OP != kCopyLhs) load_row<T, VEC>(rhs, __ldg(eidx + p), c, b);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float m;
      if constexpr (OP == kCopyLhs) {
        m = a[j];
      } else if constexpr (OP == kCopyRhs) {
        m = b[j];
      } else {
        m = round_to(apply_op<OP>(a[j], b[j]), static_cast<const T*>(nullptr));
      }
      acc[j] = __fadd_rn(acc[j], m);
    }
  });
  store_out<VEC>(out, o, acc);
}

constexpr int kThreads = 256;

int grid_of(int64_t work, unsigned* blocks) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  if (b > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(b);
  return 0;
}

template <typename T, int VEC>
int launch_gspmm(int op, Operand lhs, Operand rhs, const int32_t* n,
                 const int32_t* e, const int64_t* lo, const int64_t* lr,
                 int n_levels, const float* b, float* o, int64_t n_out,
                 int64_t feat, unsigned blocks, cudaStream_t s) {
#define DGL_GSPMM_CASE(OP)                                                  \
  case OP:                                                                  \
    shell_prefix_gspmm_kernel<T, VEC, OP><<<blocks, kThreads, 0, s>>>(      \
        lhs, rhs, n, e, lo, lr, n_levels, b, o, n_out, feat);               \
    break;
  switch (op) {
    DGL_GSPMM_CASE(kAdd)
    DGL_GSPMM_CASE(kSub)
    DGL_GSPMM_CASE(kMul)
    DGL_GSPMM_CASE(kDiv)
    DGL_GSPMM_CASE(kCopyLhs)
    DGL_GSPMM_CASE(kCopyRhs)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DGL_GSPMM_CASE
  return static_cast<int>(cudaGetLastError());
}

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
  unsigned blocks = 0;
  if (int err = grid_of(work, &blocks)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const uint16_t*>(table);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* lo = static_cast<const int64_t*>(level_off);
  const auto* lr = static_cast<const int64_t*>(level_rows);
  const auto* b = static_cast<const float*>(base);
  auto* o = static_cast<float*>(out);
  if (vec == 8) {
    shell_prefix_sum_kernel<8><<<blocks, kThreads, 0, s>>>(
        t, n_table, feat, i, lo, lr, n_levels, b, o, n_out);
  } else {
    shell_prefix_sum_kernel<1><<<blocks, kThreads, 0, s>>>(
        t, n_table, feat, i, lo, lr, n_levels, b, o, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// op: 0 add, 1 sub, 2 mul, 3 div, 4 copy_lhs, 5 copy_rhs. bf16: the tables'
// type (1 bf16, 0 f32). Each operand: pointer (null for the copy op that
// does not read it, and for an empty table, which no level reads), kind,
// div, mod (see Operand). level_real holds each
// level's real row count n_k. vec must be 8 (feat % 8 == 0 and the
// whole-row operands', the base's and the output's pointers 16-byte
// aligned, checked by the caller) or 1. Returns a cudaError_t as int.
extern "C" int dgl_shell_prefix_gspmm(
    int op, int bf16, const void* lhs, int lhs_kind, int64_t lhs_div,
    int64_t lhs_mod, const void* rhs, int rhs_kind, int64_t rhs_div,
    int64_t rhs_mod, const void* nidx, const void* eidx,
    const void* level_off, const void* level_real, int n_levels,
    const void* base, void* out, int64_t n_out, int64_t feat, int vec,
    void* stream) {
  if (vec != 8 && vec != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t work = n_out * (feat / vec);
  if (work == 0) return 0;
  unsigned blocks = 0;
  if (int err = grid_of(work, &blocks)) return err;
  const Operand l{lhs, lhs_kind, lhs_div, lhs_mod};
  const Operand r{rhs, rhs_kind, rhs_div, rhs_mod};
  const auto* n = static_cast<const int32_t*>(nidx);
  const auto* e = static_cast<const int32_t*>(eidx);
  const auto* lo = static_cast<const int64_t*>(level_off);
  const auto* lr = static_cast<const int64_t*>(level_real);
  const auto* b = static_cast<const float*>(base);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return vec == 8
        ? launch_gspmm<uint16_t, 8>(op, l, r, n, e, lo, lr, n_levels, b, o,
                                    n_out, feat, blocks, s)
        : launch_gspmm<uint16_t, 1>(op, l, r, n, e, lo, lr, n_levels, b, o,
                                    n_out, feat, blocks, s);
  }
  return vec == 8
      ? launch_gspmm<float, 8>(op, l, r, n, e, lo, lr, n_levels, b, o, n_out,
                               feat, blocks, s)
      : launch_gspmm<float, 1>(op, l, r, n, e, lo, lr, n_levels, b, o, n_out,
                               feat, blocks, s);
}
