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
//    msg_of then the masked where) and the unrank gather that follows it:
//
//      out[rank[r], j] = base[r, j] (or 0) + sum_{k : r < n_k} f32(round_T(
//          op(lhs[nidx[off_k + r], j'], rhs[eidx[off_k + r], j''])))
//
//    op is add, sub, mul, div, copy_lhs or copy_rhs; the tables are bf16 or
//    f32 (T), the message is computed in f32 and rounded to T, as the
//    reference computes it on T operands. n_k is the level's real row
//    count: the weighted plan pads its levels with row 0 and edge 0, real
//    data (a division by edge 0 may give inf), so the walk stops by the
//    count and never reads a padded slot. j' and j'' follow the operands'
//    broadcast: the whole row, one value a row, or one run of the output's
//    dims, column (j / div) % mod. rank (optional) is the permutation from
//    rank order to node order: row r is stored at rank[r], so the rows come
//    out in node order; without it, in rank order.
//
// Both sum in f32, base first, then the levels in order: the order of the
// Pallas kernel and of shell_spmm.prefix_reduce. Every add and message op
// is an explicitly rounded intrinsic, so no fused multiply-add changes a
// bit and the kernels agree with their plain versions exactly.
//
// dgl_shell_prefix_sum, simple first: one thread owns VEC consecutive
// output columns of one output row (16-byte loads when VEC == 8),
// neighbouring threads own neighbouring chunks of the same row so a warp's
// loads coalesce over the row, and the level walk (walk_levels) stops at
// the first level that does not reach the row. Bytes bound it: each
// (row, level) pair reads its index and its gathered row, and the output
// row is written once in f32. Its rows have few levels (the hub plan's
// cold tail: 2.4 a row on ogbn-arxiv), so the walk's latency stays hidden.
//
// dgl_shell_prefix_gspmm's rows have more levels (7.9 a row in the
// weighted arxiv forward, 22 levels), and each level is a chain of
// dependent loads: the level's count, the slot's indices, then the node
// row and the edge value. Walked one level after the other, that latency
// binds it, not the bytes. Once the chain is cut, the instructions a level
// costs and the registers that set how many warps hide the rest do: on
// the H100 the kernel is barely faster when every slot gathers one row,
// which takes the rows' memory traffic away (chip_smoke.py's
// ms_every_slot_row_0; PERF.md, section 6). So:
//
// - A warp owns a tile of rw consecutive rank rows, F / VEC threads a row
//   (rw = 32 / (F / VEC): several rows share a warp at small F; a wider
//   row is split over blockIdx.y). At entry the block copies the level
//   table into shared memory, its only block-wide barrier. Each warp then
//   takes its tile's level count by one ballot over its first row (rows
//   are rank-ordered and the levels nested prefixes, so the first row has
//   the most) and stages every slot of the tile's levels into its own part
//   of shared memory: the runs nidx[off_k + r0 .. off_k + min(r0 + rw,
//   n_k)) and eidx[...], kStage slots a lane at a time, so the tile's
//   index loads are in flight together. An operand of one value a row
//   (kind 1: the edge weight of u_mul_e and of EdgeWeightNorm's copy_rhs)
//   is gathered once a slot here, in place of its index, not once a lane.
//   The warps of a block do not wait for each other: staging by the whole
//   block (a barrier after the table and one after the slots) held every
//   warp to the slowest one's loads and measured slower.
// - Each thread then walks its row's levels (its tile's count, or a few
//   fewer) in groups of kGroup levels (one in f32): it issues the group's
//   row loads first, then builds the messages and adds them in level order
//   with the explicit roundings, so the result stays exact. Levels past
//   the row's count issue no load and add nothing. Two levels in flight
//   keep the kernel at 40 registers; four or eight hold more rows in
//   registers, fewer warps fit on an SM, and it measured slower.
// - The kinds of the main path (whole lhs rows, one rhs value a row) are
//   compiled in (FAST): no kind test in the walk, and the rhs value comes
//   from shared memory. bf16 messages are rounded two at a time by one
//   packed conversion, each as alone.
// - The row is stored at rank[r]: the caller needs no unrank gather, one
//   more pass over the f32 output. rank is a permutation, so no two
//   threads store one element. base stays in rank order.
//
// No tensor cores: the work has no reuse inside a block. Offsets are
// computed in int64.
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

constexpr int kMaxLevels = 32;  // SHELL_CAP; the wrapper raises above it
constexpr int kWarps = 8;       // warps a block, fewer where shared memory
constexpr int kSmemCap = 48 * 1024;  // would pass this (no opt-in needed)
constexpr int kStage = 4;       // slots a lane stages at once
// Levels whose loads a thread issues before it adds them (bf16; f32 rows
// take twice the registers, so half as many levels).
constexpr int kGroup = 2;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ld(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

__device__ __forceinline__ uint32_t ld_bits(const float* p) {
  return __float_as_uint(__ldg(p));
}

__device__ __forceinline__ uint32_t ld_bits(const uint16_t* p) {
  return __ldg(p);
}

// What a tile stages for one slot of an operand: the gathered row's index,
// or for kind 1 (ONE: known to be) the row's one value, in f32 bits.
template <typename T, bool ONE>
__device__ __forceinline__ uint32_t staged(const Operand& a, int32_t row) {
  if (!ONE && a.kind != 1) return static_cast<uint32_t>(row);
  return __float_as_uint(
      ld(static_cast<const T*>(a.ptr) + static_cast<int64_t>(row) * a.mod));
}

// One level's VEC values of an operand as loaded: bf16 two to a word (the
// even column in the low half), f32 one; kind 1 keeps the staged value.
template <typename T, int VEC>
struct Raw {
  uint32_t w[(VEC * static_cast<int>(sizeof(T)) + 3) / 4];
};

// KIND: the operand's kind where the kernel is instantiated for it, -1
// where it is read at run time (a.kind).
template <typename T, int VEC, int KIND>
__device__ __forceinline__ void load_raw(const Operand& a, uint32_t slot,
                                         int64_t c, Raw<T, VEC>& v) {
  const int kind = KIND >= 0 ? KIND : a.kind;
  if (kind == 1) {
    v.w[0] = slot;
    return;
  }
  const T* row = static_cast<const T*>(a.ptr) +
                 static_cast<int64_t>(static_cast<int32_t>(slot)) * a.mod;
  if (kind == 0) {
    const T* p = row + c;
    if constexpr (VEC == 8) {
      const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
      for (int h = 0; h < static_cast<int>(sizeof(T)) / 2; ++h) {
        const uint4 x = __ldg(q + h);
        v.w[4 * h] = x.x; v.w[4 * h + 1] = x.y;
        v.w[4 * h + 2] = x.z; v.w[4 * h + 3] = x.w;
      }
    } else {
      v.w[0] = ld_bits(p);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const uint32_t b = ld_bits(row + ((c + j) / a.div) % a.mod);
    if constexpr (sizeof(T) == 2 && VEC > 1) {
      v.w[j / 2] = (j & 1) ? (v.w[j / 2] | (b << 16)) : b;
    } else {
      v.w[j] = b;
    }
  }
}

template <typename T, int VEC, int KIND>
__device__ __forceinline__ float value(const Raw<T, VEC>& v, int a_kind,
                                       int j) {
  if ((KIND >= 0 ? KIND : a_kind) == 1) return __uint_as_float(v.w[0]);
  if constexpr (sizeof(T) == 2) {
    return (j & 1) ? bf16_hi(v.w[j / 2]) : bf16_lo(v.w[j / 2]);
  } else {
    return __uint_as_float(v.w[j]);
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

// The messages rounded to the tables' type, as op on T operands returns T:
// in bf16 two at a time (one packed conversion, each value rounded to
// nearest even as alone).
template <typename T, int VEC>
__device__ __forceinline__ void round_to(float (&m)[VEC]) {
  if constexpr (sizeof(T) == 2 && VEC % 2 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(m[j], m[j + 1]);
      m[j] = __bfloat162float(h.x);
      m[j + 1] = __bfloat162float(h.y);
    }
  } else if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      m[j] = __bfloat162float(__float2bfloat16_rn(m[j]));
    }
  }
}

// One warp owns a tile of rw consecutive rank rows, tpr threads a row
// (rw = 32 / tpr; blockIdx.y picks the row's columns when F / VEC > 32).
// Dynamic shared memory, a region a warp: the lhs slots and the rhs slots
// (those the op reads), [level][row] each for n_levels levels, then rw
// ranks. FAST: the lhs (where read) is whole rows (kind 0) and the rhs
// (where read) one value a row (kind 1, staged as a value): the kinds of
// the weighted GCN's u_mul_e, its backward and EdgeWeightNorm's copy_rhs,
// compiled in; otherwise they are read at run time.
template <typename T, int VEC, int OP, bool FAST>
__global__ void __launch_bounds__(kWarps * 32) shell_prefix_gspmm_kernel(
    Operand lhs, Operand rhs, const int32_t* __restrict__ nidx,
    const int32_t* __restrict__ eidx, const int64_t* __restrict__ level_off,
    const int64_t* __restrict__ level_real, int n_levels,
    const int32_t* __restrict__ rank, const float* __restrict__ base,
    float* __restrict__ out, int64_t n_out, int64_t feat, int tpr, int rw) {
  constexpr int U = sizeof(T) == 2 ? kGroup : (kGroup + 1) / 2;
  constexpr bool kLhs = OP != kCopyRhs;
  constexpr bool kRhs = OP != kCopyLhs;
  constexpr int LK = FAST ? 0 : -1;
  constexpr int RK = FAST ? 1 : -1;
  __shared__ int64_t s_off[kMaxLevels];
  __shared__ int64_t s_real[kMaxLevels];
  extern __shared__ uint32_t s_slot[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int span = n_levels * rw;
  uint32_t* s_lhs = s_slot + warp * ((int(kLhs) + int(kRhs)) * span + rw);
  uint32_t* s_rhs = s_lhs + (kLhs ? span : 0);
  int32_t* s_rank = reinterpret_cast<int32_t*>(s_rhs + (kRhs ? span : 0));

  for (int k = threadIdx.x; k < n_levels; k += blockDim.x) {
    s_off[k] = __ldg(level_off + k);
    s_real[k] = __ldg(level_real + k);
  }
  __syncthreads();  // the only block-wide barrier: warps go on alone

  const int64_t r0 =
      (static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp) * rw;
  if (r0 >= n_out) return;  // the whole warp
  const int rows = n_out - r0 < rw ? static_cast<int>(n_out - r0) : rw;
  // the tile's levels: those that reach its first row (a prefix)
  const bool reaches = lane < n_levels && r0 < s_real[lane];
  const int kt = __popc(__ballot_sync(0xffffffffu, reaches));
  const int n_slots = kt * rw;
  for (int s0 = lane; s0 < n_slots; s0 += 32 * kStage) {
    uint32_t a[kStage] = {}, b[kStage] = {};
    bool ok[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int s = s0 + 32 * u;
      const int k = s / rw;
      const int i = s - k * rw;
      ok[u] = s < n_slots && i < rows && r0 + i < s_real[k];
      if (ok[u]) {
        const int64_t p = s_off[k] + r0 + i;
        if constexpr (kLhs) a[u] = __ldg(nidx + p);
        if constexpr (kRhs) b[u] = __ldg(eidx + p);
      }
    }
    // the values first, then the stores: a store waits for its load, and
    // would hold back the next slot's load behind it
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      if (ok[u]) {
        if constexpr (kLhs) a[u] = staged<T, false>(lhs, a[u]);
        if constexpr (kRhs) b[u] = staged<T, RK == 1>(rhs, b[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      if (ok[u]) {
        const int s = s0 + 32 * u;
        if constexpr (kLhs) s_lhs[s] = a[u];
        if constexpr (kRhs) s_rhs[s] = b[u];
      }
    }
  }
  if (rank != nullptr && lane < rows) s_rank[lane] = __ldg(rank + r0 + lane);
  __syncwarp();

  const int i = lane / tpr;
  const int64_t c =
      (static_cast<int64_t>(blockIdx.y) * tpr + (lane - i * tpr)) * VEC;
  if (i >= rows || c >= feat) return;
  const int64_t r = r0 + i;
  int kr = kt;  // the row's levels: its tile's, or a few fewer
  while (kr > 0 && r >= s_real[kr - 1]) --kr;

  float acc[VEC];
  load_base<VEC>(base, r * feat + c, acc);
  for (int k0 = 0; k0 < kr; k0 += U) {
    Raw<T, VEC> a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u < kr) {
        const int s = (k0 + u) * rw + i;
        if constexpr (kLhs) load_raw<T, VEC, LK>(lhs, s_lhs[s], c, a[u]);
        if constexpr (kRhs && RK != 1) {
          load_raw<T, VEC, RK>(rhs, s_rhs[s], c, b[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u < kr) {
        const int s = (k0 + u) * rw + i;
        float m[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float x = kLhs ? value<T, VEC, LK>(a[u], lhs.kind, j) : 0.f;
          const float y = !kRhs ? 0.f
                          : RK == 1 ? __uint_as_float(s_rhs[s])
                                    : value<T, VEC, RK>(b[u], rhs.kind, j);
          m[j] = apply_op<OP>(x, y);
        }
        if constexpr (OP != kCopyLhs && OP != kCopyRhs) round_to<T, VEC>(m);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], m[j]);
      }
    }
  }
  const int64_t dst = rank != nullptr ? s_rank[i] : r;
  store_out<VEC>(out, dst * feat + c, acc);
}

using GspmmKernel = void (*)(Operand, Operand, const int32_t*,
                             const int32_t*, const int64_t*, const int64_t*,
                             int, const int32_t*, const float*, float*,
                             int64_t, int64_t, int, int);

template <typename T, int VEC, bool FAST>
GspmmKernel kernel_of(int op) {
  switch (op) {
    case kAdd: return shell_prefix_gspmm_kernel<T, VEC, kAdd, FAST>;
    case kSub: return shell_prefix_gspmm_kernel<T, VEC, kSub, FAST>;
    case kMul: return shell_prefix_gspmm_kernel<T, VEC, kMul, FAST>;
    case kDiv: return shell_prefix_gspmm_kernel<T, VEC, kDiv, FAST>;
    case kCopyLhs: return shell_prefix_gspmm_kernel<T, VEC, kCopyLhs, FAST>;
    case kCopyRhs: return shell_prefix_gspmm_kernel<T, VEC, kCopyRhs, FAST>;
    default: return nullptr;
  }
}

template <typename T, int VEC>
GspmmKernel kernel_of(int op, bool fast) {
  return fast ? kernel_of<T, VEC, true>(op) : kernel_of<T, VEC, false>(op);
}

// The operands have the kinds FAST compiles in.
bool fast_kinds(int op, int lhs_kind, int rhs_kind) {
  return (op == kCopyRhs || lhs_kind == 0) &&
         (op == kCopyLhs || rhs_kind == 1);
}

GspmmKernel gspmm_kernel(int op, int bf16, int vec, int lhs_kind,
                         int rhs_kind) {
  const bool fast = fast_kinds(op, lhs_kind, rhs_kind);
  if (vec != 8 && vec != 1) return nullptr;
  if (bf16) {
    return vec == 8 ? kernel_of<uint16_t, 8>(op, fast)
                    : kernel_of<uint16_t, 1>(op, fast);
  }
  return vec == 8 ? kernel_of<float, 8>(op, fast)
                  : kernel_of<float, 1>(op, fast);
}

// The launch shape of a call: tpr = min(F / vec, 32) threads a row, rw =
// 32 / tpr rows a warp, the row's columns over blockIdx.y, kWarps warps a
// block or as many as keep the shared memory under kSmemCap.
struct Tile {
  dim3 grid, block;
  size_t smem;
  int tpr, rw;
};

int tile_of(int op, int64_t n_out, int64_t feat, int vec, int n_levels,
            Tile* t) {
  const int64_t n_vec = feat / vec;
  t->tpr = static_cast<int>(n_vec < 32 ? n_vec : 32);
  t->rw = 32 / t->tpr;
  const int n_ops = op == kCopyLhs || op == kCopyRhs ? 1 : 2;
  const size_t per_warp = (n_ops * n_levels + 1) * t->rw * sizeof(uint32_t);
  const int warps = static_cast<int>(
      per_warp * kWarps > kSmemCap ? kSmemCap / per_warp : kWarps);
  const int64_t rows = static_cast<int64_t>(warps) * t->rw;
  const int64_t gx = (n_out + rows - 1) / rows;
  const int64_t gy = (n_vec + t->tpr - 1) / t->tpr;
  if (gx > 0x7fffffffLL || gy > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  t->grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  t->block = dim3(32 * warps);
  t->smem = per_warp * warps;
  return 0;
}

constexpr int kThreads = 256;

int grid_of(int64_t work, unsigned* blocks) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  if (b > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(b);
  return 0;
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
// div, mod (see Operand). level_real holds each level's real row count n_k
// (non-increasing), n_levels <= 32. rank: null (rows out in rank order) or
// an int32 permutation of n_out rows (row r out at rank[r]). vec must be 8
// (feat % 8 == 0 and the whole-row operands', the base's and the output's
// pointers 16-byte aligned, checked by the caller) or 1. Returns a
// cudaError_t as int.
extern "C" int dgl_shell_prefix_gspmm(
    int op, int bf16, const void* lhs, int lhs_kind, int64_t lhs_div,
    int64_t lhs_mod, const void* rhs, int rhs_kind, int64_t rhs_div,
    int64_t rhs_mod, const void* nidx, const void* eidx,
    const void* level_off, const void* level_real, int n_levels,
    const void* rank, const void* base, void* out, int64_t n_out,
    int64_t feat, int vec, void* stream) {
  const GspmmKernel kernel = gspmm_kernel(op, bf16, vec, lhs_kind, rhs_kind);
  if (kernel == nullptr || n_levels < 0 || n_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_out == 0 || feat / vec == 0) return 0;
  Tile t;
  if (int err = tile_of(op, n_out, feat, vec, n_levels, &t)) return err;
  kernel<<<t.grid, t.block, t.smem, static_cast<cudaStream_t>(stream)>>>(
      Operand{lhs, lhs_kind, lhs_div, lhs_mod},
      Operand{rhs, rhs_kind, rhs_div, rhs_mod},
      static_cast<const int32_t*>(nidx), static_cast<const int32_t*>(eidx),
      static_cast<const int64_t*>(level_off),
      static_cast<const int64_t*>(level_real), n_levels,
      static_cast<const int32_t*>(rank), static_cast<const float*>(base),
      static_cast<float*>(out), n_out, feat, t.tpr, t.rw);
  return static_cast<int>(cudaGetLastError());
}

// What the card runs a call of dgl_shell_prefix_gspmm with (the arguments
// as there): out[0] registers a thread, [1] static shared bytes, [2] local
// (stack and spill) bytes a thread, [3] threads a block, [4] dynamic
// shared bytes a block, [5] resident blocks an SM, [6] 1 if the
// instantiation is FAST.
extern "C" int dgl_shell_prefix_gspmm_occupancy(int op, int bf16, int vec,
                                                int lhs_kind, int rhs_kind,
                                                int64_t feat, int n_levels,
                                                int* out) {
  const GspmmKernel kernel = gspmm_kernel(op, bf16, vec, lhs_kind, rhs_kind);
  if (kernel == nullptr || n_levels < 0 || n_levels > kMaxLevels ||
      feat / vec == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tile t;
  if (int err = tile_of(op, 1, feat, vec, n_levels, &t)) return err;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, static_cast<int>(t.block.x), t.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = static_cast<int>(t.block.x);
  out[4] = static_cast<int>(t.smem);
  out[5] = blocks;
  out[6] = fast_kinds(op, lhs_kind, rhs_kind);
  return 0;
}
