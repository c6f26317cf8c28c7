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
//    with the index n_table. The table is bf16 (cold="shell") or f32
//    (cold="shell-f32", the exact mode): the Pallas kernel casts each
//    piece block to f32, so it takes either.
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
// A row's levels are a chain of dependent loads: the level's count, the
// slot's index, then the gathered row (and the edge value). Walked one
// level after the other, that latency binds, not the bytes: a row that
// reaches all 32 levels (SHELL_CAP) waits some 64 round trips to the
// memory in a row. Both kernels were first written so, one thread a
// chunk of VEC columns of one row; the weighted one was redesigned first
// (7.9 levels a row in the weighted arxiv forward), the hub caller after
// it, when its 32-level rows (the reverse shells of the arxiv backward,
// and ogbn-mag's affiliated_with, whose 8,740 rows all have 32 levels)
// ran at twice their stream time while its 13-level forwards ran at it
// (PERF.md, section 6). Both now take the same shape:
//
// - A warp owns a tile of rw consecutive rank rows, tpr = min(F / VEC, 32)
//   threads a row (rw = 32 / tpr: several rows share a warp at small F; a
//   wider row is split over blockIdx.y). It takes its tile's level count
//   by one ballot over its first row (rows are rank-ordered and the
//   levels nested prefixes, so the first row has the most) and stages
//   every slot of the tile's levels into its own part of shared memory
//   (stage_tile): the runs idx[off_k + r0 .. off_k + min(r0 + rw, m_k)),
//   several slots a lane at a time, so the tile's index loads are in
//   flight together and each (row, level) index is read once, not once a
//   lane. A round runs only the slots the tile has, and steps a slot's
//   (level, row) by adds, not by a division a slot. The warps of a block
//   do not wait for each other's slots: staging by the whole block held
//   every warp to the slowest one's loads and measured slower.
// - Each thread then walks its row's levels (its tile's count, or a few
//   fewer) in groups: it issues the group's row loads first, then adds
//   them in level order with explicitly rounded adds, so the result stays
//   exact. Levels past the row's count issue no load and add nothing. No
//   row's levels are split over threads: that would change the order of
//   the sum.
//
// dgl_shell_prefix_sum: most of its rows are short (2.4 levels a row in
// the arxiv forward), so besides the chain, what a warp does around its
// loads and the registers that set how many warps an SM holds decide its
// time. Each warp copies the level table for itself (no block-wide
// barrier), a group runs only the levels its tile has (the same in every
// lane), rows and columns are ints, and kSumGroup = 4 levels in flight
// (bf16; 2 f32 rows) with kSumStage = 4 slots a lane staged at once hold
// it to 37 registers, 6 blocks an SM. Its first version of this shape (8
// and 8, a division a slot, a block barrier: 62 registers, 4 blocks) ran
// the 32-level rows at their stream time but the 13-level forwards 40 %
// slower than the simple walk; capping the registers at 32 spills
// (b1_variants.py times these choices; PERF.md, section 6). A slot
// outside [0, n_table) loads a zero row, which is what the plain version
// adds there. The base is loaded first, so its latency passes while the
// level table and the slots arrive. The f32 output is written once and
// not read again: it is stored with the streaming hint (st.global.cs), so
// it passes through the L2 without pushing out the table rows that later
// levels gather again; an evict-last policy on the table's rows measured
// slower. Bytes bind it once the chain is cut: each distinct table row
// read, each slot's index, the base and the output.
//
// dgl_shell_prefix_gspmm's rows have more levels (7.9 a row in the
// weighted arxiv forward, 22 levels). Once the chain is cut, the
// instructions a level costs and the registers that set how many warps
// hide the rest bind it: on the H100 the kernel is barely faster when
// every slot gathers one row, which takes the rows' memory traffic away
// (chip_smoke.py's ms_every_slot_row_0; PERF.md, section 6). So:
//
// - Its block copies the level table into shared memory at entry, the
//   one block-wide barrier. It stages both index streams of a slot; an
//   operand of one value a row (kind 1: the edge weight of u_mul_e and of
//   EdgeWeightNorm's copy_rhs) is gathered once a slot while staging, in
//   place of its index, not once a lane.
// - It walks kGroup levels at a time (one in f32) and builds the messages
//   between the loads and the adds. Two levels in flight keep the kernel
//   at 40 registers; four or eight hold more rows in registers, fewer
//   warps fit on an SM, and it measured slower.
// - The kinds of the main path (whole lhs rows, one rhs value a row) are
//   compiled in (FAST): no kind test in the walk, and the rhs value comes
//   from shared memory. bf16 messages are rounded two at a time by one
//   packed conversion, each as alone.
// - The row is stored at rank[r]: the caller needs no unrank gather, one
//   more pass over the f32 output. rank is a permutation, so no two
//   threads store one element. base stays in rank order.
//
// No tensor cores: the work has no reuse inside a block. Offsets into
// the tables, the indices and the output are computed in int64.
//
// Plain C interface, bound from Python with ctypes
// (dgl_tpu_torch/_kernels.py); each launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;  // SHELL_CAP; the wrappers raise above it
constexpr int kWarps = 8;       // warps a block, fewer where shared memory
constexpr int kSmemCap = 48 * 1024;  // would pass this (no opt-in needed)
// dgl_shell_prefix_sum: levels whose row loads a thread issues before it
// adds them (bf16 rows; f32 rows take twice the registers, so half as
// many levels), and index slots a lane stages at once (see above)
constexpr int kSumGroup = 4;
constexpr int kSumStage = 4;
// dgl_shell_prefix_gspmm: slots a lane stages at once (two indices each),
// and levels in flight (bf16; f32 half as many)
constexpr int kStage = 4;
constexpr int kGroup = 2;

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
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

// One level's VEC values of a table row as loaded: bf16 two to a word (the
// even column in the low half), f32 one; the weighted caller's kind 1
// keeps its staged value in w[0].
template <typename T, int VEC>
struct Raw {
  uint32_t w[(VEC * static_cast<int>(sizeof(T)) + 3) / 4];
};

// Column j of a loaded row; KIND as for the weighted caller's operands
// (-1: read at run time as a_kind; 1: the staged value).
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

// n / d for 0 <= n < 1,056 and 1 <= d <= 32, with inv = reciprocal(d):
// a multiply and a shift in place of a division.
__host__ __device__ __forceinline__ int reciprocal(int d) {
  return (65536 + d - 1) / d;
}

__device__ __forceinline__ int div_by(int n, int inv) {
  return (n * inv) >> 16;
}

// Stages one warp's tile: for each of its kt levels k, the slots of the
// rows r0 + i (i < rows) that the level reaches (r0 + i < cnt[k]), NS
// index streams of them (src[0..NS)), into slot k * rw + i of dst[j]
// (rw_inv = reciprocal(rw)). Each lane loads up to STAGE slots (lane,
// lane + 32, ...) before it stores any, so the tile's index loads are in
// flight together; a round runs only as many of them as the tile has
// slots. fix(j, v) turns stream j's index v into what is staged. The
// caller syncs the warp after it.
template <int NS, int STAGE, typename R, typename Fix>
__device__ __forceinline__ void stage_tile(
    const int32_t* const* src, uint32_t* const* dst,
    const int64_t* s_off, const R* s_cnt, R r0, int rows, int rw,
    int rw_inv, int kt, int lane, Fix fix) {
  const int n_slots = kt * rw;
  const int dk = div_by(32, rw_inv);  // 32 slots on: dk levels, di rows
  const int di = 32 - dk * rw;
  int k = div_by(lane, rw_inv);  // the lane's slot: level k, row i
  int i = lane - k * rw;
  for (int s0 = 0; s0 < n_slots; s0 += 32 * STAGE) {
    const int n_u = (n_slots - s0 + 31) / 32;  // the same in every lane
    uint32_t v[NS][STAGE] = {};
    bool ok[STAGE];
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      ok[u] = false;
      if (u < n_u) {
        ok[u] = s0 + lane + 32 * u < n_slots && i < rows && r0 + i < s_cnt[k];
        if (ok[u]) {
          const int64_t p = s_off[k] + r0 + i;
#pragma unroll
          for (int j = 0; j < NS; ++j) v[j][u] = __ldg(src[j] + p);
        }
        k += dk;
        i += di;
        if (i >= rw) {
          i -= rw;
          ++k;
        }
      }
    }
    // the values first, then the stores: a store waits for its load, and
    // would hold back the next slot's load behind it
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      if (u < n_u && ok[u]) {
#pragma unroll
        for (int j = 0; j < NS; ++j) v[j][u] = fix(j, v[j][u]);
      }
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      if (u < n_u && ok[u]) {
#pragma unroll
        for (int j = 0; j < NS; ++j) dst[j][s0 + lane + 32 * u] = v[j][u];
      }
    }
  }
}


// ---- the hub caller --------------------------------------------------------

// VEC consecutive values of a table row.
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ row,
                                         Raw<T, VEC>& v) {
  if constexpr (VEC == 8) {
    const uint4* q = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int h = 0; h < static_cast<int>(sizeof(T)) / 2; ++h) {
      const uint4 x = __ldg(q + h);
      v.w[4 * h] = x.x; v.w[4 * h + 1] = x.y;
      v.w[4 * h + 2] = x.z; v.w[4 * h + 3] = x.w;
    }
  } else {
    v.w[0] = ld_bits(row);
  }
}

// The output row, stored with the streaming hint: written once, read by
// no later load of this kernel.
template <int VEC>
__device__ __forceinline__ void store_streaming(float* __restrict__ out,
                                                int64_t o,
                                                const float (&acc)[VEC]) {
  if constexpr (VEC == 8) {
    __stcs(reinterpret_cast<float4*>(out + o),
           make_float4(acc[0], acc[1], acc[2], acc[3]));
    __stcs(reinterpret_cast<float4*>(out + o + 4),
           make_float4(acc[4], acc[5], acc[6], acc[7]));
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) __stcs(out + o + j, acc[j]);
  }
}

// T: uint16_t (bf16 rows) or float. One warp a tile of rw rank rows, tpr
// threads a row (tpr_inv, rw_inv: their reciprocals). Shared memory, a
// region a warp: the level table (static), then n_levels * rw index
// slots, [level][row] (dynamic). A slot below n_valid = min(n_table,
// 2^31), as unsigned, reads a row; rows, columns and counts fit an int
// (the launch checks it).
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32) shell_prefix_sum_kernel(
    const T* __restrict__ table, uint32_t n_valid, int feat,
    const int32_t* __restrict__ idx, const int64_t* __restrict__ level_off,
    const int64_t* __restrict__ level_rows, int n_levels,
    const float* __restrict__ base, float* __restrict__ out, int n_out,
    int tpr, int rw, int tpr_inv, int rw_inv) {
  constexpr int U = sizeof(T) == 2 ? kSumGroup : kSumGroup / 2;
  __shared__ int64_t s_off[kWarps][kMaxLevels];
  __shared__ int s_rows[kWarps][kMaxLevels];
  extern __shared__ uint32_t s_slot[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * (blockDim.x >> 5) + warp) * rw;
  if (r0 >= n_out) return;  // the whole warp
  const int i = div_by(lane, tpr_inv);
  const int c = (blockIdx.y * tpr + lane - i * tpr) * VEC;
  const int r = r0 + i;
  const bool mine = i < rw && r < n_out && c < feat;
  const int64_t o = static_cast<int64_t>(r) * feat + c;

  // the base first: its load is in flight while the levels arrive
  float acc[VEC];
  if (mine) load_base<VEC>(base, o, acc);
  // each warp its own copy of the level table, lane k level k (counts
  // past an int clamped: no row reaches them), so no warp waits for
  // another
  int64_t* w_off = s_off[warp];
  int* w_rows = s_rows[warp];
  int m = 0;
  if (lane < n_levels) {
    w_off[lane] = __ldg(level_off + lane);
    const int64_t mk = __ldg(level_rows + lane);
    m = mk < 0x7fffffff ? static_cast<int>(mk) : 0x7fffffff;
    w_rows[lane] = m;
  }
  // the tile's levels: those that reach its first row (a prefix)
  const int kt = __popc(__ballot_sync(0xffffffffu, r0 < m));
  const int rows = n_out - r0 < rw ? n_out - r0 : rw;
  uint32_t* s_idx = s_slot + warp * n_levels * rw;
  const int32_t* const src[1] = {idx};
  uint32_t* const dst[1] = {s_idx};
  __syncwarp();
  stage_tile<1, kSumStage>(src, dst, w_off, w_rows, r0, rows, rw, rw_inv,
                           kt, lane, [](int, uint32_t v) { return v; });
  __syncwarp();
  if (!mine) return;
  int kr = kt;  // the row's levels: its tile's, or a few fewer
  while (kr > 0 && r >= w_rows[kr - 1]) --kr;

  const uint32_t* my_idx = s_idx + i;
  const T* tab = table + c;
  // groups over the tile's levels, the same in every lane, so a group
  // runs only the levels the tile has; each row loads and adds its own
  for (int k0 = 0; k0 < kt; k0 += U) {
    const int n_u = kt - k0;
    Raw<T, VEC> v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n_u && k0 + u < kr) {
        const uint32_t s = my_idx[(k0 + u) * rw];
        if (s < n_valid) {
          load_row<T, VEC>(tab + static_cast<int64_t>(s) * feat, v[u]);
        } else {
#pragma unroll
          for (int w = 0; w < static_cast<int>(sizeof(v[u].w) / 4); ++w) {
            v[u].w[w] = 0u;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n_u && k0 + u < kr) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          acc[j] = __fadd_rn(acc[j], value<T, VEC, 0>(v[u], 0, j));
        }
      }
    }
  }
  store_streaming<VEC>(out, o, acc);
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

// What a tile stages for one slot of an operand: the gathered row's index,
// or for kind 1 (ONE: known to be) the row's one value, in f32 bits.
template <typename T, bool ONE>
__device__ __forceinline__ uint32_t staged(const Operand& a, int32_t row) {
  if (!ONE && a.kind != 1) return static_cast<uint32_t>(row);
  return __float_as_uint(
      ld(static_cast<const T*>(a.ptr) + static_cast<int64_t>(row) * a.mod));
}

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
  // the streams the op reads: nidx for the lhs, eidx for the rhs
  const int32_t* const src[2] = {kLhs ? nidx : eidx, eidx};
  uint32_t* const dst[2] = {kLhs ? s_lhs : s_rhs, s_rhs};
  stage_tile<int(kLhs) + int(kRhs), kStage>(
      src, dst, s_off, s_real, r0, rows, rw, reciprocal(rw), kt, lane,
      [&](int j, uint32_t v) {
        return kLhs && j == 0 ? staged<T, false>(lhs, v)
                              : staged<T, RK == 1>(rhs, v);
      });
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
  const int64_t dst_row = rank != nullptr ? s_rank[i] : r;
  store_out<VEC>(out, dst_row * feat + c, acc);
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

// The words a weighted call stages for each row of a tile: an index (or
// value) a level for each operand the op reads, and the row's rank.
int gspmm_words(int op, int n_levels) {
  const int n_ops = op == kCopyLhs || op == kCopyRhs ? 1 : 2;
  return n_ops * n_levels + 1;
}

// The launch shape of a call: tpr = min(F / vec, 32) threads a row, rw =
// 32 / tpr rows a warp, the row's columns over blockIdx.y, kWarps warps a
// block or as many as keep the shared memory (words 32-bit words for each
// row of a tile) under kSmemCap.
struct Tile {
  dim3 grid, block;
  size_t smem;
  int tpr, rw;
};

int tile_of(int words, int64_t n_out, int64_t feat, int vec, Tile* t) {
  const int64_t n_vec = feat / vec;
  t->tpr = static_cast<int>(n_vec < 32 ? n_vec : 32);
  t->rw = 32 / t->tpr;
  const size_t per_warp = static_cast<size_t>(words) * t->rw *
                          sizeof(uint32_t);
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

template <typename T>
void launch_sum(const void* table, int64_t n_table, int64_t feat,
                const int32_t* i, const int64_t* lo, const int64_t* lr,
                int n_levels, const float* b, float* o, int64_t n_out,
                int vec, const Tile& t, cudaStream_t s) {
  const auto* tab = static_cast<const T*>(table);
  const auto n_valid = static_cast<uint32_t>(
      n_table < (int64_t{1} << 31) ? n_table : int64_t{1} << 31);
  const int f = static_cast<int>(feat), n = static_cast<int>(n_out);
  const int ti = reciprocal(t.tpr), ri = reciprocal(t.rw);
  if (vec == 8) {
    shell_prefix_sum_kernel<T, 8><<<t.grid, t.block, t.smem, s>>>(
        tab, n_valid, f, i, lo, lr, n_levels, b, o, n, t.tpr, t.rw, ti, ri);
  } else {
    shell_prefix_sum_kernel<T, 1><<<t.grid, t.block, t.smem, s>>>(
        tab, n_valid, f, i, lo, lr, n_levels, b, o, n, t.tpr, t.rw, ti, ri);
  }
}

}  // namespace

// bf16: the table's type (1 bf16, 0 f32). level_rows holds each level's
// row count m_k (non-increasing), n_levels <= 32. vec must be 8 (feat % 8
// == 0 and every pointer 16-byte aligned, checked by the caller) or 1.
// Returns a cudaError_t as int; 0 means launched.
extern "C" int dgl_shell_prefix_sum(
    const void* table, int bf16, int64_t n_table, int64_t feat,
    const void* idx, const void* level_off, const void* level_rows,
    int n_levels, const void* base, void* out, int64_t n_out, int vec,
    void* stream) {
  // rows, columns and a grid's rows fit an int in the kernel
  if ((vec != 8 && vec != 1) || n_levels < 0 || n_levels > kMaxLevels ||
      n_out > 0x7fffffffLL - 32 * kWarps || feat > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_out == 0 || feat / vec == 0) return 0;
  Tile t;
  if (int err = tile_of(n_levels, n_out, feat, vec, &t)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* lo = static_cast<const int64_t*>(level_off);
  const auto* lr = static_cast<const int64_t*>(level_rows);
  const auto* b = static_cast<const float*>(base);
  auto* o = static_cast<float*>(out);
  if (bf16) {
    launch_sum<uint16_t>(table, n_table, feat, i, lo, lr, n_levels, b, o,
                         n_out, vec, t, s);
  } else {
    launch_sum<float>(table, n_table, feat, i, lo, lr, n_levels, b, o, n_out,
                      vec, t, s);
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
  if (int err = tile_of(gspmm_words(op, n_levels), n_out, feat, vec, &t)) {
    return err;
  }
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
  if (int err = tile_of(gspmm_words(op, n_levels), 1, feat, vec, &t)) {
    return err;
  }
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
