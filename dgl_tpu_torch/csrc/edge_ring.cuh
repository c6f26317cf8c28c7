// One warp walks one row of a relation's index (its CSC or its CSR): the
// shared front end of the kernels of a bitmap plan's relation, B2
// (bitmap_spmm.cu: in-edges from the CSC forward, out-edges from the CSR
// backward), B3 (bitmap_gat_fwd.cu, in-edges from the CSC), B4
// (bitmap_gat_bwd_dst.cu, the same) and B5 (bitmap_gat_bwd_src.cu, out-edges
// from the CSR). None of them reads the plan's bitmap.
//
// The row's ids indices[beg .. end) go in chunks of C, and with each chunk
// (walk; walk_ids brings the ids alone, for B2) the E floats of a per-node
// table row that each id names (el, or the destinations' (er, lse, c)). Both
// arrive by cp.async through a ring in the warp's shared memory, without
// passing through registers: the ids two chunks ahead, read once and so
// marked evict-first in L2 (the id stream, 0.447 GB at Reddit scale, must
// not push the gathered tables out), the table rows one chunk ahead (their
// ids are in the ring by then). Prefetched into registers instead, they
// would be copied from buffer to buffer at the end of every chunk, and the
// copy waits for the load: a round trip to device memory a chunk.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace edge_ring {

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
                                              uint64_t policy) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2, %3;\n"
      ::"r"(d), "l"(src), "r"(4), "l"(policy)
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

// indices[c0 .. c0 + C) into ids, -1 past end; lane takes k * 32 + lane
template <int C>
__device__ __forceinline__ void fetch_ids(int* ids, const int* indices,
                                          int c0, int end, int lane,
                                          uint64_t once) {
#pragma unroll
  for (int k = 0; k < C / 32; ++k) {
    const int i = c0 + k * 32 + lane;
    if (i < end)
      cp_async_once(&ids[k * 32 + lane], indices + i, once);
    else
      ids[k * 32 + lane] = -1;
  }
  cp_commit();
}

// For each id j of the chunk, table[ids[j] * stride + col0 ..][0 .. E)
// into rows[j * E ..], zeros for an id outside [0, n). E is 1, 2 or a
// multiple of 4 (then 16 bytes a copy, consecutive lanes on consecutive
// pieces); table rows and col0 keep the copies aligned.
template <int C, int E>
__device__ __forceinline__ void fetch_rows(float* rows, const int* ids,
                                           const float* table,
                                           int64_t stride, int col0, int n,
                                           int lane) {
  static_assert(E == 1 || E == 2 || E % 4 == 0,
                "E is 1, 2 or a multiple of 4");
  constexpr int Q = E >= 4 ? E / 4 : 1;  // copies a row
  constexpr int B = E >= 4 ? 16 : 4 * E;  // bytes a copy
#pragma unroll
  for (int i = 0; i < C * Q / 32; ++i) {
    const int r = i * 32 + lane;
    const int j = r / Q, q = r % Q;
    const int s = ids[j];
    const bool ok = static_cast<unsigned>(s) < static_cast<unsigned>(n);
    const float* src = table + static_cast<int64_t>(ok ? s : 0) * stride +
                       col0 + q * 4;
    cp_async<B>(rows + j * E + q * 4, src, ok);
  }
  cp_commit();
}

// Calls chunk(c0, ids, rows) for the chunks c0 = beg, beg + C, ... < end of
// one row, ids[0 .. C) holding the chunk's ids (-1 past end) and rows[0 ..
// C * E) their table rows (see fetch_rows). id_ring and row_ring: the
// warp's ring, 3 chunks of ids and 2 of rows. The whole warp calls it with
// the same beg < end; chunk must leave with the warp converged.
template <int C, int E, typename Chunk>
__device__ __forceinline__ void walk(int (&id_ring)[3][C],
                                     float (&row_ring)[2][C * E],
                                     const int* __restrict__ indices,
                                     int beg, int end,
                                     const float* __restrict__ table,
                                     int64_t stride, int col0, int n,
                                     int lane, Chunk&& chunk) {
  uint64_t once;  // the id stream must not push the tables out of L2
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(once));
  fetch_ids<C>(id_ring[0], indices, beg, end, lane, once);
  fetch_ids<C>(id_ring[1], indices, beg + C, end, lane, once);
  cp_wait<1>();
  __syncwarp();
  fetch_rows<C, E>(row_ring[0], id_ring[0], table, stride, col0, n, lane);
  int it = 0;
  for (int c0 = beg; c0 < end; c0 += C, ++it) {
    fetch_ids<C>(id_ring[(it + 2) % 3], indices, c0 + 2 * C, end, lane,
                 once);
    cp_wait<1>();  // this chunk's rows and the next chunk's ids are here
    __syncwarp();
    fetch_rows<C, E>(row_ring[(it + 1) & 1], id_ring[(it + 1) % 3], table,
                     stride, col0, n, lane);
    chunk(c0, static_cast<const int*>(id_ring[it % 3]), row_ring[it & 1]);
    __syncwarp();  // the ring's slots are written again
  }
  cp_wait<0>();  // no copy may land after the warp has left
}

// Calls chunk(c0, ids) for the chunks c0 = beg, beg + C, ... < end of one
// row, ids[0 .. C) holding the chunk's ids (-1 past end): walk without the
// table rows. id_ring: the warp's ring of 3 chunks, fetched two ahead. The
// whole warp calls it with the same beg < end; chunk must leave with the
// warp converged.
template <int C, typename Chunk>
__device__ __forceinline__ void walk_ids(int (&id_ring)[3][C],
                                         const int* __restrict__ indices,
                                         int beg, int end, int lane,
                                         Chunk&& chunk) {
  uint64_t once;  // the id stream must not push the gathered rows out of L2
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(once));
  fetch_ids<C>(id_ring[0], indices, beg, end, lane, once);
  fetch_ids<C>(id_ring[1], indices, beg + C, end, lane, once);
  int it = 0;
  for (int c0 = beg; c0 < end; c0 += C, ++it) {
    fetch_ids<C>(id_ring[(it + 2) % 3], indices, c0 + 2 * C, end, lane,
                 once);
    cp_wait<2>();  // this chunk's ids are here
    __syncwarp();
    chunk(c0, static_cast<const int*>(id_ring[it % 3]));
    __syncwarp();  // the ring's slots are written again
  }
  cp_wait<0>();  // no copy may land after the warp has left
}

// Registers, static shared bytes and local (stack and spill) bytes per
// thread of a kernel launched with `threads` threads a block, its resident
// blocks per SM, and the gather bytes an SM has in flight while all those
// warps gather (`steps` 16-byte loads a lane), into out[0..4].
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, int steps, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    0);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = blocks;
  out[4] = blocks * threads * steps * 16;
  return cudaSuccess;
}

}  // namespace edge_ring
