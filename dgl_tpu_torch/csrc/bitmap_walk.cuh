// One warp walks the set bits of one row of a plane-packed adjacency bitmap
// (dgl_tpu_torch/ops/bitmap_spmm.py): the front end of the one kernel that
// reads the bitmap, the SpMM B2 (bitmap_spmm.cu). The GAT kernels B3, B4
// and B5 walk the relation's CSC or CSR instead (edge_ring.cuh).
//
// Layout: a row holds n_blocks blocks of 512 bytes (4096 sources each);
// within a block, byte b carries bit j for source block*4096 + j*512 + b.
//
// At Reddit density a 4096-source block of a row holds about 8 set bits, so
// a lane that visited the bits of the 16 bytes it decodes would find one
// now and then while the other 31 lanes wait: the visits would run one lane
// at a time. Instead the lanes queue their sources in shared memory (a warp
// prefix sum of their bit counts gives each lane its slots; a block with
// more bits than the queue has room for goes in rounds) and the warp drains
// the queue with G lanes per source, 32 / G sources at a time. The G lanes
// of a source each handle 16 bytes of its feature row, so the row's gather
// is one coalesced load.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bitmap_walk {

constexpr int kBlockBytes = 512;   // bytes per 4096-source block (S / 8)
constexpr int kPlaneStride = 512;  // source distance between bit planes
constexpr int kQueue = 256;        // queued sources per warp

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Calls visit(s) for every set bit (d, s) of the row with s < n_src, once
// on each of the G lanes lane / G * G .. lane / G * G + G - 1 (lane % G
// tells them apart). brow: the row's first byte. queue: kQueue ints of
// shared memory owned by this warp. The whole warp must call it (it
// shuffles and syncs); U blocks' loads are in flight at a time.
template <int G, int U, typename Visit>
__device__ __forceinline__ void walk_row(const uint8_t* __restrict__ brow,
                                         int64_t n_blocks, int64_t n_src,
                                         int* queue, Visit&& visit) {
  static_assert(G == 1 || G == 2 || G == 4 || G == 8, "G divides 32");
  const int lane = threadIdx.x & 31;
  const uint8_t* mine = brow + lane * 16;
  int fill = 0;  // queued sources, the same on every lane
  auto drain = [&]() {
    __syncwarp();
    for (int i = lane / G; i < fill; i += 32 / G) {
      const int s = queue[i];
      if (s < n_src) visit(s);
    }
    fill = 0;
    __syncwarp();
  };
  for (int64_t b0 = 0; b0 < n_blocks; b0 += U) {
    uint4 w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      w[u] = b0 + u < n_blocks
                 ? __ldcs(reinterpret_cast<const uint4*>(
                       mine + (b0 + u) * kBlockBytes))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      uint32_t words[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
      int count = __popc(words[0]) + __popc(words[1]) + __popc(words[2]) +
                  __popc(words[3]);
      int incl = warp_inclusive_sum(count, lane);
      int total = __shfl_sync(0xffffffffu, incl, 31);
      // source of byte k of word q at plane 0: base + 4 q + k
      const int64_t base = (b0 + u) * (8 * kBlockBytes) + lane * 16;
      while (total > 0) {  // the same on every lane
        if (fill == kQueue) drain();
        const int room = kQueue - fill;
        const int excl = incl - count;
        int take = min(count, max(room - excl, 0));
        int pos = fill + excl;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          while (take > 0 && words[q] != 0u) {
            const int b = __ffs(words[q]) - 1;  // byte b >> 3, plane b & 7
            words[q] &= words[q] - 1u;
            queue[pos++] = static_cast<int>(base + 4 * q + (b >> 3) +
                                            (b & 7) * kPlaneStride);
            --take;
          }
        }
        const int put = min(total, room);
        fill += put;
        total -= put;
        if (total > 0) {  // the queue is full: recount what is left
          count = __popc(words[0]) + __popc(words[1]) + __popc(words[2]) +
                  __popc(words[3]);
          incl = warp_inclusive_sum(count, lane);
        }
      }
    }
  }
  drain();
}

}  // namespace bitmap_walk
