// Tile helpers of the head-dim-64 Hopper kernels (flash_fwd_d64.cu,
// flash_bwd_d64.cu): one warpgroup per 64-row tile, every tile a [64, 64]
// block of a 16-bit dtype, 128-byte swizzled by TMA (a row of 64 values is
// one 128-byte line of the swizzled panel) and read by wgmma m64n64k16.

#pragma once

#include "flash_common.cuh"

namespace hvd_flash::d64 {

constexpr int TB = 64;                        // rows of a tile: queries or keys
constexpr int HD = 64;                        // head width
constexpr uint32_t TILE = TB * HD * 2;        // a [64, 64] 16-bit tile: 8 KB
constexpr float LOG2E = 1.4426950408889634f;

// KV row of q row bh under GQA: (bh / H)·KVH + (bh % H) / (H / KVH).
__device__ __forceinline__ int kv_row(int bh, int H, int KVH) {
  return (bh / H) * KVH + (bh % H) / (H / KVH);
}

inline bool bad_shape(int B, int H, int KVH, int L) {
  return B < 1 || L < 1 || KVH < 1 || H % KVH != 0;
}

// K-major descriptor of step kk (16 of the 64 columns) over a tile.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return gmma_desc(tile + kk * 32, 16, 1024);
}

// MN-major descriptor of step kk (16 rows) over a tile: the B operand
// [rows][64] of a product that sums over the tile's rows.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return gmma_desc(tile + kk * 16 * 128, TILE, 1024);
}

// A [64, 64] f32 accumulator rounded to T into a tile, swizzled as TMA
// reads it: warp w's lane holds rows 16w + g and 16w + g + 8, columns
// 8j + 2t + {0, 1}.
template <typename T>
__device__ __forceinline__ void stage_acc(unsigned char* tile,
                                          const float (&acc)[32], int w,
                                          int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * w + g + 8 * r;
      const uint32_t off = row * 128 + ((j ^ (row & 7)) * 16) + t * 4;
      *reinterpret_cast<uint32_t*>(tile + off) =
          pack_f2<T>(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// The A fragment of step kk (16 columns of the accumulator it was packed
// from): pf[m] holds columns 2m, 2m+1.
template <int N>
__device__ __forceinline__ void frag(uint32_t (&a)[4], const uint32_t (&pf)[N],
                                     int kk) {
  a[0] = pf[4 * kk];
  a[1] = pf[4 * kk + 1];
  a[2] = pf[4 * kk + 2];
  a[3] = pf[4 * kk + 3];
}

// Asks for the largest shared-memory carveout once per kernel, so several
// blocks fit one SM together.
template <auto kernel>
int prefer_max_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  return (int)err;
}

}  // namespace hvd_flash::d64
