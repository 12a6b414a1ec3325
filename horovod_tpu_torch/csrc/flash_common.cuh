// Tile helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): storage-dtype conversions, the mma.sync m16n8k16 product
// with its f32 FMA twin, and the zero-filling tile load.
//
// Layout convention: tiles live in shared memory row-major with PAD extra
// elements per row; a [rows, D] tile of a row-major global matrix is loaded
// 16 bytes per thread.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvd_flash {

constexpr int PAD = 8;        // elements of padding per shared-memory row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(const T* lo, const T* hi) {
  const uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

template <typename T>
__device__ __forceinline__ void mma_bf16_or_f16(float c[4], const uint32_t a[4],
                                                const uint32_t b[2]);

template <>
__device__ __forceinline__ void mma_bf16_or_f16<__nv_bfloat16>(
    float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
__device__ __forceinline__ void mma_bf16_or_f16<__half>(
    float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[16x8] += A[16x16] · B[16x8], all operands in shared memory.
// A is row-major with leading dimension lda.  B(k, n) is b[n*ldb + k] when
// B_KMAJOR is false (rows of the right operand are its columns, as K rows
// for Q·Kᵀ) and b[k*ldb + n] when it is true (V rows for P·V).  The
// accumulator uses the mma.sync C layout: lane (g = lane/4, t = lane%4)
// holds rows g and g+8, columns 2t and 2t+1.
template <typename T, bool B_KMAJOR>
__device__ __forceinline__ void mma_tile(float c[4], const T* a, int lda,
                                         const T* b, int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 2) {
    uint32_t af[4], bf[2];
    af[0] = *reinterpret_cast<const uint32_t*>(a + g * lda + 2 * t);
    af[1] = *reinterpret_cast<const uint32_t*>(a + (g + 8) * lda + 2 * t);
    af[2] = *reinterpret_cast<const uint32_t*>(a + g * lda + 2 * t + 8);
    af[3] = *reinterpret_cast<const uint32_t*>(a + (g + 8) * lda + 2 * t + 8);
    if constexpr (B_KMAJOR) {
      bf[0] = pack2(b + (2 * t) * ldb + g, b + (2 * t + 1) * ldb + g);
      bf[1] = pack2(b + (2 * t + 8) * ldb + g, b + (2 * t + 9) * ldb + g);
    } else {
      bf[0] = *reinterpret_cast<const uint32_t*>(b + g * ldb + 2 * t);
      bf[1] = *reinterpret_cast<const uint32_t*>(b + g * ldb + 2 * t + 8);
    }
    mma_bf16_or_f16<T>(c, af, bf);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = g + ((i & 2) ? 8 : 0);
      const int n = 2 * t + (i & 1);
      float s = c[i];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float bv = B_KMAJOR ? to_f(b[k * ldb + n]) : to_f(b[n * ldb + k]);
        s = fmaf(to_f(a[r * lda + k]), bv, s);
      }
      c[i] = s;
    }
  }
}

// Copy rows [row0, row0 + ROWS) of a row-major [L, D] matrix into shared
// memory (leading dimension D + PAD), zero-filling rows >= L.
template <typename T, int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int L,
                                          int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = tid; i < ROWS * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < L)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + PAD) + c) = val;
  }
}

// One launch with `smem` bytes of dynamic shared memory; returns the
// cudaError_t of the attribute call or of the launch itself.
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem,
                  cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace hvd_flash
