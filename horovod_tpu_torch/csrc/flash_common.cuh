// Tile helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu, and through flash_d64.cuh flash_fwd_d64.cu and
// flash_bwd_d64.cu).
//
// Ampere-style building blocks: storage-dtype conversions, the mma.sync
// m16n8k16 product with its f32 FMA twin, and the zero-filling tile load.
// Tiles live in shared memory row-major with PAD extra elements per row; a
// [rows, D] tile of a row-major global matrix is loaded 16 bytes per thread.
//
// Hopper building blocks (sm_90a): 3-D TMA tensor maps over [rows, L, D]
// with 128-byte swizzle, encoded on the host through the driver entry point
// (no -lcuda); TMA loads and stores; mbarrier init / expect-tx / arrive /
// wait; the wgmma matrix descriptor; wgmma.mma_async m64n128k16 and
// m64n64k16 with A from shared memory or from registers, and m64n32k16 and
// m64n16k16 from shared memory; setmaxnreg.  A 128-byte-swizzled tile is
// stored as panels of 64 columns (128 bytes of a 16-bit dtype), each
// [rows][128 B], 1024-byte aligned, as TMA writes it and wgmma reads it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

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

// One launch of `kernel` with SMEM bytes of dynamic shared memory; returns
// the cudaError_t of the attribute call or of the launch itself.  The
// attribute is set once per kernel instantiation (a function-local static),
// not on every launch.
template <auto kernel, size_t SMEM, typename... Args>
int launch_kernel(dim3 grid, int threads, cudaStream_t stream, Args... args) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<grid, threads, SMEM, stream>>>(args...);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Hopper: shared-memory addresses, mbarriers, TMA.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Waits until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0, so waiting on parity 1 passes at once (the "empty" side
// of a ring starts free).  A wait of more than ~2^34 cycles (seconds; a
// real wait takes microseconds) traps, so a broken pipeline ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

// Box (c0 = column, c1 = row, c2 = outer index) of a 3-D tensor map into
// shared memory; completion is counted on `bar` in bytes.  Rows past the
// map's extent are zero-filled, so a tail tile never reads the next head.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// Box of shared memory out to a 3-D tensor map; rows past the map's extent
// are clipped, so a tail tile never writes the next head.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
}

// Commits the issued TMA stores and waits until their shared-memory source
// has been read (the block may then exit or reuse it).
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Generic-proxy shared-memory writes made visible to the async proxy (a TMA
// store that reads them).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

// ---------------------------------------------------------------------------
// Hopper: wgmma.

// Shared-memory matrix descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (all >> 4), swizzle mode 1.
//   K-major (Q, K: rows of 128 B along the reduction):  LBO unused (16),
//     SBO = 1024 (8 rows × 128 B).  A step of 16 elements along the
//     reduction adds 32 B inside a panel; the next panel is one panel away.
//   MN-major (V for P·V, transposed): LBO = the panel stride (the next 64
//     output columns), SBO = 1024 (the next 8 keys).  A step of 16 keys adds
//     16 × 128 B.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins accumulator registers at this point of the program, so the compiler
// moves no read or write of them across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define HVD_ACC8(b)                                                          \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),           \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define HVD_ACC64                                                            \
  HVD_ACC8(0), HVD_ACC8(8), HVD_ACC8(16), HVD_ACC8(24), HVD_ACC8(32),       \
      HVD_ACC8(40), HVD_ACC8(48), HVD_ACC8(56)
#define HVD_REGS64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"
#define HVD_ACC32 HVD_ACC8(0), HVD_ACC8(8), HVD_ACC8(16), HVD_ACC8(24)
#define HVD_ACC16 HVD_ACC8(0), HVD_ACC8(8)
#define HVD_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define HVD_REGS16                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HVD_REGS32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"
#define HVD_WGMMA_SS64(TY)                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "   \
               HVD_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"                  \
               : HVD_ACC32 : "l"(da), "l"(db), "r"(accumulate))
#define HVD_WGMMA_SS32(TY)                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "   \
               HVD_REGS16 ", %16, %17, p, 1, 1, 0, 0;\n}\n"                  \
               : HVD_ACC16 : "l"(da), "l"(db), "r"(accumulate))
#define HVD_WGMMA_SS16(TY)                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "   \
               HVD_REGS8 ", %8, %9, p, 1, 1, 0, 0;\n}\n"                     \
               : HVD_ACC8(0) : "l"(da), "l"(db), "r"(accumulate))
#define HVD_WGMMA_SS(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
               HVD_REGS64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"                  \
               : HVD_ACC64 : "l"(da), "l"(db), "r"(accumulate))
#define HVD_WGMMA_RS(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
               HVD_REGS64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"    \
               : HVD_ACC64 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),    \
                 "l"(db), "r"(accumulate))
#define HVD_WGMMA_RS64(TY)                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "   \
               HVD_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"    \
               : HVD_ACC32 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),    \
                 "l"(db), "r"(accumulate))

// d[64x128] (+)= A[64x16] · B[16x128], f32 accumulation, both operands in
// shared memory and K-major (B = rows of K: S = Q·Kᵀ).  The accumulator
// layout: warp w of the warpgroup holds rows 16w + g and 16w + g + 8
// (g = lane / 4); d[4j + {0,1}] are columns 8j + 2t + {0,1} (t = lane % 4)
// of the first row, d[4j + {2,3}] of the second.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    HVD_WGMMA_SS("bf16");
  } else {
    HVD_WGMMA_SS("f16");
  }
}

// d[64x128] += A[64x16] · B[16x128] with A from registers (the mma.sync
// m16n8k16 A fragment in each warp: a[0] = row g, k 2t..2t+1; a[1] = row
// g+8; a[2], a[3] the same at k + 8) and B MN-major in shared memory
// (B = V tile [keys][columns], transposed by the descriptor).
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    HVD_WGMMA_RS("bf16");
  } else {
    HVD_WGMMA_RS("f16");
  }
}

// d[64x64] (+)= A[64x16] · B[16x64], both operands in shared memory and
// K-major: the 64-key and 64-query tiles of the backward kernels (S = Q·Kᵀ,
// dP = dO·Vᵀ, and their transposes Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ).  The
// accumulator layout is wgmma_ss's with j = 0..7.
template <typename T>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    HVD_WGMMA_SS64("bf16");
  } else {
    HVD_WGMMA_SS64("f16");
  }
}

// d[64x32] (+)= A[64x16] · B[16x32], both operands in shared memory and
// K-major: the 32-query halves of the head-dim-64 dK/dV kernel's Sᵀ and
// dPᵀ.  The accumulator layout is wgmma_ss's with j = 0..3.
template <typename T>
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    HVD_WGMMA_SS32("bf16");
  } else {
    HVD_WGMMA_SS32("f16");
  }
}

// d[64x16] (+)= A[64x16] · B[16x16], both operands in shared memory and
// K-major: S over the last keys of the head-dim-64 forward's tail tile when
// at most 16 are left.  The accumulator layout is wgmma_ss's with j = 0, 1.
template <typename T>
__device__ __forceinline__ void wgmma_ss16(float (&d)[8], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    HVD_WGMMA_SS16("bf16");
  } else {
    HVD_WGMMA_SS16("f16");
  }
}

// d[64x64] += A[64x16] · B[16x64], A from registers (wgmma_rs's fragment)
// and B MN-major in shared memory: the products of the head-dim-64
// backward (dV += P'ᵀ·dO, dK += dS'ᵀ·Q, dQ += dS'·K).  The accumulator
// layout is wgmma_ss64's.
template <typename T>
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    HVD_WGMMA_RS64("bf16");
  } else {
    HVD_WGMMA_RS64("f16");
  }
}

#undef HVD_WGMMA_RS64
#undef HVD_WGMMA_SS32
#undef HVD_WGMMA_SS16
#undef HVD_WGMMA_RS
#undef HVD_WGMMA_SS
#undef HVD_WGMMA_SS64
#undef HVD_REGS64
#undef HVD_REGS32
#undef HVD_ACC64
#undef HVD_ACC32
#undef HVD_ACC16
#undef HVD_REGS16
#undef HVD_REGS8
#undef HVD_ACC8

// Two f32 values rounded to the 16-bit dtype and packed (lo in the low half).
template <typename T>
__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps.

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, looked
// up once; null if the driver lacks it.
inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 3-D map over a contiguous [outer, L, D] tensor of a 16-bit dtype, boxes
// of [1, box_rows, 64] with 128-byte swizzle.  Out-of-range rows (>= L, by
// head) read as zeros and are not written.  Returns a cudaError_t.
//
// A map is a function of these arguments alone, so the last MAP_CACHE maps
// encoded on the calling thread are kept and reused: the backward's two
// launches share q, k, v and dO, and a training step finds its tensors at
// the same addresses as the step before.  This keeps the encoding off the
// host time of a call.
constexpr int MAP_CACHE = 64;

template <typename T>
int encode_rows_map(CUtensorMap* map, const void* base, int outer, int L,
                    int D, int box_rows) {
  struct Key {
    const void* base;
    int outer, L, D, box_rows;
  };
  thread_local Key keys[MAP_CACHE] = {};
  thread_local CUtensorMap maps[MAP_CACHE];
  thread_local int next = 0;
  for (int j = 1; j <= MAP_CACHE; ++j) {         // the newest first
    const int i = (next - j + MAP_CACHE) % MAP_CACHE;
    const Key& k = keys[i];
    if (k.base == base && k.outer == outer && k.L == L && k.D == D &&
        k.box_rows == box_rows) {
      *map = maps[i];
      return 0;
    }
  }
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(T),
                                 (cuuint64_t)L * D * sizeof(T)};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType dt = std::is_same_v<T, __nv_bfloat16>
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUresult r = encode(map, dt, 3, const_cast<void*>(base), dims, strides, box,
                      elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  keys[next] = {base, outer, L, D, box_rows};
  maps[next] = *map;
  next = (next + 1) % MAP_CACHE;
  return 0;
}

}  // namespace hvd_flash
