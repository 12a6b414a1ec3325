// Flash-attention forward at head dim 64 for NVIDIA Hopper (sm_90a), plain
// C interface: the forward of the ViT path.
//
// Replaces the TPU kernel `_flash_kernel`, launched by `_flash_forward`
// (horovod_tpu/parallel/flash_attention.py), at D = 64 in bf16 and fp16.
// The contract is flash_fwd.cu's (its header): softmax(Q·Kᵀ·scale)·V with
// the online-softmax recurrence, the causal mask and the tail mask (keys
// >= L), GQA through `kv_row`, P rounded to the storage dtype before P·V,
// the row sum clamped at 1e-30, o rounded once, and the per-row log-sum-exp
// written in f32 with the natural log (the backward kernels read it
// unchanged).
//
// Bound on an H100 SXM: at the ViT-B/16 shape (B = 64, L = 196, 12 heads,
// non-causal, bf16) the kernel is bound by bytes: q, k, v and o and the
// LSE are 77.7 MB, 23.2 µs at 3.35 TB/s, against 4·B·H·D·L² = 7.55 GFLOP,
// 7.6 µs at 989 TFLOP/s.  A head is 25 KB a tensor and four 64-row tiles,
// the last one holding 4 rows.
//
// Design, the layout of flash_bwd_d64.cu's dQ kernel.  One block per
// (b·h, 64-row query tile), one warpgroup of 128 threads, five blocks an SM
// (within 96 registers a thread, ~42 KB of shared memory a block), the
// grid ordered tile-fastest so that a head's blocks run together and
// re-read its K and V from L2, and within a head the longest causal walk
// first.  A block walks at most four key tiles, so it is bound by latency
// more than by either roofline: the layout buys blocks in flight, which
// hide each other's loads and softmax.  Thread 0 issues every copy by TMA
// through 3-D tensor maps over [rows, L, 64] (128-byte swizzle: a row of
// 64 16-bit values is one swizzled panel; boxes of 64 rows, tails
// zero-filled within the head, the O store clipped at L): the Q tile once,
// K and V through a two-stage ring with one mbarrier per tile, so S = Q·Kᵀ
// starts before V has landed.  S is four wgmma m64n64k16 with both
// operands K-major in shared memory.  The online softmax runs on the f32
// accumulator (exp2 with log2(e)·scale folded in, the row max and sum over
// the four lanes of a quad); only the diagonal tile and the tile holding
// key L − 1 are masked, and tiles above the diagonal are never loaded.  P
// is rounded to the storage dtype straight into the wgmma A fragments, so
// it never touches shared memory, and O += P·V is four wgmma m64n64k16
// with A from registers and V read MN-major.  A tail tile with at most 16
// keys left (4 at L = 196) takes S as m64n16k16, a softmax over those 16
// columns and one P·V step.  The epilogue rounds o / l
// once into the Q tile (swizzled as TMA reads it) and writes it with one
// TMA store; each row's LSE goes out from the lane that holds it.

#include "flash_d64.cuh"

namespace {

using namespace hvd_flash;
using namespace hvd_flash::d64;

constexpr int THREADS = 128;                  // one warpgroup
constexpr int MINB = 5;                       // blocks an SM
constexpr int STAGES = 2;                     // the K/V ring

// 2^x in one MUFU instruction, denormal results flushed to 0 (a P below
// 2^-126 adds nothing to P·V's f32 sums): the softmax's exponentials,
// without exp2f's denormal fix-up.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory: the Q tile (the O tile in the epilogue), the ring (stage
// s: K at RING_OFF + 2s·TILE, V after it), the mbarriers (0: Q; 1 + s:
// stage s's K; 1 + STAGES + s: its V), and 1024 bytes of slack for the
// 1024-byte alignment of the tiles.
constexpr uint32_t Q_OFF = 0;
constexpr uint32_t RING_OFF = TILE;
constexpr uint32_t BAR_OFF = RING_OFF + 2 * STAGES * TILE;
constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
static_assert(MINB * (SMEM + 1024) <= 233472, "blocks must fit one SM");

template <typename T>
__global__ void __launch_bounds__(THREADS, MINB)
flash_fwd_d64_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_o,
                     float* __restrict__ lse, int L, int H, int KVH,
                     int causal, float scale, int tiles) {
  extern __shared__ __align__(1024) unsigned char fwd_smem[];
  const uint32_t raw = smem_u32(fwd_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle alignment
  unsigned char* smem = fwd_smem + (base - raw);
  const uint32_t bars = base + BAR_OFF;
  const uint32_t qa = base + Q_OFF;

  const int bh = blockIdx.x / tiles;              // tile-fastest, and in a
  const int qt = tiles - 1 - blockIdx.x % tiles;  // head the longest walks
  const int q0 = qt * TB;                         // first
  const int kvbh = kv_row(bh, H, KVH);
  const int n = causal ? min(tiles, qt + 1) : tiles;   // key tiles
  const int tid = threadIdx.x, w = tid / 32;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const float c = scale * LOG2E;

  auto load_kv = [&](int s, int k0) {
    const uint32_t ka = base + RING_OFF + 2 * s * TILE;
    mbar_expect_tx(bars + 8 * (1 + s), TILE);
    tma_load_3d(ka, &map_k, bars + 8 * (1 + s), 0, k0, kvbh);
    mbar_expect_tx(bars + 8 * (1 + STAGES + s), TILE);
    tma_load_3d(ka + TILE, &map_v, bars + 8 * (1 + STAGES + s), 0, k0, kvbh);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * STAGES; ++i) mbar_init(bars + 8 * i, 1);
    mbar_fence_init();
    mbar_expect_tx(bars, TILE);
    tma_load_3d(qa, &map_q, bars, 0, q0, bh);
    for (int s = 0; s < STAGES && s < n; ++s) load_kv(s, s * TB);
  }
  __syncthreads();                                // barriers initialised

  const int row[2] = {q0 + 16 * w + g, q0 + 16 * w + g + 8};
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};            // running max of raw scores
  float l[2] = {0.f, 0.f};                        // this lane's share of a row sum

  // One key tile at k0 through the online softmax, NK keys wide: 64, or 16
  // where a tail tile holds at most 16 keys (ViT's L = 196 leaves 4), so
  // the products and the softmax skip the rest.  ka: the K tile (landed);
  // va: the V tile, landed once vbar completes phase `parity`.
  auto key_tile = [&](auto nk, int k0, uint32_t ka, uint32_t va,
                      uint32_t vbar, uint32_t parity, bool mask) {
    constexpr int NK = decltype(nk)::value;

    // S = Q·Kᵀ: 4 steps of 16 along D, both operands K-major.
    float sc[NK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      if constexpr (NK == 64)
        wgmma_ss64<T>(sc, kmajor(qa, kk), kmajor(ka, kk), kk > 0);
      else
        wgmma_ss16<T>(sc, kmajor(qa, kk), kmajor(ka, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // The causal and tail masks; sc[i] is row (i >> 1) & 1 of the lane, key
    // k0 + 8(i / 4) + 2t + (i & 1).
    if (mask) {
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) {
        const int col = k0 + (i / 4) * 8 + 2 * t + (i & 1);
        if (col >= L || (causal && col > row[(i >> 1) & 1])) sc[i] = -INFINITY;
      }
    }

    // Online softmax on the accumulator; the four lanes of a quad share a
    // row.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < NK / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float corr[2], msc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      msc[r] = mx[r] == -INFINITY ? 0.f : mx[r] * c;
      corr[r] = ex2(m[r] * c - msc[r]);
      m[r] = mx[r];
    }
    // P = exp(S·scale − m) rounded into A fragments: pf[2j + r] holds row
    // r's keys 8j + 2t, 8j + 2t + 1.
    uint32_t pf[NK / 4];
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NK / 4; ++i) {
      const int r = i & 1;
      const float p0 = ex2(fmaf(sc[2 * i], c, -msc[r]));
      const float p1 = ex2(fmaf(sc[2 * i + 1], c, -msc[r]));
      ps[r] += p0 + p1;
      pf[i] = pack_f2<T>(p0, p1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
    if (k0 > 0) {                         // O is 0 before the first tile
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];
    }

    // O += P·V: steps of 16 keys, P from registers, V read MN-major.
    mbar_wait(vbar, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      uint32_t a[4];
      frag(a, pf, kk);
      wgmma_rs64<T>(o, a, mnmajor(va, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  };

  mbar_wait(bars, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const int k0 = it * TB;
    const uint32_t ka = base + RING_OFF + 2 * s * TILE, va = ka + TILE;
    const uint32_t vbar = bars + 8 * (1 + STAGES + s);
    // Only the diagonal tile and the tile holding key L − 1 are masked.
    const bool mask = (causal && it == n - 1) || k0 + TB > L;
    mbar_wait(bars + 8 * (1 + s), parity);
    if (L - k0 <= 16)
      key_tile(std::integral_constant<int, 16>(), k0, ka, va, vbar, parity,
               mask);
    else
      key_tile(std::integral_constant<int, 64>(), k0, ka, va, vbar, parity,
               mask);

    __syncthreads();                              // stage s is read
    if (tid == 0 && it + STAGES < n) load_kv(s, (it + STAGES) * TB);
  }

  // o / l rounded once into the Q tile, then out by TMA; the LSE by row.
  float lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lc[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = o[i] / lc[(i >> 1) & 1];
  stage_acc<T>(smem + Q_OFF, o, w, lane);
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    tma_store_3d(&map_o, qa, 0, q0, bh);
    tma_store_wait();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (t == 0 && row[r] < L)
      lse[(size_t)bh * L + row[r]] = m[r] * scale + logf(lc[r]);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int KVH, int L, int causal, float scale,
           cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  int err = encode_rows_map<T>(&mq, q, B * H, L, HD, TB);
  if (!err) err = encode_rows_map<T>(&mk, k, B * KVH, L, HD, TB);
  if (!err) err = encode_rows_map<T>(&mv, v, B * KVH, L, HD, TB);
  if (!err) err = encode_rows_map<T>(&mo, o, B * H, L, HD, TB);
  if (!err) err = prefer_max_smem<flash_fwd_d64_kernel<T>>();
  if (err) return err;
  const int tiles = (L + TB - 1) / TB;
  return launch_kernel<flash_fwd_d64_kernel<T>, SMEM>(
      dim3(tiles * B * H), THREADS, stream, mq, mk, mv, mo,
      static_cast<float*>(lse), L, H, KVH, causal, scale, tiles);
}

}  // namespace

extern "C" {

// q [B·H, L, 64], k/v [B·KVH, L, 64], o [B·H, L, 64] in one dtype
// (0 = bf16, 1 = fp16); lse [B·H, L] f32.  All contiguous and 16-byte
// aligned.  Returns a cudaError_t: 0 when the launch was accepted,
// cudaErrorInvalidValue for a shape or dtype the entry does not take (D
// other than 64, f32).
int hvd_flash_fwd_d64(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int H, int KVH, int L, int D,
                      int dtype, int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, L) || D != HD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<__nv_bfloat16>(q, k, v, o, lse, B, H, KVH, L, causal,
                                   scale, s);
    case 1:
      return launch<__half>(q, k, v, o, lse, B, H, KVH, L, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block, in bytes.
int hvd_flash_fwd_d64_smem_bytes() { return (int)SMEM; }

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
