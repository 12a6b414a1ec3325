// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_flash_kernel`, launched by `_flash_forward`
// (horovod_tpu/parallel/flash_attention.py).  It computes what that kernel
// computes: softmax(Q·Kᵀ·scale, masked)·V with the online-softmax
// recurrence, causal or not, GQA through the index map
//   kv row of q row bh = (bh / H)·KVH + (bh % H) / (H / KVH),
// keys >= seq_len masked, P rounded to the storage dtype before P·V, the
// row sum clamped at 1e-30, and the per-row log-sum-exp written in f32.
//
// Design, for Llama-3's head width D = 128.  One CUDA block per
// (b·h, 64-row query tile), four warps of 16
// query rows each.  The block walks 64-key K/V tiles through shared
// memory and stops at the causal diagonal; rows and keys past seq_len are
// zero-filled on load and masked, so the caller pads nothing.  Q·Kᵀ and
// P·V run on the tensor cores through `mma.sync.m16n8k16` (bf16 or fp16
// operands, f32 accumulation).  The running max and sum stay in f32
// registers; each warp's P tile goes through shared memory in the storage
// dtype, which is the rounding the TPU kernel applies before P·V.  For
// float32 inputs the same fragment layout is computed by plain FMAs (no
// TF32), so f32 keeps full precision.  Query tiles are issued from the
// bottom of the causal triangle up, longest first.
//
// Bound on an H100 SXM.  Causal prefill at Llama-3-8B widths (H=32,
// KVH=8, D=128) is tensor-core bound: 2·B·H·L²·D FLOP (both products over
// the lower triangle) against 989 TFLOP/s bf16, while its bytes
// (q, k, v, o once each) take less time at 3.35 TB/s.
//
// What this simple design leaves on the table: no wgmma (mma.sync reaches
// a fraction of Hopper's tensor-core rate), no TMA and no cp.async
// pipelining (each tile load stalls the block), fragments read from shared
// memory with scalar loads rather than ldmatrix, P round-tripped through
// shared memory instead of staying in registers, and no warp
// specialisation or persistent scheduling.

#include "flash_common.cuh"

namespace {

using namespace hvd_flash;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per K/V tile
constexpr int NWARPS = BQ / 16;
constexpr int NTHREADS = NWARPS * 32;

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int L, int H, int KVH, int causal,
                 float scale) {
  constexpr int LDS = D + PAD;
  constexpr int LDP = BK + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQ * LDS;
  T* Vs = Ks + BK * LDS;
  T* Ps = Vs + BK * LDS;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest tiles first
  const int kvbh = (bh / H) * KVH + (bh % H) / (H / KVH);
  const T* qp = q + (size_t)bh * L * D;
  const T* kp = k + (size_t)kvbh * L * D;
  const T* vp = v + (size_t)kvbh * L * D;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const T* qw = Qs + warp * 16 * LDS;
  T* pw = Ps + warp * 16 * LDP;

  load_tile<T, D, 64, NTHREADS>(Qs, qp, q0, L, tid);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  int n_kt = (L + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the previous tile is no longer read
    load_tile<T, D, 64, NTHREADS>(Ks, kp, k0, L, tid);
    load_tile<T, D, 64, NTHREADS>(Vs, vp, k0, L, tid);
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mma_tile<T, false>(s[j], qw + kk, LDS, Ks + j * 8 * LDS + kk, LDS, lane);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int col = k0 + j * 8 + 2 * t + (i & 1);
        const bool ok = col < L && (!causal || row[r] >= col);
        const float x = ok ? s[j][i] * scale : NEG_INF;
        s[j][i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {   // the four lanes of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float p = expf(s[j][i] - m[r]);
        psum[r] += p;
        pw[(g + 8 * r) * LDP + j * 8 + 2 * t + (i & 1)] = from_f<T>(p);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] *= corr[i >> 1];
    __syncwarp();                    // this warp's P tile is written
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        mma_tile<T, true>(acc[j], pw + kk, LDP, Vs + kk * LDS + j * 8, LDS, lane);
    __syncwarp();                    // P is read before the next tile rewrites it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= L) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = o + ((size_t)bh * L + row[r]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      orow[j * 8 + 2 * t] = from_f<T>(acc[j][2 * r] / lc);
      orow[j * 8 + 2 * t + 1] = from_f<T>(acc[j][2 * r + 1] / lc);
    }
    if (t == 0) lse[(size_t)bh * L + row[r]] = m[r] + logf(lc);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int KVH, int L, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(T) * ((size_t)(BQ + 2 * BK) * (D + PAD) + (size_t)BQ * (BK + PAD));
  return launch_kernel(flash_fwd_kernel<T, D>, dim3((L + BQ - 1) / BQ, B * H),
                       NTHREADS, smem, stream, static_cast<const T*>(q),
                       static_cast<const T*>(k), static_cast<const T*>(v),
                       static_cast<T*>(o), static_cast<float*>(lse), L, H, KVH,
                       causal, scale);
}

}  // namespace

extern "C" {

// q [B·H, L, D], k/v [B·KVH, L, D], o [B·H, L, D] in one dtype
// (0 = bf16, 1 = fp16, 2 = f32); lse [B·H, L] f32.  All contiguous.
// D must be 128, the head width of the Llama-3 models the port serves.
// Returns a cudaError_t: 0 when the launch was accepted.
int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int H, int KVH, int L, int D, int dtype,
                  int causal, float scale, void* stream) {
  if (B < 1 || L < 1 || KVH < 1 || H % KVH != 0 || D != 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, KVH, L, causal, scale, s);
    case 1:
      return launch<__half, 128>(q, k, v, o, lse, B, H, KVH, L, causal, scale, s);
    case 2:
      return launch<float, 128>(q, k, v, o, lse, B, H, KVH, L, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
