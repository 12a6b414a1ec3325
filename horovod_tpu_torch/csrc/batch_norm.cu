// Train-mode batch norm over channels-last tensors, with an optional
// residual add and ReLU fused in, for NVIDIA Hopper (sm_90a); plain C
// interface.
//
// Replaces no TPU kernel: the JAX package leaves flax's BatchNorm to XLA,
// which fuses the normalisation with the add and the ReLU around it.  The
// port called ATen's channels-last batch norm (a statistics pass, an apply
// pass, two backward passes) with the ReLU, its mask and the residual add
// as separate element-wise passes; this file moves those bytes once.
//
// Bound on an H100 SXM: bytes.  A few operations per element against the
// 295 operations a byte the tensor cores need, so every kernel here is
// held to its reads and writes at 3.35 TB/s.  ResNet-50 at batch 256
// normalises 2.845 G elements a step, 5.69 GB a pass in bf16.
//
// The tensor is viewed as [M, C], C contiguous (NHWC), M = N·H·W.  Every
// kernel runs on the same tiling: blocks of 256 threads, blockDim.x
// threads across a tile of channel vectors (VEC channels a thread: 16
// bytes), blockDim.y rows at a time; blockIdx.x picks the channel tile, blockIdx.y
// a chunk of `rpb` consecutive rows.  The grid is the blocks that fit on
// the card at once (occupancy × SMs), so one wave covers it, and each
// thread keeps four 16-byte loads in flight.  Arithmetic is f32
// throughout; storage is the input's dtype (bf16 or f32).
//
// Two C entries, one a direction, each launching two kernels:
//
// `hvd_bn_forward`, the statistics kernel: one read of x.  Each thread
// keeps Welford's (count, mean, M2) for its channels; the block merges its
// threads with Chan's formula in shared memory and writes its partial to
// scratch; the last
// block of a channel tile to arrive (an atomic ticket) merges the
// partials, writes mean and 1/sqrt(var + eps) (the biased variance) and
// folds them into running_mean and running_var with flax's semantics:
// momentum on the old value, the biased batch variance.  It resets the
// ticket for the next launch.
//
// Then the apply kernel: y = act(x·a + b [+ residual]), a = γ·invstd and
// b = β − mean·a per channel; the add in f32 before the one rounding.
//
// `hvd_bn_backward`, the reduce kernel: g = dy·[y > 0] where the ReLU was
// fused (the mask from the saved output), Σg and Σg·(x − mean) per channel
// by the same partial-and-last-block scheme; writes dβ = Σg and
// dγ = invstd·Σg·(x − mean).
//
// Then the element-wise kernel:
// dx = a·(g − Σg/M) − a·invstd²·(Σg·(x − mean)/M)·(x − mean), and
// d_residual = g where a residual and the ReLU were fused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC elements of one row, moved as one aligned load or store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&out)[VEC]) {
  const Pack<T, VEC> k = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int v = 0; v < VEC; ++v) out[v] = to_f(k.v[v]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&in)[VEC]) {
  Pack<T, VEC> k;
#pragma unroll
  for (int v = 0; v < VEC; ++v) k.v[v] = from_f<T>(in[v]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = k;
}

// The tile of a thread: its first channel, whether it has channels at all,
// and its rows [r0 + threadIdx.y, r1) with stride blockDim.y.
struct Tile {
  int c0;
  bool active;
  long long r0, r1;
};

template <int VEC>
__device__ __forceinline__ Tile tile_of(long long M, int C, long long rpb) {
  Tile t;
  const int cv = blockIdx.x * blockDim.x + threadIdx.x;
  t.active = cv < C / VEC;
  t.c0 = cv * VEC;
  t.r0 = static_cast<long long>(blockIdx.y) * rpb;
  t.r1 = min(M, t.r0 + rpb);
  return t;
}

// Chan's merge of (nb, mb, m2b) into (n, mean, m2); n is shared by the
// VEC channels of a thread.
template <int VEC>
__device__ __forceinline__ void chan(float& n, float (&mean)[VEC],
                                     float (&m2)[VEC], float nb,
                                     const float* mb, const float* m2b) {
  const float nt = n + nb;
  if (nb == 0.f) return;
  const float wb = nb / nt;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const float d = mb[v] - mean[v];
    mean[v] += d * wb;
    m2[v] += m2b[v] + d * d * n * wb;
  }
  n = nt;
}

// Merge the (n, mean, m2) of the block's rows of threads into row 0,
// a tree over threadIdx.y in shared memory: on return the threads with
// threadIdx.y == 0 hold the block's result.
template <int VEC>
__device__ void block_chan(float& n, float (&mean)[VEC], float (&m2)[VEC],
                           float* smem) {
  const int w = blockDim.x * VEC, ty = threadIdx.y;
  const int col = threadIdx.x * VEC;
  float* s_mean = smem;
  float* s_m2 = s_mean + blockDim.y * w;
  float* s_n = s_m2 + blockDim.y * w;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    s_mean[ty * w + col + v] = mean[v];
    s_m2[ty * w + col + v] = m2[v];
  }
  if (threadIdx.x == 0) s_n[ty] = n;
  __syncthreads();
  int span = 1;
  while (span < static_cast<int>(blockDim.y)) span <<= 1;
  for (int s = span >> 1; s > 0; s >>= 1) {
    if (ty < s && ty + s < static_cast<int>(blockDim.y)) {
      const int o = (ty + s) * w + col;
      chan<VEC>(n, mean, m2, s_n[ty + s], s_mean + o, s_m2 + o);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        s_mean[ty * w + col + v] = mean[v];
        s_m2[ty * w + col + v] = m2[v];
      }
    }
    __syncthreads();
    if (ty < s && threadIdx.x == 0) s_n[ty] = n;
    __syncthreads();
  }
}

// Sum two sets of VEC sums over the block's rows of threads into row 0.
template <int VEC>
__device__ void block_sum2(float (&a)[VEC], float (&b)[VEC], float* smem) {
  const int w = blockDim.x * VEC, ty = threadIdx.y;
  const int col = threadIdx.x * VEC;
  float* s_a = smem;
  float* s_b = s_a + blockDim.y * w;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    s_a[ty * w + col + v] = a[v];
    s_b[ty * w + col + v] = b[v];
  }
  __syncthreads();
  int span = 1;
  while (span < static_cast<int>(blockDim.y)) span <<= 1;
  for (int s = span >> 1; s > 0; s >>= 1) {
    if (ty < s && ty + s < static_cast<int>(blockDim.y)) {
      const int o = (ty + s) * w + col;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        a[v] += s_a[o + v];
        b[v] += s_b[o + v];
        s_a[ty * w + col + v] = a[v];
        s_b[ty * w + col + v] = b[v];
      }
    }
    __syncthreads();
  }
}

// After a block has written its partial: true in the last block of its
// channel tile to arrive, which also re-arms the ticket for the next
// launch.  Block-uniform.
__device__ bool last_to_arrive(unsigned* ticket, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const unsigned t = atomicAdd(ticket + blockIdx.x, 1u);
    *flag = t == gridDim.y - 1;
    if (*flag) ticket[blockIdx.x] = 0;
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

__device__ __forceinline__ float rows_of(long long p, long long M,
                                         long long rpb) {
  return static_cast<float>(min(rpb, M - p * rpb));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                    unsigned* __restrict__ ticket, float* __restrict__ stats,
                    float* __restrict__ running_mean,
                    float* __restrict__ running_var, long long M, int C,
                    long long rpb, float eps, float momentum) {
  extern __shared__ float smem[];
  __shared__ int flag;
  const Tile t = tile_of<VEC>(M, C, rpb);
  float n = 0.f, mean[VEC], m2[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) mean[v] = m2[v] = 0.f;
  if (t.active) {
    const long long step = blockDim.y;
    long long r = t.r0 + threadIdx.y;
    for (; r + (kUnroll - 1) * step < t.r1; r += kUnroll * step) {
      float xs[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        load<T, VEC>(x + (r + u * step) * C + t.c0, xs[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        n += 1.f;
        const float inv = 1.f / n;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float d = xs[u][v] - mean[v];
          mean[v] += d * inv;
          m2[v] += d * (xs[u][v] - mean[v]);
        }
      }
    }
    for (; r < t.r1; r += step) {
      float xs[VEC];
      load<T, VEC>(x + r * C + t.c0, xs);
      n += 1.f;
      const float inv = 1.f / n;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float d = xs[v] - mean[v];
        mean[v] += d * inv;
        m2[v] += d * (xs[v] - mean[v]);
      }
    }
  }
  block_chan<VEC>(n, mean, m2, smem);
  if (threadIdx.y == 0 && t.active) {
    float* p = partial + static_cast<long long>(blockIdx.y) * 2 * C + t.c0;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      p[v] = mean[v];
      p[C + v] = m2[v];
    }
  }
  if (!last_to_arrive(ticket, &flag)) return;

  // The last block of the tile: merge every block's partial.
  n = 0.f;
#pragma unroll
  for (int v = 0; v < VEC; ++v) mean[v] = m2[v] = 0.f;
  if (t.active) {
    const int parts = gridDim.y;
    int p = threadIdx.y;
    for (; p + (kUnroll - 1) * static_cast<int>(blockDim.y) < parts;
         p += kUnroll * blockDim.y) {
      float mb[kUnroll][VEC], m2b[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float* q = partial +
                         static_cast<long long>(p + u * blockDim.y) * 2 * C +
                         t.c0;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          mb[u][v] = __ldcg(q + v);
          m2b[u][v] = __ldcg(q + C + v);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        chan<VEC>(n, mean, m2, rows_of(p + u * blockDim.y, M, rpb), mb[u],
                  m2b[u]);
    }
    for (; p < parts; p += blockDim.y) {
      const float* q = partial + static_cast<long long>(p) * 2 * C + t.c0;
      float mb[VEC], m2b[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        mb[v] = __ldcg(q + v);
        m2b[v] = __ldcg(q + C + v);
      }
      chan<VEC>(n, mean, m2, rows_of(p, M, rpb), mb, m2b);
    }
  }
  block_chan<VEC>(n, mean, m2, smem);
  if (threadIdx.y == 0 && t.active) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int c = t.c0 + v;
      const float var = m2[v] / n;
      stats[c] = mean[v];
      stats[C + c] = 1.f / sqrtf(var + eps);
      running_mean[c] = momentum * running_mean[c] + (1.f - momentum) * mean[v];
      running_var[c] = momentum * running_var[c] + (1.f - momentum) * var;
    }
  }
}

template <typename T, int VEC, bool RELU, bool RES>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    T* __restrict__ y, const float* __restrict__ stats,
                    const float* __restrict__ weight,
                    const float* __restrict__ bias, long long M, int C,
                    long long rpb) {
  const Tile t = tile_of<VEC>(M, C, rpb);
  if (!t.active) return;
  float a[VEC], b[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int c = t.c0 + v;
    a[v] = weight[c] * stats[C + c];
    b[v] = bias[c] - stats[c] * a[v];
  }
  auto one = [&](const float (&xs)[VEC], const float (&rs)[VEC], T* out) {
    float o[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float f = fmaf(xs[v], a[v], b[v]);
      if (RES) f += rs[v];
      if (RELU) f = fmaxf(f, 0.f);
      o[v] = f;
    }
    store<T, VEC>(out, o);
  };
  const long long step = blockDim.y;
  long long r = t.r0 + threadIdx.y;
  for (; r + (kUnroll - 1) * step < t.r1; r += kUnroll * step) {
    float xs[kUnroll][VEC], rs[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = (r + u * step) * C + t.c0;
      load<T, VEC>(x + off, xs[u]);
      if (RES) load<T, VEC>(res + off, rs[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      one(xs[u], rs[u], y + (r + u * step) * C + t.c0);
  }
  for (; r < t.r1; r += step) {
    float xs[VEC], rs[VEC];
    load<T, VEC>(x + r * C + t.c0, xs);
    if (RES) load<T, VEC>(res + r * C + t.c0, rs);
    one(xs, rs, y + r * C + t.c0);
  }
}

// g of one row: dy, zeroed where the fused ReLU's output is not positive.
template <typename T, int VEC, bool RELU>
__device__ __forceinline__ void grad_in(const T* dy, const T* y,
                                        long long off, float (&g)[VEC]) {
  load<T, VEC>(dy + off, g);
  if (RELU) {
    float ys[VEC];
    load<T, VEC>(y + off, ys);
#pragma unroll
    for (int v = 0; v < VEC; ++v) g[v] = ys[v] > 0.f ? g[v] : 0.f;
  }
}

template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                         const T* __restrict__ x,
                         const float* __restrict__ stats,
                         float* __restrict__ partial,
                         unsigned* __restrict__ ticket,
                         float* __restrict__ dweight,
                         float* __restrict__ dbias, long long M, int C,
                         long long rpb) {
  extern __shared__ float smem[];
  __shared__ int flag;
  const Tile t = tile_of<VEC>(M, C, rpb);
  float sg[VEC], sgx[VEC], mean[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) sg[v] = sgx[v] = 0.f;
  if (t.active) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) mean[v] = stats[t.c0 + v];
    const long long step = blockDim.y;
    long long r = t.r0 + threadIdx.y;
    for (; r + (kUnroll - 1) * step < t.r1; r += kUnroll * step) {
      float g[kUnroll][VEC], xs[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long off = (r + u * step) * C + t.c0;
        grad_in<T, VEC, RELU>(dy, y, off, g[u]);
        load<T, VEC>(x + off, xs[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          sg[v] += g[u][v];
          sgx[v] = fmaf(g[u][v], xs[u][v] - mean[v], sgx[v]);
        }
    }
    for (; r < t.r1; r += step) {
      float g[VEC], xs[VEC];
      grad_in<T, VEC, RELU>(dy, y, r * C + t.c0, g);
      load<T, VEC>(x + r * C + t.c0, xs);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        sg[v] += g[v];
        sgx[v] = fmaf(g[v], xs[v] - mean[v], sgx[v]);
      }
    }
  }
  block_sum2<VEC>(sg, sgx, smem);
  if (threadIdx.y == 0 && t.active) {
    float* p = partial + static_cast<long long>(blockIdx.y) * 2 * C + t.c0;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      p[v] = sg[v];
      p[C + v] = sgx[v];
    }
  }
  if (!last_to_arrive(ticket, &flag)) return;

  // The last block of the tile: sum every block's partial.
#pragma unroll
  for (int v = 0; v < VEC; ++v) sg[v] = sgx[v] = 0.f;
  if (t.active) {
#pragma unroll 4
    for (int p = threadIdx.y; p < static_cast<int>(gridDim.y);
         p += blockDim.y) {
      const float* q = partial + static_cast<long long>(p) * 2 * C + t.c0;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        sg[v] += __ldcg(q + v);
        sgx[v] += __ldcg(q + C + v);
      }
    }
  }
  block_sum2<VEC>(sg, sgx, smem);
  if (threadIdx.y == 0 && t.active) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int c = t.c0 + v;
      dbias[c] = sg[v];
      dweight[c] = sgx[v] * stats[C + c];
    }
  }
}

template <typename T, int VEC, bool RELU, bool RES>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_elemt_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                        const T* __restrict__ x,
                        const float* __restrict__ stats,
                        const float* __restrict__ weight,
                        const float* __restrict__ dweight,
                        const float* __restrict__ dbias, T* __restrict__ dx,
                        T* __restrict__ dres, long long M, int C,
                        long long rpb) {
  const Tile t = tile_of<VEC>(M, C, rpb);
  if (!t.active) return;
  // dx = a·(g − Σg/M) − k·(x − mean), k = a·invstd·(invstd·Σg·(x − mean))/M.
  float a[VEC], shift[VEC], k[VEC], mean[VEC];
  const float inv_m = 1.f / static_cast<float>(M);
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int c = t.c0 + v;
    const float invstd = stats[C + c];
    mean[v] = stats[c];
    a[v] = weight[c] * invstd;
    shift[v] = -a[v] * dbias[c] * inv_m;
    k[v] = a[v] * invstd * dweight[c] * inv_m;
  }
  auto one = [&](const float (&g)[VEC], const float (&xs)[VEC],
                 long long off) {
    float o[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      o[v] = fmaf(a[v], g[v], shift[v]) - k[v] * (xs[v] - mean[v]);
    store<T, VEC>(dx + off, o);
    if (RES) store<T, VEC>(dres + off, g);
  };
  const long long step = blockDim.y;
  long long r = t.r0 + threadIdx.y;
  for (; r + (kUnroll - 1) * step < t.r1; r += kUnroll * step) {
    float g[kUnroll][VEC], xs[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = (r + u * step) * C + t.c0;
      grad_in<T, VEC, RELU>(dy, y, off, g[u]);
      load<T, VEC>(x + off, xs[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) one(g[u], xs[u], (r + u * step) * C + t.c0);
  }
  for (; r < t.r1; r += step) {
    float g[VEC], xs[VEC];
    grad_in<T, VEC, RELU>(dy, y, r * C + t.c0, g);
    load<T, VEC>(x + r * C + t.c0, xs);
    one(g, xs, r * C + t.c0);
  }
}

// -- launches -------------------------------------------------------------

enum Kernel { kStats, kApply, kReduce, kElemt, kKernels };

// The statistics kernel's shared memory (two VEC-wide rows a thread row and
// the counts) for a block of (bx, by); the backward reduce takes the first
// two parts.
size_t smem_of(dim3 block, int vec) {
  return (2 * block.y * block.x * vec + block.y) * sizeof(float);
}

// Resident blocks of 256 threads an SM for kernel `k` (the variant with
// the most operands), asked once a process.
template <typename T, int VEC>
int resident(int k) {
  static int cached[kKernels] = {};
  if (cached[k] == 0) {
    const size_t smem = (2 * kThreads * VEC + kThreads) * sizeof(float);
    int n = 0;
    if (k == kStats)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, bn_stats_kernel<T, VEC>, kThreads, smem);
    else if (k == kApply)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, bn_apply_kernel<T, VEC, true, true>, kThreads, 0);
    else if (k == kReduce)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, bn_bwd_reduce_kernel<T, VEC, true>, kThreads, smem);
    else
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, bn_bwd_elemt_kernel<T, VEC, true, true>, kThreads, 0);
    cached[k] = n > 0 ? n : 1;
  }
  return cached[k];
}

// SMs of the current device, asked once a device.
int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 1;
  }
  return cached[dev];
}

// The grid of kernel `k` over [M, C]: blocks of 256 threads, up to 32
// across a tile of channel vectors and the rest down the rows; grid
// (tiles, parts), as many chunks of rpb rows as fill the card once with the
// tiles.
struct Launch {
  dim3 grid, block;
  long long rpb;
};

template <typename T, int VEC>
Launch launch_for(int k, long long M, int C) {
  const int nvec = C / VEC;
  const int bx = nvec < 32 ? nvec : 32;
  const int by = kThreads / bx;
  const int tiles = (nvec + bx - 1) / bx;
  const long long want = static_cast<long long>(resident<T, VEC>(k)) *
                         sm_count();
  long long parts = (want + tiles - 1) / tiles;
  parts = std::min(parts, (M + by - 1) / by);
  parts = std::max(parts, 1LL);
  const long long rpb = (M + parts - 1) / parts;
  parts = (M + rpb - 1) / rpb;
  return Launch{dim3(tiles, static_cast<unsigned>(parts)), dim3(bx, by), rpb};
}

template <typename T, int VEC>
cudaError_t workspace(long long M, int C, long long* floats, int* tickets) {
  const Launch a = launch_for<T, VEC>(kStats, M, C);
  const Launch b = launch_for<T, VEC>(kReduce, M, C);
  *floats = 2LL * C * std::max(a.grid.y, b.grid.y);
  *tickets = static_cast<int>(std::max(a.grid.x, b.grid.x));
  return cudaGetLastError();
}

template <typename T, int VEC, bool RELU, bool RES>
void launch_apply(const Launch& l, const void* x, const void* res, void* y,
                  const void* st, const void* w, const void* b, long long M,
                  int C, cudaStream_t s) {
  bn_apply_kernel<T, VEC, RELU, RES><<<l.grid, l.block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<T*>(y), static_cast<const float*>(st),
      static_cast<const float*>(w), static_cast<const float*>(b), M, C, l.rpb);
}

template <typename T, int VEC>
cudaError_t forward(const void* x, const void* res, void* y, void* st,
                    const void* w, const void* b, void* rmean, void* rvar,
                    void* scratch, void* ticket, long long M, int C, int relu,
                    float eps, float momentum, cudaStream_t s) {
  const Launch l = launch_for<T, VEC>(kStats, M, C);
  bn_stats_kernel<T, VEC><<<l.grid, l.block, smem_of(l.block, VEC), s>>>(
      static_cast<const T*>(x), static_cast<float*>(scratch),
      static_cast<unsigned*>(ticket), static_cast<float*>(st),
      static_cast<float*>(rmean), static_cast<float*>(rvar), M, C, l.rpb, eps,
      momentum);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const Launch a = launch_for<T, VEC>(kApply, M, C);
  if (res != nullptr && relu)
    launch_apply<T, VEC, true, true>(a, x, res, y, st, w, b, M, C, s);
  else if (res != nullptr)
    launch_apply<T, VEC, false, true>(a, x, res, y, st, w, b, M, C, s);
  else if (relu)
    launch_apply<T, VEC, true, false>(a, x, res, y, st, w, b, M, C, s);
  else
    launch_apply<T, VEC, false, false>(a, x, res, y, st, w, b, M, C, s);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t backward(const void* dy, const void* y, const void* x,
                     const void* st, const void* w, void* scratch,
                     void* ticket, void* dw, void* db, void* dx, void* dres,
                     long long M, int C, int relu, cudaStream_t s) {
  const Launch l = launch_for<T, VEC>(kReduce, M, C);
  const size_t smem = 2 * l.block.y * l.block.x * VEC * sizeof(float);
  auto reduce = [&](auto kernel) {
    kernel<<<l.grid, l.block, smem, s>>>(
        static_cast<const T*>(dy), static_cast<const T*>(y),
        static_cast<const T*>(x), static_cast<const float*>(st),
        static_cast<float*>(scratch), static_cast<unsigned*>(ticket),
        static_cast<float*>(dw), static_cast<float*>(db), M, C, l.rpb);
  };
  if (relu)
    reduce(bn_bwd_reduce_kernel<T, VEC, true>);
  else
    reduce(bn_bwd_reduce_kernel<T, VEC, false>);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const Launch a = launch_for<T, VEC>(kElemt, M, C);
  auto elemt = [&](auto kernel) {
    kernel<<<a.grid, a.block, 0, s>>>(
        static_cast<const T*>(dy), static_cast<const T*>(y),
        static_cast<const T*>(x), static_cast<const float*>(st),
        static_cast<const float*>(w), static_cast<const float*>(dw),
        static_cast<const float*>(db), static_cast<T*>(dx),
        static_cast<T*>(dres), M, C, a.rpb);
  };
  if (relu && dres != nullptr)
    elemt(bn_bwd_elemt_kernel<T, VEC, true, true>);
  else if (relu)
    elemt(bn_bwd_elemt_kernel<T, VEC, true, false>);
  else
    elemt(bn_bwd_elemt_kernel<T, VEC, false, false>);
  return cudaGetLastError();
}

// The element type (0 = bf16, 2 = f32) of a call, as one switch, with its
// 16-byte vector of V elements; a shape the vector does not divide is
// refused.
#define HVD_BN_DISPATCH(dtype, M, C, CALL)                           \
  do {                                                               \
    if ((M) <= 0 || (C) <= 0) return cudaErrorInvalidValue;          \
    if ((dtype) == 0) {                                              \
      using T = __nv_bfloat16;                                       \
      constexpr int V = 8;                                           \
      return (C) % V == 0 ? CALL : cudaErrorInvalidValue;            \
    }                                                                \
    if ((dtype) == 2) {                                              \
      using T = float;                                               \
      constexpr int V = 4;                                           \
      return (C) % V == 0 ? CALL : cudaErrorInvalidValue;            \
    }                                                                \
    return cudaErrorInvalidValue;                                    \
  } while (0)

}  // namespace

extern "C" {

// x, residual (or null), y, dy, dx, d_residual (or null): contiguous
// [M, C] with C innermost, one element type (0 = bf16, 2 = f32), 16-byte
// aligned, C a multiple of the 16-byte vector (8 bf16, 4 f32).  stats
// [2, C] f32 (mean, invstd); weight, bias, running_mean, running_var,
// dweight, dbias [C] f32.  scratch and ticket as `hvd_bn_workspace` sizes
// them, on the device; the ticket zero before the first launch (each
// launch leaves it zero).  Launched on `stream`.  Returns a cudaError_t:
// 0 when the launches were accepted, cudaErrorInvalidValue for a shape or
// dtype the entries do not take.

// The f32 scratch and the tickets a call at (M, C) needs.
int hvd_bn_workspace(long long M, int C, int dtype, long long* scratch_floats,
                     int* tickets) {
  HVD_BN_DISPATCH(dtype, M, C,
                  (workspace<T, V>(M, C, scratch_floats, tickets)));
}

// The statistics kernel (mean and invstd into stats, the running
// statistics folded in place), then the apply kernel (y).
int hvd_bn_forward(const void* x, const void* residual, void* y, void* stats,
                   const void* weight, const void* bias, void* running_mean,
                   void* running_var, void* scratch, void* ticket, long long M,
                   int C, int dtype, int relu, float eps, float momentum,
                   void* stream) {
  HVD_BN_DISPATCH(
      dtype, M, C,
      (forward<T, V>(x, residual, y, stats, weight, bias, running_mean,
                     running_var, scratch, ticket, M, C, relu, eps, momentum,
                     static_cast<cudaStream_t>(stream))));
}

// The reduce kernel (dweight, dbias), then the element-wise kernel (dx,
// and d_residual = g where it is not null).  y is read for the ReLU's mask
// where `relu` is 1.
int hvd_bn_backward(const void* dy, const void* y, const void* x,
                    const void* stats, const void* weight, void* scratch,
                    void* ticket, void* dweight, void* dbias, void* dx,
                    void* dres, long long M, int C, int dtype, int relu,
                    void* stream) {
  HVD_BN_DISPATCH(
      dtype, M, C,
      (backward<T, V>(dy, y, x, stats, weight, scratch, ticket, dweight, dbias,
                      dx, dres, M, C, relu,
                      static_cast<cudaStream_t>(stream))));
}

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
