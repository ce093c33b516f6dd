// InstanceNorm2d+ for Hopper (sm_90a): the NCSN score nets' norm, with its
// embeddings folded in and an optional ELU, as two kernels over x kept in
// channels_last memory (physically NHWC), bf16 or float32.
//
// Replaces: no kernel of the JAX package. There the norm is plain jnp code
// (audiosourcesep_tpu/models/ncsn/layers.py::_norm2dplus) that XLA fuses on
// the TPU; the port's PyTorch composite of the same math
// (audiosourcesep_tpu_torch/models/ncsn/layers.py::_norm2dplus) runs as
// about 20 kernels a norm on the card, most of them small [N, C] row ops
// and f32 copies of x, and took 56% of a separation step's device time.
//
//   out[n, c] = a[n, c] * x[n, c] + b[n, c]      (then ELU, if asked)
//   a = gamma_r[c] * in_gamma[c] * rsqrt(var_hw + 1e-3)
//   b = alpha_r[c] * (mean_hw - m) * rsqrt(v + 1e-5)
//       + gamma_r[c] * in_beta[c] + beta_r[c] - a * mean_hw
//
// with mean_hw, var_hw the channel's statistics over H x W, m and v the
// mean and variance of mean_hw across the C channels, and the rows
// gamma_r, alpha_r, beta_r of the embedding tables at r = y[n] (v1), or
// row 0 of a one-row table for every n (v2's unconditional norm).
//
// What bounds it on this card: bytes. The statistics read x once, the
// affine reads x and writes y once: 6 bytes an element in bf16, about 3.7
// ms of HBM traffic for the 142 norms of a separation step at 30 frames
// (3.06 G elements) against ~62 ms for the composite.
//
// What the design does about it:
// - stats: a grid of S slices of H x W by N samples. A thread owns 8
//   contiguous channels and walks the pixels of its slice R pixels apart
//   (R threads a channel group in a block of 256), so a warp reads whole
//   pixel rows with 16-byte loads, four in flight a thread. Sums are f32,
//   of x less a shift (x at the sample's first pixel, the same in every
//   slice), so that a large mean does not cancel the variance; the clamp
//   at 0 stays. Each block adds its threads' sums pairwise and writes its
//   [C, 2] partial sums to an f32 scratch [N, S, C, 2]. The last block of
//   a sample to arrive (an atomic ticket a sample) adds the slices in
//   order, compensated (the result does not depend
//   on which block is last), forms the channels' mean and variance, m and
//   v (two passes over the C means, in shared memory), gathers the
//   sample's embedding rows and folds them into a[n, c] and b[n, c] (f32,
//   in scratch). The tickets live in the call's scratch and the C entry
//   zeroes them on the stream before the statistics, so every launch, and
//   every replay of a CUDA graph that holds one, starts clean, and
//   launches on other streams share nothing.
// - apply: the same grid, samples walked from the last one the statistics
//   read, whose x is most likely still in L2. A thread keeps its 8
//   channels' a and b in registers, computes a * x + b (and ELU) in f32 and
//   rounds once to x's dtype; 16-byte loads and stores.
// A channel count that is not a multiple of 8, or x not 16-byte aligned,
// takes the same kernels with element loads.
//
// C interface (bound with ctypes): instnorm_plus_fwd(x, y, labels, gamma,
// alpha, beta, in_gamma, in_beta, scratch, N, C, HW, K, bf16,
// slices, elu, stream): x, y [N, HW, C] in x's dtype (bf16 when `bf16`,
// else float32); labels int64 [N] or null (row 0 for all); gamma, alpha,
// beta (beta may be null) float32 [K, C]; in_gamma, in_beta float32 [C];
// scratch float32 [N * C * 2 * (slices + 1) + N] (the partial sums, a and
// b, then the tickets as uint32). It zeroes the tickets and launches both
// kernels on `stream`, allocates nothing, and returns the first CUDA error
// (or an error code for a call it does not take). instnorm_plus_blocks_per_sm(C, bf16) gives the
// statistics blocks an SM holds at once, from which the wrapper sizes the
// grid to whole waves. A label outside [0, K) traps (a CUDA error, as an
// out-of-range index on the card).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;            // channels a thread owns
constexpr int BLOCK = 256;        // threads a block (more for C > 2048)
constexpr int MAXC = 4096;        // channels (blocks of C / 8 threads)
constexpr int UNROLL = 4;         // loads in flight a thread

struct Args {
  const void* x;
  void* y;
  const long long* labels;
  const float* gamma;
  const float* alpha;
  const float* beta;
  const float* in_gamma;
  const float* in_beta;
  float* partials;                // [N, S, C, 2]
  float2* ab;                     // [N, C]
  unsigned int* tickets;          // [N], zero before the statistics
  int N, C, HW, K, S, G, R;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// 8 channels at p (nc of them real) into f32
template <bool WIDE>
__device__ __forceinline__ void load8(const float* p, int nc, float v[8]) {
  if (WIDE) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = j < nc ? __ldg(p + j) : 0.f;
  }
}

template <bool WIDE>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int nc,
                                      float v[8]) {
  if (WIDE) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // a bf16 is the high half of an f32
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = j < nc ? to_f32(p[j]) : 0.f;
  }
}

template <bool WIDE>
__device__ __forceinline__ void store8(float* p, int nc, const float v[8]) {
  if (WIDE) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (j < nc) p[j] = v[j];
  }
}

template <bool WIDE>
__device__ __forceinline__ void store8(__nv_bfloat16* p, int nc,
                                       const float v[8]) {
  if (WIDE) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (j < nc) from_f32(v[j], p + j);
  }
}

// ELU, exp(o) - 1 below 0: a polynomial near 0 (the terms to o^7 / 7!,
// off by under o^8 / 8! < 4e-10 of it for o in [-1/4, 0]) and the fast
// exponential beyond, where exp(o) - 1 cancels nothing; a third of expm1f's
// instructions, which made the fused ELU the bf16 apply pass's limit
__device__ __forceinline__ float elu(float o) {
  if (o > 0.f) return o;
  float p = fmaf(o, 1.f / 5040.f, 1.f / 720.f);
  p = fmaf(o, p, 1.f / 120.f);
  p = fmaf(o, p, 1.f / 24.f);
  p = fmaf(o, p, 1.f / 6.f);
  p = fmaf(o, p, 0.5f);
  p = fmaf(o, p, 1.f);
  return o > -0.25f ? o * p : __expf(o) - 1.f;
}

// the pixels [p0, p1) of slice s of S over HW
__device__ __forceinline__ void slice(int s, int S, int HW, int* p0,
                                      int* p1) {
  *p0 = (int)((long long)s * HW / S);
  *p1 = (int)((long long)(s + 1) * HW / S);
}

// *sum += v, Kahan-compensated by *err
__device__ __forceinline__ void kahan(float v, float* sum, float* err) {
  const float y = v - *err;
  const float t = *sum + y;
  *err = (t - *sum) - y;
  *sum = t;
}

// the sum of v over the block, the same value in every thread, in a fixed
// order (blockDim.x a multiple of 32; `tree` holds a float a warp)
__device__ float block_sum(float v, float* tree) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();                 // tree may still be read
  if ((threadIdx.x & 31) == 0) tree[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += tree[w];
  return t;
}

// the last block of sample n: partial sums -> a, b
template <typename T>
__device__ void finish(const Args& a, int n, const T* xn, float* sm) {
  const int C = a.C;
  float* mean = sm;                // [C]
  float* var = sm + C;             // [C]
  float* tree = sm + 16 * blockDim.x;
  const float inv_hw = 1.f / (float)a.HW;
  const float* part = a.partials + (size_t)n * a.S * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    // the slices' sums, compensated (up to a few hundred slices at N = 1)
    float t1 = 0.f, t2 = 0.f, e1 = 0.f, e2 = 0.f;
    for (int s = 0; s < a.S; ++s) {
      // L2 only: the other blocks' writes, not a stale L1 line
      kahan(__ldcg(part + (size_t)s * 2 * C + 2 * c), &t1, &e1);
      kahan(__ldcg(part + (size_t)s * 2 * C + 2 * c + 1), &t2, &e2);
    }
    const float d = t1 * inv_hw;   // mean less the shift
    mean[c] = to_f32(xn[c]) + d;
    var[c] = fmaxf(t2 * inv_hw - d * d, 0.f);
  }
  __syncthreads();
  float t = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) t += mean[c];
  const float m = block_sum(t, tree) / (float)C;
  t = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float d = mean[c] - m;
    t = fmaf(d, d, t);
  }
  const float rv = rsqrtf(block_sum(t, tree) / (float)C + 1e-5f);
  long long row = 0;
  if (a.labels != nullptr) {
    row = a.labels[n];
    if (row < 0 || row >= a.K) __trap();
  }
  const size_t at = (size_t)row * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float g = a.gamma[at + c];
    const float bias = fmaf(g, a.in_beta[c],
                            a.beta != nullptr ? a.beta[at + c] : 0.f);
    const float A = g * a.in_gamma[c] * rsqrtf(var[c] + 1e-3f);
    const float B = a.alpha[at + c] * ((mean[c] - m) * rv) + bias
                    - A * mean[c];
    a.ab[(size_t)n * C + c] = make_float2(A, B);
  }
}

template <typename T, bool WIDE>
__global__ void __launch_bounds__(2 * BLOCK)
instnorm_stats_kernel(const Args a) {
  extern __shared__ float sm[];    // [16 * blockDim] + [blockDim / 32]
  __shared__ int last;
  const int n = blockIdx.y, s = blockIdx.x;
  const int g = threadIdx.x % a.G, r = threadIdx.x / a.G;
  const int C = a.C, c0 = VEC * g, nc = min(VEC, C - c0);
  const T* xn = static_cast<const T*>(a.x) + (size_t)n * a.HW * C;
  if (r < a.R) {
    float k[VEC], s1[VEC], s2[VEC];
    load8<WIDE>(xn + c0, nc, k);
#pragma unroll
    for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.f;
    int p, p1;
    slice(s, a.S, a.HW, &p, &p1);
    p += r;
    for (; p + (UNROLL - 1) * a.R < p1; p += UNROLL * a.R) {
      float v[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        load8<WIDE>(xn + (size_t)(p + u * a.R) * C + c0, nc, v[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = v[u][j] - k[j];
          s1[j] += d;
          s2[j] = fmaf(d, d, s2[j]);
        }
    }
    for (; p < p1; p += a.R) {
      float v[VEC];
      load8<WIDE>(xn + (size_t)p * C + c0, nc, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = v[j] - k[j];
        s1[j] += d;
        s2[j] = fmaf(d, d, s2[j]);
      }
    }
    float4* out = reinterpret_cast<float4*>(sm + 16 * threadIdx.x);
    out[0] = make_float4(s1[0], s1[1], s1[2], s1[3]);
    out[1] = make_float4(s1[4], s1[5], s1[6], s1[7]);
    out[2] = make_float4(s2[0], s2[1], s2[2], s2[3]);
    out[3] = make_float4(s2[4], s2[5], s2[6], s2[7]);
  }
  __syncthreads();
  // the block's [C, 2] sums over its R pixel rows, pairwise in a fixed
  // order (row i takes row i + h, h halving), so that a sum's rounding
  // grows with log R and not with R (up to 256 rows at C = 8)
  const int row = a.G * 16;
  for (int rows = a.R; rows > 1;) {
    const int h = (rows + 1) / 2;
    for (int t = threadIdx.x; t < (rows - h) * row; t += blockDim.x)
      sm[t] += sm[t + h * row];
    __syncthreads();
    rows = h;
  }
  float* part = a.partials + ((size_t)n * a.S + s) * 2 * C;
  for (int t = threadIdx.x; t < 2 * C; t += blockDim.x) {
    const int c = t >> 1;
    part[t] = sm[(c / VEC) * 16 + (t & 1) * VEC + c % VEC];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(a.tickets + n, 1u) == (unsigned int)(a.S - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  finish<T>(a, n, xn, sm);
}

template <typename T, bool WIDE, bool ELU>
__global__ void __launch_bounds__(2 * BLOCK)
instnorm_apply_kernel(const Args a) {
  const int n = a.N - 1 - (int)blockIdx.y, s = blockIdx.x;
  const int g = threadIdx.x % a.G, r = threadIdx.x / a.G;
  if (r >= a.R) return;
  const int C = a.C, c0 = VEC * g, nc = min(VEC, C - c0);
  float A[VEC], B[VEC];
  const float2* ab = a.ab + (size_t)n * C + c0;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float2 t = j < nc ? ab[j] : make_float2(0.f, 0.f);
    A[j] = t.x;
    B[j] = t.y;
  }
  const size_t base = (size_t)n * a.HW * C + c0;
  const T* xn = static_cast<const T*>(a.x) + base;
  T* yn = static_cast<T*>(a.y) + base;
  int p, p1;
  slice(s, a.S, a.HW, &p, &p1);
  p += r;
  for (; p + (UNROLL - 1) * a.R < p1; p += UNROLL * a.R) {
    float v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      load8<WIDE>(xn + (size_t)(p + u * a.R) * C, nc, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float o = fmaf(v[u][j], A[j], B[j]);
        v[u][j] = ELU ? elu(o) : o;
      }
      store8<WIDE>(yn + (size_t)(p + u * a.R) * C, nc, v[u]);
    }
  }
  for (; p < p1; p += a.R) {
    float v[VEC];
    load8<WIDE>(xn + (size_t)p * C, nc, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float o = fmaf(v[j], A[j], B[j]);
      v[j] = ELU ? elu(o) : o;
    }
    store8<WIDE>(yn + (size_t)p * C, nc, v);
  }
}

// a block's threads for C channels: R pixel rows of G channel groups, a
// whole number of warps; and the statistics pass's shared memory
void geometry(int C, int* G, int* R, int* threads, size_t* smem) {
  *G = (C + VEC - 1) / VEC;
  *R = *G >= BLOCK ? 1 : BLOCK / *G;
  *threads = (*G * *R + 31) / 32 * 32;
  *smem = sizeof(float) * (16 * *threads + *threads / 32);
}

template <typename T, bool WIDE>
void launch(const Args& a, int threads, size_t smem, bool elu,
            cudaStream_t s) {
  const dim3 grid(a.S, a.N);
  instnorm_stats_kernel<T, WIDE><<<grid, threads, smem, s>>>(a);
  if (elu)
    instnorm_apply_kernel<T, WIDE, true><<<grid, threads, 0, s>>>(a);
  else
    instnorm_apply_kernel<T, WIDE, false><<<grid, threads, 0, s>>>(a);
}

}  // namespace

extern "C" int instnorm_plus_fwd(const void* x, void* y, const void* labels,
                                 const void* gamma, const void* alpha,
                                 const void* beta, const void* in_gamma,
                                 const void* in_beta, void* scratch,
                                 int N, int C, int HW, int K,
                                 int bf16, int slices, int elu,
                                 void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (N < 0 || N > 65535 || C < 1 || C > MAXC || HW < 1 || K < 1 ||
      slices < 1 || slices > HW || !x || !y || !gamma || !alpha ||
      !in_gamma || !in_beta || !scratch)
    return bad;
  if (N == 0) return (int)cudaSuccess;
  Args a;
  a.x = x; a.y = y;
  a.labels = static_cast<const long long*>(labels);
  a.gamma = static_cast<const float*>(gamma);
  a.alpha = static_cast<const float*>(alpha);
  a.beta = static_cast<const float*>(beta);
  a.in_gamma = static_cast<const float*>(in_gamma);
  a.in_beta = static_cast<const float*>(in_beta);
  a.partials = static_cast<float*>(scratch);
  a.ab = reinterpret_cast<float2*>(a.partials +
                                   (size_t)N * slices * 2 * C);
  a.tickets = reinterpret_cast<unsigned int*>(a.ab + (size_t)N * C);
  a.N = N; a.C = C; a.HW = HW; a.K = K; a.S = slices;
  int threads;
  size_t smem;
  geometry(C, &a.G, &a.R, &threads, &smem);
  const bool wide = C % VEC == 0 && ((uintptr_t)x | (uintptr_t)y) % 16 == 0;
  // ab (float2) must be 8-byte aligned
  if ((uintptr_t)a.ab % 8) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed =
      cudaMemsetAsync(a.tickets, 0, (size_t)N * sizeof(unsigned int), s);
  if (zeroed != cudaSuccess) return (int)zeroed;
  if (bf16) {
    if (wide) launch<__nv_bfloat16, true>(a, threads, smem, elu, s);
    else launch<__nv_bfloat16, false>(a, threads, smem, elu, s);
  } else {
    if (wide) launch<float, true>(a, threads, smem, elu, s);
    else launch<float, false>(a, threads, smem, elu, s);
  }
  return (int)cudaGetLastError();
}

// the statistics pass's blocks an SM holds at once for C channels (its
// registers and shared memory), or -1 for a C it does not take
extern "C" int instnorm_plus_blocks_per_sm(int C, int bf16) {
  if (C < 1 || C > MAXC) return -1;
  int G, R, threads, blocks = 0;
  size_t smem;
  geometry(C, &G, &R, &threads, &smem);
  const cudaError_t err =
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, instnorm_stats_kernel<__nv_bfloat16, true>,
                 threads, smem)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, instnorm_stats_kernel<float, true>, threads, smem);
  return err == cudaSuccess ? blocks : -1;
}
