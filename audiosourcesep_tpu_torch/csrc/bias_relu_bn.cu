// bias -> ReLU -> frozen BatchNorm for Hopper (sm_90a): the Glow coupling
// nets' activation chain after each of their first two convs, as one kernel
// forward and one for the input gradient, over tensors kept in
// channels_last memory (physically NHWC), bf16 or float32.
//
// Replaces: no kernel of the JAX package. There the chain is plain jnp code
// (audiosourcesep_tpu/bijectors/nets.py, audiosourcesep_tpu/nn.py:
// frozen_batchnorm) that XLA fuses on the TPU; the port ran it as PyTorch
// elementwise ops: the conv's bias add, relu, the norm's multiply and add
// (and three small launches forming its scale), and autograd's broadcast
// multiply and threshold_backward for the input gradient, each a pass over
// a 512-channel f32 tensor (94 MB at a separation's first Glow level).
//
//   forward:  y  = fl(fl(max_relu(fl(h + b)) * g) + beta)
//   gradient: gh = fl(h + b) <= 0 ? 0 : fl(gy * g)
//
// with b the conv's bias, g = fl(gamma * fl(rsqrt(1 + eps))) the norm's
// scale and beta its shift, per channel, and fl() rounding to the tensor's
// dtype after every operation, as the PyTorch ops do one by one. The adds
// and multiplies are __fadd_rn / __fmul_rn, so that nothing is contracted
// into an FMA, and max_relu keeps NaN and otherwise takes fmaxf(v, 0), as
// torch.relu (clamp_min) does: the results equal the PyTorch ops' bit for
// bit. The gradient's mask is the relu's: fl(h + b) <= 0 exactly where the
// relu's result is <= 0 (NaN passes the gradient through in both).
//
// What bounds it on this card: bytes. The forward reads h and writes y, the
// gradient reads gy and h and writes gh: 2 and 3 touches of each element
// against 8 and 5 for the PyTorch ops.
//
// What the design does about it:
// - forward and NHWC gradient: a block of G channel groups x R rows
//   (G x R <= 256 threads); a thread owns the 16 bytes of one group (4
//   channels in f32, 8 in bf16), loads their b, g, beta once, and walks the
//   rows of the tensor R x gridDim.x apart, UNROLL rows in flight, so that
//   each load or store of a warp covers 512 contiguous bytes. The grid
//   holds the blocks the card keeps resident at once (the wrapper sizes
//   it), so every block walks an equal share and no wave is left part full.
// - NCHW gradient (gy in NCHW memory, as a conv's input gradient may come):
//   a block reads a tile of 128 channels x 32 pixels of gy along the pixels
//   (a warp 8 pixels of 4 channels: whole 32-byte sectors), transposes it
//   through shared memory (pixel-major, padded so that neither pass meets a
//   bank conflict), and each warp then reads h and writes gh NHWC along the
//   channels, 512 contiguous bytes an access; no copy of gy is made.
// A channel count that is not a multiple of a group, or a pointer not
// 16-byte aligned, takes the same kernels with element loads.
//
// C interface (bound with ctypes):
//   bias_relu_bn_fwd(h, p, y, N, HW, C, bf16, blocks, stream): h, y
//     [N, HW, C] in h's dtype (bf16 when `bf16`, else float32); p [3, C] in
//     the same dtype, the rows b, g, beta; `blocks` the grid's row blocks.
//   bias_relu_bn_bwd(gy, h, p, gh, N, HW, C, gy_nchw, bf16, blocks,
//     stream): gh [N, HW, C]; gy [N, HW, C], or [N, C, HW] when `gy_nchw`
//     (`blocks` then unused).
//   bias_relu_bn_blocks_per_sm(kind, bf16, threads): the blocks of
//     `threads` threads of the forward (kind 0) or the NHWC gradient
//     (kind 1) an SM holds at once, or -1.
// Each launches on `stream`, allocates nothing and returns the first CUDA
// error, or cudaErrorInvalidValue for a call it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BYTES = 16;        // bytes of a thread's access
constexpr int THREADS = 256;     // threads a block, at most
constexpr int UNROLL = 4;        // rows a thread has in flight
constexpr int TP = 32;           // pixels of a transpose tile
constexpr int TC = 128;          // its channels
constexpr int PITCH = TC + 4;    // floats a pixel of the tile in shared memory
constexpr int MAX_N = 65535;     // samples (the transpose grid's z)
enum { FWD = 0, BWD = 1 };

// channels of a thread's group: 16 bytes of T
template <typename T>
constexpr int V = BYTES / (int)sizeof(T);

// v rounded to T and back (the PyTorch op's result in T)
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a group of channels at p as floats (nc of them real; the others 0)
template <typename T, bool WIDE>
__device__ __forceinline__ void load(const T* p, int nc, float f[V<T>]) {
  if constexpr (WIDE && sizeof(T) == 2) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of an f32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else if constexpr (WIDE) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  } else {
#pragma unroll
    for (int j = 0; j < V<T>; ++j) f[j] = j < nc ? to_float(p[j]) : 0.f;
  }
}

// f rounded once to T, stored at p (nc channels)
template <bool WIDE>
__device__ __forceinline__ void store(__nv_bfloat16* p, int nc,
                                      const float f[8]) {
  if constexpr (WIDE) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < nc) p[j] = __float2bfloat16_rn(f[j]);
  }
}

template <bool WIDE>
__device__ __forceinline__ void store(float* p, int nc, const float f[4]) {
  if constexpr (WIDE) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nc) p[j] = f[j];
  }
}

// y = fl(fl(relu(fl(h + b)) * g) + beta), the last rounding by the store
template <typename T>
__device__ __forceinline__ float forward(float h, float b, float g,
                                         float beta) {
  float t = rnd<T>(__fadd_rn(h, b));
  t = isnan(t) ? t : fmaxf(t, 0.f);
  return __fadd_rn(rnd<T>(__fmul_rn(t, g)), beta);
}

// gh = fl(h + b) <= 0 ? 0 : fl(gy * g), the rounding by the store
template <typename T>
__device__ __forceinline__ float gradient(float gy, float h, float b,
                                          float g) {
  return rnd<T>(__fadd_rn(h, b)) <= 0.f ? 0.f : __fmul_rn(gy, g);
}

// a block of the row kernels for C channels of T: G groups x R rows
template <typename T>
__host__ __device__ inline void block_shape(int C, int* G, int* R) {
  const int groups = (C + V<T> - 1) / V<T>;
  *G = groups < THREADS ? groups : THREADS;
  *R = THREADS / *G;
}

// forward (KIND FWD: a = h, b unused, out = y) or NHWC gradient (KIND BWD:
// a = gy, b = h, out = gh) over M rows of C channels
template <typename T, int KIND, bool WIDE>
__global__ void __launch_bounds__(THREADS)
brbn_rows_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const T* __restrict__ p, T* __restrict__ out, long long M,
                 int C) {
  constexpr int VT = V<T>;
  int G, R;
  block_shape<T>(C, &G, &R);
  const int c0 = (blockIdx.y * G + threadIdx.x % G) * VT;
  if (c0 >= C) return;
  const int nc = min(VT, C - c0);
  float bias[VT], scale[VT], shift[VT];
  load<T, WIDE>(p + c0, nc, bias);
  load<T, WIDE>(p + C + c0, nc, scale);
  if constexpr (KIND == FWD) load<T, WIDE>(p + 2 * C + c0, nc, shift);
  const long long step = (long long)gridDim.x * R;
  for (long long m = (long long)blockIdx.x * R + threadIdx.x / G; m < M;
       m += UNROLL * step) {
    float va[UNROLL][VT], vb[UNROLL][VT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long r = m + u * step;
      if (r < M) {
        load<T, WIDE>(a + r * C + c0, nc, va[u]);
        if constexpr (KIND == BWD) load<T, WIDE>(b + r * C + c0, nc, vb[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long r = m + u * step;
      if (r < M) {
        float o[VT];
#pragma unroll
        for (int i = 0; i < VT; ++i) {
          if constexpr (KIND == FWD)
            o[i] = forward<T>(va[u][i], bias[i], scale[i], shift[i]);
          else
            o[i] = gradient<T>(va[u][i], vb[u][i], bias[i], scale[i]);
        }
        store<WIDE>(out + r * C + c0, nc, o);
      }
    }
  }
}

// the gradient with gy in NCHW memory: a tile of TC channels x TP pixels of
// one sample, transposed through shared memory; gh NHWC
template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS)
brbn_grad_nchw_kernel(const T* __restrict__ gy, const T* __restrict__ h,
                      const T* __restrict__ p, T* __restrict__ gh, int HW,
                      int C) {
  constexpr int VT = V<T>;
  constexpr int LP = TC / VT;            // lanes a pixel (32 or 16)
  constexpr int PW = 32 / LP;            // pixels a warp's access (1 or 2)
  __shared__ __align__(16) float tile[TP * PITCH];
  const int n = blockIdx.z, q0 = blockIdx.x * TP, ct = blockIdx.y * TC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* g = gy + (size_t)n * C * HW;
  // along the pixels: a warp's access is 8 pixels of 4 channels, whole
  // sectors; the tile is pixel-major, PITCH apart, so that the 32 lanes
  // write 32 banks
#pragma unroll
  for (int j = 0; j < TC * TP / THREADS; ++j) {
    const int task = j * (THREADS / 32) + warp;
    const int q = (task % (TP / 8)) * 8 + lane % 8;
    const int c = (task / (TP / 8)) * 4 + lane / 8;
    tile[q * PITCH + c] = ct + c < C && q0 + q < HW
                              ? to_float(g[(size_t)(ct + c) * HW + q0 + q])
                              : 0.f;
  }
  __syncthreads();
  // along the channels: LP lanes a pixel, a lane VT channels (16 bytes of
  // h and gh), its b and g loaded once
  const int c = (lane % LP) * VT;
  if (ct + c >= C) return;
  const int nc = min(VT, C - ct - c);
  float bias[VT], scale[VT];
  load<T, WIDE>(p + ct + c, nc, bias);
  load<T, WIDE>(p + C + ct + c, nc, scale);
#pragma unroll
  for (int k = 0; k < TP / (THREADS / 32 * PW); ++k) {
    const int q = (k * (THREADS / 32) + warp) * PW + lane / LP;
    if (q0 + q >= HW) break;
    const size_t at = ((size_t)n * HW + q0 + q) * C + ct + c;
    float hv[VT], o[VT];
    load<T, WIDE>(h + at, nc, hv);
    const float4* t = reinterpret_cast<const float4*>(tile + q * PITCH + c);
#pragma unroll
    for (int i = 0; i < VT / 4; ++i) {
      const float4 v = t[i];
      const float gv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[4 * i + e] = gradient<T>(gv[e], hv[4 * i + e], bias[4 * i + e],
                                   scale[4 * i + e]);
    }
    store<WIDE>(gh + at, nc, o);
  }
}

template <typename T, int KIND>
cudaError_t launch_rows(const void* a, const void* b, const void* p,
                        void* out, long long M, int C, int blocks, bool wide,
                        cudaStream_t s) {
  int G, R;
  block_shape<T>(C, &G, &R);
  const dim3 grid(blocks,
                  (unsigned)(((C + V<T> - 1) / V<T> + G - 1) / G));
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  const T* tp = static_cast<const T*>(p);
  T* to = static_cast<T*>(out);
  if (wide)
    brbn_rows_kernel<T, KIND, true><<<grid, G * R, 0, s>>>(ta, tb, tp, to,
                                                            M, C);
  else
    brbn_rows_kernel<T, KIND, false><<<grid, G * R, 0, s>>>(ta, tb, tp, to,
                                                             M, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_nchw(const void* gy, const void* h, const void* p,
                        void* gh, int N, int HW, int C, bool wide,
                        cudaStream_t s) {
  const dim3 grid((unsigned)((HW + TP - 1) / TP),
                  (unsigned)((C + TC - 1) / TC), (unsigned)N);
  const T* tg = static_cast<const T*>(gy);
  const T* th = static_cast<const T*>(h);
  const T* tp = static_cast<const T*>(p);
  T* to = static_cast<T*>(gh);
  if (wide)
    brbn_grad_nchw_kernel<T, true><<<grid, THREADS, 0, s>>>(tg, th, tp, to,
                                                            HW, C);
  else
    brbn_grad_nchw_kernel<T, false><<<grid, THREADS, 0, s>>>(tg, th, tp, to,
                                                             HW, C);
  return cudaGetLastError();
}

bool aligned(const void* a, const void* b, const void* c, const void* d) {
  return ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d) % 16 ==
         0;
}

bool takes(int N, int HW, int C, int blocks) {
  return N >= 0 && N <= MAX_N && HW >= 0 && C >= 1 && blocks >= 1;
}

}  // namespace

extern "C" int bias_relu_bn_fwd(const void* h, const void* p, void* y, int N,
                                int HW, int C, int bf16, int blocks,
                                void* stream) {
  if (!takes(N, HW, C, blocks) || !h || !p || !y)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * HW;
  if (M == 0) return (int)cudaSuccess;
  const bool wide = C % (bf16 ? V<__nv_bfloat16> : V<float>) == 0 &&
                    aligned(h, p, y, y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_rows<__nv_bfloat16, FWD>(h, h, p, y, M, C,
                                                      blocks, wide, s)
                    : launch_rows<float, FWD>(h, h, p, y, M, C, blocks, wide,
                                              s));
}

extern "C" int bias_relu_bn_bwd(const void* gy, const void* h, const void* p,
                                void* gh, int N, int HW, int C, int gy_nchw,
                                int bf16, int blocks, void* stream) {
  if (!takes(N, HW, C, blocks) || !gy || !h || !p || !gh)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * HW;
  if (M == 0) return (int)cudaSuccess;
  const bool wide = C % (bf16 ? V<__nv_bfloat16> : V<float>) == 0 &&
                    aligned(gy, h, p, gh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gy_nchw)
    return (int)(bf16 ? launch_nchw<__nv_bfloat16>(gy, h, p, gh, N, HW, C,
                                                   wide, s)
                      : launch_nchw<float>(gy, h, p, gh, N, HW, C, wide, s));
  return (int)(bf16 ? launch_rows<__nv_bfloat16, BWD>(gy, h, p, gh, M, C,
                                                      blocks, wide, s)
                    : launch_rows<float, BWD>(gy, h, p, gh, M, C, blocks,
                                              wide, s));
}

extern "C" int bias_relu_bn_blocks_per_sm(int kind, int bf16, int threads) {
  if ((kind != FWD && kind != BWD) || threads < 1 || threads > THREADS)
    return -1;
  int blocks = 0;
  cudaError_t err;
  if (kind == FWD)
    err = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, brbn_rows_kernel<__nv_bfloat16, FWD, true>,
                     threads, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, brbn_rows_kernel<float, FWD, true>, threads,
                     0);
  else
    err = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, brbn_rows_kernel<__nv_bfloat16, BWD, true>,
                     threads, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, brbn_rows_kernel<float, BWD, true>, threads,
                     0);
  return err == cudaSuccess ? blocks : -1;
}
