// The NCSN score nets' pools for Hopper (sm_90a), over x kept in
// channels_last memory (physically NHWC), bf16 or float32:
//
//   avg5: 5x5 stride-1 SAME average over the valid taps only
//         (count_include_pad=False), the v1 CRP blocks' pool;
//   max5: 5x5 stride-1 SAME max (taps outside the image never win), the v2
//         CRP blocks' pool;
//   avg2: 2x2 stride-2 VALID average, the residual blocks' downsampling.
//
// Replaces: no kernel of the JAX package. There the pools are
// jax.lax.reduce_window calls (audiosourcesep_tpu/nn.py: avg_pool_same,
// max_pool_same, avg_pool2) that XLA compiles on the TPU; the port ran
// PyTorch's pools (F.avg_pool2d, F.max_pool2d) on the card, where each
// output makes its own 25 reads and max_pool2d also writes an int64 index
// an output. They took a fifth of an NCSN separation step's device time.
//
// What bounds it on this card: bytes. A pool reads x once and writes y
// once; a v1 separation step's pools move ~2.0 GB, ~0.6 ms at 3.35 TB/s.
//
// What the design does about it:
// - avg5 / max5 (one kernel, templated on the mode): a block is one
//   sample's strip of `rows` output rows by a tile of TW columns (the whole
//   width up to 128) by a slab of G groups of 8 channels; a thread owns one
//   column and one group (16-byte loads and stores). It walks down the
//   strip, keeping the last 5 input rows and the AHEAD rows in flight in a
//   register ring, so each element is read from DRAM once (a strip re-reads
//   its 4 halo rows, a column tile its 4 halo columns). Each row it reduces
//   its column's 5 rows, top to bottom, into a shared-memory row
//   (double-buffered, in planes of 16 bytes a thread so that a warp's
//   accesses meet no bank conflict), syncs once, reduces the 5 columns left
//   to right and stores the row. Taps outside the image are the
//   reduction's identity (0, or -inf for max); the order of a sum is fixed
//   by the output's position alone, so a result does not depend on the
//   tiling. The kernel is bound by its instructions as much as by its
//   bytes, so each tap costs one instruction a channel or two: avg sums in
//   f32 and divides by the count of valid taps, as F.avg_pool2d does (a
//   reciprocal and one FMA correction, exact), rounding once to x's dtype;
//   max takes PTX's NaN-propagating max (NaN wins, as in F.max_pool2d) on
//   x's own values, a bf16 pair at a time, and writes no indices. The
//   wrapper sizes the strips so that the grid fills whole waves of the card
//   (ops/pool.py).
// - avg2: a thread reads the 2x2 window's four 16-byte vectors and writes
//   one, summed in F.avg_pool2d's order from 0 in f32 and multiplied by
//   0.25 (its division by 4, exactly), so it equals F.avg_pool2d bit for
//   bit.
// A channel count that is not a multiple of 8, or x or y not 16-byte
// aligned, takes the same kernels with element loads.
//
// C interface (bound with ctypes):
//   pool5_fwd(x, y, N, H, W, C, mode, bf16, G, TW, rows, stream): x, y
//     [N, H, W, C] in x's dtype (bf16 when `bf16`, else float32); mode 0
//     avg, 1 max; G channel groups, TW output columns and `rows` output rows
//     a block.
//   pool5_blocks_per_sm(mode, bf16, W, G, TW): the blocks of that shape an
//     SM holds at once (its registers and shared memory), or -1.
//   avg_pool2_fwd(x, y, N, H, W, C, bf16, stream): y [N, H/2, W/2, C].
// Each launches on `stream`, allocates nothing and returns the first CUDA
// error, or cudaErrorInvalidValue for a call it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;              // channels a thread owns
constexpr int WIN = 5;              // the SAME pools' window
constexpr int REACH = WIN / 2;      // taps on each side
constexpr int AHEAD = 2;            // rows loaded ahead of those reduced
constexpr int RING = WIN + AHEAD;   // rows a thread holds
constexpr int MAX_THREADS = 256;    // threads a block
constexpr int MAX_SMEM = 48 * 1024; // shared memory a block, bytes
constexpr int MAX_N = 65535;        // samples (the grid's y)
constexpr int POOL2_THREADS = 256;
enum { AVG = 0, MAX = 1 };

// 8 channels of x in x's own encoding
template <typename T>
struct Vec {
  static constexpr int WORDS = (int)sizeof(T) * VEC / 4;
  uint32_t w[WORDS];
};

// the reduction's identity in T's bits: 0, or -inf for max
template <typename T, int MODE>
__device__ __forceinline__ Vec<T> identity() {
  Vec<T> v;
  const uint32_t bits =
      MODE == AVG ? 0u : (sizeof(T) == 2 ? 0xff80ff80u : 0xff800000u);
#pragma unroll
  for (int i = 0; i < Vec<T>::WORDS; ++i) v.w[i] = bits;
  return v;
}

// 8 channels at p (nc of them real; the others keep `fill`)
template <typename T, bool WIDE>
__device__ __forceinline__ Vec<T> load(const T* p, int nc,
                                       const Vec<T>& fill) {
  Vec<T> v = fill;
  if constexpr (WIDE) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < Vec<T>::WORDS / 4; ++i) {
      const uint4 r = __ldg(q + i);
      v.w[4 * i] = r.x; v.w[4 * i + 1] = r.y;
      v.w[4 * i + 2] = r.z; v.w[4 * i + 3] = r.w;
    }
  } else if constexpr (sizeof(T) == 2) {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (j < nc) {
        const int s = 16 * (j & 1);
        v.w[j >> 1] = (v.w[j >> 1] & ~(0xffffu << s)) |
                      ((uint32_t)__ldg(q + j) << s);
      }
  } else {
    const unsigned int* q = reinterpret_cast<const unsigned int*>(p);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (j < nc) v.w[j] = __ldg(q + j);
  }
  return v;
}

template <typename T>
__device__ __forceinline__ void unpack(const Vec<T>& v, float f[VEC]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of an f32
      f[2 * i] = __uint_as_float(v.w[i] << 16);
      f[2 * i + 1] = __uint_as_float(v.w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = __uint_as_float(v.w[i]);
  }
}

// f rounded once to x's dtype, stored at p (nc channels)
template <bool WIDE>
__device__ __forceinline__ void store(__nv_bfloat16* p, int nc,
                                      const float f[VEC]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  if constexpr (WIDE) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    unsigned short* q = reinterpret_cast<unsigned short*>(p);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (j < nc) q[j] = (unsigned short)(w[j >> 1] >> (16 * (j & 1)));
  }
}

template <bool WIDE>
__device__ __forceinline__ void store(float* p, int nc, const float f[VEC]) {
  if constexpr (WIDE) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (j < nc) p[j] = f[j];
  }
}

// A 5x5 pool reduces `Row`s: 8 channels as f32 sums (avg), or as x's own
// values (max), which a bf16 max keeps packed in pairs. A shared-memory
// entry is a Row, in PLANES planes of 16 bytes.
template <typename T, int MODE>
struct Row {
  static constexpr bool PACKED = MODE == MAX && sizeof(T) == 2;
  static constexpr int WORDS = PACKED ? VEC / 2 : VEC;
  static constexpr int PLANES = WORDS / 4;
  uint32_t w[WORDS];
};

// the reduction's identity as a word of a Row
template <typename T, int MODE>
__device__ __forceinline__ uint32_t identity_word() {
  return MODE == AVG ? 0u : (Row<T, MODE>::PACKED ? 0xff80ff80u : 0xff800000u);
}

// a row of x as a Row
template <typename T, int MODE>
__device__ __forceinline__ Row<T, MODE> prep(const Vec<T>& v) {
  Row<T, MODE> r;
  if constexpr (Row<T, MODE>::PACKED) {
#pragma unroll
    for (int i = 0; i < Row<T, MODE>::WORDS; ++i) r.w[i] = v.w[i];
  } else {
    float f[VEC];
    unpack(v, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) r.w[i] = __float_as_uint(f[i]);
  }
  return r;
}

// a = a reduced with b, word by word: the f32 sum, or the max (NaN
// propagates, as in F.max_pool2d)
template <typename T, int MODE>
__device__ __forceinline__ void reduce(Row<T, MODE>& a,
                                       const Row<T, MODE>& b) {
#pragma unroll
  for (int i = 0; i < Row<T, MODE>::WORDS; ++i) {
    if constexpr (MODE == AVG) {
      a.w[i] = __float_as_uint(__uint_as_float(a.w[i]) +
                               __uint_as_float(b.w[i]));
    } else if constexpr (Row<T, MODE>::PACKED) {
      uint32_t d;
      asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a.w[i]), "r"(b.w[i]));
      a.w[i] = d;
    } else {
      float d;
      asm("max.NaN.f32 %0, %1, %2;"
          : "=f"(d)
          : "f"(__uint_as_float(a.w[i])), "f"(__uint_as_float(b.w[i])));
      a.w[i] = __float_as_uint(d);
    }
  }
}

// |s| below which s / count (count <= 25) may be subnormal
constexpr float TINY = 0x1p-121f;

// s / count, rounded once to f32, for |s| >= TINY: the quotient by the
// reciprocal, corrected once by its remainder (exact in an FMA); rc is
// 1 / count rounded to nearest. It equals IEEE division there for every
// float32 s and count 1..25 (chip_smoke.py --pool checks all 2^32 s on the
// card); s infinite or NaN keeps s * rc, as s / count does. (Below TINY a
// subnormal quotient can be a tie, which the correction does not round to
// even.)
__device__ __forceinline__ float quotient(float s, float count, float rc) {
  const float q = s * rc;
  const float e = fmaf(-q, count, s);
  const float q1 = fmaf(e, rc, q);
  return e != e ? q : q1;
}

// v / count for 8 sums: by quotient(), or by IEEE division where one of
// them is below TINY (rare: a row of zeros, or of subnormal sums)
__device__ __forceinline__ void divide(uint32_t v[VEC], int count) {
  float f[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = __uint_as_float(v[i]);
  float least = fabsf(f[0]);
#pragma unroll
  for (int i = 1; i < VEC; ++i) least = fminf(least, fabsf(f[i]));
  const float c = (float)count;
  if (least < TINY) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = f[i] / c;
  } else {
    const float rc = __frcp_rn(c);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = quotient(f[i], c, rc);
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = __float_as_uint(f[i]);
}

// the taps of a SAME window of WIN at i that lie in [0, n)
__device__ __forceinline__ int valid(int i, int n) {
  return min(i + REACH, n - 1) - max(i - REACH, 0) + 1;
}

// a Row's result in x's dtype at p (nc channels)
template <typename T, int MODE, bool WIDE>
__device__ __forceinline__ void put(T* p, int nc, const Row<T, MODE>& r) {
  if constexpr (Row<T, MODE>::PACKED) {
    // x's own bf16 values, in pairs
    if constexpr (WIDE) {
      *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2],
                                                r.w[3]);
    } else {
      unsigned short* q = reinterpret_cast<unsigned short*>(p);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (j < nc) q[j] = (unsigned short)(r.w[j >> 1] >> (16 * (j & 1)));
    }
  } else {
    float f[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = __uint_as_float(r.w[i]);
    store<WIDE>(p, nc, f);
  }
}

struct Args {
  const void* x;
  void* y;
  int N, H, W, C;
  int G;       // channel groups a block
  int TW;      // output columns a block
  int span;    // TW + 2 REACH: the shared row's entries
  int rows;    // output rows a block
  int slabs, tiles, strips;
};

template <typename T, int MODE, bool WIDE>
__global__ void __launch_bounds__(MAX_THREADS, 1) pool5_kernel(const Args a) {
  using R = Row<T, MODE>;
  constexpr int P = R::PLANES;
  // [2 buffers][P planes of 16 bytes][span][G]
  extern __shared__ uint4 sm[];
  int b = blockIdx.x;
  const int slab = b % a.slabs;
  b /= a.slabs;
  const int tile = b % a.tiles;
  const int strip = b / a.tiles;
  const int n = blockIdx.y;
  const int g = threadIdx.x % a.G;
  const int j = threadIdx.x / a.G;
  const int c0 = (slab * a.G + g) * VEC;
  const int nc = min(VEC, a.C - c0);
  const int w0 = tile * a.TW;                      // first output column
  const int e0 = w0 - REACH;                       // column of entry 0
  const int wlo = max(e0, 0);
  const int whi = min(w0 + a.TW + REACH, a.W);     // columns read: [wlo, whi)
  const int w = wlo + j;                           // this thread's column
  const bool reads = w < whi && nc > 0;
  const bool writes = reads && w >= w0 && w < w0 + a.TW;
  const int r0 = strip * a.rows;
  const int r1 = min(r0 + a.rows, a.H);            // output rows [r0, r1)
  const int last = reads ? min(r1 + REACH, a.H) : 0;  // input rows < last
  const int plane = a.span * a.G;                  // uint4s a plane

  // entries of columns outside the image hold the identity in both buffers
  const uint32_t id = identity_word<T, MODE>();
  for (int t = threadIdx.x; t < a.span * a.G; t += blockDim.x) {
    const int col = e0 + t / a.G;
    if (col < 0 || col >= a.W)
#pragma unroll
      for (int p = 0; p < 2 * P; ++p)
        sm[p * plane + t] = make_uint4(id, id, id, id);
  }

  const size_t pitch = (size_t)a.W * a.C;          // elements a row
  const size_t at = (size_t)n * a.H * pitch + (size_t)w * a.C + c0;
  const T* xc = static_cast<const T*>(a.x) + at;
  T* yp = static_cast<T*>(a.y) + at + (size_t)r0 * pitch;
  const Vec<T> ident = identity<T, MODE>();
  // shared entries: this column's (written), the window's first (read)
  const int ew = (w - e0) * a.G + g;
  const int er = (w - w0) * a.G + g;
  // avg: this column's valid taps
  const int cw = valid(w, a.W);

  // input row i in slot (i - r0 + REACH) % RING of the ring
  Vec<T> raw[RING];
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    const int i = r0 - REACH + s;
    raw[s] = i >= 0 && i < last
                 ? load<T, WIDE>(xc + (size_t)i * pitch, nc, ident)
                 : ident;
  }
  // the next row to load, and where
  int q = r0 + REACH + AHEAD;
  const T* xq = xc + (size_t)q * pitch;

  for (int r = r0; r < r1; r += RING) {
    const int flip = (r - r0) & 1;
#pragma unroll
    for (int k = 0; k < RING; ++k) {
      const int row = r + k;
      if (row >= r1) break;
      raw[(k + RING - 1) % RING] =
          q < last ? load<T, WIDE>(xq, nc, ident) : ident;
      ++q;
      xq += pitch;
      uint4* s = sm + ((k & 1) ^ flip) * P * plane;
      // rows row - 2 .. row + 2, top to bottom
      R acc = prep<T, MODE>(raw[k % RING]);
#pragma unroll
      for (int t = 1; t < WIN; ++t)
        reduce<T, MODE>(acc, prep<T, MODE>(raw[(k + t) % RING]));
      if (reads)
#pragma unroll
        for (int p = 0; p < P; ++p)
          s[p * plane + ew] = make_uint4(acc.w[4 * p], acc.w[4 * p + 1],
                                         acc.w[4 * p + 2], acc.w[4 * p + 3]);
      __syncthreads();
      if (writes) {
        // columns w - 2 .. w + 2, left to right
#pragma unroll
        for (int t = 0; t < WIN; ++t) {
          R tap;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const uint4 u = s[p * plane + er + t * a.G];
            tap.w[4 * p] = u.x; tap.w[4 * p + 1] = u.y;
            tap.w[4 * p + 2] = u.z; tap.w[4 * p + 3] = u.w;
          }
          if (t == 0) acc = tap;
          else reduce<T, MODE>(acc, tap);
        }
        if constexpr (MODE == AVG) divide(acc.w, valid(row, a.H) * cw);
        put<T, MODE, WIDE>(yp, nc, acc);
      }
      yp += pitch;
    }
  }
}

template <typename T, bool WIDE>
__global__ void __launch_bounds__(POOL2_THREADS)
avg_pool2_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W,
                 int C) {
  const int groups = (C + VEC - 1) / VEC;
  const int Wo = W / 2, Ho = H / 2;
  const int t = blockIdx.x * POOL2_THREADS + threadIdx.x;
  if (t >= Wo * groups) return;
  const int g = t % groups, wo = t / groups;
  const int ho = blockIdx.y, n = blockIdx.z;
  const int c0 = g * VEC, nc = min(VEC, C - c0);
  const size_t pitch = (size_t)W * C;
  const T* p = x + ((size_t)n * H + 2 * ho) * pitch + (size_t)(2 * wo) * C +
               c0;
  const Vec<T> zero = identity<T, AVG>();
  const Vec<T> v[4] = {load<T, WIDE>(p, nc, zero),
                       load<T, WIDE>(p + C, nc, zero),
                       load<T, WIDE>(p + pitch, nc, zero),
                       load<T, WIDE>(p + pitch + C, nc, zero)};
  float s[VEC], f[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    unpack(v[k], f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) s[i] += f[i];
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] *= 0.25f;
  store<WIDE>(y + (((size_t)n * Ho + ho) * Wo + wo) * C + c0, nc, s);
}

// a block's geometry for W columns, G groups and TW output columns: its
// threads and shared memory, or false for one the kernel does not take
bool geometry(int W, int G, int TW, int* threads, int* span, size_t* smem) {
  if (W < 1 || G < 1 || TW < 1) return false;
  const int tw = min(TW, W);
  const int cols = min(W, tw + 2 * REACH);
  *threads = (cols * G + 31) / 32 * 32;
  *span = tw + 2 * REACH;
  // two buffers of two planes (one, for a bf16 max, uses half)
  *smem = sizeof(uint4) * 4 * (size_t)*span * G;
  return *threads <= MAX_THREADS && *smem <= (size_t)MAX_SMEM;
}

template <typename T, int MODE, bool WIDE>
cudaError_t launch5(const Args& a, int threads, size_t smem,
                    cudaStream_t s) {
  const dim3 grid(a.slabs * a.tiles * a.strips, a.N);
  pool5_kernel<T, MODE, WIDE><<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch5(const Args& a, bool wide, int threads, size_t smem,
                    cudaStream_t s) {
  return wide ? launch5<T, MODE, true>(a, threads, smem, s)
              : launch5<T, MODE, false>(a, threads, smem, s);
}

template <typename T>
int occupancy(int mode, int threads, size_t smem) {
  int blocks = 0;
  const cudaError_t err =
      mode == AVG ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &blocks, pool5_kernel<T, AVG, true>, threads, smem)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &blocks, pool5_kernel<T, MAX, true>, threads, smem);
  return err == cudaSuccess ? blocks : -1;
}

bool aligned(const void* x, const void* y) {
  return ((uintptr_t)x | (uintptr_t)y) % 16 == 0;
}

}  // namespace

extern "C" int pool5_fwd(const void* x, void* y, int N, int H, int W, int C,
                         int mode, int bf16, int G, int TW, int rows,
                         void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  int threads, span;
  size_t smem;
  if (N < 0 || N > MAX_N || H < 1 || C < 1 || rows < 1 ||
      (mode != AVG && mode != MAX) || !x || !y ||
      !geometry(W, G, TW, &threads, &span, &smem))
    return bad;
  if (N == 0) return (int)cudaSuccess;
  Args a;
  a.x = x; a.y = y;
  a.N = N; a.H = H; a.W = W; a.C = C;
  a.G = G; a.TW = min(TW, W); a.span = span; a.rows = min(rows, H);
  a.slabs = ((C + VEC - 1) / VEC + G - 1) / G;
  a.tiles = (W + a.TW - 1) / a.TW;
  a.strips = (H + a.rows - 1) / a.rows;
  if ((long long)a.slabs * a.tiles * a.strips > 0x7fffffffLL) return bad;
  const bool wide = C % VEC == 0 && aligned(x, y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)(mode == AVG
                     ? launch5<__nv_bfloat16, AVG>(a, wide, threads, smem, s)
                     : launch5<__nv_bfloat16, MAX>(a, wide, threads, smem, s));
  return (int)(mode == AVG ? launch5<float, AVG>(a, wide, threads, smem, s)
                           : launch5<float, MAX>(a, wide, threads, smem, s));
}

extern "C" int pool5_blocks_per_sm(int mode, int bf16, int W, int G,
                                   int TW) {
  int threads, span;
  size_t smem;
  if ((mode != AVG && mode != MAX) || !geometry(W, G, TW, &threads, &span,
                                                &smem))
    return -1;
  return bf16 ? occupancy<__nv_bfloat16>(mode, threads, smem)
              : occupancy<float>(mode, threads, smem);
}

extern "C" int avg_pool2_fwd(const void* x, void* y, int N, int H, int W,
                             int C, int bf16, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (N < 0 || N > MAX_N || H < 0 || H / 2 > MAX_N || W < 0 || C < 1 ||
      !x || !y)
    return bad;
  const long long per_row = (long long)(W / 2) * ((C + VEC - 1) / VEC);
  if (per_row > 0x7fffffffLL - POOL2_THREADS) return bad;
  if (N == 0 || H < 2 || W < 2) return (int)cudaSuccess;
  const dim3 grid((unsigned)((per_row + POOL2_THREADS - 1) / POOL2_THREADS),
                  H / 2, N);
  const bool wide = C % VEC == 0 && aligned(x, y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
    if (wide)
      avg_pool2_kernel<__nv_bfloat16, true><<<grid, POOL2_THREADS, 0, s>>>(
          xb, yb, H, W, C);
    else
      avg_pool2_kernel<__nv_bfloat16, false><<<grid, POOL2_THREADS, 0, s>>>(
          xb, yb, H, W, C);
  } else {
    const float* xf = static_cast<const float*>(x);
    float* yf = static_cast<float*>(y);
    if (wide)
      avg_pool2_kernel<float, true><<<grid, POOL2_THREADS, 0, s>>>(xf, yf, H,
                                                                   W, C);
    else
      avg_pool2_kernel<float, false><<<grid, POOL2_THREADS, 0, s>>>(xf, yf, H,
                                                                    W, C);
  }
  return (int)cudaGetLastError();
}
