// Fused Winograd F(2x2,3x3) convolution for Hopper (sm_90a), NHWC, float32
// on the CUDA cores, for dilation 1 and for the phase grids of a dilated
// conv.
//
// Replaces: audiosourcesep_tpu/ops/winograd.py::_wino_kernel (launched by
// _winograd_pallas, behind winograd_conv2d and dilated_winograd_conv2d) for
// float32 inputs; bf16 inputs go to the tensor-core kernel in
// winograd_mma.cu. Same math: a 3x3 stride-1 SAME conv computed per 2x2
// output tile as  Y = A^T [ sum_cin (G g G^T) . (B^T d B) ] A  with f32
// accumulation, exact f32 (FMA, no TF32). The bias is the caller's job.
//
// Dilation d: output pixel (d (2a + r) + p, d (2c + s) + q) of phase (p, q)
// reads only x[d (2a + i - 1) + p, d (2c + j - 1) + q], so each phase is a
// stride-1 SAME conv on its (H/d) x (W/d) grid. A block owns tiles of one
// phase and reads and writes them in place in the undilated NHWC tensors,
// with the SAME halo zero-filled per phase grid: no phase copy. d = 1 is
// the dense conv.
//
// What bounds it on this card: operations. The 16 transform-domain
// channel contractions are 16 * tiles * C_in * C_out FMAs (2.25x fewer than
// the direct conv) on the CUDA cores, 67 TFLOP/s at the published peak: the
// tensor cores have no full-f32 product. At 96x64 192->192, batch 30, that
// is 0.81 ms against 0.085 ms for x, y and U moved once at 3.35 TB/s.
//
// What the design does about it:
// - The 16 points are split across the 8 warps, two points a warp, and
//   each thread owns an 8-tile x 8-channel outer product per point (128
//   f32 accumulators). Per point and input channel it reads four 16-byte
//   values from shared memory for 64 FMAs. Its 8 tiles are tg*4.. and
//   16 + tg*4.., its 8 channels cg*4.. and 32 + cg*4.., so each 16-byte
//   read of a warp covers one contiguous run of shared memory (no bank
//   conflicts).
// - A block owns a rectangle of 32 tiles of one phase grid, 4 x 8 (8 x 4
//   for grids 4 tiles wide, which the wrapper picks: the cascade's d = 4
//   grid of 6 x 4 tiles then fills 75% of a block instead of 37.5%), and
//   64 output channels, and walks C_in in chunks of 8. Per chunk it copies
//   the 10 x 18-pixel (or 18 x 10) x slab and the U chunk [16][8][64] with
//   16-byte cp.async through a 3-stage ring; the SAME halo, the ragged grid
//   edge and channels past C_in or C_out are zero-filled by the copy's
//   source size, with no padded copy in HBM. V = B^T d B is formed once
//   per (tile, channel) and C_out block, one a thread, into a
//   double-buffered V.
// - One barrier per chunk, and nothing else between the FMAs: the loads,
//   adds and stores of the next chunk's transform and the issue of the
//   copies two chunks ahead are spread over the 16 FMA steps of a chunk
//   (run on their own, they took a quarter of each chunk's cycles).
// - Epilogue: each warp folds its two points into its row's share of
//   r_u = M[u,:] A, the 16 shares meet in 128 KB of shared memory (the
//   ring's), and Y = A^T r is written straight into the interleaved NHWC
//   output, 4 channels (16 bytes) a store.
// C_in or C_out that is not a multiple of 4 (begin_conv, end_conv) takes
// the same kernel with plain loads and stores in place of 16-byte ones.
//
// What still holds it back: 128 accumulators cap the block at 32 tiles x
// 64 channels (240-255 registers a thread), so one block of 8 warps runs
// per SM, and the FMAs issue in about two thirds of the loop's cycles
// (benchmarks/torch_winograd_probe.py, PERF.md). 16 warps of 64
// accumulators each fit only in 128 registers, and ran slower.
//
// C interface (bound with ctypes): winograd_f23_fwd_f32(x, u, y, B, H, W,
// Cin, Cout, d, block_rows, stream) with x [B,H,W,Cin], U [16,Cin,Cout] and
// y [B,H,W,Cout], all float32, and dilation d; H and W divisible by 2d;
// block_rows 4 or 8 (the tile rows of a block). It launches on `stream`,
// allocates nothing, and returns cudaGetLastError().
// winograd_f23_f32_smem_bytes() returns the dynamic shared memory a block
// takes.

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef WINOGRAD_PROBE
// Built only by benchmarks/torch_winograd_probe.py: clock64 cycles that each
// warp spends in each phase (the FMAs with the next chunk's transform and
// the copies between them, copy wait, barrier, epilogue), summed over
// blocks.
__device__ unsigned long long g_probe_f32[8][4];
#define PROBE(i)                               \
  do {                                         \
    const long long t_ = clock64();            \
    probe[i] += t_ - probe_t;                  \
    probe_t = t_;                              \
  } while (0)
#else
#define PROBE(i) \
  do {           \
  } while (0)
#endif

namespace {

constexpr int NTILE = 32;              // tiles per block
constexpr int NB = 64;                 // output channels per block
constexpr int KC = 8;                  // input channels per chunk
constexpr int NT = 256;                // 8 warps
constexpr int MAXDEV = 64;             // devices whose kernel limits are raised
constexpr int DEPTH = 3;               // x and U stages of the ring
constexpr int PIX = 48;                // bytes per slab pixel: 8 f32 + pad
constexpr int SLAB = 180;              // slab pixels: 10 x 18 or 18 x 10
constexpr int X_PIECES = SLAB * 2;     // 16-byte pieces per slab
constexpr int VROW = NTILE + 4;        // floats per (point, channel) of V
constexpr int V_BYTES = 16 * KC * VROW * 4;    // one V stage
constexpr int U_BYTES = 16 * KC * NB * 4;      // one U stage
constexpr int X_BYTES = SLAB * PIX;            // one x stage
constexpr int R_BYTES = 8 * 2 * NTILE * NB * 4;  // epilogue shares
constexpr int RING_BYTES = 2 * V_BYTES + DEPTH * (U_BYTES + X_BYTES);
constexpr int SMEM_BYTES = RING_BYTES > R_BYTES ? RING_BYTES : R_BYTES;

static_assert(NTILE * KC == NT, "one (tile, channel) V a thread per chunk");
static_assert(16 * KC * (NB / 4) == 8 * NT, "eight U pieces a thread");
static_assert(X_PIECES <= 2 * NT, "at most two x pieces a thread");
static_assert((2 * 4 + 2) * (2 * 8 + 2) == SLAB, "slab of a 4 x 8 block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_size 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// 4 floats from global memory, the first n of them real, the rest zero
__device__ __forceinline__ float4 load4(const float* src, int n) {
  return make_float4(n > 0 ? src[0] : 0.f, n > 1 ? src[1] : 0.f,
                     n > 2 ? src[2] : 0.f, n > 3 ? src[3] : 0.f);
}

// TR: tile rows of the block (4 or 8; 32 / TR tile columns)
// XV: C_in % 4 == 0 and x 16-byte aligned (x by cp.async, else plain loads)
// CV: C_out % 4 == 0 and U, y 16-byte aligned (U by cp.async, 16-byte
//     stores of y, else plain loads and stores)
template <int TR, bool XV, bool CV>
__global__ void __launch_bounds__(NT, 1)
    winograd_f23_f32_kernel(const float* __restrict__ x,
                            const float* __restrict__ u,
                            float* __restrict__ y, int H, int W, int Cin,
                            int Cout, int d, int n_trb, int n_tcb, int n_cb) {
  constexpr int TCOL = NTILE / TR;
  constexpr int SC = 2 * TCOL + 2;     // slab columns
  static_assert((2 * TR + 2) * SC == SLAB, "slab size");
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const Vs = smem;                  // [2][16][KC][VROW] f32
  unsigned char* const Us = Vs + 2 * V_BYTES;      // [DEPTH][16][KC][NB] f32
  unsigned char* const Xs = Us + DEPTH * U_BYTES;  // [DEPTH][SLAB][PIX B]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int bid = blockIdx.x;                // C_out block fastest: x from L2
  const int cb = bid % n_cb;
  bid /= n_cb;
  const int tcb = bid % n_tcb;
  bid /= n_tcb;
  const int trb = bid % n_trb;
  bid /= n_trb;
  const int phase = bid % (d * d), b = bid / (d * d);
  const int pr = phase / d, pc = phase % d;        // phase (row, column)
  const int gh = H / d, gw = W / d;                // phase grid, pixels
  const int th = gh >> 1, tw = gw >> 1;            // phase grid, tiles
  const int co0 = cb * NB, tr0 = trb * TR, tc0 = tcb * TCOL;
  const int n_chunks = (Cin + KC - 1) / KC;
  // pixel (r, c) of the phase grid is x[b, d r + pr, d c + pc]
  const float* const xb =
      x + (((long long)b * H + pr) * W + pc) * Cin;

  // ---- copy roles -------------------------------------------------------
  // x: pieces e = tid, tid + NT of the slab's (pixel, 4-channel half)
  const float* xsrc[2];
  uint32_t xdst[2];
  int xn[2];                           // real channels from the piece on
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = tid + r * NT;
    const int pix = e >> 1, sr = pix / SC, sc = pix % SC;
    const int gr = 2 * tr0 - 1 + sr, gc = 2 * tc0 - 1 + sc;
    const bool in = e < X_PIECES && gr >= 0 && gr < gh && gc >= 0 && gc < gw;
    xsrc[r] = in ? xb + ((long long)d * gr * W + (long long)d * gc) * Cin +
                       4 * (e & 1)
                 : x;
    xdst[r] = smem_u32(Xs) + pix * PIX + 16 * (e & 1);
    xn[r] = in ? Cin - 4 * (e & 1) : 0;   // outside the grid: zeros
  }
  // U: row k, 16-byte column c, points up0 + 2r (r < 8)
  const int uk = (tid >> 4) & (KC - 1), uc = tid & 15, up0 = tid >> 7;
  const int uco = co0 + 4 * uc;
  const int un = uco < Cout ? Cout - uco : 0;   // real channels of the piece
  const long long ustep = 2LL * Cin * Cout;
  const float* const usrc =
      un > 0 ? u + ((long long)up0 * Cin + uk) * Cout + uco : u;
  const uint32_t udst = smem_u32(Us) + (up0 * KC + uk) * (NB * 4) + 16 * uc;

  // piece r of chunk j's x -> x stage j % DEPTH; zeros past the last chunk
  auto copy_x = [&](int j, int r) {
    if (tid + r * NT >= X_PIECES) return;
    const int n = j < n_chunks ? xn[r] - j * KC : 0;  // real channels
    const uint32_t dst = xdst[r] + (j % DEPTH) * X_BYTES;
    if constexpr (XV) {
      cp_async16(dst, n > 0 ? xsrc[r] + j * KC : x, n > 0);
    } else {
      const float4 v = load4(xsrc[r] + j * KC, n);
      asm volatile("st.shared.v4.f32 [%0], {%1,%2,%3,%4};\n"
                   :: "r"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
                   : "memory");
    }
  };
  // points up0 + 2r of chunk j's U -> U stage j % DEPTH; zeros past the
  // last chunk
  auto copy_u = [&](int j, int r) {
    const bool ok = un > 0 && j < n_chunks && j * KC + uk < Cin;
    const float* src = usrc + (long long)j * KC * Cout + r * ustep;
    const uint32_t dst = udst + (j % DEPTH) * U_BYTES + r * 2 * KC * NB * 4;
    if constexpr (CV) {
      cp_async16(dst, ok ? src : u, ok);
    } else {
      const float4 v = load4(src, ok ? un : 0);
      asm volatile("st.shared.v4.f32 [%0], {%1,%2,%3,%4};\n"
                   :: "r"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
                   : "memory");
    }
  };

  // ---- transform role: tile t_tile, channel t_c ---------------------------
  const int t_tile = tid >> 3, t_c = tid & 7;
  const int t_src = ((2 * (t_tile / TCOL)) * SC + 2 * (t_tile % TCOL)) * PIX +
                    4 * t_c;
  const int t_dst = (t_c * VROW + t_tile) * 4;
  // in three parts, which the main loop spreads over its FMA steps:
  // row i of the 4x4 patch from x stage j % DEPTH, then B^T d, then row a
  // of (B^T d) B (points 4a .. 4a + 3) into V stage j & 1
  float dd[4][4], tt[4][4];
  auto t_load = [&](int j, int i) {
    const unsigned char* xs = Xs + (j % DEPTH) * X_BYTES + t_src;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dd[i][c] = *reinterpret_cast<const float*>(xs + (i * SC + c) * PIX);
  };
  auto t_bt = [&]() {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      tt[0][c] = dd[0][c] - dd[2][c];
      tt[1][c] = dd[1][c] + dd[2][c];
      tt[2][c] = dd[2][c] - dd[1][c];
      tt[3][c] = dd[1][c] - dd[3][c];
    }
  };
  auto t_store = [&](int j, int a) {
    float* vs = reinterpret_cast<float*>(Vs + (j & 1) * V_BYTES + t_dst);
    constexpr int PT = KC * VROW;      // floats per point of V
    vs[(4 * a + 0) * PT] = tt[a][0] - tt[a][2];
    vs[(4 * a + 1) * PT] = tt[a][1] + tt[a][2];
    vs[(4 * a + 2) * PT] = tt[a][2] - tt[a][1];
    vs[(4 * a + 3) * PT] = tt[a][1] - tt[a][3];
  };

  // ---- FMA role: points 2 warp, 2 warp + 1; tiles tg*4.., 16 + tg*4..;
  //      channels cg*4.., 32 + cg*4.. -------------------------------------
  const int tg = lane >> 3, cg = lane & 7;
  const int a_off = (2 * warp * KC * VROW + 4 * tg) * 4;
  const int b_off = (2 * warp * KC * NB + 4 * cg) * 4;

  float acc[2][8][8];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[p][i][c] = 0.f;

  // ---- ring: prologue ----------------------------------------------------
  // commit groups: chunk i's x and U for i < DEPTH - 1, then x DEPTH - 1
#pragma unroll
  for (int i = 0; i < DEPTH; ++i) {
    copy_x(i, 0);
    copy_x(i, 1);
    if (i < DEPTH - 1)
#pragma unroll
      for (int r = 0; r < 8; ++r) copy_u(i, r);
    cp_async_commit();
  }
  cp_async_wait<DEPTH - 1>();          // x 0, U 0
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) t_load(0, i);
  t_bt();
#pragma unroll
  for (int a = 0; a < 4; ++a) t_store(0, a);
  cp_async_wait<DEPTH - 2>();          // x 1, U 1
  __syncthreads();

  // chunk j: the FMAs on V j & 1 and U j % DEPTH, 16 steps of one point
  // and one input channel. Between the steps run the transform of x j+1
  // into V (j+1) & 1 (past the last chunk it transforms stale data into a
  // V stage that is never read) and the copies of U j+DEPTH-1 and x
  // j+DEPTH, so that their latency and issue overlap the FMAs. Each stage
  // is free again when it is refilled: x stage j % DEPTH was transformed,
  // and U stage (j - 1) % DEPTH consumed, before the barrier that ended
  // iteration j - 1.
#ifdef WINOGRAD_PROBE
  unsigned long long probe[4] = {0, 0, 0, 0};
  long long probe_t = clock64();
#endif
  for (int j = 0; j < n_chunks; ++j) {
    const float* va =
        reinterpret_cast<const float*>(Vs + (j & 1) * V_BYTES + a_off);
    const float* ub =
        reinterpret_cast<const float*>(Us + (j % DEPTH) * U_BYTES + b_off);
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int step = p * KC + k;
        if (step < 4) t_load(j + 1, step);
        if (step == 4) t_bt();
        if (step >= 5 && step < 9) t_store(j + 1, step - 5);
        if (step % 2 == 0) copy_u(j + DEPTH - 1, step / 2);
        if (step == 2 * KC - 3) copy_x(j + DEPTH, 0);
        if (step == 2 * KC - 1) copy_x(j + DEPTH, 1);
        const float* vr = va + (p * KC + k) * VROW;
        const float* ur = ub + (p * KC + k) * NB;
        const float4 a0 = *reinterpret_cast<const float4*>(vr);
        const float4 a1 = *reinterpret_cast<const float4*>(vr + 16);
        const float4 b0 = *reinterpret_cast<const float4*>(ur);
        const float4 b1 = *reinterpret_cast<const float4*>(ur + 32);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[p][i][c] = fmaf(av[i], bv[c], acc[p][i][c]);
      }
    cp_async_commit();
    PROBE(0);
    cp_async_wait<DEPTH - 2>();        // x j+2, U j+1
    PROBE(1);
    __syncthreads();
    PROBE(2);
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring's memory becomes R

  // ---- epilogue: row u = warp / 2 gets M[u, v] A^T from points v, v + 1
  // (v = 0: q0 M0 + M1, q1 M1; v = 2: q0 M2, q1 -M2 - M3), then
  // Y = A^T r with r_u the sum of its two warps' shares
  float* const R = reinterpret_cast<float*>(smem);   // [8 w][2 q][NTILE][NB]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tile = 4 * tg + (i & 3) + 16 * (i >> 2);
      float s0[4], s1[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float m0 = acc[0][i][4 * h + c], m1 = acc[1][i][4 * h + c];
        s0[c] = (warp & 1) ? m0 : m0 + m1;
        s1[c] = (warp & 1) ? -m0 - m1 : m1;
      }
      float* dst = R + ((2 * warp) * NTILE + tile) * NB + 4 * cg + 32 * h;
      *reinterpret_cast<float4*>(dst) = make_float4(s0[0], s0[1], s0[2], s0[3]);
      *reinterpret_cast<float4*>(dst + NTILE * NB) =
          make_float4(s1[0], s1[1], s1[2], s1[3]);
    }
  __syncthreads();

  const int e_tile = tid >> 3, e_cg = tid & 7;
  const int orow = tr0 + e_tile / TCOL, ocol = tc0 + e_tile % TCOL;
  if (orow < th && ocol < tw) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {      // channels co0 + 4 e_cg + 32 h ..
      const int co = co0 + 4 * e_cg + 32 * h;
      if (co >= Cout) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {    // output column 2 ocol + c
        float r[4][4];
#pragma unroll
        for (int uu = 0; uu < 4; ++uu) {
          const float* s = R + 4 * e_cg + 32 * h + e_tile * NB;
          const float4 a = *reinterpret_cast<const float4*>(
              s + ((2 * (2 * uu) + c) * NTILE) * NB);
          const float4 bq = *reinterpret_cast<const float4*>(
              s + ((2 * (2 * uu + 1) + c) * NTILE) * NB);
          r[uu][0] = a.x + bq.x; r[uu][1] = a.y + bq.y;
          r[uu][2] = a.z + bq.z; r[uu][3] = a.w + bq.w;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // output row 2 orow + i
          float o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[e] = i == 0 ? r[0][e] + r[1][e] + r[2][e]
                          : r[1][e] - r[2][e] - r[3][e];
          float* dst = y + (((long long)b * H + d * (2 * orow + i) + pr) * W +
                            d * (2 * ocol + c) + pc) *
                               Cout +
                       co;
          if constexpr (CV) {
            *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
          } else {
            const int n = Cout - co;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (e < n) dst[e] = o[e];
          }
        }
      }
    }
  }
#ifdef WINOGRAD_PROBE
  PROBE(3);
  if (lane == 0)
    for (int i = 0; i < 4; ++i) atomicAdd(&g_probe_f32[warp][i], probe[i]);
#endif
}

template <int TR, bool XV, bool CV>
int launch(const void* x, const void* u, void* y, int B, int H, int W,
           int Cin, int Cout, int d, cudaStream_t s) {
  const int th = H / (2 * d), tw = W / (2 * d);
  const int n_trb = (th + TR - 1) / TR;
  const int n_tcb = (tw + NTILE / TR - 1) / (NTILE / TR);
  const int n_cb = (Cout + NB - 1) / NB;
  const long long blocks = (long long)B * d * d * n_trb * n_tcb * n_cb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = winograd_f23_f32_kernel<TR, XV, CV>;
  // the dynamic shared memory limit is raised on this instance's first
  // launch on the current device, not on every launch (a race only sets it
  // twice): a launch then makes no other runtime call, so a CUDA graph
  // captures it as it is
  static bool raised[MAXDEV];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAXDEV || !raised[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAXDEV) raised[dev] = true;
  }
  kernel<<<(unsigned)blocks, NT, SMEM_BYTES, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<float*>(y), H, W, Cin, Cout, d, n_trb, n_tcb, n_cb);
  return (int)cudaGetLastError();
}

template <int TR>
int dispatch(const void* x, const void* u, void* y, int B, int H, int W,
             int Cin, int Cout, int d, bool xv, bool cv, cudaStream_t s) {
  if (xv && cv) return launch<TR, true, true>(x, u, y, B, H, W, Cin, Cout, d, s);
  if (xv) return launch<TR, true, false>(x, u, y, B, H, W, Cin, Cout, d, s);
  if (cv) return launch<TR, false, true>(x, u, y, B, H, W, Cin, Cout, d, s);
  return launch<TR, false, false>(x, u, y, B, H, W, Cin, Cout, d, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int winograd_f23_fwd_f32(const void* x, const void* u, void* y,
                                    int B, int H, int W, int Cin, int Cout,
                                    int d, int block_rows, void* stream) {
  if (B < 0 || d < 1 || H < 2 * d || W < 2 * d || H % (2 * d) ||
      W % (2 * d) || Cin < 1 || Cout < 1 ||
      (block_rows != 4 && block_rows != 8))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool xv = Cin % 4 == 0 && aligned16(x);
  const bool cv = Cout % 4 == 0 && aligned16(u) && aligned16(y);
  return block_rows == 4
             ? dispatch<4>(x, u, y, B, H, W, Cin, Cout, d, xv, cv, s)
             : dispatch<8>(x, u, y, B, H, W, Cin, Cout, d, xv, cv, s);
}

extern "C" int winograd_f23_f32_smem_bytes() { return SMEM_BYTES; }

#ifdef WINOGRAD_PROBE
// copies the phase cycles ([8 warps][4] u64) to `out` and zeroes them
extern "C" int winograd_f23_f32_probe(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_probe_f32, sizeof(g_probe_f32));
  static const unsigned long long zero[8][4] = {};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_probe_f32, zero, sizeof(zero));
  return (int)err;
}
#endif
