// Winograd F(2x2,3x3) convolution for Hopper (sm_90a): bf16 on the tensor
// cores, NHWC, for dilation 1 and for the phase grids of a dilated conv.
//
// Replaces: audiosourcesep_tpu/ops/winograd.py::_wino_kernel (launched by
// _winograd_pallas, behind winograd_conv2d and dilated_winograd_conv2d) for
// bf16 inputs; float32 inputs
// go to the CUDA-core kernel in winograd.cu. Same function and the same
// operand rounding as the TPU kernel: a SAME 3x3 stride-1 conv computed per
// 2x2 output tile as  Y = A^T [ sum_cin (G g G^T) . (B^T d B) ] A,  with U =
// G g G^T handed in already rounded to bf16 (winograd.py:292), V = B^T d B
// formed in bf16 arithmetic from bf16 d, the 16 channel contractions
// accumulated in f32, and Y rounded to bf16 once. The bias is the caller's.
//
// Dilation d: output pixel (d (2a + r) + p, d (2c + s) + q) of phase (p, q)
// reads only x[d (2a + i - 1) + p, d (2c + j - 1) + q], so each phase is a
// stride-1 SAME conv on its (H/d) x (W/d) grid. A block owns tiles of one
// phase and reads and writes them in place in the undilated NHWC tensors,
// with the SAME halo zero-filled per phase grid: no phase copy. d = 1 is
// the dense conv.
//
// What bounds it on this card: operations. The 16 transform-domain
// contractions are 16 * tiles * C_in * C_out multiply-adds; at 96x64
// 192->192, batch 30, that is 54.4 GFLOP, 55 us at the 989 TFLOP/s bf16
// tensor-core peak, against 143 MB of x, y and U, 43 us at 3.35 TB/s.
//
// What the design does about it:
// - The contractions run as mma.sync.m16n8k16 (bf16 in, f32 accumulate)
//   fed by ldmatrix from shared memory.
// - A block owns a rectangle of 4 x 8 tiles of one phase grid (an 8 x
//   16-pixel output patch; 8 x 4 tiles for grids 4 tiles wide, which the
//   wrapper picks: the cascade's d = 4 grid of 6 x 4 tiles then fills 75%
//   of a block instead of 37.5%) and 64 output channels, and walks C_in in
//   chunks of 16. Eight warps:
//   warp (row u, half h) holds transform-domain row u (points 4u..4u+3)
//   for the 32 tiles x 32 channels h*32.., 128 f32 accumulators a thread.
//   Per point and k16 step a warp reads 1 KB of V and 1 KB of U from shared
//   memory for 16,384 MACs: 0.125 B/MAC, about 1,024 MAC/clk/SM at 128
//   B/clk, half the tensor cores' peak.
// - Per chunk the block copies the 10 x 18-pixel (or 18 x 10) x slab and
//   the U chunk
//   [16][16][64] with 16-byte cp.async. NHWC keeps 8 bf16 channels in 16
//   bytes; the SAME halo, the ragged image edge and channels past C_in or
//   C_out are zero-filled by the copy's source size, with no padded copy in
//   HBM. Four x stages, four U stages and two V stages form a ring: chunk
//   j's MMAs run while chunk j+1 is transformed and the copies of chunks
//   up to j+3 (U) and j+4 (x) are in flight, with one barrier per chunk.
// - V = B^T d B is formed once per (tile, channel) and C_out block, 2
//   channels a thread with bf16x2 adds, into a [16][32 tiles][16] layout
//   whose 16-byte halves are swizzled so that ldmatrix is conflict-free;
//   U rows are swizzled the same way (XOR of the 16-byte column by k % 8).
//   x is read from HBM about once: the C_out blocks of one patch are
//   neighbours in the grid, so their slabs come from L2.
// - Epilogue: each warp forms r_u = M[u,:] A in registers, the four r_u
//   meet in 72 KB of shared memory, and Y = A^T r is written straight into
//   the interleaved NHWC output, 8 channels (16 bytes) a store.
// C_in or C_out that is not a multiple of 8 (begin_conv, end_conv) takes
// the same kernel with plain loads in place of the 16-byte copies.
//
// What still holds it back: the 16 accumulator sets cap a block at 32
// tiles x 64 channels (128 f32 a thread, 239-251 registers), so one
// block of 8 warps runs per SM, and every chunk moves about 134 KB through
// shared memory (38 KB copied in, 16 KB of slab read, 16 KB of V written,
// 64 KB of ldmatrix) for 524,288 MACs. Copies, MMAs and the transform take
// turns rather than overlapping. wgmma with TMA copies and warp-specialised
// producers is the next step (PERF.md, ROADMAP.md).
//
// C interface (bound with ctypes): winograd_f23_fwd_bf16(x, u, y, B, H, W,
// Cin, Cout, d, block_rows, stream) with x [B,H,W,Cin], U [16,Cin,Cout] and
// y [B,H,W,Cout], all bf16, and dilation d; H and W divisible by 2d;
// block_rows 4 or 8 (the tile rows of a block). It launches on `stream`,
// allocates nothing, and returns cudaGetLastError(). winograd_f23_bf16_smem_bytes() returns the
// dynamic shared memory a block takes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifdef WINOGRAD_PROBE
// Built only by benchmarks/torch_winograd_probe.py: clock64 cycles that each
// warp spends in each phase of the C_in loop (MMAs, transform, copies
// issued, copy wait, barrier), summed over blocks.
__device__ unsigned long long g_probe[8][5];
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

constexpr int NTILE = 32;              // tiles per block: 4 x 8 or 8 x 4
constexpr int NB = 64;                 // output channels per block
constexpr int KC = 16;                 // input channels per chunk
constexpr int NT = 256;                // 8 warps
constexpr int DEPTH = 4;               // x and U stages of the ring
constexpr int SLAB = 180;              // slab pixels: 10 x 18 or 18 x 10
constexpr int PIX = 48;                // bytes per slab pixel: 16 bf16 + pad
constexpr int X_PIECES = SLAB * 2;     // 16-byte pieces per slab: 360

constexpr int VP = NTILE * KC * 2;     // bytes of one point of V: 1 KB
constexpr int UP = KC * NB * 2;        // bytes of one point of U: 2 KB
constexpr int V_BYTES = 16 * VP;       // one V stage
constexpr int U_BYTES = 16 * UP;       // one U stage
constexpr int X_BYTES = SLAB * PIX;    // one x stage
constexpr int RSTR = NB + 8;           // f32 row stride of the epilogue
constexpr int R_BYTES = 4 * 2 * NTILE * RSTR * 4;
constexpr int RING_BYTES = 2 * V_BYTES + DEPTH * (U_BYTES + X_BYTES);
constexpr int SMEM_BYTES = RING_BYTES > R_BYTES ? RING_BYTES : R_BYTES;

static_assert(NTILE * (KC / 2) == NT, "one (tile, channel pair) a thread");
static_assert(16 * KC * (NB / 8) == 8 * NT, "eight U pieces a thread");
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 bf16 from global memory, the first n of them real, the rest zero
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* src, int n) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = 2 * k < n ? s[2 * k] : 0u;
    const uint32_t hi = 2 * k + 1 < n ? s[2 * k + 1] : 0u;
    w[k] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};\n"
               :: "r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// TR: tile rows of the block (4 or 8; 32 / TR tile columns)
// XV: C_in % 8 == 0 and x 16-byte aligned (x by cp.async, else plain loads)
// CV: C_out % 8 == 0 and U, y 16-byte aligned (U by cp.async, 16-byte
//     stores of y, else plain loads and stores)
template <int TR, bool XV, bool CV>
__global__ void __launch_bounds__(NT, 1)
    winograd_f23_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ u,
                             __nv_bfloat16* __restrict__ y, int H, int W,
                             int Cin, int Cout, int d, int n_trb, int n_tcb,
                             int n_cb) {
  constexpr int TCOL = NTILE / TR;
  constexpr int SC = 2 * TCOL + 2;     // slab columns
  static_assert((2 * TR + 2) * SC == SLAB, "slab size");
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const Vs = smem;                  // [2][16][NTILE][KC]
  unsigned char* const Us = Vs + 2 * V_BYTES;      // [DEPTH][16][KC][NB]
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
  const __nv_bfloat16* const xb =
      x + (((long long)b * H + pr) * W + pc) * Cin;

  // ---- copy roles -------------------------------------------------------
  // x: pieces e = tid, tid + NT of the slab's (pixel, 8-channel half)
  const __nv_bfloat16* xsrc[2];
  uint32_t xdst[2];
  int xn[2];                           // real channels from the piece on
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = tid + r * NT;
    const int pix = e >> 1, sr = pix / SC, sc = pix % SC;
    const int gr = 2 * tr0 - 1 + sr, gc = 2 * tc0 - 1 + sc;
    const bool in = e < X_PIECES && gr >= 0 && gr < gh && gc >= 0 && gc < gw;
    xsrc[r] = in ? xb + ((long long)d * gr * W + (long long)d * gc) * Cin +
                       8 * (e & 1)
                 : x;
    xdst[r] = smem_u32(Xs) + pix * PIX + 16 * (e & 1);
    xn[r] = in ? Cin - 8 * (e & 1) : 0;   // outside the grid: zeros
  }
  // U: row k, 16-byte column c, points up0 + 2r (r < 8)
  const int uk = (tid >> 3) & (KC - 1), uc = tid & 7, up0 = tid >> 7;
  const int uco = co0 + 8 * uc;
  const int un = uco < Cout ? Cout - uco : 0;   // real channels of the piece
  const long long ustep = 2LL * Cin * Cout;
  const __nv_bfloat16* const usrc =
      un > 0 ? u + ((long long)up0 * Cin + uk) * Cout + uco : u;
  const uint32_t udst =
      smem_u32(Us) + up0 * UP + uk * (NB * 2) + ((uc ^ (uk & 7)) << 4);

  auto issue_x = [&](int j) {          // chunk j -> x stage j % DEPTH
    if (j >= n_chunks) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (tid + r * NT >= X_PIECES) continue;
      const int n = xn[r] - j * KC;    // real channels in this piece
      const uint32_t dst = xdst[r] + (j % DEPTH) * X_BYTES;
      if constexpr (XV) {
        cp_async16(dst, n > 0 ? xsrc[r] + j * KC : x, n > 0);
      } else {
        const uint4 v = load8(n > 0 ? xsrc[r] + j * KC : x, min(n, 8));
        st_shared16(dst, v);
      }
    }
  };
  auto issue_u = [&](int j) {          // chunk j -> U stage j % DEPTH
    if (j >= n_chunks) return;
    const bool ok = un > 0 && j * KC + uk < Cin;
    const __nv_bfloat16* src = usrc + (long long)j * KC * Cout;
    const uint32_t dst = udst + (j % DEPTH) * U_BYTES;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if constexpr (CV) {
        cp_async16(dst + r * 2 * UP, ok ? src + r * ustep : u, ok);
      } else {
        const uint4 v = load8(ok ? src + r * ustep : u, ok ? min(un, 8) : 0);
        st_shared16(dst + r * 2 * UP, v);
      }
    }
  };

  // ---- transform role: tile (t_tr, t_tc), channels 2 t_cp, 2 t_cp + 1 ---
  const int t_tile = 4 * warp + (lane >> 3), t_cp = lane & 7;
  const int t_tr = t_tile / TCOL, t_tc = t_tile % TCOL;
  const uint32_t t_src = ((2 * t_tr) * SC + 2 * t_tc) * PIX + 4 * t_cp;
  const uint32_t t_dst = t_tile * (KC * 2) +
                         (((t_cp >> 2) ^ ((t_tile >> 2) & 1)) << 4) +
                         4 * (t_cp & 3);
  auto transform = [&](int j) {        // x stage j % DEPTH -> V stage j & 1
    const unsigned char* xs = Xs + (j % DEPTH) * X_BYTES + t_src;
    __nv_bfloat162 d[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        d[i][c] = *reinterpret_cast<const __nv_bfloat162*>(
            xs + (i * SC + c) * PIX);
    __nv_bfloat162 t[4][4];            // B^T d, in the TPU kernel's order
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      t[0][c] = __hsub2(d[0][c], d[2][c]);
      t[1][c] = __hadd2(d[1][c], d[2][c]);
      t[2][c] = __hsub2(d[2][c], d[1][c]);
      t[3][c] = __hsub2(d[1][c], d[3][c]);
    }
    unsigned char* vs = Vs + (j & 1) * V_BYTES + t_dst;
#pragma unroll
    for (int a = 0; a < 4; ++a) {      // (B^T d) B
      *reinterpret_cast<__nv_bfloat162*>(vs + (4 * a + 0) * VP) =
          __hsub2(t[a][0], t[a][2]);
      *reinterpret_cast<__nv_bfloat162*>(vs + (4 * a + 1) * VP) =
          __hadd2(t[a][1], t[a][2]);
      *reinterpret_cast<__nv_bfloat162*>(vs + (4 * a + 2) * VP) =
          __hsub2(t[a][2], t[a][1]);
      *reinterpret_cast<__nv_bfloat162*>(vs + (4 * a + 3) * VP) =
          __hsub2(t[a][1], t[a][3]);
    }
  };

  // ---- MMA role: points 4 mu .. 4 mu + 3, channels 32 mnh .. + 31 --------
  const int mu = warp & 3, mnh = warp >> 2;
  // A (V, [tile][k]): lane -> row lane & 15, 16-byte half lane >> 4
  const uint32_t a_off =
      (lane & 15) * (KC * 2) + (((lane >> 4) ^ ((lane >> 2) & 1)) << 4);
  // B (U, [k][n], transposed on load): lane -> k, 8-channel column
  const int bk = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int bc = 4 * mnh + (lane >> 4);
  const uint32_t b_off0 = bk * (NB * 2) + (((bc + 0) ^ (lane & 7)) << 4);
  const uint32_t b_off1 = bk * (NB * 2) + (((bc + 2) ^ (lane & 7)) << 4);

  float acc[4][2][4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][m][n][e] = 0.f;

  // ---- ring: prologue ----------------------------------------------------
  // commit groups: chunk i's x and U for i < DEPTH - 1, then x DEPTH - 1
#pragma unroll
  for (int i = 0; i < DEPTH - 1; ++i) {
    issue_x(i);
    issue_u(i);
    cp_async_commit();
  }
  issue_x(DEPTH - 1);
  cp_async_commit();
  cp_async_wait<DEPTH - 1>();          // x 0, U 0
  __syncthreads();
  transform(0);
  cp_async_wait<DEPTH - 2>();          // x 1, U 1
  __syncthreads();

  // chunk j: MMAs on V j & 1 and U j % DEPTH, the transform of x j+1, then
  // the copies of x j+DEPTH and U j+DEPTH-1 (last: issuing them stalls on
  // the memory system). Each stage is free again when it is refilled: x
  // stage j % DEPTH was transformed, and U stage (j - 1) % DEPTH consumed,
  // before the barrier that ended iteration j - 1.
#ifdef WINOGRAD_PROBE
  unsigned long long probe[5] = {0, 0, 0, 0, 0};
  long long probe_t = clock64();
#endif
  for (int j = 0; j < n_chunks; ++j) {
    const uint32_t vs = smem_u32(Vs + (j & 1) * V_BYTES) + 4 * mu * VP;
    const uint32_t us = smem_u32(Us + (j % DEPTH) * U_BYTES) + 4 * mu * UP;
    // fragments of point q + 1 are loaded before the MMAs of point q
    uint32_t fa[2][2][4], fb[2][2][4];   // [buffer][m16 / n16 half][reg]
    ldsm_x4(fa[0][0], vs + a_off);
    ldsm_x4(fa[0][1], vs + 16 * KC * 2 + a_off);
    ldsm_x4_t(fb[0][0], us + b_off0);
    ldsm_x4_t(fb[0][1], us + b_off1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cur = q & 1, nxt = cur ^ 1;
      if (q < 3) {
        ldsm_x4(fa[nxt][0], vs + (q + 1) * VP + a_off);
        ldsm_x4(fa[nxt][1], vs + (q + 1) * VP + 16 * KC * 2 + a_off);
        ldsm_x4_t(fb[nxt][0], us + (q + 1) * UP + b_off0);
        ldsm_x4_t(fb[nxt][1], us + (q + 1) * UP + b_off1);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma_bf16(acc[q][m][n], fa[cur][m], fb[cur][n >> 1][2 * (n & 1)],
                   fb[cur][n >> 1][2 * (n & 1) + 1]);
    }
    PROBE(0);
    if (j + 1 < n_chunks) transform(j + 1);
    PROBE(1);
    issue_x(j + DEPTH);
    issue_u(j + DEPTH - 1);
    cp_async_commit();
    PROBE(2);
    cp_async_wait<DEPTH - 2>();        // x j+2, U j+1
    PROBE(3);
    __syncthreads();
    PROBE(4);
  }
#ifdef WINOGRAD_PROBE
  if (lane == 0)
    for (int i = 0; i < 5; ++i) atomicAdd(&g_probe[warp][i], probe[i]);
#endif
  cp_async_wait<0>();
  __syncthreads();                     // the ring's memory becomes R

  // ---- epilogue: r_u = M[u,:] A per warp, then Y = A^T r -----------------
  float* const R = reinterpret_cast<float*>(smem);   // [4 u][2][NTILE][RSTR]
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int tile = 16 * m + g + 8 * hh, co = 32 * mnh + 8 * n + 2 * t4;
        float r0[2], r1[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 2 * hh + e;
          r0[e] = acc[0][m][n][k] + acc[1][m][n][k] + acc[2][m][n][k];
          r1[e] = acc[1][m][n][k] - acc[2][m][n][k] - acc[3][m][n][k];
        }
        float* dst = R + ((2 * mu) * NTILE + tile) * RSTR + co;
        *reinterpret_cast<float2*>(dst) = make_float2(r0[0], r0[1]);
        *reinterpret_cast<float2*>(dst + NTILE * RSTR) =
            make_float2(r1[0], r1[1]);
      }
  __syncthreads();

  const int e_tile = tid >> 3, e_cg = tid & 7;
  const int orow = tr0 + e_tile / TCOL, ocol = tc0 + e_tile % TCOL;
  const int co = co0 + 8 * e_cg;
  if (orow >= th || ocol >= tw || co >= Cout) return;
#pragma unroll
  for (int c = 0; c < 2; ++c) {        // output column 2 ocol + c
    float r[4][8];
#pragma unroll
    for (int uu = 0; uu < 4; ++uu) {
      const float* src = R + ((2 * uu + c) * NTILE + e_tile) * RSTR + 8 * e_cg;
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      r[uu][0] = lo.x; r[uu][1] = lo.y; r[uu][2] = lo.z; r[uu][3] = lo.w;
      r[uu][4] = hi.x; r[uu][5] = hi.y; r[uu][6] = hi.z; r[uu][7] = hi.w;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {      // output row 2 orow + i
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = i == 0 ? r[0][e] + r[1][e] + r[2][e]
                      : r[1][e] - r[2][e] - r[3][e];
      __nv_bfloat16* dst =
          y + (((long long)b * H + d * (2 * orow + i) + pr) * W +
               d * (2 * ocol + c) + pc) * Cout + co;
      if constexpr (CV) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(pack_bf16x2(o[0], o[1]), pack_bf16x2(o[2], o[3]),
                       pack_bf16x2(o[4], o[5]), pack_bf16x2(o[6], o[7]));
      } else {
        const int n = Cout - co;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (e < n) dst[e] = __float2bfloat16(o[e]);
      }
    }
  }
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
  auto kernel = winograd_f23_bf16_kernel<TR, XV, CV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, NT, SMEM_BYTES, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(u), static_cast<__nv_bfloat16*>(y),
      H, W, Cin, Cout, d, n_trb, n_tcb, n_cb);
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

extern "C" int winograd_f23_fwd_bf16(const void* x, const void* u, void* y,
                                     int B, int H, int W, int Cin, int Cout,
                                     int d, int block_rows, void* stream) {
  if (B < 0 || d < 1 || H < 2 * d || W < 2 * d || H % (2 * d) ||
      W % (2 * d) || Cin < 1 || Cout < 1 ||
      (block_rows != 4 && block_rows != 8))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool xv = Cin % 8 == 0 && aligned16(x);
  const bool cv = Cout % 8 == 0 && aligned16(u) && aligned16(y);
  return block_rows == 4
             ? dispatch<4>(x, u, y, B, H, W, Cin, Cout, d, xv, cv, s)
             : dispatch<8>(x, u, y, B, H, W, Cin, Cout, d, xv, cv, s);
}

extern "C" int winograd_f23_bf16_smem_bytes() { return SMEM_BYTES; }

#ifdef WINOGRAD_PROBE
// copies the phase cycles ([8 warps][5] u64) to `out` and zeroes them
extern "C" int winograd_f23_bf16_probe(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  static const unsigned long long zero[8][5] = {};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  return (int)err;
}
#endif
