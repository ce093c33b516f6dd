// Winograd F(2x2,3x3) convolution for Hopper (sm_90a): bf16 on the tensor
// cores through wgmma, fed by TMA, NHWC, for dilation 1 and for the phase
// grids of a dilated conv.
//
// Replaces: audiosourcesep_tpu/ops/winograd.py::_wino_kernel (launched by
// _winograd_pallas, behind winograd_conv2d and dilated_winograd_conv2d) for
// bf16 inputs; float32 inputs go to the CUDA-core kernel in winograd.cu.
// Same function and the same operand rounding as the TPU kernel: a SAME 3x3
// stride-1 conv computed per 2x2 output tile as
//   Y = A^T [ sum_cin (G g G^T) . (B^T d B) ] A,
// with U = G g G^T handed in already rounded to bf16 (winograd.py:292), V =
// B^T d B formed in bf16 arithmetic (rows first, as the TPU kernel), the 16
// channel contractions accumulated in f32, and Y rounded to bf16 once. The
// bias is the caller's.
//
// Dilation d: output pixel (d (2a + r) + p, d (2c + s) + q) of phase (p, q)
// reads only x[d (2a + i - 1) + p, d (2c + j - 1) + q], so each phase is a
// stride-1 SAME conv on its (H/d) x (W/d) grid. The kernel reads and writes
// the phases in place in the undilated NHWC tensors, at any d; d = 1 is the
// dense conv.
//
// What bounds it on this card: operations. The 16 transform-domain
// contractions are 16 * tiles * C_in * C_out multiply-adds; at 96x64
// 192->192, batch 30, 54.4 GFLOP, 55 us at the 989 TFLOP/s bf16 tensor-core
// peak, against 71 MB of x, y and U, 21 us at 3.35 TB/s.
//
// Design (one persistent block of 384 threads per SM):
// - A block owns 64 tiles of one column phase q (TC = 8 or 4 tile columns,
//   64 / TC tile rows taken from P row phases, which the wrapper picks so
//   that the grid is covered with the fewest idle tiles) and 64 output
//   channels, and walks C_in in chunks of 16 through a ring of 4 stages.
//   The grid is one block an SM; each walks blocks bid, bid + grid, ... and
//   the ring runs on across them, so one block's epilogue overlaps the
//   next one's loads.
// - Producer (warpgroup 2, setmaxnreg 40): one thread issues, per chunk,
//   three TMA loads into the stage and arms its full mbarrier with their
//   bytes. x is a 5-D tensor map (C, W, row phase, phase row, batch); two
//   boxes, one per column parity of the slab, with an element stride of
//   2d along W, so that each box holds every other slab column of phase
//   q. TMA's element strides stop at 8, so for d > 4 the map is (2d C, W /
//   2d, row phase, phase row, batch) instead: a group of 2d pixels' channels
//   is one row of the innermost dimension, a slab column's place in its
//   group (q, or d + q one group to the left) is a coordinate there, and
//   every stride is 1. The start coordinate sits one tile row and column
//   before the block, and TMA's out-of-bounds zero fill is the phase grid's
//   SAME halo and ragged edge: no padded copy in HBM, no phase copy. The
//   wide map has no zero fill past C_in inside a group, so it needs C_in a
//   multiple of the 16-channel chunk (else the plain path). U is a 5-D tensor
//   map that reorders the chunk's 16 channels (see the A operand below)
//   and lands 128-byte swizzled, the layout wgmma reads B from. U's rows
//   are ldu long, C_out padded to a multiple of 8 by the wrapper, so TMA
//   can address it for any C_out (end_conv, 192->1). When C_in is not a
//   multiple of 8 (begin_conv, 1->192) TMA cannot address x: the 128
//   producer threads then copy x and U into the same layouts with plain
//   loads (path "plain").
// - Consumers (warpgroups 0 and 1, setmaxnreg 232 on the TMA path, 224 on
//   the plain one, whose producer keeps 56): warpgroup g computes
//   output row g of every tile. It holds P[v] = sum_u A^T[g][u] M[u][v]
//   for v = 0..3, the TPU kernel's fold of A^T (winograd.py:170-188): four
//   m64n64 f32 accumulators, 128 registers a thread, where the 16 points
//   M[u][v] would take 256. A^T's row g has three nonzeros (+1 +1 +1, or
//   +1 -1 -1), so a chunk is 12 wgmma m64n64k16 a warpgroup, the sign as
//   wgmma's scale of A: 1.5x the multiply-adds of the 16 points.
//   Each thread forms its share of V = B^T d B for the three transform
//   rows with bf16x2 adds straight into the registers of wgmma's A operand
//   (A from registers, B = U from shared memory): V never goes through
//   shared memory. A thread's A rows are two vertically adjacent tiles, so
//   it reads 5 slab rows x 4 columns of 4 channels (8 bytes) for them; the
//   8 lanes of a row group read 8 neighbouring tiles, and with the column
//   parities in separate boxes every half-warp read covers 128 contiguous
//   bytes (no bank conflict). For that the K order of a chunk is permuted:
//   lane q's A columns 2q, 2q+1, 2q+8, 2q+9 are channels 4q..4q+3, and the U
//   tensor map lands U's rows in the same order.
// - The ring runs on mbarriers alone, no __syncthreads: a consumer warp
//   releases a stage (one arrive on its empty barrier) once wgmma.wait_group
//   says the wgmmas that read its U are done; one warpgroup's transform
//   runs while the other's wgmmas do.
// - Epilogue: Y[g][j] = sum_v P[v] A^T[j][v], rounded to bf16 once,
//   written by the warpgroup that holds it as bf16x2 stores into the
//   interleaved NHWC y.
//
// What still holds it back (benchmarks/torch_winograd_probe.py and
// benchmarks/torch_winograd_variants.py, PERF.md): the consumers' own
// instruction stream, not the tensor cores or the copies. A warpgroup takes
// turns between its transform and waiting for its own wgmmas (holding the
// next chunk's rows or V while the last chunk's wgmmas are in flight
// spills at 232 registers); with two warps an SM sub-partition the slab
// reads' and adds' latencies show. Taking the wgmmas away, or the U or x
// loads, saves far less than the transform costs.
//
// C interface (bound with ctypes): winograd_f23_fwd_bf16(x, u, y, B, H, W,
// Cin, Cout, ldu, d, P, TC, tma, stream) with x [B,H,W,Cin], U
// [16,Cin,ldu] (ldu >= Cout; the channels past Cout zero) and y
// [B,H,W,Cout], all bf16, and dilation d >= 1; H and W divisible by 2d;
// P (1, 2 or 4, dividing d) row phases and TC (4 or 8) tile columns per
// block; tma 1 for the TMA path (C_in and ldu multiples of 8, C_in of 16
// when d > 4, x and U 16-byte aligned), 0 for plain loads. It launches on
// `stream`, allocates nothing, and returns cudaGetLastError()
// (cudaErrorInvalidValue for what it does not take).
// winograd_f23_bf16_smem_bytes() returns the dynamic shared memory a block
// takes. The tensor maps are encoded per launch through
// cuTensorMapEncodeTiled, taken from the driver with cudaGetDriverEntryPoint
// (no link against libcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#ifdef WINOGRAD_PROBE
// Built only by benchmarks/torch_winograd_probe.py: clock64 cycles that each
// warp spends in each of its role's phases, summed over blocks. Consumer
// warps 0-7: full-barrier wait, transform (slab reads and V), wgmma (fence,
// issue, wait for the previous chunk's group, release), epilogue. Producer
// warps 8-11 (one of them on the TMA path): empty-barrier wait, copy issue.
__device__ unsigned long long g_probe[12][4];
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

constexpr int KC = 16;                  // input channels per chunk (k16)
constexpr int NB = 64;                  // output channels per block (n64)
constexpr int STAGES = 4;               // ring depth
constexpr int NT = 384;                 // 2 consumer + 1 producer warpgroup
constexpr int NP = 128;                 // producer threads
constexpr int U_POINT = KC * NB * 2;    // one point of U: 16 rows x 128 B
constexpr int U_BYTES = 16 * U_POINT;   // one U stage: 32 KB
constexpr int X_HALF = 6912;            // one column-parity box, largest
constexpr int STAGE_BYTES = 47104;      // U + two x boxes, 1024-aligned
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr int SMEM_BYTES = 1024 + BAR_OFF + 2 * STAGES * 8;
constexpr int MAX_STRIDED_D = 4;        // TMA element strides stop at 8
constexpr int MAXDEV = 64;               // devices whose kernel limits are kept
static_assert(U_BYTES + 2 * X_HALF <= STAGE_BYTES, "stage layout");
static_assert(STAGE_BYTES % 1024 == 0, "stages stay 1024-aligned");

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* u;
  __nv_bfloat16* y;
  int H, W, Cin, Cout, d;
  int P, TC, TRp;               // row phases, tile columns, rows a phase
  int n_pg, n_trb, n_tcb, n_cb, n_chunks, n_blocks;
  int x_bytes;                  // both x boxes of a stage
  int ldu;                      // U's row length: C_out padded to 8
  int uvec;                     // plain path: 16-byte loads of U
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
// waits for the phase of parity `parity` to complete; traps (a launch
// error, not a hang) if it has not after ~2^34 cycles (the clock read
// every 64 tries)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  for (uint32_t n = 1; !mbar_try(bar, parity); ++n)
    if ((n & 63) == 0 && clock64() - t0 > (1LL << 34)) __trap();
}

// ---- TMA --------------------------------------------------------------------
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// ---- wgmma --------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// B descriptor of one point of U: [16 k rows][64 n] bf16, N contiguous
// (MN-major), 128-byte swizzle; the two 8-row K groups 1024 B apart (SBO)
__device__ __forceinline__ uint64_t u_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(2048 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x 64] += SA * A[64 x 16] (registers) * B[16 x 64] (shared memory,
// MN-major); SA = +1 or -1 (exact: a sign)
template <int SA>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, %38, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(SA));
}

// ---- plain loads ------------------------------------------------------------
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
__device__ __forceinline__ uint2 ld_shared8(uint32_t src) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0,%1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(src));
  return v;
}

__device__ __forceinline__ uint32_t b2u(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 u2b(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// a block: tiles of batch b, row phases p0 .. p0 + P - 1, column phase q,
// from tile row tr0 and tile column tc0 of the phase grid; channels co0..
struct Blk {
  int b, p0, q, tr0, tc0, co0;
};
__device__ __forceinline__ Blk decode(const Params& p, int bid) {
  Blk k;                               // C_out block fastest: x from L2
  const int cb = bid % p.n_cb;
  bid /= p.n_cb;
  const int tcb = bid % p.n_tcb;
  bid /= p.n_tcb;
  const int trb = bid % p.n_trb;
  bid /= p.n_trb;
  k.q = bid % p.d;
  bid /= p.d;
  k.p0 = (bid % p.n_pg) * p.P;
  k.b = bid / p.n_pg;
  k.co0 = cb * NB;
  k.tc0 = tcb * p.TC;
  k.tr0 = trb * p.TRp;
  return k;
}

// ---- the producer's plain-load path ---------------------------------------
// the same stage layouts as the TMA path: x boxes [SR][P][TC+1][16 ch] per
// column parity, U [16 points][16 rows in k_channel order][64 n] with the
// 128-byte swizzle; zeros outside the phase grid, past C_in and past C_out
__device__ __forceinline__ void copy_plain(const Params& p, uint32_t stage,
                                           int j, const Blk& k0, int pt) {
  constexpr int BATCH = 2;             // loads in flight per thread
  const int SR = 2 * p.TRp + 2, SCH = p.TC + 1;
  const int gh = p.H / p.d, gw = p.W / p.d;
  const int half = SR * p.P * SCH * 2;         // 16-byte pieces of x / 2
  const int nx = 2 * half;
  const int nu = 16 * KC * (NB / 8);           // 16-byte pieces of U
  for (int e0 = pt; e0 < nx + nu; e0 += NP * BATCH) {
    uint4 v[BATCH];
    uint32_t dst[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int e = e0 + i * NP;
      v[i] = make_uint4(0, 0, 0, 0);
      dst[i] = 0xffffffffu;
      if (e < nx) {      // x: channel half, then (parity, row, phase, col)
        const int hf = e >= half;
        int r = e - hf * half;
        const int k = r % SCH;
        r /= SCH;
        const int ph = r % p.P;
        r /= p.P;
        const int sr = r % SR, par = r / SR;
        const int gr = 2 * k0.tr0 - 1 + sr;
        const int gc = 2 * k0.tc0 - 1 + par + 2 * k;
        const int c0 = KC * j + 8 * hf;
        dst[i] = stage + U_BYTES + par * X_HALF +
                 ((sr * p.P + ph) * SCH + k) * 32 + 16 * hf;
        if (gr >= 0 && gr < gh && gc >= 0 && gc < gw && c0 < p.Cin) {
          const __nv_bfloat16* src =
              p.x + (((long long)k0.b * p.H + (long long)p.d * gr + k0.p0 +
                      ph) * p.W + (long long)p.d * gc + k0.q) * p.Cin + c0;
          v[i] = load8(src, min(p.Cin - c0, 8));
        }
      } else if (e < nx + nu) {   // U: channel, point, 8 output channels
        const int eu = e - nx;
        const int g = eu & 7, point = (eu >> 3) & 15, cc = eu >> 7;
        const int kk = 8 * ((cc >> 1) & 1) + 2 * (cc >> 2) + (cc & 1);
        const int c = KC * j + cc, co = k0.co0 + 8 * g;
        const uint32_t off = point * U_POINT + kk * (NB * 2) + g * 16;
        dst[i] = stage + (off ^ (((off >> 7) & 7) << 4));
        if (c < p.Cin && co < p.ldu) {
          const __nv_bfloat16* src =
              p.u + ((long long)point * p.Cin + c) * p.ldu + co;
          v[i] = p.uvec ? *reinterpret_cast<const uint4*>(src)
                        : load8(src, min(p.ldu - co, 8));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i)
      if (dst[i] != 0xffffffffu) st_shared16(dst[i], v[i]);
  }
}

// ---- consumer warpgroup G: output row G of every tile -------------------
// P[v] = sum_u A^T[G][u] M[u][v] over the transform rows u = G .. G + 2 (the
// TPU kernel's fold: A^T's row G has three nonzeros, +1 +1 +1 for G = 0 and
// +1 -1 -1 for G = 1, applied as wgmma's scale of A), then Y[G][j] =
// sum_v P[v] A^T[j][v].
template <int G>
__device__ __forceinline__ void consume(const Params& p, uint32_t base,
                                        uint32_t bars) {
  const int ct = threadIdx.x & 127, wl = ct >> 5, lane = ct & 31;
  const int t = lane >> 2, lq = lane & 3;
  const int TC = p.TC, TRp = p.TRp, P = p.P;
  // this thread's A rows 16 wl + t (s = 0) and + 8 (s = 1): tiles (row0, col)
  // and (row0 + 1, col) of the block, row0 even
  const int col = t & (TC - 1);
  const int row0 = (16 / TC) * wl + 2 * (t / TC);
  const int ph = row0 / TRp, trl = row0 % TRp;
  const uint32_t rs = P * (TC + 1) * 32;        // slab row stride (bytes)
  const uint32_t xoff = U_BYTES + ((2 * trl * P + ph) * (TC + 1) + col) * 32 +
                        8 * lq + G * rs;
  const int th = p.H / (2 * p.d), tw = p.W / (2 * p.d);
  const bool even = (p.Cout & 1) == 0;

#ifdef WINOGRAD_PROBE
  unsigned long long probe[4] = {0, 0, 0, 0};
  long long probe_t = clock64();
#endif
  int s = 0;
  uint32_t parity = 0;
  for (int bid = blockIdx.x; bid < p.n_blocks; bid += gridDim.x) {
    const Blk k0 = decode(p, bid);
    float acc[4][32];
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[v][e] = 0.f;
    for (int j = 0; j < p.n_chunks; ++j) {
      const uint32_t stage = base + s * STAGE_BYTES;
      if (j > 0) {               // the previous chunk's wgmmas are done:
        wgmma_wait0();           // release its stage
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
          for (int e = 0; e < 32; ++e) fence_operand(acc[v][e]);
        if (lane == 0)
          mbar_arrive(bars + 8 * (STAGES + (s == 0 ? STAGES - 1 : s - 1)));
      }
      PROBE(2);
      mbar_wait(bars + 8 * s, parity);
      PROBE(0);
      // slab rows 2 trl + G + r (r < 5) of tile columns 2 col + jj (jj < 4):
      // column parity jj & 1 is its own box. B^T along the rows, as the TPU
      // kernel: u0 = d0 - d2, u1 = d1 + d2, u2 = d2 - d1, u3 = d1 - d3 of
      // each tile's rows (tile s starts at slab row 2 s)
      __nv_bfloat162 tt[3][2][4][2];            // [u - G][s][jj][lo/hi]
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const uint32_t src =
            stage + xoff + (jj & 1) * X_HALF + (jj >> 1) * 32;
        uint2 R[5];
#pragma unroll
        for (int r = 0; r < 5; ++r) R[r] = ld_shared8(src + r * rs);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162 d[5];
#pragma unroll
          for (int r = 0; r < 5; ++r) d[r] = u2b(h ? R[r].y : R[r].x);
#pragma unroll
          for (int ss = 0; ss < 2; ++ss) {
            const __nv_bfloat162* e = d + 2 * ss;
            if (G == 0) {                        // d_i = e[i]
              tt[0][ss][jj][h] = __hsub2(e[0], e[2]);
              tt[1][ss][jj][h] = __hadd2(e[1], e[2]);
              tt[2][ss][jj][h] = __hsub2(e[2], e[1]);
            } else {                             // d_i = e[i - 1]
              tt[0][ss][jj][h] = __hadd2(e[0], e[1]);
              tt[1][ss][jj][h] = __hsub2(e[1], e[0]);
              tt[2][ss][jj][h] = __hsub2(e[0], e[2]);
            }
          }
        }
      }
      PROBE(1);
      // (B^T d) B along the columns, into wgmma's A registers (a0 / a1 the
      // low channel pair of tiles s = 0 / 1, a2 / a3 the high pair), and
      // the row's four wgmmas
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        uint32_t A[4][4];
#pragma unroll
        for (int ss = 0; ss < 2; ++ss)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const __nv_bfloat162 t0 = tt[k][ss][0][h], t1 = tt[k][ss][1][h];
            const __nv_bfloat162 t2 = tt[k][ss][2][h], t3 = tt[k][ss][3][h];
            A[0][2 * h + ss] = b2u(__hsub2(t0, t2));
            A[1][2 * h + ss] = b2u(__hadd2(t1, t2));
            A[2][2 * h + ss] = b2u(__hsub2(t2, t1));
            A[3][2 * h + ss] = b2u(__hsub2(t1, t3));
          }
        PROBE(1);
        wgmma_fence();
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const uint64_t desc = u_desc(stage + (4 * (G + k) + v) * U_POINT);
          if (G == 1 && k > 0)
            wgmma_rs<-1>(acc[v], A[v], desc);
          else
            wgmma_rs<1>(acc[v], A[v], desc);
        }
        PROBE(2);
      }
      wgmma_commit();
      if (++s == STAGES) {
        s = 0;
        parity ^= 1;
      }
    }
    wgmma_wait0();               // the block's last chunk: release its stage
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int e = 0; e < 32; ++e) fence_operand(acc[v][e]);
    if (lane == 0)
      mbar_arrive(bars + 8 * (STAGES + (s == 0 ? STAGES - 1 : s - 1)));
    PROBE(2);

    // ---- epilogue: Y[G][j] = P A, rounded to bf16, into output row G ----
    const int gtc = k0.tc0 + col;
#pragma unroll
    for (int ss = 0; ss < 2; ++ss) {
      const int gtr = k0.tr0 + trl + ss;
      if (gtr >= th || gtc >= tw) continue;
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        __nv_bfloat16* dst =
            p.y + (((long long)k0.b * p.H + p.d * (2 * gtr + G) + k0.p0 +
                    ph) * p.W + p.d * (2 * gtc + jp) + k0.q) * p.Cout;
#pragma unroll
        for (int jb = 0; jb < NB / 8; ++jb) {
          float o[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * jb + 2 * ss + c;
            o[c] = jp == 0 ? acc[0][e] + acc[1][e] + acc[2][e]
                           : acc[1][e] - acc[2][e] - acc[3][e];
          }
          const int co = k0.co0 + 8 * jb + 2 * lq;
          if (even && co < p.Cout) {
            *reinterpret_cast<__nv_bfloat162*>(dst + co) =
                __floats2bfloat162_rn(o[0], o[1]);
          } else {
            if (co < p.Cout) dst[co] = __float2bfloat16(o[0]);
            if (co + 1 < p.Cout) dst[co + 1] = __float2bfloat16(o[1]);
          }
        }
      }
    }
    PROBE(3);
  }
#ifdef WINOGRAD_PROBE
  if (lane == 0)
    for (int i = 0; i < 4; ++i)
      atomicAdd(&g_probe[threadIdx.x >> 5][i], probe[i]);
#endif
}

// TMA: x and U by TMA, else by the producer's plain loads
template <bool TMA>
__global__ void __launch_bounds__(NT, 1)
    winograd_f23_bf16_wgmma(const __grid_constant__ CUtensorMap tmx,
                            const __grid_constant__ CUtensorMap tmu,
                            const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // stages 1024-aligned
  const uint32_t bars = base + BAR_OFF;         // full[s], then empty[s]

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // TMA: one arrive with the bytes; plain: every producer thread
      mbar_init(bars + 8 * s, TMA ? 1 : NP);
      mbar_init(bars + 8 * (STAGES + s), 8);    // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---- producer -------------------------------------------------------
    // the TMA path's producer is one thread issuing copies; the plain
    // path's copies take more registers
    if (TMA)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int pt = threadIdx.x & 127;
    if (TMA && pt != 0) return;
#ifdef WINOGRAD_PROBE
    unsigned long long probe[4] = {0, 0, 0, 0};
    long long probe_t = clock64();
#endif
    int s = 0, it = 0;
    uint32_t parity = 0;
    for (int bid = blockIdx.x; bid < p.n_blocks; bid += gridDim.x) {
      const Blk k = decode(p, bid);
      for (int j = 0; j < p.n_chunks; ++j, ++it) {
        const uint32_t stage = base + s * STAGE_BYTES, full = bars + 8 * s;
        if (it >= STAGES) mbar_wait(bars + 8 * (STAGES + s), parity ^ 1);
        PROBE(0);
        if (TMA) {
          mbar_expect_tx(full, p.x_bytes + U_BYTES);
          tma_load_5d(stage, &tmu, full, k.co0, 0, 4 * j, 0, 0);
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            // the slab's first column of this parity, in x's columns
            const int w0 = p.d * (2 * k.tc0 - 1 + par) + k.q;
            int c0 = KC * j, c1 = w0;
            if (p.d > MAX_STRIDED_D) {   // group w0 / 2d (floor), place in it
              c1 = k.tc0 - 1 + par;
              c0 += (w0 - 2 * p.d * c1) * p.Cin;
            }
            tma_load_5d(stage + U_BYTES + par * X_HALF, &tmx, full, c0, c1,
                        k.p0, 2 * k.tr0 - 1, k.b);
          }
        } else {
          copy_plain(p, stage, j, k, pt);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(full);
        }
        PROBE(1);
        if (++s == STAGES) {
          s = 0;
          parity ^= 1;
        }
      }
    }
#ifdef WINOGRAD_PROBE
    if ((pt & 31) == 0)
      for (int i = 0; i < 4; ++i)
        atomicAdd(&g_probe[threadIdx.x >> 5][i], probe[i]);
#endif
  } else {
    // ---- consumers ------------------------------------------------------
    if (TMA)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    if (wg == 0)
      consume<0>(p, base, bars);
    else
      consume<1>(p, base, bars);
  }
}

// ---- host ---------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// x as (C, W, row phase, phase row, batch): element stride 2d along W, so a
// box holds every other column of one column phase; for d > 4 as (2d C, W /
// 2d, row phase, phase row, batch), where the box's column of a group is
// the innermost coordinate and its next column one group on. U as (n, e,
// qj, h, point) with channel 4 qj + 2 h + e, so a box lands the chunk's
// rows in k_channel order, 128-byte swizzled
int encode_maps(CUtensorMap* tmx, CUtensorMap* tmu, const Params& p, int B) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUresult r = CUDA_SUCCESS;
  const cuuint64_t C = p.Cin, O = p.ldu, d = p.d;
  const bool strided = p.d <= MAX_STRIDED_D;
  const cuuint64_t xdim[5] = {strided ? C : 2 * d * C,
                              strided ? (cuuint64_t)p.W : p.W / (2 * d), d,
                              (cuuint64_t)p.H / d, (cuuint64_t)B};
  const cuuint64_t xstr[4] = {strided ? 2 * C : 4 * d * C, 2 * C * p.W,
                              2 * C * p.W * d, 2 * C * p.W * p.H};
  const cuuint32_t xbox[5] = {
      KC, (cuuint32_t)(strided ? 2 * d * (p.TC + 1) : p.TC + 1),
      (cuuint32_t)p.P, (cuuint32_t)(2 * p.TRp + 2), 1};
  const cuuint32_t xel[5] = {1, (cuuint32_t)(strided ? 2 * d : 1), 1, 1, 1};
  r = encode(tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
               const_cast<__nv_bfloat16*>(p.x), xdim, xstr, xbox, xel,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const cuuint64_t udim[5] = {O, 2, C / 4, 2, 16};
  const cuuint64_t ustr[4] = {2 * O, 8 * O, 4 * O, 2 * C * O};
  const cuuint32_t ubox[5] = {NB, 2, 4, 2, 16};
  const cuuint32_t uel[5] = {1, 1, 1, 1, 1};
  if (r == CUDA_SUCCESS)
    r = encode(tmu, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
               const_cast<__nv_bfloat16*>(p.u), udim, ustr, ubox, uel,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int winograd_f23_fwd_bf16(const void* x, const void* u, void* y,
                                     int B, int H, int W, int Cin, int Cout,
                                     int ldu, int d, int P, int TC, int tma,
                                     void* stream) {
  if (B < 0 || d < 1 || H < 2 * d || W < 2 * d || H % (2 * d) ||
      W % (2 * d) || Cin < 1 || Cout < 1 || ldu < Cout ||
      (TC != 4 && TC != 8) ||
      (P != 1 && P != 2 && P != 4) || d % P)
    return (int)cudaErrorInvalidValue;
  if (tma && (Cin % 8 || (d > MAX_STRIDED_D && Cin % KC) || ldu % 8 ||
              !aligned16(x) || !aligned16(u)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.u = static_cast<const __nv_bfloat16*>(u);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.ldu = ldu; p.d = d;
  p.P = P; p.TC = TC; p.TRp = 64 / (TC * P);
  const int th = H / (2 * d), tw = W / (2 * d);
  p.n_pg = d / P;
  p.n_trb = (th + p.TRp - 1) / p.TRp;
  p.n_tcb = (tw + TC - 1) / TC;
  p.n_cb = (Cout + NB - 1) / NB;
  p.n_chunks = (Cin + KC - 1) / KC;
  p.x_bytes = 2 * (2 * p.TRp + 2) * P * (TC + 1) * 32;
  p.uvec = ldu % 8 == 0 && aligned16(u);
  const long long blocks =
      (long long)B * p.n_pg * d * p.n_trb * p.n_tcb * p.n_cb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.n_blocks = (int)blocks;
  // persistent: one block an SM, each walking blocks bid, bid + grid, ..
  static int sm_count[MAXDEV] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAXDEV) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (int)(blocks < sm_count[dev] ? blocks : sm_count[dev]);
  CUtensorMap tmx, tmu;
  memset(&tmx, 0, sizeof(tmx));
  memset(&tmu, 0, sizeof(tmu));
  if (tma) {
    const int merr = encode_maps(&tmx, &tmu, p, B);
    if (merr) return merr;
  }
  auto kernel = tma ? winograd_f23_bf16_wgmma<true>
                    : winograd_f23_bf16_wgmma<false>;
  // each kernel's dynamic shared memory limit is raised on its first
  // launch on this device, not on every launch (a race only sets it twice)
  static bool raised[2][MAXDEV];
  if (!raised[tma != 0][dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    raised[tma != 0][dev] = true;
  }
  kernel<<<grid, NT, SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(tmx, tmu, p);
  return (int)cudaGetLastError();
}

extern "C" int winograd_f23_bf16_smem_bytes() { return SMEM_BYTES; }

#ifdef WINOGRAD_PROBE
// copies the phase cycles ([12 warps][4] u64) to `out` and zeroes them
extern "C" int winograd_f23_bf16_probe(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  static const unsigned long long zero[12][4] = {};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  return (int)err;
}
#endif
