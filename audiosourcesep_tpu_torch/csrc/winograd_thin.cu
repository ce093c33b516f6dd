// Winograd F(2x2,3x3) convolution for Hopper (sm_90a), NHWC, float32, at
// thin channel counts: few input channels (C_in <= 4) or few output
// channels (C_out <= 16). The wide classes stay on winograd.cu.
//
// Replaces: audiosourcesep_tpu/ops/winograd.py::_wino_kernel (launched by
// _winograd_pallas, behind winograd_conv2d and dilated_winograd_conv2d) for
// float32 inputs whose channels are thin: Glow's coupling convs (2/4 ->
// 512 and 512 -> 4/8/16), the NCSN's begin_conv (1 -> 192) and end_conv
// (192 -> 1), Flow++'s 3 -> 96. Same math as winograd.cu: a 3x3 stride-1
// SAME conv per 2x2 output tile, Y = A^T [sum_cin U . V] A, f32 FMA
// accumulation (no TF32); the bias is the caller's job. Dilation d works on
// the d*d phase grids in place, as in winograd.cu. At C_in = 8 to 12 the
// wide kernel's 8-tile x 8-channel outer product already fills its chunk
// and was the faster on the card (Glow's 8 -> 512, Flow++'s 6/12 -> 32/96).
//
// What bounds it on this card: bytes. A thin conv moves its wide side (x of
// 512 channels, or y of 512) once and does 16 * C_in * C_out FMAs a tile
// on top, so at 48x32 512 -> 4 (batch 30) 94 MB of x take 28 us at 3.35
// TB/s against 11 us of FMAs at the f32 peak. Next comes the instruction
// stream: the transform B^T d B (32 adds a tile and channel) and the shared
// memory reads are as many as the FMAs when C_out is 4.
//
// What the design does about it (winograd.cu's block of 32 tiles x 64
// C_out spends 60 of every 64 FMAs on zero channels at C_out = 4, one block
// walks all 512 C_in, and at C_in = 2 a block is all prologue and epilogue
// while y, not the FMAs, bounds the conv):
// - thin_out (C_out <= 16, C_in a multiple of 4): a tile's 16 points are
//   split over two threads (rows u = 0, 1 and u = 2, 3 of V, each from 3
//   of the patch's 4 rows), each with CB = 4 output channels (CB = 1 at
//   C_out = 1): 32 accumulators, so three blocks of 128 threads fit on an
//   SM. A block is G = C_out / 4 groups of 2 x 64 / G threads over a box
//   of images x tile rows x tile columns that the wrapper fits to the
//   phase grid, so every accumulator holds a real channel. A thread forms
//   its half of V for 4 input channels at once from twelve 16-byte reads of
//   the slab, then runs 8 x 4 x CB FMAs against U, which the lanes of a
//   warp read at one address (a broadcast). The slab holds a pixel's
//   channels in one slot of PIXW = 12 (or 4) floats, a row's even columns
//   before its odd ones, so the 8 lanes of a quarter warp (consecutive
//   tiles) read 8 different 16-byte bank groups. C_in is split over the n
//   blocks of a thread-block cluster (n <= 8): block rank r walks its
//   chunks of 8 (or 4) channels through a 3-stage cp.async ring of x slab
//   and U. The partial M [tiles][C_out][16] of each block then sits in its
//   shared memory; rank r reads the tiles of its slice (1/n of the box)
//   from every block of the cluster through distributed shared memory,
//   adds them in rank order 0, 1, ..., n - 1 (each rank's partial summed
//   over its chunks in order), forms Y = A^T M A and writes y. The order
//   is fixed, so a result is the same from run to run; nothing goes
//   through HBM atomics. x must be 16-byte aligned (the wrapper copies x
//   that is not); C_out that is not a multiple of 4 takes 4-byte copies
//   of U.
// - thin_in (C_in <= 4): weights stationary. A lane owns one output
//   channel and keeps its U [C_in][16] in registers; a warp's 32 lanes are
//   32 consecutive channels, so every store of y is 128 contiguous bytes.
//   A block (Wc channel warps x Wt tile warps: 32 Wc channels) copies its
//   box's x slab once (4-byte cp.async: all of C_in is one stage, no
//   ring), forms V of every tile and input channel once into shared
//   memory, and then each warp walks its share of the box's tiles for its
//   32 channels: V read as 16-byte broadcasts, 16 C_in FMAs, Y = A^T M A in
//   registers, four stores. No shared-memory fold. The channel warps share
//   the slab and V; the tile warps give an SM more warps in flight where
//   C_out is small.
//
// C interface (bound with ctypes): winograd_f23_fwd_f32_thin(x, u, y, B, H,
// W, Cin, Cout, d, path, nimg, trb, tcb, split, cwarps, stream): x
// [B,H,W,Cin], U [16,Cin,Cout], y [B,H,W,Cout], float32, dilation d (H, W
// divisible by 2d); path 0 thin_in, 1 thin_out; the box of nimg phase-grid
// images x trb tile rows x tcb tile columns (thin_out: 64 / G tiles,
// thin_in: up to 64); split: thin_out's cluster (the blocks C_in is split
// over), thin_in's tile warps Wt; cwarps: thin_in's channel warps Wc
// (thin_out: 4). It launches on `stream`, allocates nothing, and returns
// cudaGetLastError() (or an error code for a call it does not take). The
// first launch of each kernel on a device raises the kernel's dynamic
// shared memory limit to SMEM_MAX; later launches skip that call.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;         // thin_out threads per block
constexpr int MINB = 3;         // thin_out blocks an SM (register budget)
constexpr int MAXPIECE = 8;     // 16-byte x pieces a thread copies a chunk
constexpr int MAXSTAGE = 3;     // thin_out ring stages
constexpr int MAXC = 4;         // thin_in's C_in: a lane's U registers
constexpr int MAXCOUT = 16;     // thin_out's C_out
constexpr int IN_THREADS = 512; // thin_in threads a block, at most
constexpr int MAXCLUSTER = 8;   // portable cluster size
constexpr int SMEM_MAX = 227 * 1024;
constexpr int MAXDEV = 64;      // devices whose kernel limits are raised

// the phase grids and the box of a block, for both paths
struct Grid {
  int H, W, Cin, Cout, d;
  int NI, gh, gw, th, tw;       // phase-grid images (B d^2), grid, tiles
  int nimg, trb, tcb, tpb;      // box; tiles per block
  int sr, sc;                   // slab rows and columns
  int n_trb, n_tcb, n_inner;    // C_out blocks (thin_in) or cluster
  int cwarps;                   // thin_in's channel warps
};

struct OutGeo {
  Grid g;
  int hh, scp;                  // slab half row, row pitch (slots)
  int kc, ppp, pixw;            // channels a chunk, pieces a pixel, slot
  int co;                       // channels a block (padded to 4)
  int nch, stages;              // chunks of C_in; ring stages
  int slab_words, stage_words, npieces;
  int cv;                       // 16-byte U pieces
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte async copy; src_size 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}
__device__ __forceinline__ float4 f4add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 f4sub(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}
__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Y = A^T M A of one tile and channel; m[4 u + v]
__device__ __forceinline__ void output_tile(const float* m, float Y[2][2]) {
  float r0[4], r1[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    r0[a] = m[4 * a] + m[4 * a + 1] + m[4 * a + 2];
    r1[a] = m[4 * a + 1] - m[4 * a + 2] - m[4 * a + 3];
  }
  Y[0][0] = r0[0] + r0[1] + r0[2];
  Y[1][0] = r0[1] - r0[2] - r0[3];
  Y[0][1] = r1[0] + r1[1] + r1[2];
  Y[1][1] = r1[1] - r1[2] - r1[3];
}

// V = B^T d B of one tile and channel; d[4 i + j] in, V[4 u + v] out
__device__ __forceinline__ void input_tile(float* v) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float d0 = v[j], d1 = v[4 + j], d2 = v[8 + j], d3 = v[12 + j];
    v[j] = d0 - d2;
    v[4 + j] = d1 + d2;
    v[8 + j] = d2 - d1;
    v[12 + j] = d1 - d3;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float t0 = v[4 * a], t1 = v[4 * a + 1], t2 = v[4 * a + 2],
                t3 = v[4 * a + 3];
    v[4 * a] = t0 - t2;
    v[4 * a + 1] = t1 + t2;
    v[4 * a + 2] = t2 - t1;
    v[4 * a + 3] = t1 - t3;
  }
}

// the box-local tile t of a block: (image, tile row, tile column)
struct Tile {
  int img, tr, tc;
};
__device__ __forceinline__ Tile tile_of(const Grid& g, int t) {
  return {t / (g.tcb * g.trb), (t / g.tcb) % g.trb, t % g.tcb};
}
// x (or y) pixel index (b H + row) W + col of phase-grid image ii, phase
// grid pixel (r, c)
__device__ __forceinline__ int pixel_of(const Grid& g, int ii, int r, int c) {
  const int dd = g.d * g.d, b = ii / dd, ph = ii - b * dd;
  return (b * g.H + g.d * r + ph / g.d) * g.W + g.d * c + ph % g.d;
}

// ---------------------------------------------------------------------------
// thin_out: C_in over a cluster, half a tile's points a thread
// ---------------------------------------------------------------------------
// CB: output channels a thread (4, or 1 for C_out = 1)
template <int CB>
__global__ void __launch_bounds__(NT, MINB)
    winograd_f23_f32_thin_out_kernel(const float* __restrict__ x,
                                     const float* __restrict__ u,
                                     float* __restrict__ y, const OutGeo o) {
  extern __shared__ __align__(128) float sm[];
  const Grid& g = o.g;
  const int tid = threadIdx.x;
  int bid = blockIdx.x / g.n_inner;    // the cluster: consecutive blocks
  const int tcb_i = bid % g.n_tcb;
  bid /= g.n_tcb;
  const int trb_i = bid % g.n_trb;
  const int ib = bid / g.n_trb;
  const int tr0 = trb_i * g.trb, tc0 = tcb_i * g.tcb, ii0 = ib * g.nimg;
  const int Cin = g.Cin, Cout = g.Cout;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), nrank = g.n_inner;
  const int lo = rank * o.nch / nrank, hi = (rank + 1) * o.nch / nrank;

  // ---- this thread: tile t, rows 2 hf, 2 hf + 1 of V, channels grp ------
  const int t = tid % g.tpb, hf = (tid / g.tpb) & 1, grp = tid / g.tpb >> 1;
  const Tile tl = tile_of(g, t);
  // slot of patch row hf (the first of the three it reads), column 0
  const int prow = (tl.img * g.sr + 2 * tl.tr + hf) * o.scp + tl.tc;

  // ---- copy roles: x pieces (pixel, 4 channels), the same every chunk ----
  int xsrc[MAXPIECE], xdst[MAXPIECE];
  const int slab_px = g.nimg * g.sr * g.sc;
#pragma unroll
  for (int k = 0; k < MAXPIECE; ++k) {
    xsrc[k] = -1;
    xdst[k] = -1;
    if (k >= o.npieces) continue;
    const int e = tid + k * NT;
    const int pix = e / o.ppp, q = e - pix * o.ppp;
    if (pix >= slab_px) continue;
    const int im = pix / (g.sr * g.sc), rem = pix - im * g.sr * g.sc;
    const int sr = rem / g.sc, sc = rem - sr * g.sc;
    xdst[k] = ((im * g.sr + sr) * o.scp + (sc & 1) * o.hh + (sc >> 1)) *
                  o.pixw + 4 * q;
    const int ii = ii0 + im, gr = 2 * tr0 - 1 + sr, gc = 2 * tc0 - 1 + sc;
    if (ii < g.NI && gr >= 0 && gr < g.gh && gc >= 0 && gc < g.gw)
      xsrc[k] = pixel_of(g, ii, gr, gc) * Cin + 4 * q;
  }
  // chunk j's x -> stage s: zeros outside the grid (the chunks are whole)
  auto copy_x = [&](int j, int s) {
    float* st = sm + s * o.stage_words;
#pragma unroll
    for (int k = 0; k < MAXPIECE; ++k) {
      if (xdst[k] < 0) continue;
      const bool ok = xsrc[k] >= 0;
      cp_async16(smem_u32(st + xdst[k]),
                 x + (ok ? (long long)xsrc[k] + j * o.kc : 0), ok);
    }
  };
  // chunk j's U [kc][16][co] -> stage s: zeros past C_out
  auto copy_u = [&](int j, int s) {
    float* st = sm + s * o.stage_words + o.slab_words;
    const int c4n = o.co >> 2, nq = o.kc * 16 * c4n;
    for (int e = tid; e < nq; e += NT) {
      const int c4 = e % c4n, rest = e / c4n, p = rest & 15, c = rest >> 4;
      const int ci = j * o.kc + c, oc = 4 * c4;
      const float* src = u + ((long long)p * Cin + ci) * Cout + oc;
      const uint32_t dst = smem_u32(st + (c * 16 + p) * o.co + 4 * c4);
      if (o.cv) {
        cp_async16(dst, oc < Cout ? src : u, oc < Cout);
      } else {
#pragma unroll
        for (int e2 = 0; e2 < 4; ++e2)
          cp_async4(dst + 4 * e2, oc + e2 < Cout ? src + e2 : u,
                    oc + e2 < Cout);
      }
    }
  };

  float acc[8][CB];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int k = 0; k < CB; ++k) acc[p][k] = 0.f;

  // chunk (stage s): rows 2 hf, 2 hf + 1 of V for 4 input channels at a
  // time (from patch rows hf .. hf + 2), then the FMAs
  auto compute = [&](int s) {
    const float* xs = sm + s * o.stage_words;
    const float* us = xs + o.slab_words + 8 * hf * o.co + grp * CB;
    for (int h = 0; h < (o.kc >> 2); ++h) {
      float4 v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {    // rows 2 hf, 2 hf + 1 of B^T d
        const float* col = xs + ((j & 1) * o.hh + (j >> 1) + prow) * o.pixw +
                           4 * h;
        const float4 d0 = *reinterpret_cast<const float4*>(col);
        const float4 d1 =
            *reinterpret_cast<const float4*>(col + o.scp * o.pixw);
        const float4 d2 =
            *reinterpret_cast<const float4*>(col + 2 * o.scp * o.pixw);
        // d0..d2 are patch rows hf..hf + 2; of patch rows p0..p3 the
        // thread needs (p0 - p2, p1 + p2) at hf = 0, (p2 - p1, p1 - p3) at 1
        v[j] = hf ? f4sub(d1, d0) : f4sub(d0, d2);
        v[4 + j] = hf ? f4sub(d0, d2) : f4add(d1, d2);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {    // (B^T d) B
        const float4 t0 = v[4 * a], t1 = v[4 * a + 1], t2 = v[4 * a + 2],
                     t3 = v[4 * a + 3];
        v[4 * a] = f4sub(t0, t2);
        v[4 * a + 1] = f4add(t1, t2);
        v[4 * a + 2] = f4sub(t2, t1);
        v[4 * a + 3] = f4sub(t1, t3);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {    // input channel 4 h + k
        const float* ur = us + (4 * h + k) * 16 * o.co;
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const float vv = comp(v[p], k);
          if constexpr (CB == 4) {
            const float4 w = *reinterpret_cast<const float4*>(ur + p * o.co);
            acc[p][0] = fmaf(vv, w.x, acc[p][0]);
            acc[p][1] = fmaf(vv, w.y, acc[p][1]);
            acc[p][2] = fmaf(vv, w.z, acc[p][2]);
            acc[p][3] = fmaf(vv, w.w, acc[p][3]);
          } else {
            acc[p][0] = fmaf(vv, ur[p * o.co], acc[p][0]);
          }
        }
      }
    }
  };

  // ---- the ring over this block's chunks [lo, hi) -----------------------
  // stage i % ns holds chunk lo + i. Iteration i waits for chunk lo + i,
  // meets the block at the barrier (after which every thread is done with
  // chunk lo + i - 1, whose stage is refilled now with chunk lo + i + ns -
  // 1), and computes. One stage (one chunk a block) copies, waits and
  // computes.
  const int nmy = hi - lo, ns = o.stages;
  for (int s = 0; s < ns - 1; ++s) {
    if (s < nmy) {
      copy_x(lo + s, s);
      copy_u(lo + s, s);
    }
    cp_async_commit();
  }
  for (int i = 0; i < nmy; ++i) {
    if (ns == 1) {
      copy_x(lo + i, 0);
      copy_u(lo + i, 0);
      cp_async_commit();
      cp_async_wait<0>();
    } else if (ns == 2) {
      cp_async_wait<0>();
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();
    if (ns > 1) {
      const int in = i + ns - 1;
      if (in < nmy) {
        copy_x(lo + in, in % ns);
        copy_u(lo + in, in % ns);
      }
      cp_async_commit();
    }
    compute(i % ns);
  }

  // ---- the cluster's reduction, in rank order, and the epilogue ---------
  cp_async_wait<0>();
  __syncthreads();                     // the ring's memory becomes M
  const int ms = 16 * o.co + 4;        // floats per tile of M
  float* const Ms = sm;                // [tpb][co][16], each tile padded
#pragma unroll
  for (int k = 0; k < CB; ++k)
#pragma unroll
    for (int p4 = 0; p4 < 2; ++p4)
      *reinterpret_cast<float4*>(Ms + t * ms + (grp * CB + k) * 16 + 8 * hf +
                                 4 * p4) =
          make_float4(acc[4 * p4][k], acc[4 * p4 + 1][k], acc[4 * p4 + 2][k],
                      acc[4 * p4 + 3][k]);
  cluster.sync();
  const int t_lo = rank * g.tpb / nrank, t_hi = (rank + 1) * g.tpb / nrank;
  const int npair = (t_hi - t_lo) * Cout;
  for (int q = tid; q < npair; q += NT) {
    const int tt = t_lo + q / Cout, oc = q % Cout;
    const Tile ot = tile_of(g, tt);
    const int ii = ii0 + ot.img, otr = tr0 + ot.tr, otc = tc0 + ot.tc;
    if (ii >= g.NI || otr >= g.th || otc >= g.tw) continue;
    float m[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) m[p] = 0.f;
    for (int rk = 0; rk < nrank; ++rk) {
      const float* src = cluster.map_shared_rank(Ms, rk) + tt * ms + oc * 16;
#pragma unroll
      for (int p4 = 0; p4 < 4; ++p4) {
        const float4 a = *reinterpret_cast<const float4*>(src + 4 * p4);
        m[4 * p4] += a.x;
        m[4 * p4 + 1] += a.y;
        m[4 * p4 + 2] += a.z;
        m[4 * p4 + 3] += a.w;
      }
    }
    float Y[2][2];
    output_tile(m, Y);
    const long long pix = pixel_of(g, ii, 2 * otr, 2 * otc);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        y[(pix + (long long)g.d * (i * g.W + j)) * Cout + oc] = Y[i][j];
  }
  cluster.sync();                      // peers' M stays until all have read
}

// ---------------------------------------------------------------------------
// thin_in: weights stationary, a lane per output channel
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(IN_THREADS)
    winograd_f23_f32_thin_in_kernel(const float* __restrict__ x,
                                    const float* __restrict__ u,
                                    float* __restrict__ y, const Grid g) {
  extern __shared__ __align__(128) float sm[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int cw = (tid >> 5) % g.cwarps, tw = (tid >> 5) / g.cwarps;
  const int twarps = (nthr >> 5) / g.cwarps;
  int bid = blockIdx.x;
  const int cob = bid % g.n_inner;     // C_out block, fastest: x from L2
  bid /= g.n_inner;
  const int tcb_i = bid % g.n_tcb;
  bid /= g.n_tcb;
  const int trb_i = bid % g.n_trb;
  const int ib = bid / g.n_trb;
  const int tr0 = trb_i * g.trb, tc0 = tcb_i * g.tcb, ii0 = ib * g.nimg;
  const int Cin = g.Cin, Cout = g.Cout;
  const int slab_px = g.nimg * g.sr * g.sc;
  float* const S = sm;                          // [Cin][slab pixels]
  float* const Vs = S + ((Cin * slab_px + 3) & ~3);  // [tpb][Cin][16]
  int* const Ts = reinterpret_cast<int*>(Vs + g.tpb * Cin * 16);  // [tpb]

  // the slab by 4-byte async copies, all in flight at once (zeros outside
  // the phase grid): lanes on consecutive channels
  for (int e = tid; e < Cin * slab_px; e += nthr) {
    const int pix = e / Cin, c = e - pix * Cin;
    const int im = pix / (g.sr * g.sc), rem = pix - im * g.sr * g.sc;
    const int sr = rem / g.sc, sc = rem - sr * g.sc;
    const int ii = ii0 + im, gr = 2 * tr0 - 1 + sr, gc = 2 * tc0 - 1 + sc;
    const bool ok = ii < g.NI && gr >= 0 && gr < g.gh && gc >= 0 && gc < g.gw;
    cp_async4(smem_u32(S + c * slab_px + pix),
              ok ? x + (long long)pixel_of(g, ii, gr, gc) * Cin + c : x, ok);
  }
  cp_async_commit();
  // each tile's first output pixel (-1 outside the grid)
  for (int t = tid; t < g.tpb; t += nthr) {
    const Tile tl = tile_of(g, t);
    const int ii = ii0 + tl.img, otr = tr0 + tl.tr, otc = tc0 + tl.tc;
    Ts[t] = (ii < g.NI && otr < g.th && otc < g.tw)
                ? pixel_of(g, ii, 2 * otr, 2 * otc) : -1;
  }
  // this lane's channel and its U [C_in][16] in registers
  const int oc = 32 * (cob * g.cwarps + cw) + (tid & 31);
  const bool live = oc < Cout;
  float ur[MAXC][16];
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
#pragma unroll
    for (int p = 0; p < 16; ++p)
      ur[c][p] = (live && c < Cin) ? u[((long long)p * Cin + c) * Cout + oc]
                                   : 0.f;
  cp_async_wait<0>();
  __syncthreads();
  // V of every (tile, input channel) once
  for (int e = tid; e < g.tpb * Cin; e += nthr) {
    const int t = e / Cin, c = e - t * Cin;
    const Tile tl = tile_of(g, t);
    const float* s = S + c * slab_px + (tl.img * g.sr + 2 * tl.tr) * g.sc +
                     2 * tl.tc;
    float v[16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[4 * i + j] = s[i * g.sc + j];
    input_tile(v);
    float4* dst = reinterpret_cast<float4*>(Vs + e * 16);
#pragma unroll
    for (int p4 = 0; p4 < 4; ++p4)
      dst[p4] = make_float4(v[4 * p4], v[4 * p4 + 1], v[4 * p4 + 2],
                            v[4 * p4 + 3]);
  }
  __syncthreads();
  if (!live) return;

  // tile warp tw walks tiles tw, tw + Wt, ...
  for (int t = tw; t < g.tpb; t += twarps) {
    const int pix = Ts[t];
    if (pix < 0) continue;
    float m[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) m[p] = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c >= Cin) break;
      const float4* vs = reinterpret_cast<const float4*>(Vs + (t * Cin + c) *
                                                         16);
#pragma unroll
      for (int p4 = 0; p4 < 4; ++p4) {
        const float4 v = vs[p4];
        m[4 * p4] = fmaf(v.x, ur[c][4 * p4], m[4 * p4]);
        m[4 * p4 + 1] = fmaf(v.y, ur[c][4 * p4 + 1], m[4 * p4 + 1]);
        m[4 * p4 + 2] = fmaf(v.z, ur[c][4 * p4 + 2], m[4 * p4 + 2]);
        m[4 * p4 + 3] = fmaf(v.w, ur[c][4 * p4 + 3], m[4 * p4 + 3]);
      }
    }
    float Y[2][2];
    output_tile(m, Y);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        y[((long long)pix + (long long)g.d * (i * g.W + j)) * Cout + oc] =
            Y[i][j];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// cudaLaunchKernelEx of `kernel` with a cluster of `cluster` blocks along
// x (0: not a cluster launch); the kernel's dynamic shared memory limit is
// raised to SMEM_MAX on its first launch on the current device (a race
// only sets it twice)
template <auto kernel, typename Geo>
int launch(const void* x, const void* u, void* y, const Geo& geo,
           int blocks, int threads, int cluster, int smem, cudaStream_t s) {
  static bool raised[MAXDEV];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAXDEV || !raised[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAXDEV) raised[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(x),
                           static_cast<const float*>(u),
                           static_cast<float*>(y), geo);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int winograd_f23_fwd_f32_thin(const void* x, const void* u,
                                         void* y, int B, int H, int W,
                                         int Cin, int Cout, int d, int path,
                                         int nimg, int trb, int tcb,
                                         int split, int cwarps,
                                         void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (B < 0 || d < 1 || H < 2 * d || W < 2 * d || H % (2 * d) ||
      W % (2 * d) || Cin < 1 || Cout < 1 || nimg < 1 || trb < 1 || tcb < 1 ||
      (path != 0 && path != 1))
    return bad;
  // the x and y pixel indices are 32-bit, and x's offsets
  if ((long long)B * H * W * Cin >= (1LL << 31)) return bad;
  const bool out = path == 1;
  if (out ? (Cout > MAXCOUT || Cin % 4 || split < 1 ||
             split > MAXCLUSTER || cwarps != NT / 32 || !aligned16(x))
          : (Cin > MAXC || split < 1 || cwarps < 1 || cwarps > 4 ||
             32 * split * cwarps > IN_THREADS))
    return bad;
  if (B == 0) return (int)cudaSuccess;
  Grid g;
  g.H = H; g.W = W; g.Cin = Cin; g.Cout = Cout; g.d = d;
  g.NI = B * d * d; g.gh = H / d; g.gw = W / d;
  g.th = g.gh / 2; g.tw = g.gw / 2;
  g.nimg = nimg; g.trb = trb; g.tcb = tcb; g.tpb = nimg * trb * tcb;
  g.sr = 2 * trb + 2; g.sc = 2 * tcb + 2;
  g.n_trb = ceil_div(g.th, trb);
  g.n_tcb = ceil_div(g.tw, tcb);
  const long long boxes = (long long)ceil_div(g.NI, nimg) * g.n_trb * g.n_tcb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slab_px = nimg * g.sr * g.sc;

  if (!out) {
    const int threads = 32 * split * cwarps;
    g.cwarps = cwarps;
    g.n_inner = ceil_div(Cout, 32 * cwarps);
    if (g.tpb > 64) return bad;
    const long long words =
        ((Cin * slab_px + 3) & ~3) + (long long)g.tpb * Cin * 16 + g.tpb;
    if (4 * words > SMEM_MAX || boxes * g.n_inner > 0x7fffffffLL) return bad;
    const int blocks = (int)(boxes * g.n_inner), smem = (int)(4 * words);
    return launch<winograd_f23_f32_thin_in_kernel>(x, u, y, g, blocks,
                                                   threads, 0, smem, s);
  }

  OutGeo o;
  const int cb = Cout == 1 ? 1 : 4, ngrp = ceil_div(Cout, cb);
  o.co = cb == 1 ? 4 : 4 * ngrp;
  if (2 * ngrp * g.tpb != NT) return bad;
  o.hh = tcb + 1; o.scp = g.sc;
  o.kc = Cin % 8 == 0 ? 8 : 4;
  o.ppp = o.kc / 4;
  o.pixw = (o.ppp & 1) ? o.kc : o.kc + 4;
  o.nch = Cin / o.kc;
  g.n_inner = split;
  g.cwarps = cwarps;
  if (split > o.nch) return bad;
  const int per_block = ceil_div(o.nch, split);
  o.stages = per_block < MAXSTAGE ? per_block : MAXSTAGE;
  o.slab_words = nimg * g.sr * o.scp * o.pixw;
  o.stage_words = o.slab_words + o.kc * 16 * o.co;
  o.npieces = ceil_div((long long)slab_px * o.ppp, NT);
  if (o.npieces > MAXPIECE) return bad;
  long long words = (long long)o.stages * o.stage_words;
  if ((long long)g.tpb * (16 * o.co + 4) > words)
    words = (long long)g.tpb * (16 * o.co + 4);
  if (4 * words > SMEM_MAX || boxes * split > 0x7fffffffLL) return bad;
  o.cv = Cout % 4 == 0 && aligned16(u);
  o.g = g;
  const int blocks = (int)(boxes * split), smem = (int)(4 * words);
  if (cb == 1)
    return launch<winograd_f23_f32_thin_out_kernel<1>>(x, u, y, o, blocks,
                                                       NT, split, smem, s);
  return launch<winograd_f23_f32_thin_out_kernel<4>>(x, u, y, o, blocks, NT,
                                                     split, smem, s);
}
