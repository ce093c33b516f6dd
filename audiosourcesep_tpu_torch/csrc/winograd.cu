// Fused Winograd F(2x2,3x3) convolution for Hopper (sm_90a), NHWC, float32
// on the CUDA cores.
//
// Replaces: audiosourcesep_tpu/ops/winograd.py::_wino_kernel (launched by
// _winograd_pallas, behind winograd_conv2d) for float32 inputs; bf16 inputs
// go to the tensor-core kernel in winograd_mma.cu. Same math: SAME 3x3
// stride-1 conv computed per 2x2 output tile as  Y = A^T [ sum_cin
// (G g G^T) . (B^T d B) ] A  with f32 accumulation. The bias is the
// caller's job.
//
// What bounds it on this card: operations, not bytes. The 16
// transform-domain channel contractions (16 * tiles * Cin * Cout FMAs,
// 2.25x fewer than the direct conv) run as f32 FMA on the CUDA cores
// (67 TFLOP/s peak): the tensor cores have no full-f32 product. x, U and y
// are read or written about once per Cout block and mostly hit L2. Within
// that, the FMAs are fed from shared memory (two 8-byte loads per four
// FMAs) and each thread holds 64 accumulators, so a block takes ~250
// registers a thread and only one block (8 warps) fits on an SM: latency,
// not the FMA pipe, sets the rate (about 11 TFLOP/s measured on an H100 at
// 700 W).
//
// What the design does about it: only x, U and y touch device memory.
// Each block owns 32 output tiles x 32 output channels and walks Cin in
// chunks of 8: per chunk every thread builds one (tile, channel) V = B^T d B
// from an NHWC 4x4 patch (the SAME halo is masked to zero, no padded
// copy), the block stages V and the U chunk in shared memory, and each
// thread accumulates all 16 transform points for 2 tiles x 2 channels in
// registers (16*2*2 f32). The next chunk's global loads are issued before
// the current chunk's FMAs (a register-staged software pipeline), which
// hides their latency (1.44x over loading after the FMAs). Shared reads
// are broadcast (V) or one 128-byte wavefront (U); V stores use a padded
// stride so they are conflict-free. The inverse transform A^T M A runs in
// registers and the interleaved NHWC 2x2 output is written directly (no
// phase split, no de-interleave, no channel padding: those existed only
// for Mosaic/VMEM on the TPU).
//
// C interface (bound with ctypes): winograd_f23_fwd_f32(x, u, y, B, H, W,
// Cin, Cout, stream) with x [B,H,W,Cin], U [16,Cin,Cout] and y [B,H,W,Cout],
// all float32; H and W even. It launches on `stream`, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int TP = 32;               // output tiles per block
constexpr int TC = 32;               // output channels per block
constexpr int CK = 8;                // input channels per chunk
constexpr int NT = 256;              // threads per block
constexpr int VSTRIDE = 16 * TP + 4; // per-channel stride of Vs: 516 = 4 mod 32

static_assert(TP * CK == NT, "one (tile, channel) V per thread per chunk");
static_assert((TP / 2) * (TC / 2) == NT, "2 tiles x 2 channels per thread");
constexpr int UPT = CK * 16 * TC / NT;  // U values each thread stages
static_assert(UPT * NT == CK * 16 * TC, "U chunk splits evenly");

__global__ void __launch_bounds__(NT)
    winograd_f23_f32_kernel(const float* __restrict__ x,
                            const float* __restrict__ u,
                            float* __restrict__ y, int B, int H, int W,
                            int Cin, int Cout) {
  __shared__ __align__(16) float Vs[CK * VSTRIDE];   // [k][uv][tile]
  __shared__ __align__(16) float Us[CK * 16 * TC];   // [k][uv][cout]

  const int tid = threadIdx.x;
  const int th = H / 2, tw = W / 2;
  const long long tiles_per_img = (long long)th * tw;
  const long long n_tiles = (long long)B * tiles_per_img;
  const long long tile0 = (long long)blockIdx.x * TP;
  const int co0 = blockIdx.y * TC;

  // load role: tile lp, channel c0 + lk of each chunk
  const int lk = tid % CK;
  const int lp = tid / CK;
  const long long lt = tile0 + lp;
  const bool l_valid = lt < n_tiles;
  long long lbase = 0;   // offset of image lb
  int lr0 = 0, lc0 = 0;  // top-left input pixel of the 4x4 patch (may be -1)
  if (l_valid) {
    const long long lb = lt / tiles_per_img;
    const int rem = (int)(lt - lb * tiles_per_img);
    lbase = lb * H * W * (long long)Cin;
    lr0 = 2 * (rem / tw) - 1;
    lc0 = 2 * (rem % tw) - 1;
  }

  // compute role: tiles cp, cp+1 x channels cc, cc+1, all 16 points
  const int cc = (tid % (TC / 2)) * 2;
  const int cp = (tid / (TC / 2)) * 2;

  float acc[16][2][2];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    acc[i][0][0] = 0.f; acc[i][0][1] = 0.f;
    acc[i][1][0] = 0.f; acc[i][1][1] = 0.f;
  }

  // Software pipeline over C_in chunks: iteration i loads chunk i's x patch
  // and U values into registers, runs the FMAs of chunk i-1 from shared
  // memory while those loads are in flight, then stages chunk i (V = B^T d B
  // and U) in shared memory. One load site keeps d and ur in registers.
  float d[4][4];   // x patch of (tile lp, channel c0 + lk)
  float ur[UPT];   // U values this thread stages
  for (int c0 = 0; c0 < Cin + CK; c0 += CK) {
    const bool have = c0 < Cin;
    if (have) {
      const int c = c0 + lk;
      const bool cvalid = l_valid && c < Cin;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = lr0 + i;
        const float* xrow = x + lbase + ((long long)r * W + lc0) * Cin + c;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = lc0 + j;
          d[i][j] = (cvalid && r >= 0 && r < H && q >= 0 && q < W)
                        ? xrow[j * Cin] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < UPT; ++i) {  // zero-filled past C_in / C_out
        const int e = tid + i * NT;
        const int uv = (e / TC) % 16, k = e / (TC * 16);
        const int ci = c0 + k, o = co0 + e % TC;
        ur[i] = (ci < Cin && o < Cout)
                    ? u[((long long)uv * Cin + ci) * Cout + o] : 0.f;
      }
    }
    if (c0 > 0) {  // FMAs of the chunk staged in the previous iteration
#pragma unroll 2
      for (int k = 0; k < CK; ++k) {
#pragma unroll
        for (int uv = 0; uv < 16; ++uv) {
          const float2 v = *reinterpret_cast<const float2*>(
              Vs + k * VSTRIDE + uv * TP + cp);
          const float2 w = *reinterpret_cast<const float2*>(
              Us + (k * 16 + uv) * TC + cc);
          acc[uv][0][0] = fmaf(v.x, w.x, acc[uv][0][0]);
          acc[uv][0][1] = fmaf(v.x, w.y, acc[uv][0][1]);
          acc[uv][1][0] = fmaf(v.y, w.x, acc[uv][1][0]);
          acc[uv][1][1] = fmaf(v.y, w.y, acc[uv][1][1]);
        }
      }
    }
    __syncthreads();  // shared memory free for the next stage
    if (have) {
      float t[4][4];  // B^T d
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        t[0][j] = d[0][j] - d[2][j];
        t[1][j] = d[1][j] + d[2][j];
        t[2][j] = d[2][j] - d[1][j];
        t[3][j] = d[1][j] - d[3][j];
      }
      float* vs = Vs + lk * VSTRIDE + lp;
#pragma unroll
      for (int a = 0; a < 4; ++a) {  // (B^T d) B
        vs[(a * 4 + 0) * TP] = t[a][0] - t[a][2];
        vs[(a * 4 + 1) * TP] = t[a][1] + t[a][2];
        vs[(a * 4 + 2) * TP] = t[a][2] - t[a][1];
        vs[(a * 4 + 3) * TP] = t[a][1] - t[a][3];
      }
#pragma unroll
      for (int i = 0; i < UPT; ++i) Us[tid + i * NT] = ur[i];
    }
    __syncthreads();  // staged chunk visible to every thread
  }

  // Y = A^T M A, written straight into the interleaved NHWC output
#pragma unroll
  for (int pi = 0; pi < 2; ++pi) {
    const long long t = tile0 + cp + pi;
    if (t >= n_tiles) continue;
    const long long b = t / tiles_per_img;
    const int rem = (int)(t - b * tiles_per_img);
    const int r = 2 * (rem / tw), q = 2 * (rem % tw);
    float* out = y + ((b * H + r) * (long long)W + q) * Cout;
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const int o = co0 + cc + ci;
      if (o >= Cout) continue;
      float r0[4], r1[4];  // A^T M
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float m0 = acc[0 * 4 + v][pi][ci], m1 = acc[1 * 4 + v][pi][ci];
        const float m2 = acc[2 * 4 + v][pi][ci], m3 = acc[3 * 4 + v][pi][ci];
        r0[v] = m0 + m1 + m2;
        r1[v] = m1 - m2 - m3;
      }
      out[o] = r0[0] + r0[1] + r0[2];
      out[Cout + o] = r0[1] - r0[2] - r0[3];
      out[(long long)W * Cout + o] = r1[0] + r1[1] + r1[2];
      out[(long long)W * Cout + Cout + o] = r1[1] - r1[2] - r1[3];
    }
  }
}

}  // namespace

extern "C" int winograd_f23_fwd_f32(const void* x, const void* u, void* y,
                                    int B, int H, int W, int Cin, int Cout,
                                    void* stream) {
  if (B < 0 || H < 2 || W < 2 || (H % 2) || (W % 2) || Cin < 1 || Cout < 1)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (long long)B * (H / 2) * (W / 2);
  if (n_tiles == 0) return (int)cudaSuccess;
  const long long gx = (n_tiles + TP - 1) / TP;
  const int gy = (Cout + TC - 1) / TC;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  winograd_f23_f32_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<float*>(y), B, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}
