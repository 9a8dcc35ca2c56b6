// One FAN DenseConvBlock (in = out = F channels) in a single launch.
//
// Replaces the Pallas kernel ppvision_tpu/ops/denseblock.py::_kernel
// (fused_dense_block): three stages of FrozenBN scale/shift (bf16) ->
// ReLU -> SAME 3x3 conv (bf16 in, f32 accumulate, bf16 out), then
// concat([o1, o2, o3]) + x.  Weights are HWIO bf16:
// k1 (3,3,F,F/2), k2 (3,3,F/2,F/4), k3 (3,3,F/4,F/4); bn is (6, F) f32
// rows (mul1, add1, mul2, add2, mul3, add3), zero-padded past each
// stage's channel count.
//
// What bounds it on an H100: a block reads x once and writes F channels
// once (2 x B H W F x 2 bytes) and does 2 x 9 x B H W (F F/2 + F/2 F/4 +
// F/4 F/4) flops; at 64^2 x 256 that is 3.3 GFLOP over 4.2 MB an image,
// ~790 flops a byte, so the tensor cores, not HBM, set the floor.
// The TPU kernel kept the whole padded 66x66x256 image in VMEM; 227 KB
// of shared memory cannot, so this kernel tiles the output 8x8 and
// recomputes a 3-pixel halo (one pixel per chained conv): the tile's
// 14x14xF input, its 12x12 o1 and 10x10 o2 stay in shared memory and
// only x and the output touch HBM.
//
// Each conv stage is an implicit GEMM on mma.sync m16n8k16 (bf16 in,
// f32 accumulate).  Outputs are computed over the full padded width of
// their input tile, so the A operand of tap (dy, dx) for 16 consecutive
// output positions is 16 consecutive rows of the shared tile starting
// at offset dy*width + dx: one ldmatrix.x4.  The columns past the valid
// width are discarded in the epilogue.  The weights pass through shared
// memory 16 input channels at a time; each warp holds a block of row x
// 32-channel accumulator tiles, so every fragment it loads feeds several
// MMAs.  All shared rows are padded by 8 elements so ldmatrix phases hit
// distinct banks.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 8;  // output tile edge
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // extra elements a shared row

constexpr int kR1 = kT + 6;  // h1 tile edge (x + 3-pixel halo)
constexpr int kR2 = kT + 4;  // o1 / h2 tile edge
constexpr int kR3 = kT + 2;  // o2 / h3 tile edge
constexpr int kMT1 = (kR2 * kR1 + 15) / 16;  // row tiles of stage 1
constexpr int kMT2 = (kR3 * kR2 + 15) / 16;
constexpr int kMT3 = (kT * kR3 + 15) / 16;
// Positions (rows) each shared tile holds, with zeroed slack for the
// discarded columns' over-reads.
constexpr int kP1 = kMT1 * 16 + 2 * kR1 + 2;
constexpr int kP2 = kMT2 * 16 + 2 * kR2 + 2;
constexpr int kP3 = kMT3 * 16 + 2 * kR3 + 2;

__device__ __forceinline__ bf16 bn_relu(bf16 v, bf16 mul, bf16 add) {
  // x * mul and + add each round to bf16, as FrozenBatchNorm does.
  const bf16 t = __hadd(__hmul(v, mul), add);
  return __hmax(t, __float2bfloat16(0.f));
}

// One 3x3 conv stage over a shared tile of `width` positions a row:
// act (positions x (CIN + kPad)) * w (9 x CIN x COUT, global) ->
// epi(r, n, v) for linear output position r (same width), output
// channel n and its f32 sum v.
template <int CIN, int COUT, int MT, int WIDTH, typename Epi>
__device__ void conv_stage(const bf16* act, const bf16* __restrict__ w, bf16* wbuf, Epi epi) {
  constexpr int ALD = CIN + kPad;
  constexpr int WLD = COUT + kPad;
  constexpr int NG = COUT / 32;  // warps across the columns, 32 channels each
  constexpr int MG = kWarps / NG;  // warps down the rows
  constexpr int WM = (MT + MG - 1) / MG;  // 16-row tiles a warp
  static_assert(COUT % 32 == 0 && NG * MG == kWarps, "stage shape");
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = (warp % NG) * 32;
  const int m0 = (warp / NG) * WM;
  const int mcnt = max(0, min(WM, MT - m0));
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int b_row = lane % 8 + ((lane / 8) % 2) * 8, b_col = (lane / 16) * 8;

  float acc[WM][4][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < CIN; k0 += 16) {
    __syncthreads();  // the previous chunk's weights are consumed
    for (int i = threadIdx.x; i < 9 * 16 * (COUT / 8); i += kThreads) {
      const int row = i / (COUT / 8), cv = (i % (COUT / 8)) * 8;
      const int tap = row / 16, kk = row % 16;
      *reinterpret_cast<uint4*>(wbuf + row * WLD + cv) =
          *reinterpret_cast<const uint4*>(w + (tap * CIN + k0 + kk) * COUT + cv);
    }
    __syncthreads();
    if (mcnt > 0) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * WIDTH + (tap % 3);
        unsigned b[2][4];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          ldsm_x4_trans(b[p], wbuf + (tap * 16 + b_row) * WLD + n0 + p * 16 + b_col);
        }
#pragma unroll
        for (int i = 0; i < WM; ++i) {
          if (i < mcnt) {
            unsigned a[4];
            ldsm_x4(a, act + ((m0 + i) * 16 + a_row + off) * ALD + k0 + a_col);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              mma_16816(acc[i][j], a, b[j / 2][(j % 2) * 2], b[j / 2][(j % 2) * 2 + 1]);
            }
          }
        }
      }
    }
  }
  // Accumulator (i, j) element e sits at row 16(m0 + i) + lane/4 (+8 for
  // e >= 2) and channel n0 + 8j + 2(lane%4) (+1 for odd e).
#pragma unroll
  for (int i = 0; i < WM; ++i) {
    if (i < mcnt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (m0 + i) * 16 + lane / 4 + (e / 2) * 8;
#pragma unroll
        for (int j = 0; j < 4; ++j) epi(r, n0 + j * 8 + (lane % 4) * 2 + e % 2, acc[i][j][e]);
      }
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
denseblock_kernel(const bf16* __restrict__ x, const bf16* __restrict__ k1,
                  const bf16* __restrict__ k2, const bf16* __restrict__ k3,
                  const float* __restrict__ bn, bf16* __restrict__ out, int H, int W) {
  constexpr int HALF = F / 2;
  constexpr int Q = F / 4;
  constexpr int L1 = F + kPad, L2 = HALF + kPad, L3 = Q + kPad;  // shared row lengths
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* h1 = reinterpret_cast<bf16*>(smem_raw);  // kP1 x L1
  bf16* h2 = h1 + kP1 * L1;                      // kP2 x L2
  bf16* h3 = h2 + kP2 * L2;                      // kP3 x L3
  bf16* bnb = h3 + kP3 * L3;                     // 6 x F
  bf16* wbuf = bnb + 6 * F;  // one 16-channel slice of a stage's weights

  const int tiles_x = (W + kT - 1) / kT;
  const int y0 = (blockIdx.x / tiles_x) * kT;
  const int x0 = (blockIdx.x % tiles_x) * kT;
  const int b = blockIdx.y;
  const size_t img = static_cast<size_t>(b) * H * W;
  const bf16 zero = __float2bfloat16(0.f);

  for (int i = threadIdx.x; i < 6 * F; i += kThreads) bnb[i] = __float2bfloat16(bn[i]);
  for (int i = kR2 * kR2 * L2 + threadIdx.x; i < kP2 * L2; i += kThreads) h2[i] = zero;
  for (int i = kR3 * kR3 * L3 + threadIdx.x; i < kP3 * L3; i += kThreads) h3[i] = zero;
  __syncthreads();

  // h1 = bn_relu1(x) over the tile plus a 3-pixel halo; zero outside the
  // image (SAME padding pads the conv input, not x).
  constexpr int V = 8;  // bf16 per 16-byte vector
  for (int i = threadIdx.x; i < kP1 * (F / V); i += kThreads) {
    const int pos = i / (F / V);
    const int cv = (i % (F / V)) * V;
    const int py = pos / kR1, px = pos % kR1;
    const int gy = y0 - 3 + py, gx = x0 - 3 + px;
    alignas(16) bf16 v[V];
    if (pos < kR1 * kR1 && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      *reinterpret_cast<uint4*>(v) =
          *reinterpret_cast<const uint4*>(x + (img + gy * W + gx) * F + cv);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = bn_relu(v[j], bnb[cv + j], bnb[F + cv + j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = zero;
    }
    *reinterpret_cast<uint4*>(h1 + pos * L1 + cv) = *reinterpret_cast<uint4*>(v);
  }

  // Stage 1: o1 over the 12x12 region (offset -2), computed at width kR1.
  conv_stage<F, HALF, kMT1, kR1>(h1, k1, wbuf, [&](int r, int n, float acc) {
    const int py = r / kR1, px = r % kR1;
    if (py >= kR2 || px >= kR2) return;
    const int gy = y0 - 2 + py, gx = x0 - 2 + px;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const bf16 o = __float2bfloat16(acc);
    h2[(py * kR2 + px) * L2 + n] = in ? bn_relu(o, bnb[2 * F + n], bnb[3 * F + n]) : zero;
    if (in && py >= 2 && py < 2 + kT && px >= 2 && px < 2 + kT) {
      const size_t p = (img + gy * W + gx) * F + n;
      out[p] = __hadd(o, x[p]);
    }
  });
  // Stage 2: o2 over the 10x10 region (offset -1), at width kR2.
  conv_stage<HALF, Q, kMT2, kR2>(h2, k2, wbuf, [&](int r, int n, float acc) {
    const int py = r / kR2, px = r % kR2;
    if (py >= kR3 || px >= kR3) return;
    const int gy = y0 - 1 + py, gx = x0 - 1 + px;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const bf16 o = __float2bfloat16(acc);
    h3[(py * kR3 + px) * L3 + n] = in ? bn_relu(o, bnb[4 * F + n], bnb[5 * F + n]) : zero;
    if (in && py >= 1 && py < 1 + kT && px >= 1 && px < 1 + kT) {
      const size_t p = (img + gy * W + gx) * F + HALF + n;
      out[p] = __hadd(o, x[p]);
    }
  });
  // Stage 3: o3 over the 8x8 tile, at width kR3.
  conv_stage<Q, Q, kMT3, kR3>(h3, k3, wbuf, [&](int r, int n, float acc) {
    const int py = r / kR3, px = r % kR3;
    if (py >= kT || px >= kT) return;
    const int gy = y0 + py, gx = x0 + px;
    if (gy >= H || gx >= W) return;
    const size_t p = (img + gy * W + gx) * F + HALF + Q + n;
    out[p] = __hadd(__float2bfloat16(acc), x[p]);
  });
}

template <int F>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (kP1 * (F + kPad) + kP2 * (F / 2 + kPad) + kP3 * (F / 4 + kPad) + 6 * F +
                         9 * 16 * (F / 2 + kPad));
}

template <int F>
cudaError_t launch(const bf16* x, const bf16* k1, const bf16* k2, const bf16* k3,
                   const float* bn, bf16* out, int B, int H, int W, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<F>();
  cudaError_t e = ppv_allow_smem(denseblock_kernel<F>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(((H + kT - 1) / kT) * ((W + kT - 1) / kT), B);
  denseblock_kernel<F><<<grid, kThreads, smem, s>>>(x, k1, k2, k3, bn, out, H, W);
  return cudaGetLastError();
}

}  // namespace

// x, out: (B, H, W, F) bf16 NHWC; F in {128, 256}; any H, W >= 1.
PPV_EXPORT int denseblock(const void* x, const void* k1, const void* k2, const void* k3,
                          const float* bn, void* out, int B, int H, int W, int F, void* stream) {
  auto xp = static_cast<const bf16*>(x);
  auto k1p = static_cast<const bf16*>(k1);
  auto k2p = static_cast<const bf16*>(k2);
  auto k3p = static_cast<const bf16*>(k3);
  auto op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F == 256) return launch<256>(xp, k1p, k2p, k3p, bn, op, B, H, W, s);
  if (F == 128) return launch<128>(xp, k1p, k2p, k3p, bn, op, B, H, W, s);
  return cudaErrorInvalidValue;
}
