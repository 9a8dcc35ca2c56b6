// Stride-1 SAME 3x3 convolution, NHWC bf16 x HWIO bf16 -> NHWC bf16
// (f32 accumulate, one rounding), no bias.
//
// Replaces the Pallas kernel ppvision_tpu/ops/winograd.py::_kernel
// (conv3x3 / _winograd_impl).  The TPU kernel did Winograd F(2,3) along
// H only, because Mosaic could not lower the strided access the 2-D form
// needs; it paid for fewer MXU multiplies with VPU transforms.  On an
// H100 these convs (C, K in 128..512 at 4^2..128^2) do 2 x 9 C K flops per
// output pixel against 2 (C + K) bytes, hundreds of flops a byte, so the
// tensor cores bound them; this kernel is a direct implicit GEMM on WMMA
// 16x16x16 bf16 tiles with f32 accumulators.
//
// Design: a block computes an 8 x 14 output tile for 128 output
// channels of one image.  It walks the input channels in 16-channel
// slices; for each slice it stages the tile's 10 x 16 input window (SAME
// halo, zeros outside the image) and the slice's 9 x 16 x 128 weights in
// shared memory with cp.async, double-buffered so the next slice loads
// while the tensor cores work on this one.  Output positions are
// computed over the window's full width of 16, so the A operand of tap
// (dy, dx) for a 16-row tile is 16 consecutive window rows at offset
// dy*16 + dx; the two discarded columns cost 12.5% extra MMAs.  The 8
// warps split the 128 x 128 block tile 2 x 4; each warp holds a 64 x 32
// tile of f32 accumulators and feeds mma.sync m16n8k16 from ldmatrix
// loads (4 for A and 2 transposed ones for B per 16 input channels and
// tap, for 16 MMAs).  Window and weight rows are padded so the ldmatrix
// phases hit distinct shared-memory banks.  The weights are the
// (3, 3, C, K) bf16 copy the conv module prepares once from its f32
// master.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTH = 8, kTW = 14;
constexpr int kWP = kTW + 2;  // window width
constexpr int kMT = kTH * kWP / 16;  // 8 row tiles
constexpr int kBN = 128;  // output channels per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKC = 16;  // input channels per staged slice
constexpr int kPos = kMT * 16 + 2 * kWP + 2;  // window rows + over-read slack
constexpr int kWLd = kBN + 8;  // padded weight row (elements)
constexpr int kWinLd = kKC + 8;  // padded window row (elements)
constexpr int kWinBytes = (kPos * kWinLd * 2 + 127) / 128 * 128;
constexpr int kWtsBytes = 9 * kKC * kWLd * 2;
constexpr int kStageBytes = kWinBytes + kWtsBytes;
constexpr int kSmemBytes = 2 * kStageBytes;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the cp.async copies of one 16-channel slice into a stage.
__device__ __forceinline__ void load_slice(unsigned char* stage, const bf16* __restrict__ x,
                                           const bf16* __restrict__ w, size_t img, int y0, int x0,
                                           int n_blk, int c0, int H, int W, int C, int K) {
  bf16* win = reinterpret_cast<bf16*>(stage);
  bf16* wts = reinterpret_cast<bf16*>(stage + kWinBytes);
  for (int i = threadIdx.x; i < kPos * 2; i += kThreads) {
    const int pos = i / 2, half = i % 2;
    const int py = pos / kWP, px = pos % kWP;
    const int gy = y0 - 1 + py, gx = x0 - 1 + px;
    const bool in = py < kTH + 2 && gy >= 0 && gy < H && gx >= 0 && gx < W;
    const bf16* src = in ? x + (img + gy * W + gx) * C + c0 + half * 8 : x;
    cp_async16(win + pos * kWinLd + half * 8, src, in);
  }
  // 9 taps x 16 channels: rows of kBN outputs, kBN / 8 vectors each.
  for (int i = threadIdx.x; i < 9 * kKC * (kBN / 8); i += kThreads) {
    const int row = i / (kBN / 8), cv = (i % (kBN / 8)) * 8;
    const int tap = row / kKC, kk = row % kKC;
    const bool in = n_blk + cv < K;
    const bf16* src = in ? w + (static_cast<size_t>(tap) * C + c0 + kk) * K + n_blk + cv : w;
    cp_async16(wts + row * kWLd + cv, src, in);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out,
               int H, int W, int C, int K) {
  extern __shared__ __align__(128) unsigned char smem[];

  const int tiles_x = (W + kTW - 1) / kTW;
  const int y0 = (blockIdx.x / tiles_x) * kTH;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const int n_blk = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const size_t img = static_cast<size_t>(b) * H * W;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64;  // warp's first output row (position)
  const int wn = (warp % 4) * 32;  // warp's first output channel in the block
  // Per-lane ldmatrix row addresses: A rows of a 16x16 tile, B k-rows.
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int b_row = lane % 8 + ((lane / 8) % 2) * 8, b_col = (lane / 16) * 8;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int slices = C / kKC;
  load_slice(smem, x, w, img, y0, x0, n_blk, 0, H, W, C, K);
  cp_async_commit();
  for (int s = 0; s < slices; ++s) {
    unsigned char* stage = smem + (s % 2) * kStageBytes;
    if (s + 1 < slices) {
      load_slice(smem + ((s + 1) % 2) * kStageBytes, x, w, img, y0, x0, n_blk, (s + 1) * kKC, H,
                 W, C, K);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this slice has landed; the next may be in flight
    __syncthreads();
    const bf16* win = reinterpret_cast<const bf16*>(stage);
    const bf16* wts = reinterpret_cast<const bf16*>(stage + kWinBytes);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * kWP + (tap % 3);
      unsigned a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ldsm_x4(a[i], win + (wm + i * 16 + a_row + off) * kWinLd + a_col);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        ldsm_x4_trans(b[p], wts + (tap * kKC + b_row) * kWLd + wn + p * 16 + b_col);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_16816(acc[i][j], a[i], b[j / 2][(j % 2) * 2], b[j / 2][(j % 2) * 2 + 1]);
    }
    __syncthreads();  // everyone is done with this stage before it is refilled
  }
  // Accumulator (i, j) element e sits at row wm + 16i + lane/4 (+8 for
  // e >= 2) and channel wn + 8j + 2(lane%4) (+1 for odd e).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + i * 16 + lane / 4 + h * 8;
      const int py = r / kWP, px = r % kWP;
      const int gy = y0 + py, gx = x0 + px;
      if (px >= kTW || gy >= H || gx >= W) continue;
      bf16* o = out + (img + gy * W + gx) * K;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n_blk + wn + j * 8 + (lane % 4) * 2;
        if (n < K) {
          *reinterpret_cast<__nv_bfloat162*>(o + n) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
  }
}

}  // namespace

// x: (B, H, W, C) bf16; w: (3, 3, C, K) bf16; out: (B, H, W, K) bf16.
// C and K multiples of 16.
PPV_EXPORT int conv3x3(const void* x, const void* w, void* out, int B, int H, int W, int C, int K,
                       void* stream) {
  if (C % 16 || K % 16) return cudaErrorInvalidValue;
  cudaError_t e = ppv_allow_smem(conv3x3_kernel, kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW), (K + kBN - 1) / kBN, B);
  conv3x3_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out), H, W, C,
      K);
  return cudaGetLastError();
}
