// One FAN DenseConvBlock (in = out = F channels, F in {128, 256}) as four
// launches on the caller's stream.
//
// Replaces the Pallas kernel ppvision_tpu/ops/denseblock.py::_kernel
// (fused_dense_block): three stages of FrozenBN scale/shift (bf16) ->
// ReLU -> SAME 3x3 conv (bf16 in, f32 accumulate, one rounding to bf16),
// then concat([o1, o2, o3]) + x (bf16).  bn is (6, F) f32 rows (mul1,
// add1, mul2, add2, mul3, add3), zero-padded past each stage's channels.
//
// What bounds it on an H100: a block reads x once and writes F channels
// once (2 x B H W F x 2 bytes) and does 2 x 9 x B H W (F F/2 + F/2 F/4 +
// F/4 F/4) flops, ~790 flops a byte at F = 256, so the tensor cores set
// the floor at 64^2 and 32^2; at 16^2 and below a pass is a few blocks,
// and the weights (each block restages them from L2) and launch latency
// bind.  The TPU kernel kept the whole padded 66x66x256 image in VMEM and
// chained the convs there.  Shared memory cannot hold that, and a fused
// tile recomputes a halo through the chained convs (2.5x the block's
// products at an 8x8 tile), so the block runs as passes over valid pixels
// only, on conv3x3's wgmma mainloop (conv3x3_wgmma.cuh), with the
// intermediates (4-17 MB at B = 8) left to L2:
//   0. h1 = bn_relu1(x), 16-byte vectors;
//   1. o1 = conv(h1, k1), F -> F/2;
//   2. o2 = conv(h2, k2), F/2 -> F/4, where h2 = bn_relu2(o1);
//   3. o3 = conv(h3, k3), F/4 -> F/4, where h3 = bn_relu3(o2).
// Pass k's epilogue writes o_k + x into channels [off_k, off_k + K) of
// out as 16-byte rows (x read the same way) and, for k < 3,
// bn_relu_{k+1}(o_k) into the next pass's input.  SAME padding pads h1,
// h2 and h3, so the mainloop's zero-fill outside the image is the border.
// Pass 0 is 10.7% of the call at 8x64x64x256; applying bn_relu1 to pass
// 1's staged window in shared memory instead (rows in the image only, a
// barrier every third stage) made pass 1 20 us slower and the call 9%.
#include "conv3x3_wgmma.cuh"

namespace {

// bn_relu of 8 bf16 channels: x * mul and + add each round to bf16, as
// FrozenBatchNorm applied in bf16 does, then ReLU; mul and add are the
// channels' f32 BN entries.
__device__ __forceinline__ uint4 bn_relu8(uint4 v, const float* mul, const float* add) {
  const float4 m0 = *reinterpret_cast<const float4*>(mul);
  const float4 m1 = *reinterpret_cast<const float4*>(mul + 4);
  const float4 a0 = *reinterpret_cast<const float4*>(add);
  const float4 a1 = *reinterpret_cast<const float4*>(add + 4);
  const __nv_bfloat162 m[4] = {__floats2bfloat162_rn(m0.x, m0.y), __floats2bfloat162_rn(m0.z, m0.w),
                               __floats2bfloat162_rn(m1.x, m1.y), __floats2bfloat162_rn(m1.z, m1.w)};
  const __nv_bfloat162 a[4] = {__floats2bfloat162_rn(a0.x, a0.y), __floats2bfloat162_rn(a0.z, a0.w),
                               __floats2bfloat162_rn(a1.x, a1.y), __floats2bfloat162_rn(a1.z, a1.w)};
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  auto* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __hmax2(__hadd2(__hmul2(h[j], m[j]), a[j]), zero);
  return v;
}

// Pass 0: h = bn_relu1(x) over n 16-byte vectors of F channels a pixel.
__global__ void __launch_bounds__(256)
denseblock_bn_relu_kernel(const uint4* __restrict__ x, const float* __restrict__ bn,
                          uint4* __restrict__ h, size_t n, int F) {
  const size_t step = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += step) {
    const int c = static_cast<int>(i % (F / 8)) * 8;
    h[i] = bn_relu8(x[i], bn + c, bn + F + c);
  }
}

// The epilogue of conv pass k: output channels n .. n + 7 of pixel p.
struct DenseBlockEpi {
  const bf16* x;  // the block's input, F channels a pixel
  bf16* out;  // the block's output, F channels a pixel
  bf16* next;  // the next pass's input, K channels a pixel; null in pass 3
  const float* mul;  // the next BN's f32 rows (null in pass 3)
  const float* add;
  int F, off, K;
  __device__ void operator()(size_t p, int n, uint4 v) const {
    const size_t o = p * F + off + n;
    uint4 r = *reinterpret_cast<const uint4*>(x + o);
    auto* rh = reinterpret_cast<__nv_bfloat162*>(&r);
    const auto* vh = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) rh[j] = __hadd2(vh[j], rh[j]);
    *reinterpret_cast<uint4*>(out + o) = r;
    if (next != nullptr) {
      *reinterpret_cast<uint4*>(next + p * K + n) = bn_relu8(v, mul + n, add + n);
    }
  }
};

}  // namespace

// x, out: (B, H, W, F) bf16 NHWC, F in {128, 256}; w1, w2, w3: k1
// (3,3,F,F/2), k2 (3,3,F/2,F/4), k3 (3,3,F/4,F/4) packed by
// ops/winograd.py::pack_conv3x3_weight; bn: (6, F) f32; scratch:
// B H W (F + F/2) bf16 the passes' inputs use.
PPV_EXPORT int denseblock(const void* x, const void* w1, const void* w2, const void* w3,
                          const float* bn, void* out, void* scratch, int B, int H, int W, int F,
                          void* stream) {
  if ((F != 128 && F != 256) || B < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  auto* ob = static_cast<bf16*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t pixels = static_cast<size_t>(B) * H * W;
  const int half = F / 2, q = F / 4;
  // h1 is dead once pass 1 has run, so h3 takes its place.
  bf16* h1 = static_cast<bf16*>(scratch);
  bf16* h2 = h1 + pixels * F;
  bf16* h3 = h1;

  const size_t n = pixels * F / 8;
  constexpr int kThreads = 256, kMaxBlocks = 132 * 16;
  const size_t blocks = (n + kThreads - 1) / kThreads;
  denseblock_bn_relu_kernel<<<static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks), kThreads,
                              0, s>>>(static_cast<const uint4*>(x), bn, reinterpret_cast<uint4*>(h1),
                                      n, F);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = conv3x3_run(h1, static_cast<const bf16*>(w1),
                  DenseBlockEpi{xb, ob, h2, bn + 2 * F, bn + 3 * F, F, 0, half}, B, H, W, F, half, s);
  if (e != cudaSuccess) return e;
  e = conv3x3_run(h2, static_cast<const bf16*>(w2),
                  DenseBlockEpi{xb, ob, h3, bn + 4 * F, bn + 5 * F, F, half, q}, B, H, W, half, q, s);
  if (e != cudaSuccess) return e;
  return conv3x3_run(h3, static_cast<const bf16*>(w3),
                     DenseBlockEpi{xb, ob, nullptr, nullptr, nullptr, F, half + q, q}, B, H, W, q,
                     q, s);
}
