// Stride-1 SAME 3x3 convolution, NHWC bf16 x packed (3, 3, C, K) bf16
// -> NHWC bf16 (f32 accumulate, one rounding), no bias.
//
// Replaces the Pallas kernel ppvision_tpu/ops/winograd.py::_kernel
// (conv3x3 / _winograd_impl).  The TPU kernel did Winograd F(2,3) along
// H only, because Mosaic could not lower the strided access the 2-D form
// needs; it paid for fewer MXU multiplies with VPU transforms.  On an
// H100 the paths' convs (C, K in 64..512 at 4^2..256^2) do 2 x 9 C K
// flops per output pixel against 2 (C + K) bytes, 290 flops a byte at
// C = K = 64 and more above, so the tensor cores bound them (at
// C = K = 64 the card's HBM bound is as close); this kernel is a direct
// implicit GEMM on wgmma (m64nNk16, bf16 in, f32 accumulators), the only
// instruction that reaches the card's bf16 rate.
//
// The mainloop (tiles, gather, weight ring, wgmma) is conv3x3_wgmma.cuh,
// which the dense block's convs share; this file's epilogue stores the
// bf16 rows as they come.
#include "conv3x3_wgmma.cuh"

namespace {

struct StoreOut {
  bf16* out;
  int K;
  __device__ void operator()(size_t p, int n, uint4 v) const {
    *reinterpret_cast<uint4*>(out + p * K + n) = v;
  }
};

}  // namespace

// x: (B, H, W, C) bf16; wp: the (3, 3, C, K) weights packed by
// ops/winograd.py::pack_conv3x3_weight, (9, ceil(C/64), K, 8, 8) bf16;
// out: (B, H, W, K) bf16.  C and K multiples of 16.
PPV_EXPORT int conv3x3(const void* x, const void* wp, void* out, int B, int H, int W, int C,
                       int K, void* stream) {
  return conv3x3_run(static_cast<const bf16*>(x), static_cast<const bf16*>(wp),
                     StoreOut{static_cast<bf16*>(out), K}, B, H, W, C, K,
                     static_cast<cudaStream_t>(stream));
}
