// Circular 2-D FFT convolution of NHWC f32 images with a per-channel OTF.
//
// Replaces the Pallas kernel ppvision_tpu/ops/fftconv.py::_fftconv_kernel
// (fft_conv2d_circular_pallas): FFT_H -> FFT_W -> (* OTF) -> IFFT_W ->
// IFFT_H, real part, * 1/(H W), one read and one write of each image.
//
// What bounds it on an H100: at the camera's shapes (B x 128 x 128 x 3
// f32) the function moves 2 x B x 196 KB and does ~4 x 5 n^2 log2 n flops
// per plane, far below either roof; a launch is a few microseconds of
// work, so latency (one launch, few barriers) bounds it.  The TPU kernel
// spent its work on dense cos/sin DFT matmuls for the MXU; a GPU has no
// reason to, so this is a radix-2 FFT in f32 (fewer flops and a smaller
// rounding error than a 128-term DFT sum).
//
// Design: one block per (image, channel) plane.  The plane lives as
// complex f32 in shared memory when it fits (n <= 128: 128 KB of the
// 227 KB a block may use) and otherwise in a global scratch plane that
// the same code walks (n = 256 is 512 KB; it stays in the 50 MB L2).
// Forward passes are decimation-in-frequency (natural order in,
// bit-reversed out), the OTF is applied at bit-reversed indices, and the
// inverse passes are decimation-in-time (bit-reversed in, natural out),
// so no permutation pass is ever needed.  Twiddles come from a host table
// built in f64 and rounded to f32 (as ops/fftconv.py::_mats_np builds its
// DFT matrices), never from fast-math sin/cos.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Radix-2 passes over all n lines of the plane along one axis.
// `along_rows`: elements of a line are contiguous (the W axis); otherwise
// they are n apart (the H axis) and neighbouring threads take
// neighbouring lines so shared-memory accesses stay conflict-free.
template <bool kDIF>
__device__ void fft_axis(float2* buf, const float2* tw, int n, int log2n, bool along_rows,
                         bool inverse) {
  const int half = n >> 1;
  const int total = n * half;
  for (int stage = 0; stage < log2n; ++stage) {
    // DIF spans n/2 .. 1, DIT spans 1 .. n/2.
    const int log2s = kDIF ? (log2n - 1 - stage) : stage;
    const int s = 1 << log2s;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      int line, b;
      if (along_rows) {
        line = idx >> (log2n - 1);
        b = idx & (half - 1);
      } else {
        line = idx & (n - 1);
        b = idx >> log2n;
      }
      const int j = b & (s - 1);
      const int i0 = ((b >> log2s) << (log2s + 1)) + j;
      const int i1 = i0 + s;
      float2 w = tw[j << (log2n - 1 - log2s)];
      if (inverse) w.y = -w.y;
      const int a0 = along_rows ? line * n + i0 : i0 * n + line;
      const int a1 = along_rows ? line * n + i1 : i1 * n + line;
      const float2 u = buf[a0];
      float2 v = buf[a1];
      if (kDIF) {
        buf[a0] = make_float2(u.x + v.x, u.y + v.y);
        buf[a1] = cmul(make_float2(u.x - v.x, u.y - v.y), w);
      } else {
        v = cmul(v, w);
        buf[a0] = make_float2(u.x + v.x, u.y + v.y);
        buf[a1] = make_float2(u.x - v.x, u.y - v.y);
      }
    }
    __syncthreads();
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
fftconv_kernel(const float* __restrict__ img, const float* __restrict__ otf_re,
               const float* __restrict__ otf_im, const float2* __restrict__ tw_g,
               float* __restrict__ out, float2* __restrict__ scratch, int n, int log2n,
               int channels, float inv_scale) {
  extern __shared__ float2 smem[];
  const int plane = blockIdx.x;  // b * C + c
  const int b = plane / channels;
  const int c = plane % channels;
  const int nn = n * n;
  float2* buf;
  const float2* tw;
  if (kShared) {
    buf = smem;
    float2* tws = smem + nn;
    for (int k = threadIdx.x; k < n / 2; k += blockDim.x) tws[k] = tw_g[k];
    tw = tws;
  } else {
    buf = scratch + static_cast<size_t>(plane) * nn;
    tw = tw_g;
  }
  const size_t img_base = static_cast<size_t>(b) * nn * channels + c;
  for (int p = threadIdx.x; p < nn; p += blockDim.x) {
    buf[p] = make_float2(img[img_base + static_cast<size_t>(p) * channels], 0.f);
  }
  __syncthreads();
  fft_axis<true>(buf, tw, n, log2n, /*along_rows=*/true, /*inverse=*/false);
  fft_axis<true>(buf, tw, n, log2n, false, false);
  // buf[p][q] now holds frequency (rev(p), rev(q)).
  const int shift = 32 - log2n;
  for (int p = threadIdx.x; p < nn; p += blockDim.x) {
    const int kh = __brev(p / n) >> shift;
    const int kw = __brev(p % n) >> shift;
    const int o = (kh * n + kw) * channels + c;
    buf[p] = cmul(buf[p], make_float2(otf_re[o], otf_im[o]));
  }
  __syncthreads();
  fft_axis<false>(buf, tw, n, log2n, false, true);
  fft_axis<false>(buf, tw, n, log2n, true, true);
  for (int p = threadIdx.x; p < nn; p += blockDim.x) {
    out[img_base + static_cast<size_t>(p) * channels] = buf[p].x * inv_scale;
  }
}

}  // namespace

// Planes up to this many bytes run in shared memory.
static constexpr size_t kMaxSharedPlane = 128 * 128 * sizeof(float2);

// img, out: (B, n, n, C) f32; otf_re/otf_im: (n, n, C) f32; tw: n/2 complex
// f32 twiddles exp(-2 pi i k / n); scratch: B*C*n*n complex f32 when the
// plane does not fit in shared memory (may be null otherwise).
PPV_EXPORT int fftconv_circular(const float* img, const float* otf_re, const float* otf_im,
                                const float2* tw, float* out, float2* scratch, int batch, int n,
                                int channels, void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  const size_t plane_bytes = static_cast<size_t>(n) * n * sizeof(float2);
  const float inv_scale = 1.0f / static_cast<float>(n * n);
  const dim3 grid(batch * channels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plane_bytes <= kMaxSharedPlane) {
    const size_t smem = plane_bytes + (n / 2) * sizeof(float2);
    cudaError_t e = ppv_allow_smem(fftconv_kernel<true>, smem);
    if (e != cudaSuccess) return e;
    fftconv_kernel<true><<<grid, kThreads, smem, s>>>(img, otf_re, otf_im, tw, out, scratch, n,
                                                      log2n, channels, inv_scale);
  } else {
    fftconv_kernel<false><<<grid, kThreads, 0, s>>>(img, otf_re, otf_im, tw, out, scratch, n,
                                                     log2n, channels, inv_scale);
  }
  return cudaGetLastError();
}

PPV_EXPORT int fftconv_uses_scratch(int n) {
  return static_cast<size_t>(n) * n * sizeof(float2) > kMaxSharedPlane;
}
