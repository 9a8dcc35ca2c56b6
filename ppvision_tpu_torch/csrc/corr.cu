// RAFT's windowed bilinear correlation (the reference's alt_cuda_corr).
//
// Replaces the Pallas kernel ppvision_tpu/ops/corr.py::_corr_kernel
// (local_corr_pallas): for each query pixel q of fmap1 (B, H, W, C) and its
// centre coords[q] = (x, y) in fmap2 (B, H2, W2, C) pixels, the (2r+1)^2
// outputs out[q, dy, dx] = <fmap1[q], bilinear(fmap2, x + dx, y + dy)>,
// with a zero for every bilinear corner outside [0, W2-1] x [0, H2-1],
// in true f32 (the JAX package pins Precision.HIGHEST), (dy, dx) y-major.
//
// What bounds it on an H100: per query it needs the (K+1)^2 integer-grid
// dots of a K = 2r+1 window (the bilinear weights are shared by the whole
// window), 2 (K+1)^2 C flops, in f32 outside the tensor cores (TF32 would
// lose the true-f32 result).  At RAFT's level 0 (B=30, 32x32 queries and
// targets, C=256, r=4) that is 1.57 GFLOP, ~0.023 ms at 67 TFLOP/s, against
// ~73 MB of compulsory traffic, ~0.022 ms at 3.35 TB/s: both roofs meet.
// The window rows are re-read by every query near them (100 KB of fmap2 per
// query at C=256), so this first design leans on L1/L2 for that reuse; a
// shared-memory fmap2 tile shared by neighbouring queries is the next step.
//
// Design: one warp per query pixel, eight queries (neighbours in a row) per
// block so their windows meet in L1.  Each lane holds its float4 slices of
// the query feature in registers and reads fmap2 through the read-only
// cache; a dot is FFMA over the lane's channels and a butterfly of warp
// shuffles, skipped outright for a grid point outside the map (its zero is
// exact, per corner, as in local_corr_xla).  The (K+1)^2 scores go to
// shared memory and the lanes apply the 4-corner combination, writing the
// K^2 outputs contiguously.  Coords are clamped to [-(r+1), W2+r] x
// [-(r+1), H2+r] before any float -> int conversion (corr.py:105-110):
// there every sampled corner is already outside, so far-out coords give
// exact zeros and no integer overflow.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <int kVec>
__global__ void __launch_bounds__(kWarps * 32)
local_corr_kernel(const float4* __restrict__ f1, const float4* __restrict__ f2,
                  const float2* __restrict__ coords, float* __restrict__ out, int n_query,
                  int hw, int h2, int w2, int c4, int radius) {
  extern __shared__ float scores_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kWarps + warp;
  if (q >= n_query) return;  // the whole warp leaves together
  const int k = 2 * radius + 1;
  const int k1 = k + 1;
  float* s = scores_smem + warp * k1 * k1;

  float4 a[kVec];
  const float4* f1q = f1 + static_cast<size_t>(q) * c4;
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int idx = lane + 32 * v;
    a[v] = idx < c4 ? f1q[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const float2 p = coords[q];
  const float x = fminf(fmaxf(p.x, -static_cast<float>(radius + 1)), static_cast<float>(w2 + radius));
  const float y = fminf(fmaxf(p.y, -static_cast<float>(radius + 1)), static_cast<float>(h2 + radius));
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  const int ix = static_cast<int>(x0) - radius;
  const int iy = static_cast<int>(y0) - radius;
  const float4* f2b = f2 + static_cast<size_t>(q / hw) * h2 * w2 * c4;

  for (int i = 0; i < k1; ++i) {
    const int yy = iy + i;
    const bool row_in = yy >= 0 && yy < h2;
    for (int j = 0; j < k1; ++j) {
      const int xx = ix + j;
      float d = 0.f;
      if (row_in && xx >= 0 && xx < w2) {  // uniform across the warp
        const float4* f2p = f2b + (static_cast<size_t>(yy) * w2 + xx) * c4;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const int idx = lane + 32 * v;
          if (idx < c4) {
            const float4 t = __ldg(f2p + idx);
            d = fmaf(a[v].x, t.x, d);
            d = fmaf(a[v].y, t.y, d);
            d = fmaf(a[v].z, t.z, d);
            d = fmaf(a[v].w, t.w, d);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      }
      if (lane == 0) s[i * k1 + j] = d;
    }
  }
  __syncwarp();

  // Same products, in the same order, as local_corr_xla's four corners.
  const float gx = 1.f - fx;
  const float gy = 1.f - fy;
  float* o = out + static_cast<size_t>(q) * k * k;
  for (int t = lane; t < k * k; t += 32) {
    const int dy = t / k;
    const int dx = t - dy * k;
    const float* s0 = s + dy * k1 + dx;
    o[t] = s0[0] * gx * gy + s0[1] * fx * gy + s0[k1] * gx * fy + s0[k1 + 1] * fx * fy;
  }
}

template <int kVec>
cudaError_t launch(const float* f1, const float* f2, const float* coords, float* out, int n_query,
                   int hw, int h2, int w2, int c4, int radius, cudaStream_t s) {
  const int k1 = 2 * radius + 2;
  const size_t smem = static_cast<size_t>(kWarps) * k1 * k1 * sizeof(float);
  cudaError_t e = ppv_allow_smem(local_corr_kernel<kVec>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n_query + kWarps - 1) / kWarps);
  local_corr_kernel<kVec><<<grid, kWarps * 32, smem, s>>>(
      reinterpret_cast<const float4*>(f1), reinterpret_cast<const float4*>(f2),
      reinterpret_cast<const float2*>(coords), out, n_query, hw, h2, w2, c4, radius);
  return cudaGetLastError();
}

}  // namespace

// f1: (B, H, W, C) f32, f2: (B, H2, W2, C) f32, coords: (B, H, W, 2) f32
// (x, y), out: (B, H, W, (2r+1)^2) f32; all contiguous, C % 4 == 0 and
// C <= 512 (one to four float4 slices a lane).
PPV_EXPORT int local_corr(const float* f1, const float* f2, const float* coords, float* out,
                          int batch, int hw, int h2, int w2, int channels, int radius,
                          void* stream) {
  const int c4 = channels / 4;
  const int n_query = batch * hw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((c4 + 31) / 32) {
    case 1: return launch<1>(f1, f2, coords, out, n_query, hw, h2, w2, c4, radius, s);
    case 2: return launch<2>(f1, f2, coords, out, n_query, hw, h2, w2, c4, radius, s);
    case 3: return launch<3>(f1, f2, coords, out, n_query, hw, h2, w2, c4, radius, s);
    case 4: return launch<4>(f1, f2, coords, out, n_query, hw, h2, w2, c4, radius, s);
    default: return cudaErrorInvalidValue;
  }
}
