// Per-(sample, channel) E[x] and E[x^2] over H*W of an NHWC tensor.
//
// Replaces the Pallas kernel ppvision_tpu/ops/instats.py::_kernel
// (instance_moments): f32 sums of x and x^2 over the (H, W) axes of a
// bf16 or f32 (B, H, W, C) tensor, each divided by n = H*W once with
// IEEE rounding, as jnp.mean divides its f32 sum.  Output is (2, B, C)
// f32: row 0 the means, row 1 the means of squares.
//
// What bounds it on an H100: it reads each input byte once and writes
// 8 bytes per (sample, channel); three flops an element against two
// bytes (bf16) is far below the f32 rate, so HBM bandwidth sets the
// floor (0.040 ms for the 134 MB of 16x256x256x64 bf16 at 3.35 TB/s).
// The TPU kernel kept whole images in VMEM, one grid step each.  Here
// a small image is read whole, one block for each slice of its
// channels, and a large one is cut into S chunks of whole pixels
// (ops/instats.py::plan_split picks both from the shape alone), so
// B x S x slices blocks fill the 132 SMs with enough 16-byte loads in
// flight to cover HBM latency.  The kernel takes any such plan.
//
// Design:
// - A block owns one image, one chunk and one slice of the channels:
//   chunk pixels of Cs = C / slices contiguous elements each, pixels C
//   apart in NHWC.  A thread loads 16 bytes (8 bf16 or 4 f32 channels,
//   its channel group g), neighbouring threads neighbouring groups, so
//   a warp reads contiguous runs of Cs elements; a pass covers
//   rows = 256 / G pixels of the slice's G = Cs / V groups.  Where G
//   does not divide 256 the last 256 % G threads idle, so every
//   thread's group stays fixed while the pass strides through the
//   chunk (channel phase never shifts).  Past 256 groups (Cs > 2048
//   bf16) the block makes one pass over the chunk per 256 groups.
//   U = 16 loads are in flight a thread (64 KB a block), issued with
//   no branch between them; a chunk of at most 4 passes takes U = 4, a
//   chunk of one pass U = 1, so a small block issues no loads it does
//   not add.  A C whose pixels are not 16-byte aligned (C % 8 != 0 in
//   bf16) takes the same code with one element a load.
// - In-block reduction: each thread's f32 sums go to shared memory and
//   one thread per (moment, channel) adds the rows in order 0..rows-1.
// - S = 1: the block divides and writes the means.  S > 1: it writes
//   its partial sums to ws[b][slice][s][2][Cs], fences, and takes a
//   ticket on tickets[b][slice]; the block that draws the last ticket
//   adds the S partials in the order s = 0..S-1 (a fixed order, so the
//   bits depend on the shape alone, not on which block came last),
//   divides, writes, and zeroes its ticket for the next launch on the
//   stream.  Slices never meet: each owns its channels.  The wrapper
//   owns ws and tickets; the kernel allocates nothing.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// One load of a thread: 16 bytes (V = 8 bf16 or 4 f32 channels), or one
// element where pixels are not 16-byte aligned.
template <typename T, int V>
struct Lane;

template <>
struct Lane<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static void unpack(const Raw& w, float (&f)[8]) {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little-endian: element 2i is the low half
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

template <>
struct Lane<float, 4> {
  using Raw = uint4;
  __device__ static void unpack(const Raw& w, float (&f)[4]) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
};

template <>
struct Lane<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  __device__ static void unpack(const Raw& w, float (&f)[1]) {
    f[0] = __uint_as_float(static_cast<unsigned>(w) << 16);
  }
};

template <>
struct Lane<float, 1> {
  using Raw = float;
  __device__ static void unpack(const Raw& w, float (&f)[1]) { f[0] = w; }
};

template <typename L, int V>
__device__ __forceinline__ void accumulate(const typename L::Raw& w, float (&acc)[V],
                                           float (&acc2)[V]) {
  float f[V];
  L::unpack(w, f);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    acc[v] += f[v];
    acc2[v] = fmaf(f[v], f[v], acc2[v]);
  }
}

// The last block of image b's slice adds its S partial rows of ws (2Cs
// floats each) in the order s = 0..S-1, W floats a load (4 where Cs is
// even), and writes channels coff..coff+Cs-1 of the C in out.  Up to
// 256 / (2Cs / W) threads share a W-float column: lane l takes the rows
// l, l + lanes, ..., and the lanes' sums are added in lane order, so the
// order is fixed by the shape.
template <int W>
__device__ __forceinline__ void combine(const float* __restrict__ wb, float* __restrict__ out,
                                        float* red, int splits, int cs, int c, int coff, int b,
                                        int batch, float n) {
  using F = typename std::conditional<W == 4, float4, float>::type;
  constexpr int kDepth = 32 / W;  // loads in flight a thread
  const int t = threadIdx.x;
  const int cols = 2 * cs / W;
  const int lanes = cols <= kThreads ? kThreads / cols : 1;
  const int lane = t / cols < lanes ? t / cols : lanes;  // == lanes: idle
  const F* rows = reinterpret_cast<const F*>(wb);
  for (int k0 = 0; k0 < cols; k0 += kThreads) {
    const int k = lanes > 1 ? t - lane * cols : k0 + t;
    float sum[W];
#pragma unroll
    for (int w = 0; w < W; ++w) sum[w] = 0.f;
    if (lane < lanes && k < cols) {
      for (int ss = lane; ss < splits; ss += kDepth * lanes) {
        F v[kDepth];  // issued together, as in the main loop
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          v[u] = __ldcg(rows + static_cast<size_t>(min(ss + u * lanes, splits - 1)) * cols + k);
        }
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          const float* f = reinterpret_cast<const float*>(&v[u]);
          if (ss + u * lanes < splits) {
#pragma unroll
            for (int w = 0; w < W; ++w) sum[w] += f[w];
          }
        }
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) red[w * kThreads + t] = sum[w];
    __syncthreads();
    if (t < min(cols - k0, kThreads / lanes)) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        float total = 0.f;
        for (int l = 0; l < lanes; ++l) total += red[w * kThreads + l * cols + t];
        const int q = (k0 + t) * W + w;
        const int m = q / cs;
        out[(static_cast<size_t>(m) * batch + b) * c + coff + (q - m * cs)] = __fdiv_rn(total, n);
      }
    }
    __syncthreads();
  }
}

template <typename T, int V, int U>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const typename Lane<T, V>::Raw* __restrict__ x, float* __restrict__ out,
               float* __restrict__ ws, unsigned* __restrict__ tickets, int hw, int groups,
               int chunk, float n) {
  using L = Lane<T, V>;
  using Raw = typename L::Raw;
  constexpr int kRed = kThreads * (V > 2 ? V : 2);  // floats a moment (>= 4 x 256 for combine)
  __shared__ float red[2 * kRed];
  __shared__ bool last;

  const int slices = gridDim.z;
  const int sg = groups / slices;  // groups of the block's slice
  const int c = groups * V;
  const int cs = sg * V;
  const int coff = blockIdx.z * cs;
  const int batch = gridDim.y;
  const int splits = gridDim.x;
  const int b = blockIdx.y;
  const int s = blockIdx.x;
  const int t = threadIdx.x;
  const int p0 = s * chunk;
  const int np = min(chunk, hw - p0);
  const int gt = min(sg, kThreads);  // channel groups a pass
  const int rows = kThreads / gt;    // pixels a pass
  const int width = gt * V;          // channels a pass
  const int r = t / gt;
  const int gl = t - r * gt;
  const Raw* base = x + (static_cast<size_t>(b) * hw + p0) * groups + blockIdx.z * sg;
  // This (image, slice)'s S partial rows of 2Cs floats, and its ticket.
  const size_t line = static_cast<size_t>(b) * slices + blockIdx.z;
  float* wb = splits > 1 ? ws + line * splits * 2 * cs : nullptr;

  for (int g0 = 0; g0 < sg; g0 += gt) {
    const int g = g0 + gl;
    float acc[V], acc2[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = acc2[v] = 0.f;
    if (r < rows && g < sg) {
      // U loads issued together with no branch between them: one past
      // the chunk rereads its last pixel and is not added, so a chunk's
      // tail costs no extra round.
      const Raw* p = base + g;
      for (int i = r; i < np; i += U * rows) {
        Raw w[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          w[u] = __ldg(p + static_cast<size_t>(min(i + u * rows, np - 1)) * groups);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (i + u * rows < np) accumulate<L, V>(w[u], acc, acc2);
        }
      }
    }
    // Thread t's sums sit at t * V: row r, channel gl * V + v of the pass.
#pragma unroll
    for (int v = 0; v < V; ++v) {
      red[t * V + v] = acc[v];
      red[kRed + t * V + v] = acc2[v];
    }
    __syncthreads();
    for (int q = t; q < 2 * width; q += kThreads) {
      const int m = q / width;
      const int k = q - m * width;
      const int ch = g0 * V + k;  // within the slice
      float sum = 0.f;
      for (int rr = 0; rr < rows; ++rr) sum += red[m * kRed + rr * width + k];
      if (ch < cs) {
        if (splits == 1) {
          out[(static_cast<size_t>(m) * batch + b) * c + coff + ch] = __fdiv_rn(sum, n);
        } else {
          wb[(static_cast<size_t>(s) * 2 + m) * cs + ch] = sum;
        }
      }
    }
    __syncthreads();  // red is rewritten by the next pass
  }
  if (splits == 1) return;

  // The block's partials are visible before its ticket is counted (the
  // barrier, then one thread's fence, as a grid-wide sync orders them);
  // the block that draws the last ticket combines and rearms the counter.
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicAdd(&tickets[line], 1u) == static_cast<unsigned>(splits - 1);
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  if (cs % 2 == 0) {
    combine<4>(wb, out, red, splits, cs, c, coff, b, batch, n);
  } else {
    combine<1>(wb, out, red, splits, cs, c, coff, b, batch, n);
  }
  if (t == 0) tickets[line] = 0u;
}

template <typename T, int V>
cudaError_t launch(const void* x, float* out, float* ws, unsigned* tickets, int batch, int hw,
                   int channels, int chunk, int splits, int slices, cudaStream_t stream) {
  if (channels % (V * slices) != 0) return cudaErrorInvalidValue;
  const dim3 grid(splits, batch, slices);
  const auto* xr = static_cast<const typename Lane<T, V>::Raw*>(x);
  const int groups = channels / V;
  const int passes = (chunk - 1) / (kThreads / min(groups / slices, kThreads)) + 1;
  const float n = static_cast<float>(hw);
  if (passes == 1) {
    moments_kernel<T, V, 1><<<grid, kThreads, 0, stream>>>(xr, out, ws, tickets, hw, groups, chunk, n);
  } else if (passes <= 4) {
    moments_kernel<T, V, 4><<<grid, kThreads, 0, stream>>>(xr, out, ws, tickets, hw, groups, chunk, n);
  } else {
    moments_kernel<T, V, 16><<<grid, kThreads, 0, stream>>>(xr, out, ws, tickets, hw, groups, chunk, n);
  }
  return cudaGetLastError();
}

}  // namespace

// x: (B, H*W, C) contiguous, bf16 (esize 2) or f32 (esize 4); out: (2, B,
// C) f32.  vec: elements a load, 16 / esize (pixels 16-byte aligned) or
// 1.  The image is cut into `splits` chunks of `chunk` pixels (the last
// may be shorter, none empty) and its channels into `slices` slices of
// C / slices (a multiple of vec); with splits > 1, ws holds B x splits x
// 2C f32 and tickets B x slices zeroed counters, both left for the next
// call with tickets zeroed.
PPV_EXPORT int instance_moments(const void* x, float* out, float* ws, unsigned* tickets,
                                int batch, int hw, int channels, int esize, int vec, int chunk,
                                int splits, int slices, void* stream) {
  const long long covered = static_cast<long long>(chunk) * splits;
  if (batch < 1 || batch > 65535 || hw < 1 || channels < 1 || chunk < 1 || splits < 1 ||
      slices < 1 || slices > 65535 || covered < hw || covered - chunk >= hw ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (esize == 2 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, out, ws, tickets, batch, hw, channels, chunk, splits, slices, s);
  if (esize == 2 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, out, ws, tickets, batch, hw, channels, chunk, splits, slices, s);
  if (esize == 4 && vec == 4)
    return launch<float, 4>(x, out, ws, tickets, batch, hw, channels, chunk, splits, slices, s);
  if (esize == 4 && vec == 1)
    return launch<float, 1>(x, out, ws, tickets, batch, hw, channels, chunk, splits, slices, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// norm_apply: the instance norm applied, with the Generator's AdaIN
// modulation or affine and its leaky ReLU, in one pass over bf16 NHWC.
//
// Replaces no Pallas kernel: XLA fused this glue around the TPU moments
// kernel (ppvision_tpu/models/stargan.py's InstanceNorm and AdaIN).
// Eager PyTorch ran it as about a dozen elementwise kernels, each a
// pass over the tensor, some in f32.  Here one launch reads the bf16
// tensor once and writes it once, after moments_kernel has given the
// f32 (B, C) moments, and computes per element
//   t = (x - mean) * rsqrt(max(m2 - mean * mean, 0) + eps)       f32
//   kAffine: t = t * w + b                                        f32
//   n = bf16(t)
//   kStyle:  n = bf16(bf16(1 + gamma) * n); n = bf16(n + beta)    gamma, beta bf16
//   y = bf16(n > 0 ? n : n * slope)
// rounding where the eager path rounds and nowhere else: every f32
// product and sum goes through __fmul_rn / __fadd_rn / __fsub_rn, so
// nvcc contracts none into an FMA (the eager path runs each op as its
// own kernel), and the output equals the eager path's byte for byte.
//
// What bounds it on an H100: 2 bytes read and 2 written an element
// against ~15 flops, so HBM bandwidth (0.16 ms for the 268 MB of
// 32x256x256x64 read and again written at 3.35 TB/s).
//
// Design: a thread owns one channel group g of 8 channels (a 16-byte
// load) of one image and derives those channels' parameters once into
// registers (the moments, weights or dense-layer output are a few KB,
// read through the cache); the block's 256 threads hold rows = 256 / G'
// pixels of G' = min(G, 256) groups, so a warp reads contiguous runs of
// the pixel row, and a block of the grid (pixel chunks, B, channel
// passes) walks rows x U pixels with U 16-byte loads in flight a thread
// (U from 8 down to 1 until the grid has kApplyBlocks blocks, so the
// small 8x8 maps still fill the 132 SMs).
// ---------------------------------------------------------------------------

namespace {

constexpr int kApplyBlocks = 1024;

enum ApplyMode { kAffine = 0, kStyle = 1 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int MODE>
__device__ __forceinline__ float apply_one(float x, float mean, float scale, float a, float s,
                                           float slope) {
  float t = __fmul_rn(__fsub_rn(x, mean), scale);
  if (MODE == kAffine) t = __fadd_rn(__fmul_rn(t, a), s);
  float n = bf16_round(t);
  if (MODE == kStyle) {
    n = bf16_round(__fmul_rn(a, n));
    n = bf16_round(__fadd_rn(n, s));
  }
  return n > 0.f ? n : __fmul_rn(n, slope);  // rounded to bf16 by the caller
}

template <int MODE, int U>
__global__ void __launch_bounds__(kThreads)
norm_apply_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, const float* __restrict__ mean,
                  const float* __restrict__ m2, const float* __restrict__ weight,
                  const float* __restrict__ bias, const __nv_bfloat16* __restrict__ style, int hw,
                  int groups, int chunk, float eps, float slope) {
  const int gt = min(groups, kThreads);  // channel groups a pass
  const int rows = kThreads / gt;        // pixels a pass
  const int t = threadIdx.x;
  const int r = t / gt;
  const int g = blockIdx.z * gt + (t - r * gt);
  if (r >= rows || g >= groups) return;
  const int b = blockIdx.y;
  const int c = groups * 8;

  float mu[8], scale[8], a[8], s[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int bc = b * c + g * 8 + v;
    const float m = __ldg(mean + bc);
    const float var = __fsub_rn(__ldg(m2 + bc), __fmul_rn(m, m));
    mu[v] = m;
    scale[v] = rsqrtf(__fadd_rn(var < 0.f ? 0.f : var, eps));  // clamp_min keeps a NaN
    if (MODE == kAffine) {
      a[v] = __ldg(weight + g * 8 + v);
      s[v] = __ldg(bias + g * 8 + v);
    } else {
      const __nv_bfloat16* row = style + static_cast<size_t>(b) * 2 * c + g * 8 + v;
      a[v] = bf16_round(__fadd_rn(__bfloat162float(row[0]), 1.f));
      s[v] = __bfloat162float(row[c]);
    }
  }

  const int p0 = blockIdx.x * chunk;
  const int np = min(chunk, hw - p0);
  const size_t base = (static_cast<size_t>(b) * hw + p0) * groups + g;
  for (int i = r; i < np; i += U * rows) {
    uint4 w[U];  // issued together; one past the chunk rereads its last pixel and is not stored
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = __ldg(x + base + static_cast<size_t>(min(i + u * rows, np - 1)) * groups);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i + u * rows >= np) continue;
      const unsigned in[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
      unsigned out[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // little-endian: channel 2k is the low half
        const float lo = apply_one<MODE>(__uint_as_float(in[k] << 16), mu[2 * k], scale[2 * k],
                                         a[2 * k], s[2 * k], slope);
        const float hi = apply_one<MODE>(__uint_as_float(in[k] & 0xffff0000u), mu[2 * k + 1],
                                         scale[2 * k + 1], a[2 * k + 1], s[2 * k + 1], slope);
        const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
        out[k] = *reinterpret_cast<const unsigned*>(&h);
      }
      y[base + static_cast<size_t>(i + u * rows) * groups] = make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
}

template <int MODE>
cudaError_t launch_apply(const void* x, void* y, const float* mean, const float* m2,
                         const float* weight, const float* bias, const void* style, int batch,
                         int hw, int channels, float eps, float slope, cudaStream_t stream) {
  const int groups = channels / 8;
  const int gt = min(groups, kThreads);
  const int rows = kThreads / gt;
  const int passes = (groups + gt - 1) / gt;
  int u = 8;
  while (u > 1 && static_cast<long long>(batch) * passes * ((hw + rows * u - 1) / (rows * u)) < kApplyBlocks)
    u /= 2;
  const int chunk = rows * u;
  const dim3 grid((hw + chunk - 1) / chunk, batch, passes);
  const auto* xr = static_cast<const uint4*>(x);
  auto* yr = static_cast<uint4*>(y);
  const auto* st = static_cast<const __nv_bfloat16*>(style);
#define PPV_APPLY(U) \
  norm_apply_kernel<MODE, U><<<grid, kThreads, 0, stream>>>(xr, yr, mean, m2, weight, bias, st, hw, groups, chunk, eps, slope)
  switch (u) {
    case 8: PPV_APPLY(8); break;
    case 4: PPV_APPLY(4); break;
    case 2: PPV_APPLY(2); break;
    default: PPV_APPLY(1); break;
  }
#undef PPV_APPLY
  return cudaGetLastError();
}

}  // namespace

// x, y: (B, H*W, C) contiguous bf16, 16-byte aligned, C % 8 == 0; mean,
// m2: (B, C) f32; either weight, bias: (C,) f32, or style: the (B, 2C)
// bf16 AdaIN dense output (gamma, then beta), the others null; slope:
// the leaky ReLU's negative slope.
PPV_EXPORT int norm_apply(const void* x, void* y, const float* mean, const float* m2,
                          const float* weight, const float* bias, const void* style, int batch,
                          int hw, int channels, float eps, float slope, void* stream) {
  if (batch < 1 || batch > 65535 || hw < 1 || channels < 8 || channels % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
      (weight == nullptr) != (bias == nullptr) || (style == nullptr) == (weight == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (style != nullptr)
    return launch_apply<kStyle>(x, y, mean, m2, weight, bias, style, batch, hw, channels, eps, slope, s);
  return launch_apply<kAffine>(x, y, mean, m2, weight, bias, style, batch, hw, channels, eps, slope, s);
}
