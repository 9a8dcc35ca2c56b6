// Circular 2-D FFT convolution of NHWC f32 images with a per-channel OTF.
//
// Replaces the Pallas kernel ppvision_tpu/ops/fftconv.py::_fftconv_kernel
// (fft_conv2d_circular_pallas): FFT_H -> FFT_W -> (* OTF) -> IFFT_W ->
// IFFT_H, real part, * 1/(H W).
//
// What bounds it on an H100: at the paths' shapes (B x n x n x 3 f32,
// n = 128 and 256) the function moves 2 x B x n^2 x 12 bytes and does
// ~4 x 5 n^2 log2 n flops per plane: a few microseconds at either roof.
// What costs time is shared memory and latency: every radix-2 stage reads
// and writes all points of a tile through shared memory between two
// barriers.  The TPU kernel spent its work on dense cos/sin DFT matmuls
// for the MXU; a GPU has no reason to, so this is a radix-2 FFT in true
// f32 (fewer flops and a smaller rounding error than an n-term DFT sum).
//
// Design: the textbook row-column split, three launches, each with many
// blocks and its working tile in shared memory; a (B, C, n, n) complex
// f32 scratch spectrum (allocated by the wrapper, L2-resident at the
// paths' sizes) carries the planes between them.
//   1. rows_forward: a block takes R = kRows image rows with (up to
//      kRowSmem bytes of) their channels, a contiguous NHWC read, splits
//      them into one complex line per (channel, row), runs the forward
//      stages along each line and writes the lines into the spectrum.
//      Alongside, these blocks write the OTF, permuted to the spectrum's
//      bit-reversed order, into C planes after the B C image planes.
//   2. columns: a block takes Q adjacent columns of one plane (row
//      segments of Q x 8 bytes), runs the forward stages along them,
//      multiplies by the permuted OTF (the same Q-wide segments), runs
//      the inverse stages and writes the columns back in place.
//   3. rows_inverse: the mirror of 1: the inverse stages along each line,
//      and real * 1/n^2 written to the NHWC output as a contiguous block.
// Forward stages are decimation-in-frequency (natural order in,
// bit-reversed out), so spectrum point (p, q) holds the frequency
// (rev(p), rev(q)), and the inverse stages are decimation-in-time
// (bit-reversed in, natural out): the data is never permuted.  Stages
// go two at a time: a thread loads the four points that two radix-2
// stages share, runs their four butterflies in registers and stores them,
// so each point crosses shared memory once per two stages; the
// butterflies, their twiddles and their order are those of one stage at
// a time, so the results are the same to the bit.  Tiles and twiddles
// arrive by cp.async, all of a thread's loads in flight at once.
// Twiddles come from a host table built in f64 and rounded to f32 (as
// ops/fftconv.py::_mats_np builds its DFT matrices), laid out per stage
// (stage of span s at [s, 2s)) so a warp reads consecutive entries, and
// copied into shared memory by every block; never fast-math sin/cos.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// R: image rows a row-pass block takes.
constexpr int kLog2Rows = 2;
constexpr int kRows = 1 << kLog2Rows;
// Most shared memory a row-pass tile may take: channels per block =
// min(C, kRowSmem / (R n 8)), all three channels up to n = 1024.
constexpr int kRowSmem = 96 * 1024;
// Q: columns a column-pass block takes, min(n, 2^kLog2Cols, 2^13 / n):
// 16 (128-byte row segments) up to n = 512, 8 at n = 1024 (64 KB tiles
// from n = 512).
constexpr int kLog2Cols = 4;
constexpr int kLog2ColPoints = 13;

__host__ __device__ constexpr int log2_cols(int log2n) {
  return log2n < kLog2Cols ? log2n
                           : (kLog2Cols < kLog2ColPoints - log2n ? kLog2Cols
                                                                 : kLog2ColPoints - log2n);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Asynchronous global -> shared copies of 4 or 8 bytes: a thread starts
// all of its loads before waiting for any (cp_async_wait), so global
// latency overlaps across the whole tile.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(kBytes));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int brev(int x, int log2n) {
  return static_cast<int>(__brev(static_cast<unsigned>(x)) >> (32 - log2n));
}

__device__ __forceinline__ void dif(float2& u, float2& v, float2 w) {
  const float2 d = make_float2(u.x - v.x, u.y - v.y);
  u = make_float2(u.x + v.x, u.y + v.y);
  v = cmul(d, w);
}

__device__ __forceinline__ void dit(float2& u, float2& v, float2 w) {
  w.y = -w.y;
  const float2 t = cmul(v, w);
  v = make_float2(u.x - t.x, u.y - t.y);
  u = make_float2(u.x + t.x, u.y + t.y);
}

// Point i of line `line`: kContig, buf[line n + i] (a row tile);
// otherwise buf[i Q + line] (a column tile of Q = 2^LOG2Q lines).
template <int LOG2N, bool kContig, int LOG2Q>
__device__ __forceinline__ int point(int line, int i) {
  return kContig ? (line << LOG2N) + i : (i << LOG2Q) + line;
}

// Butterfly or group `idx` of a stage: its line, and its index in the line.
template <int LOG2N, bool kContig, int LOG2Q, int LOG2PER>
__device__ __forceinline__ void split(int idx, int& line, int& g) {
  line = kContig ? idx >> (LOG2N - LOG2PER) : idx & ((1 << LOG2Q) - 1);
  g = kContig ? idx & ((1 << (LOG2N - LOG2PER)) - 1) : idx >> LOG2Q;
}

// Two radix-2 stages, of spans 2h and h (kDIF, in that order) or h and
// 2h (inverse), in one shared-memory round trip: a group of the four
// points i0 + {0, h, 2h, 3h} closes under both, so a thread loads them,
// runs the same four butterflies with the same twiddles as two one-stage
// passes would, and stores them.  `total` groups.
template <int LOG2N, bool kDIF, bool kContig, int LOG2Q>
__device__ __forceinline__ void stage_pair(float2* buf, const float2* tw, int total,
                                           int log2h) {
  const int h = 1 << log2h;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    int line, g;
    split<LOG2N, kContig, LOG2Q, 2>(idx, line, g);
    const int j = g & (h - 1);
    const int i0 = ((g >> log2h) << (log2h + 2)) + j;
    float2 x[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) x[m] = buf[point<LOG2N, kContig, LOG2Q>(line, i0 + m * h)];
    const float2 w1 = tw[h + j], w2a = tw[2 * h + j], w2b = tw[3 * h + j];
    if (kDIF) {
      dif(x[0], x[2], w2a);
      dif(x[1], x[3], w2b);
      dif(x[0], x[1], w1);
      dif(x[2], x[3], w1);
    } else {
      dit(x[0], x[1], w1);
      dit(x[2], x[3], w1);
      dit(x[0], x[2], w2a);
      dit(x[1], x[3], w2b);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) buf[point<LOG2N, kContig, LOG2Q>(line, i0 + m * h)] = x[m];
  }
}

// One radix-2 stage of span s = 2^log2s: `total` butterflies.
template <int LOG2N, bool kDIF, bool kContig, int LOG2Q>
__device__ __forceinline__ void stage(float2* buf, const float2* tw, int total, int log2s) {
  const int s = 1 << log2s;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    int line, b;
    split<LOG2N, kContig, LOG2Q, 1>(idx, line, b);
    const int j = b & (s - 1);
    const int i0 = ((b >> log2s) << (log2s + 1)) + j;
    float2& u = buf[point<LOG2N, kContig, LOG2Q>(line, i0)];
    float2& v = buf[point<LOG2N, kContig, LOG2Q>(line, i0 + s)];
    float2 x0 = u, x1 = v;
    if (kDIF) {
      dif(x0, x1, tw[s + j]);
    } else {
      dit(x0, x1, tw[s + j]);
    }
    u = x0;
    v = x1;
  }
}

// The radix-2 transform along `lines` lines of n = 2^LOG2N points in
// shared memory (layout as in `point`).  kDIF: forward, spans n/2 .. 1
// (natural order in, bit-reversed out); otherwise the inverse, unscaled,
// spans 1 .. n/2 (bit-reversed in, natural out).  Stages go two at a
// time; an odd one out is the last.
template <int LOG2N, bool kDIF, bool kContig, int LOG2Q>
__device__ __forceinline__ void fft_lines(float2* buf, const float2* tw, int lines) {
#pragma unroll
  for (int p = 0; p < LOG2N / 2; ++p) {
    stage_pair<LOG2N, kDIF, kContig, LOG2Q>(buf, tw, lines << (LOG2N - 2),
                                            kDIF ? LOG2N - 2 - 2 * p : 2 * p);
    __syncthreads();
  }
  if (LOG2N & 1) {
    stage<LOG2N, kDIF, kContig, LOG2Q>(buf, tw, lines << (LOG2N - 1), kDIF ? 0 : LOG2N - 1);
    __syncthreads();
  }
}

template <int N>
__device__ __forceinline__ void load_twiddles(float2* tw, const float2* __restrict__ tw_g) {
  for (int k = threadIdx.x; k < N; k += kThreads) cp_async<8>(tw + k, tw_g + k);
}

// Pass 1.  Grid (B n / R, channel groups).  Block (b, h0, group): line
// (cc, r) = channel c0 + cc of image row h0 + r sits at buf[(cc R + r) n].
// Besides, the B blocks of group 0 that share h0 write a 1/B share each
// of rows h0 .. h0 + R - 1 of the permuted OTF planes, placed after the
// B C spectrum planes: otf[c][p][q] = OTF(rev p, rev q, c).
template <int LOG2N>
__global__ void __launch_bounds__(kThreads)
rows_forward(const float* __restrict__ img, const float* __restrict__ otf_re,
             const float* __restrict__ otf_im, const float2* __restrict__ tw_g,
             float2* __restrict__ spec, int batch, int channels, int group) {
  constexpr int N = 1 << LOG2N;
  const int b = blockIdx.x >> (LOG2N - kLog2Rows);
  const int h0 = (blockIdx.x & ((N >> kLog2Rows) - 1)) << kLog2Rows;
  if (blockIdx.y == 0) {
    float2* otf = spec + static_cast<size_t>(batch) * channels * N * N;
    const int total = channels << (kLog2Rows + LOG2N);
    const int share = (total + batch - 1) / batch;
    const int end = min(total, (b + 1) * share);
    for (int i = b * share + threadIdx.x; i < end; i += kThreads) {
      const int q = i & (N - 1);
      const int p = h0 + ((i >> LOG2N) & (kRows - 1));
      const int c = i >> (LOG2N + kLog2Rows);
      const int o = (brev(p, LOG2N) * N + brev(q, LOG2N)) * channels + c;
      otf[(static_cast<size_t>(c) * N + p) * N + q] = make_float2(otf_re[o], otf_im[o]);
    }
  }
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = smem + N;
  const int c0 = blockIdx.y * group;
  const int nc = min(group, channels - c0);
  load_twiddles<N>(tw, tw_g);
  // R n C contiguous floats of the NHWC image (all of them when the
  // group is all C channels): point p = r n + w, channel cc.
  const float* src = img + (static_cast<size_t>(b) * N + h0) * N * channels + c0;
  const int total = nc << (kLog2Rows + LOG2N);
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int p = i / nc;
    const int cc = i - p * nc;
    float2* slot = buf + (cc << (kLog2Rows + LOG2N)) + p;
    cp_async<4>(&slot->x, src + static_cast<size_t>(p) * channels + cc);
    slot->y = 0.f;
  }
  cp_async_wait();
  __syncthreads();
  fft_lines<LOG2N, true, true, 0>(buf, tw, nc << kLog2Rows);
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int line = i >> LOG2N;
    const size_t row =
        (static_cast<size_t>(b) * channels + c0 + (line >> kLog2Rows)) * N + h0 +
        (line & (kRows - 1));
    spec[row * N + (i & (N - 1))] = buf[i];
  }
}

// Pass 2.  Grid (B C, n / Q); the tile holds spectrum row p, column
// q0 + qq at buf[p Q + qq].
template <int LOG2N>
__global__ void __launch_bounds__(kThreads)
columns(float2* __restrict__ spec, const float2* __restrict__ tw_g, int batch, int channels) {
  constexpr int N = 1 << LOG2N;
  constexpr int LOG2Q = log2_cols(LOG2N);
  constexpr int Q = 1 << LOG2Q;
  constexpr int kPoints = N << LOG2Q;
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = smem + N;
  const int plane = blockIdx.x;  // b * C + c
  const int q0 = blockIdx.y << LOG2Q;
  float2* pl = spec + static_cast<size_t>(plane) * N * N + q0;
  const float2* otf =
      spec + (static_cast<size_t>(batch) * channels + plane % channels) * N * N + q0;
  load_twiddles<N>(tw, tw_g);
  for (int i = threadIdx.x; i < kPoints; i += kThreads) {
    cp_async<8>(buf + i, pl + (i >> LOG2Q) * N + (i & (Q - 1)));
  }
  cp_async_wait();
  __syncthreads();
  fft_lines<LOG2N, true, false, LOG2Q>(buf, tw, Q);
  for (int i = threadIdx.x; i < kPoints; i += kThreads) {
    buf[i] = cmul(buf[i], otf[(i >> LOG2Q) * N + (i & (Q - 1))]);
  }
  __syncthreads();
  fft_lines<LOG2N, false, false, LOG2Q>(buf, tw, Q);
  for (int i = threadIdx.x; i < kPoints; i += kThreads) {
    pl[(i >> LOG2Q) * N + (i & (Q - 1))] = buf[i];
  }
}

// Pass 3: the mirror of pass 1, into the NHWC output.  Grid (B n / R,
// channel groups).
template <int LOG2N>
__global__ void __launch_bounds__(kThreads)
rows_inverse(const float2* __restrict__ spec, const float2* __restrict__ tw_g,
             float* __restrict__ out, int channels, int group, float inv_scale) {
  constexpr int N = 1 << LOG2N;
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = smem + N;
  const int b = blockIdx.x >> (LOG2N - kLog2Rows);
  const int h0 = (blockIdx.x & ((N >> kLog2Rows) - 1)) << kLog2Rows;
  const int c0 = blockIdx.y * group;
  const int nc = min(group, channels - c0);
  load_twiddles<N>(tw, tw_g);
  const int total = nc << (kLog2Rows + LOG2N);
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int line = i >> LOG2N;
    const size_t row =
        (static_cast<size_t>(b) * channels + c0 + (line >> kLog2Rows)) * N + h0 +
        (line & (kRows - 1));
    cp_async<8>(buf + i, spec + row * N + (i & (N - 1)));
  }
  cp_async_wait();
  __syncthreads();
  fft_lines<LOG2N, false, true, 0>(buf, tw, nc << kLog2Rows);
  float* dst = out + (static_cast<size_t>(b) * N + h0) * N * channels + c0;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int p = i / nc;
    const int cc = i - p * nc;
    dst[static_cast<size_t>(p) * channels + cc] =
        buf[(cc << (kLog2Rows + LOG2N)) + p].x * inv_scale;
  }
}

template <int LOG2N>
cudaError_t launch(const float* img, const float* otf_re, const float* otf_im, const float2* tw,
                   float* out, float2* spec, int batch, int channels, cudaStream_t s) {
  constexpr int N = 1 << LOG2N;
  constexpr size_t kLine = N * sizeof(float2);
  constexpr size_t kRowBytes = kRows * kLine;
  int group = static_cast<int>(kRowSmem / kRowBytes);
  group = group < 1 ? 1 : (group > channels ? channels : group);
  const int groups = (channels + group - 1) / group;
  const size_t row_smem = kLine + group * kRowBytes;
  const size_t col_smem = kLine + (kLine << log2_cols(LOG2N));
  cudaError_t e = ppv_allow_smem(rows_forward<LOG2N>, row_smem);
  if (e == cudaSuccess) e = ppv_allow_smem(rows_inverse<LOG2N>, row_smem);
  if (e == cudaSuccess) e = ppv_allow_smem(columns<LOG2N>, col_smem);
  if (e != cudaSuccess) return e;
  const int row_blocks = N / kRows;
  rows_forward<LOG2N><<<dim3(batch * row_blocks, groups), kThreads, row_smem, s>>>(
      img, otf_re, otf_im, tw, spec, batch, channels, group);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  columns<LOG2N><<<dim3(batch * channels, N >> log2_cols(LOG2N)), kThreads, col_smem, s>>>(
      spec, tw, batch, channels);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  rows_inverse<LOG2N><<<dim3(batch * row_blocks, groups), kThreads, row_smem, s>>>(
      spec, tw, out, channels, group, 1.0f / static_cast<float>(N * N));
  return cudaGetLastError();
}

}  // namespace

// img, out: (B, n, n, C) f32; otf_re/otf_im: (n, n, C) f32; tw: n complex
// f32 twiddles, entry s + j = exp(-2 pi i j / (2 s)) for the stage of span
// s; spec: (B C + C) n n complex f32 scratch.  n is a power of two in
// [4, 1024].  Three launches on `stream`.
PPV_EXPORT int fftconv_circular(const float* img, const float* otf_re, const float* otf_im,
                                const float2* tw, float* out, float2* spec, int batch, int n,
                                int channels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define PPV_FFTCONV_CASE(L) \
  case 1 << L:              \
    return launch<L>(img, otf_re, otf_im, tw, out, spec, batch, channels, s);
    PPV_FFTCONV_CASE(2)
    PPV_FFTCONV_CASE(3)
    PPV_FFTCONV_CASE(4)
    PPV_FFTCONV_CASE(5)
    PPV_FFTCONV_CASE(6)
    PPV_FFTCONV_CASE(7)
    PPV_FFTCONV_CASE(8)
    PPV_FFTCONV_CASE(9)
    PPV_FFTCONV_CASE(10)
#undef PPV_FFTCONV_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
