// RAFT's windowed bilinear correlation (the reference's alt_cuda_corr).
//
// Replaces the Pallas kernel ppvision_tpu/ops/corr.py::_corr_kernel
// (local_corr_pallas): for each query pixel q of fmap1 (B, H, W, C) and its
// centre coords[q] = (x, y) in fmap2 (B, H2, W2, C) pixels, the (2r+1)^2
// outputs out[q, dy, dx] = <fmap1[q], bilinear(fmap2, x + dx, y + dy)>,
// with a zero for every bilinear corner outside [0, W2-1] x [0, H2-1],
// in true f32 (the JAX package pins Precision.HIGHEST), (dy, dx) y-major.
//
// What bounds it on an H100: per query the (K+1)^2 integer-grid dots of a
// K = 2r+1 window (the bilinear weights are shared by the whole window),
// C FMAs each for the grid points inside the map, in f32 outside the tensor
// cores (TF32 would lose the true-f32 result), against fmap1, fmap2, the
// coords and the K^2 outputs moved once.  At RAFT's levels (B=30, 32x32
// queries, C=256, r=4, fmap2 32^2 .. 4^2, zero flow) that is
//   level 0: 73.1 MB, 0.0218 ms at 3.35 TB/s; 0.67 G FMA, 0.0200 ms at 67 TFLOP/s
//   level 1: 49.5 MB, 0.0148 ms;              0.56 G FMA, 0.0167 ms
//   level 2: 43.6 MB, 0.0130 ms;              0.37 G FMA, 0.0111 ms
//   level 3: 42.2 MB, 0.0126 ms;              0.13 G FMA, 0.0038 ms
// (chip_smoke.py computes each run's bound from its own coords).  Each FMA
// here takes one 4-byte operand from shared memory, read as 16-byte
// vectors at 128 B/clk/SM, so the products run at most at a quarter of
// the f32 rate; corr_probe.py measures them at about 80% of that read
// rate, two thirds of a block's cycles at level 0, the staging of the
// steps' copies a quarter.
//
// The window rows: neighbouring queries share most of their windows (100
// KB of fmap2 a query at C=256), so a block owns a band of `qb` consecutive
// queries of one image (4 rows of 32 at RAFT's level shapes, 240 blocks of
// 1024 threads), reduces their clamped coords to the bounding box of their
// (K+1)^2 grid windows, clipped to the map, and stages that box of fmap2
// with the band's fmap1 in shared memory, `cw` channels a step, by
// cp.async into a two-stage ring: fmap2 comes from L2 once a block and
// step, not once a query.  A box larger than the ring's `cap` (coords
// spread over a large map) is walked in tiles of whole box rows (or row
// pieces), each with every step; a grid point counts in the one tile that
// holds it.
//
// Each query has a quarter-warp of 8 lanes (more for r > 4).  Its window's
// in-map part is an nr x nc rectangle; lane l owns the rectangle's points
// l, l+8, l+16, .. (13 at most) in (row, column) order, with one register
// accumulator each across all steps, so the 8 lanes read 8 neighbouring
// points at once, and the staged rows' pitch makes those 8 16-byte reads
// fall in 8 different bank groups whatever the coords.  A lane keeps its
// query's 8 channels of a round in registers and reads each point's as
// two 16-byte vectors, 4 points at a time; a slot outside this tile reads
// a staged point of zeros.  There is no shuffle reduction: every dot sums
// its channels 0..C-1 in order, so two calls agree bit for bit, and a grid
// point outside the map is never read (its zero is exact, per corner, as
// in local_corr_xla).  The epilogue puts the scores in shared memory over
// the ring and applies the 4-corner combination, each query's K^2 outputs
// written as one contiguous run.  Coords are clamped to [-(r+1), W2+r] x
// [-(r+1), H2+r] before any float -> int conversion (corr.py:105-110):
// there every sampled corner is already outside, so far-out coords give
// exact zeros and no integer overflow.
//
// ops/corr.py::plan_corr picks qb, cw (16 .. 512, the widest whose ring
// holds the whole map) and cap from the shape alone; the layout below is
// the one it sizes.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kP = 13;     // window points a lane at most
constexpr int kGroup = 4;  // points a lane loads at once

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n / d for 0 <= n < 2^22 and d >= 1, from inv = 1 / d: a float product
// and one correction, in place of an integer division.
__device__ __forceinline__ int div_small(int n, int d, float inv) {
  int q = static_cast<int>(static_cast<float>(n) * inv);
  q -= q * d > n;
  q += (q + 1) * d <= n;
  return q;
}

// Lanes a query: whole quarter-warps, each lane at most kP window points.
__host__ __device__ inline int lanes_per_query(int k1) {
  return 8 * ((k1 * k1 + 8 * kP - 1) / (8 * kP));
}

// Shared memory, in floats: the box bounds and each query's (ix, iy, fx,
// fy); then the ring, two stages of `units` 16-byte units each: the band's
// fmap1 (qb points), one point of zeros and up to `cap` units of the box
// tile, a point pu = cw/4 + 1 units (cw channels and a pad); the scores
// (qb x (K1^2 + 1)) reuse the ring.
__host__ __device__ inline int header_floats(int qb) { return (4 + 4 * qb + 3) & ~3; }
__host__ __device__ inline int stage_units(int qb, int pu, int cap) { return (qb + 1) * pu + cap; }
__host__ __device__ inline int smem_floats(int qb, int pu, int cap, int k1) {
  const int ring = 2 * 4 * stage_units(qb, pu, cap);
  const int scores = qb * (k1 * k1 + 1);
  return header_floats(qb) + (ring > scores ? ring : scores);
}

// Units from one staged box row to the next, for a tile `cols` points
// wide: at least cols * pu, and = pu * min(K1, cols) (mod 8), so that 8
// consecutive points of a query's in-map window, in (row, column) order,
// start in 8 different 16-byte bank groups (pu is odd) wherever the
// window's in-map part is min(K1, cols) wide, as it is away from the
// map's left and right edges.
__device__ __forceinline__ int row_pitch(int cols, int pu, int k1) {
  return cols * pu + (((k1 < cols ? k1 : cols) - cols) * pu & 7);
}

// What one step stages: a tile of the box and a chunk of channels.
struct Step {
  int y0, x0, rows, cols, pitch, ch;
};

__global__ void __launch_bounds__(kThreads, 1)
corr_band_kernel(const float4* __restrict__ f1, const float4* __restrict__ f2,
                 const float2* __restrict__ coords, float* __restrict__ out, int hw, int h2, int w2,
                 int c4, int radius, int qb, int cw4, int cap) {
  extern __shared__ __align__(16) float smem[];
  const int k = 2 * radius + 1;
  const int k1 = k + 1;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * qb;
  const int nq = min(qb, hw - q0);
  const int tid = threadIdx.x;
  const int pu = cw4 + 1;

  int* box = reinterpret_cast<int*>(smem);  // y0, y1, x0, x1
  int* qix = box + 4;
  int* qiy = qix + qb;
  float* qfx = reinterpret_cast<float*>(qiy + qb);
  float* qfy = qfx + qb;
  float* ring = smem + header_floats(qb);
  float4* ring4 = reinterpret_cast<float4*>(ring);
  const int units = stage_units(qb, pu, cap);

  if (tid == 0) {
    box[0] = h2;
    box[1] = 0;
    box[2] = w2;
    box[3] = 0;
  }
  __syncthreads();
  if (tid < nq) {
    const float2 p = coords[static_cast<size_t>(b) * hw + q0 + tid];
    const float x = fminf(fmaxf(p.x, -static_cast<float>(radius + 1)), static_cast<float>(w2 + radius));
    const float y = fminf(fmaxf(p.y, -static_cast<float>(radius + 1)), static_cast<float>(h2 + radius));
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const int ix = static_cast<int>(x0) - radius;
    const int iy = static_cast<int>(y0) - radius;
    qix[tid] = ix;
    qiy[tid] = iy;
    qfx[tid] = x - x0;
    qfy[tid] = y - y0;
    const int ylo = max(iy, 0), yhi = min(iy + k1, h2);
    const int xlo = max(ix, 0), xhi = min(ix + k1, w2);
    if (ylo < yhi && xlo < xhi) {
      atomicMin(&box[0], ylo);
      atomicMax(&box[1], yhi);
      atomicMin(&box[2], xlo);
      atomicMax(&box[3], xhi);
    }
  }
  __syncthreads();

  // The box whole if it fits `cap` units, else tiles of whole rows (or
  // row pieces) that do.
  const int by0 = box[0], bx0 = box[2];
  const int bh = max(box[1] - by0, 0), bw = max(box[3] - bx0, 0);
  int tw = bw, th = bh;
  if (bh * row_pitch(bw, pu, k1) > cap) {
    tw = min(bw, (cap - 7) / pu);
    th = min(bh, cap / row_pitch(tw, pu, k1));
  }
  const int tiles_x = tw > 0 ? (bw + tw - 1) / tw : 0;
  const int tiles_y = th > 0 ? (bh + th - 1) / th : 0;
  const int nchunks = (c4 + cw4 - 1) / cw4;
  const int nsteps = tiles_x * tiles_y * nchunks;
  auto step_of = [&](int s) {
    const int tile = s / nchunks;
    const int ty = tile / tiles_x;
    const int tx = tile - ty * tiles_x;
    Step st;
    st.ch = s - tile * nchunks;
    st.y0 = by0 + ty * th;
    st.x0 = bx0 + tx * tw;
    st.rows = min(th, by0 + bh - st.y0);
    st.cols = min(tw, bx0 + bw - st.x0);
    st.pitch = row_pitch(st.cols, pu, k1);
    return st;
  };

  // Stage step s: the band's fmap1 chunk, then the tile's points; float4
  // slices past C are zero on both sides.
  const int lg_cw4 = __ffs(cw4) - 1;
  auto issue = [&](int s) {
    const Step st = step_of(s);
    float4* dst0 = ring4 + (s & 1) * units;
    const int v0 = st.ch * cw4;
    const int nv = min(cw4, c4 - v0);
    const int n = (nq + st.rows * st.cols) * cw4;
    const float inv_cols = 1.f / st.cols;
    for (int idx = tid; idx < n; idx += blockDim.x) {
      const int p = idx >> lg_cw4;
      const int v = idx & (cw4 - 1);
      float4* dst;
      const float4* src;
      if (p < nq) {
        dst = dst0 + p * pu + v;
        src = f1 + (static_cast<size_t>(b) * hw + q0 + p) * c4 + v0 + v;
      } else {
        const int pp = p - nq;
        const int py = div_small(pp, st.cols, inv_cols);
        const int px = pp - py * st.cols;
        dst = dst0 + (qb + 1) * pu + py * st.pitch + px * pu + v;
        src = f2 + ((static_cast<size_t>(b) * h2 + st.y0 + py) * w2 + st.x0 + px) * c4 + v0 + v;
      }
      if (v < nv) {
        cp_async16(dst, src);
      } else {
        *dst = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    cp_async_commit();
  };

  // This lane's query, and its points: the query's window inside the map
  // is an nr x nc rectangle from window row ry0, column rx0; the lane takes
  // its points g = l, l + L, l + 2L, ... in (row, column) order, so a
  // quarter-warp reads 8 consecutive points of one window.
  const int lq = lanes_per_query(k1);
  const int q = tid / lq;
  const int l = tid - q * lq;
  const bool works = q < nq;
  const int ix = works ? qix[q] : 0;
  const int iy = works ? qiy[q] : 0;
  const int ry0 = max(0, -iy), rx0 = max(0, -ix);
  const int nr = max(0, min(k1, h2 - iy) - ry0);
  const int nc = max(0, min(k1, w2 - ix) - rx0);
  const float inv_nc = 1.f / max(nc, 1);
  float acc[kP];
  int off[kP];  // the point's first unit in this tile
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    acc[i] = 0.f;
    off[i] = 0;
  }
  unsigned mask = 0;  // bit i: point i is in the map and in this tile

  // Each stage's point of zeros, which no copy overwrites.
  for (int t = tid; t < 2 * pu; t += blockDim.x) {
    ring4[(t / pu) * units + qb * pu + t % pu] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (nsteps > 0) issue(0);
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (works) {
      const Step st = step_of(s);
      if (st.ch == 0) {
        mask = 0;
#pragma unroll
        for (int i = 0; i < kP; ++i) {
          const int g = l + i * lq;
          const int r = div_small(g, max(nc, 1), inv_nc);
          const int y = iy + ry0 + r;
          const int x = ix + rx0 + g - r * nc;
          off[i] = -pu;
          if (g < nr * nc && y >= st.y0 && y < st.y0 + st.rows && x >= st.x0 && x < st.x0 + st.cols) {
            off[i] = (y - st.y0) * st.pitch + (x - st.x0) * pu;
            mask |= 1u << i;
          }
        }
      }
      if (mask) {
        const float4* stage = ring4 + (s & 1) * units;
        const float4* fa = stage + q * pu;
        const float4* pts = stage + (qb + 1) * pu;
        for (int c = 0; c < cw4; c += 2) {
          const float4 a0 = fa[c], a1 = fa[c + 1];
#pragma unroll
          for (int i0 = 0; i0 < kP; i0 += kGroup) {
            if (!((mask >> i0) & ((1u << kGroup) - 1))) continue;
            // kGroup points at once; a slot outside reads the zeros.
            const float4* pv[kGroup];
#pragma unroll
            for (int u = 0; u < kGroup; ++u) pv[u] = pts + (i0 + u < kP ? off[i0 + u] : -pu) + c;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float4 a = h ? a1 : a0;
              float4 t[kGroup];
#pragma unroll
              for (int u = 0; u < kGroup; ++u) t[u] = pv[u][h];
#pragma unroll
              for (int u = 0; u < kGroup; ++u) {
                if (i0 + u < kP) {
                  float d = acc[i0 + u];
                  d = fmaf(a.x, t[u].x, d);
                  d = fmaf(a.y, t[u].y, d);
                  d = fmaf(a.z, t[u].z, d);
                  d = fmaf(a.w, t[u].w, d);
                  acc[i0 + u] = d;
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // Epilogue: the (K+1)^2 scores of each query over the ring (zero
  // outside the map), then the same products, in the same order, as
  // local_corr_xla's four corners.
  const int sstride = k1 * k1 + 1;
  float* scores = ring;
  for (int t = tid; t < nq * sstride; t += blockDim.x) scores[t] = 0.f;
  __syncthreads();
  if (works) {
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int g = l + i * lq;
      if (g < nr * nc) {
        const int r = div_small(g, nc, inv_nc);
        scores[q * sstride + (ry0 + r) * k1 + rx0 + g - r * nc] = acc[i];
      }
    }
  }
  __syncthreads();
  const int kk = k * k;
  if (works) {
    // The query's K^2 outputs, one contiguous run, 8 neighbours a store.
    const float fx = qfx[q], fy = qfy[q];
    const float gx = 1.f - fx, gy = 1.f - fy;
    const float inv_k = 1.f / k;
    const float* sq = scores + q * sstride;
    float* o = out + (static_cast<size_t>(b) * hw + q0 + q) * kk;
    for (int t = l; t < kk; t += lq) {
      const int dy = div_small(t, k, inv_k);
      const float* s0 = sq + dy * k1 + t - dy * k;
      o[t] = s0[0] * gx * gy + s0[1] * fx * gy + s0[k1] * gx * fy + s0[k1 + 1] * fx * fy;
    }
  }
}

}  // namespace

// f1: (B, H, W, C) f32, f2: (B, H2, W2, C) f32, coords: (B, H, W, 2) f32
// (x, y), out: (B, H, W, (2r+1)^2) f32; all contiguous and 16-byte
// aligned, C % 4 == 0, 0 <= r <= 16.  The plan (ops/corr.py::plan_corr):
// qb queries a block (a band of one image), cw channels a step (a power of
// two, at least 16) and cap 16-byte units of box a ring stage.
PPV_EXPORT int local_corr(const float* f1, const float* f2, const float* coords, float* out,
                          int batch, int hw, int h2, int w2, int channels, int radius, int qb,
                          int cw, int cap, void* stream) {
  const int k1 = 2 * radius + 2;
  if (channels % 4 != 0 || radius < 0 || radius > 16 || qb < 1 || cw < 16 || cw % 16 != 0 ||
      (cw & (cw - 1)) != 0 || cap < cw / 4 + 8 || qb * lanes_per_query(k1) > kThreads ||
      batch > 65535) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = static_cast<size_t>(smem_floats(qb, cw / 4 + 1, cap, k1)) * sizeof(float);
  cudaError_t e = ppv_allow_smem(corr_band_kernel, smem);
  if (e != cudaSuccess) return e;
  const int threads = (qb * lanes_per_query(k1) + 31) / 32 * 32;
  const dim3 grid((hw + qb - 1) / qb, batch);
  corr_band_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(f1), reinterpret_cast<const float4*>(f2),
      reinterpret_cast<const float2*>(coords), out, hw, h2, w2, channels / 4, radius, qb, cw / 4,
      cap);
  return cudaGetLastError();
}
