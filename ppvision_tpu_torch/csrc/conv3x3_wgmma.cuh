// The stride-1 SAME 3x3 conv mainloop on wgmma, shared by the conv3x3
// kernel (winograd.cu) and the FAN dense block's three convs
// (denseblock.cu).  conv3x3_run() launches the conv of an NHWC bf16
// input with packed (3, 3, C, K) weights and hands every 16-byte row of
// 8 output channels, rounded to bf16 once, to an epilogue functor
// epi(pixel, channel, row), pixel = (b H + y) W + x: the caller decides
// what is stored.
//
// The GEMM: M = output pixels, N = output channels, reduction = 9 taps
// x C input channels, walked as stages of one tap x 64 input channels.
//
// Tiles.  A block computes BM = 64 WG MT valid output pixels (WG
// warpgroups of MT m64 tiles each) for BN output channels.  The pixels
// are a TH x NI x TW box of (row, image, column): TW = min(W, 16),
// TH = min(H, BM / TW), and where a whole image is smaller than the tile
// (8^2, 4^2) the box spans NI = BM / (H W) images, so no MMA row is spent
// on a pixel that is thrown away.  BN = 64 when K <= 64 or K % 128 != 0
// (K = 16, 48, 80 run masked 64-wide tiles), else 128.  The host picks
// the largest BM that still gives about one block an SM (120 of 132),
// since every block restages its weights from L2: 256 x 128 at
// 8x128x128x128 -> 128 and the 64^2 and 32^2 decoder shapes; 64 x 64 at
// 16^2, 8^2 and 4^2 (256, 64 and 24 blocks: the last two under-fill the
// card).  At C <= 64 with BN = 64 (16x256x256x64 -> 64, 9 stages a
// block) BM = 128 instead, two blocks an SM, so that one block's
// prologue and epilogue overlap the other's stages.
//
// Operands, both from shared memory through wgmma descriptors, in the
// 128-byte-swizzled K-major layout: a row is 64 channels (128 bytes)
// whose 16-byte chunk g sits at g ^ (row % 8), eight rows a 1024-byte
// atom.  A: a slice's input window is staged as three copies, one for
// each column tap dx, in which row ((r NI + image) TW + column) holds
// pixel (image, y0 - 1 + r, x0 - 1 + dx + column), zeros outside the
// image.  Output row m = (r NI + image) TW + column reads, at tap (dy,
// dx), row m + dy NI TW of copy dx: a tap's 64-row A tile is 64
// consecutive rows, one descriptor, for every tile shape.  B:
// ops/winograd.py packs the weights once per weight version into exactly
// this image (a row an output channel), so a stage's BN x 64 weight tile
// is one contiguous run.  A k16 step moves a descriptor 32 bytes along
// the rows.  A does not come from registers: with ldmatrix fragments as
// A, ptxas either serializes the wgmmas or reuses the fragments'
// registers before the wgmmas that read them retire.  The swizzle
// matters: the unswizzled core-matrix layout halves the wgmma rate.
//
// Pipeline.  A stage's weights come as one cp.async.bulk on an mbarrier
// into a ring of D stages (7 at BM = 64, 5 at 128 x 64, else 6).  The
// window copies come by cp.async, gathered through a per-block table of
// their rows' pixels, into one window buffer: the taps run column by
// column, so copy dx is read by three consecutive stages and the next
// slice's copy dx replaces it as soon as they retire.  Each stage issues
// 4 MT wgmmas as one commit group and keeps it in flight while the next
// stage's loads land; a buffer is refilled only after the group that read
// it has retired.  The epilogue rounds the accumulators to bf16 through
// shared memory and hands the tile's valid 16-byte rows to the functor.
//
// Bytes from L2 a call (weights + windows; the conv's compulsory HBM
// bytes in brackets): 8x128x128x128 -> 128, 512 blocks: 151 + 113 MB
// (67 MB); 16x256x256x64 -> 64, 8,192 blocks: 604 + 503 MB (268 MB).
// At these tiles shared memory, not L2, bounds the kernel: the operands
// wgmma reads (~96 bytes a clock at its peak rate for 64 x 128 x 16
// products) plus the fills; building copies 1 and 2 from copy 0 in
// shared memory cut the window's L2 bytes by two thirds and was slower.
#pragma once

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxSmem = 232448;  // the most a block may have on an H100
constexpr int kAlign = 1024;  // a swizzle atom: buffers start on one

struct Tile {
  int ni, th, tw;  // images, rows, columns of a block's pixel box
  int tiles_b, tiles_y, tiles_x;
  int pos;  // window rows a copy: (th + 2) * ni * tw
  int plane;  // rows a copy holds: >= pos and >= 2 ni tw + BM, % 8 = 0
};

// The pixel box of a BM-row tile, cut (images first, then rows) until a
// window copy holds at most max_rows rows.
Tile make_tile(int bm, int B, int H, int W, int max_rows) {
  Tile t;
  t.tw = W < 16 ? W : 16;
  t.th = H < bm / t.tw ? H : bm / t.tw;
  t.ni = t.th == H && t.tw == W && bm / (H * W) > 1 ? bm / (H * W) : 1;
  for (;;) {
    t.pos = (t.th + 2) * t.ni * t.tw;
    const int need = 2 * t.ni * t.tw + bm;
    t.plane = ((t.pos > need ? t.pos : need) + 7) / 8 * 8;
    if (t.plane <= max_rows || (t.ni == 1 && t.th == 1)) break;
    if (t.ni > 1) --t.ni;
    else --t.th;
  }
  t.tiles_b = (B + t.ni - 1) / t.ni;
  t.tiles_y = (H + t.th - 1) / t.th;
  t.tiles_x = (W + t.tw - 1) / t.tw;
  return t;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's copy of `bytes` contiguous bytes into shared memory,
// counted against the mbarrier at `bar` (the async proxy).
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// Wait until the phase of parity `parity` of the mbarrier at `bar` has
// completed.  A copy that never lands traps (a launch error) instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (long long spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1ll << 28)) __trap();
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving an accumulator across a wgmma wait.
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// Descriptor of a 128-byte-swizzled K-major operand whose first row is
// at shared address `a`: 1024 bytes to the next 8 rows.
__device__ __forceinline__ uint64_t desc(unsigned a) {
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 64 f32, 32 a thread) = a (64 x 16 bf16) * b (16 x 64 bf16) (+ d if `add`), a and b
// in shared memory.
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(add));
}
// d (64 x 128 f32, 64 a thread) = a (64 x 16 bf16) * b (16 x 128 bf16) (+ d if `add`), a and b
// in shared memory.
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(add));
}

template <int WG, int MT, int BN>
struct Cfg {
  static constexpr int kThreads = 128 * WG;
  static constexpr int kBM = 64 * WG * MT;
  // Weight ring depth: at most 7 (see issue()); 5 at 128 x 64, which
  // runs two blocks an SM.
  static constexpr int kD = kBM == 64 ? 7 : kBM == 128 && BN == 64 ? 5 : 6;
  static constexpr int kBlocksPerSM = kBM == 128 && BN == 64 ? 2 : 1;
  static constexpr int kStageBytes = BN * 128;  // BN rows of 64 channels
  static constexpr int kOutLd = BN + 8;  // epilogue row (elements)
  static constexpr int kRing = kD * kStageBytes;
  // The most rows a window copy may hold beside the other two copies,
  // the ring and the gather table (8 bytes a row of a copy).
  static constexpr int kMaxRows = (kMaxSmem - kAlign - kRing - kD * 8) / (3 * 128 + 3 * 8);
  __host__ __device__ static int win_bytes(const Tile& t) { return 3 * t.plane * 128; }
  static int smem_bytes(const Tile& t) {
    const int ring = win_bytes(t) + kRing + 3 * t.pos * 8 + kD * 8;
    const int epi = kBM * kOutLd * 2;
    return kAlign + (ring > epi ? ring : epi);
  }
};

template <int WG, int MT, int BN, typename Epi>
__global__ void __launch_bounds__(Cfg<WG, MT, BN>::kThreads, Cfg<WG, MT, BN>::kBlocksPerSM)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp, Tile t, int B, int H,
               int W, int C, int K, Epi epi) {
  using G = Cfg<WG, MT, BN>;
  constexpr int kThreads = G::kThreads, kD = G::kD;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // Swizzle atoms are 1024-byte aligned shared addresses.
  const unsigned raw_s = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((kAlign - raw_s % kAlign) % kAlign);
  const unsigned smem_s = static_cast<unsigned>(__cvta_generic_to_shared(smem));

  int tile = blockIdx.x;
  const int tx = tile % t.tiles_x;
  tile /= t.tiles_x;
  const int ty = tile % t.tiles_y;
  const int b0 = (tile / t.tiles_y) * t.ni, y0 = ty * t.th, x0 = tx * t.tw;
  const int n0 = blockIdx.y * BN;
  const int row_len = t.ni * t.tw, rows = t.th * row_len;
  const int slices = (C + 63) / 64;
  const int T = 9 * slices;  // stages: slice u / 9, taps column by column

  const int wts_off = G::win_bytes(t);
  const unsigned wts_s = smem_s + wts_off;

  // The gather table, built once: for each row of each window copy, its
  // input pixel (-1 outside the image) and its row in the buffer.  Every
  // slice's window load then costs a table read a 16-byte copy.
  int2* gather = reinterpret_cast<int2*>(smem + wts_off + G::kRing);
  // One mbarrier a weight stage, after the table.
  const unsigned bars = smem_s + wts_off + G::kRing + 3 * t.pos * 8;
  if (threadIdx.x == 0) {
    for (int d = 0; d < kD; ++d) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars + 8 * d));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = threadIdx.x; e < 3 * t.pos; e += kThreads) {
    const int dx = e / t.pos, p = e % t.pos;
    const int c = p % t.tw, pi = (p / t.tw) % t.ni, row = p / row_len;
    const int gb = b0 + pi, gy = y0 - 1 + row, gx = x0 - 1 + dx + c;
    const bool in = gb < B && gy >= 0 && gy < H && gx >= 0 && gx < W;
    gather[e] = make_int2(in ? (gb * H + gy) * W + gx : -1, dx * t.plane + p);
  }
  __syncthreads();

  // Issue stage u's copies: its weights, one bulk copy on mbarrier u % D,
  // and, at its column's first tap, window copy dx of its slice as one
  // cp.async group (committed, maybe empty, every stage).  Stage u is
  // tap (dy, dx) = (j % 3, j / 3), j = u % 9, so copy dx is read by three
  // consecutive stages; the next slice's copy dx replaces it D - 2 stages
  // before its own first tap, when the last stage that read it (7 stages
  // earlier) has retired as long as D <= 7: one window buffer serves
  // every slice.
  // Row r's 16-byte chunk g goes to chunk g ^ (r % 8) (all buffers start
  // on a swizzle atom; the packed weights come swizzled).
  auto issue = [&](int u) {
    if (u < T) {
      const int s = u / 9, dx = u % 9 / 3, dy = u % 3, tap = 3 * dy + dx;
      if (dy == 0) {
        bf16* win = reinterpret_cast<bf16*>(smem);
        const int c0 = s * 64;
        for (int i = threadIdx.x; i < t.pos * 8; i += kThreads) {
          const int2 g = gather[dx * t.pos + i / 8];
          const int ch = i % 8;
          const bool in = g.x >= 0 && c0 + 8 * ch < C;
          const bf16* src = in ? x + static_cast<size_t>(g.x) * C + c0 + 8 * ch : x;
          cp_async16(win + g.y * 64 + (ch ^ (g.y % 8)) * 8, src, in);
        }
      }
      // Rows past K stay as they were: they only reach output channels
      // that are not stored.
      if (threadIdx.x == 0) {
        const int n = K - n0 < BN ? K - n0 : BN;
        const bf16* src = wp + ((static_cast<size_t>(tap) * slices + s) * K + n0) * 64;
        bulk_load(wts_s + (u % kD) * G::kStageBytes, src, n * 128, bars + 8 * (u % kD));
      }
    }
    cp_async_commit();
  };

  const int wg = threadIdx.x / 128;
  // Not zeroed: the first product overwrites (scale-d = 0), so that no
  // other instruction defines an accumulator, which would make ptxas
  // serialize the wgmmas.
  float acc[MT][BN / 2];

  for (int u = 0; u < kD - 2; ++u) issue(u);
  for (int u = 0; u < T; ++u) {
    cp_async_wait<kD - 3>();  // stage u has landed; later ones may be in flight
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();
    issue(u + kD - 2);  // into the buffers of stage u - 2, whose wgmmas have retired
    mbar_wait(bars + 8 * (u % kD), (u / kD) % 2);  // stage u's weights have landed
    const int dx = u % 9 / 3, dy = u % 3;
    // A of m64 tile i: copy dx, rows dy NI TW + 64 (tile) on; B: the
    // stage's run.  k16 step kk: 32 bytes along the rows.
    const unsigned a_s = smem_s + (dx * t.plane + dy * row_len + 64 * wg * MT) * 128;
    const unsigned b_s = wts_s + (u % kD) * G::kStageBytes;
    uint64_t da[4][MT], db[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      db[kk] = desc(b_s + kk * 32);
#pragma unroll
      for (int i = 0; i < MT; ++i) da[kk][i] = desc(a_s + i * 64 * 128 + kk * 32);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < MT; ++i) wgmma(acc[i], da[kk][i], db[kk], u > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // stage u - 1 has retired; stage u stays in flight
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) pin(acc[i][j]);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the bf16 tile there

  // Accumulator element 4j + 2h + e of m64 tile i sits at tile row
  // 16 (warp % 4) + lane / 4 + 8h and channel 8j + 2 (lane % 4) + e.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* o_tile = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (wg * MT + i) * 64 + (warp % 4) * 16 + lane / 4 + h * 8;
        *reinterpret_cast<__nv_bfloat162*>(o_tile + row * G::kOutLd + j * 8 + (lane % 4) * 2) =
            __floats2bfloat162_rn(acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
      }
  __syncthreads();
  for (int i = threadIdx.x; i < G::kBM * (BN / 8); i += kThreads) {
    const int row = i / (BN / 8), cv = (i % (BN / 8)) * 8;
    const int c = row % t.tw, pi = (row / t.tw) % t.ni, r = row / row_len;
    const int gb = b0 + pi, gy = y0 + r, gx = x0 + c;
    if (row >= rows || gb >= B || gy >= H || gx >= W || n0 + cv >= K) continue;
    epi((static_cast<size_t>(gb) * H + gy) * W + gx, n0 + cv,
        *reinterpret_cast<const uint4*>(o_tile + row * G::kOutLd + cv));
  }
}

template <int WG, int MT, int BN, typename Epi>
cudaError_t launch(const bf16* x, const bf16* w, Epi epi, int B, int H, int W, int C, int K,
                   cudaStream_t stream) {
  using G = Cfg<WG, MT, BN>;
  static const cudaError_t allowed = ppv_allow_smem(conv3x3_kernel<WG, MT, BN, Epi>, kMaxSmem);
  if (allowed != cudaSuccess) return allowed;
  const Tile t = make_tile(G::kBM, B, H, W, G::kMaxRows);
  const dim3 grid(t.tiles_b * t.tiles_y * t.tiles_x, (K + BN - 1) / BN);
  conv3x3_kernel<WG, MT, BN, Epi><<<grid, G::kThreads, G::smem_bytes(t), stream>>>(x, w, t, B, H, W,
                                                                                  C, K, epi);
  return cudaGetLastError();
}

int blocks(int bm, int bn, int B, int H, int W, int K) {
  const Tile t = make_tile(bm, B, H, W, 1 << 30);
  return t.tiles_b * t.tiles_y * t.tiles_x * ((K + bn - 1) / bn);
}

// The conv of x (B, H, W, C) with wp, the (3, 3, C, K) weights packed by
// ops/winograd.py::pack_conv3x3_weight, (9, ceil(C/64), K, 8, 8), on
// `stream`; each 16-byte row of 8 output channels goes to epi(pixel,
// channel, row).  C and K multiples of 16.
template <typename Epi>
cudaError_t conv3x3_run(const bf16* x, const bf16* wp, Epi epi, int B, int H, int W, int C, int K,
                        cudaStream_t s) {
  if (C % 16 || K % 16 || B < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  constexpr int kSMs = 132;
  const bool wide = K > 64 && K % 128 == 0;
  const int bn = wide ? 128 : 64;
  // The largest tile that still gives (nearly) every SM a block: the
  // weights are restaged from L2 once a tile, so a larger tile moves fewer.
  if (!(C <= 64 && bn == 64) && blocks(256, bn, B, H, W, K) >= kSMs - 12) {
    return wide ? launch<2, 2, 128>(x, wp, epi, B, H, W, C, K, s)
                : launch<2, 2, 64>(x, wp, epi, B, H, W, C, K, s);
  }
  if (blocks(128, bn, B, H, W, K) >= kSMs - 12) {
    return wide ? launch<2, 1, 128>(x, wp, epi, B, H, W, C, K, s)
                : launch<2, 1, 64>(x, wp, epi, B, H, W, C, K, s);
  }
  if (wide && blocks(64, 128, B, H, W, K) >= kSMs) {
    return launch<1, 1, 128>(x, wp, epi, B, H, W, C, K, s);
  }
  return launch<1, 1, 64>(x, wp, epi, B, H, W, C, K, s);
}

}  // namespace
