// Per-sample weight gradient of a 'same' 3-D convolution, for Hopper (sm_90a).
//
// Replaces the TPU kernel repmode_tpu/ops/pallas/conv3d.py:
// pallas_conv3d_dw_persample (body _dw_kernel_ps). It computes the tap
// correlation
//
//     dW[n, t, i, o] = sum_p x[n, p + t - c, i] * dy[n, p, o]
//
// with zero 'same' padding, NDHWC x (N,D,H,W,Ci) and dy (N,D,H,W,Co) in bf16,
// fp32 sums, and an fp32 (N, kD, kH, kW, Ci, Co) result: the sufficient
// statistic of the merged MoDE conv's backward (the expert-bank and gate
// gradients are contractions of it).
//
// For each (sample, tap) this is a GEMM with M = Ci, N = Co and K = the
// sample's positions, and the shapes swing across the net: 32x32 outputs
// over 524,288 positions at level 1, 512x512 outputs over 128 positions at
// the bottleneck. What bounds it is tensor-core operations (2*125*Ci*Co per
// position, like the forward) except where the output is large against the
// positions (the bottleneck writes 8*125*512*512*4 B = 1 GB of fp32 dW), where
// bytes bound it. The design common to the instances:
//
//   * a block computes a tile of dW for one sample, one (dz, dy) tap pair and
//     KWB consecutive taps along W (all kW of them when kW is 1, 3 or 5), so
//     the kW taps share one shared-memory slab: x is read kD*kH times a Co
//     tile, not 125 times (conv3d_same.cu's slab trick, seen from the weight
//     side);
//   * positions are walked in chunks: one row segment, or several whole rows
//     when W is smaller than the chunk. Per chunk, the dy tile and the x slab
//     (the chunk's rows shifted by (dz, dy), widened by the column halo) are
//     copied to shared memory; halos and tails are zero-filled; depth taps
//     outside the volume skip the chunk;
//   * split over positions: where (sample, tap, tile) blocks alone would not
//     fill the card, each block takes a contiguous range of the sample's
//     chunks and writes its fp32 partial sums to a workspace; a second kernel
//     adds the partials in a fixed order. No atomics, so dW is
//     bit-reproducible. The wide instances do not split where the fp32 dW
//     outweighs x and dy (the deep levels): there the split-sum pass would
//     only add bytes.
//
// Three instances, chosen by the packed channel counts (Ci, Co):
//
//   * wgmma (Ci >= 64, Co >= 32 and planes of 128 positions or more: native
//     levels 2-4, dec1.conv1 and every s2d-level conv): warpgroup MMA, both
//     operands in shared memory, filled by the tensor memory accelerator
//     (TMA) onto an mbarrier ring of 3-4 stages from one thread. A chunk is
//     128 positions.
//     - A = x^T (M = 64 input channels a warpgroup, K = positions): K1's
//       slab (conv3d_same.cu), laid out chunk-major [Ci/8][slab
//       position][8], zero past every edge. Read the other way round, the
//       same bytes are an MN-major operand in the no-swizzle layout: a core
//       matrix is 8 channels (16 bytes) x 8 consecutive positions, the
//       8-channel groups a slab chunk apart. wgmma's transpose-A immediate
//       reads it, and tap dx is the same descriptor started dx * 16 bytes
//       later. A k16 step is 16 positions of one slab row (W >= 16: its two
//       core matrices 128 bytes apart) or of two rows (W <= 8: pitch * 16
//       bytes apart).
//     - B = dy (K = positions, N = Co), the same chunk-major layout, read
//       MN-major with the transpose-B immediate.
//     - Each operand of a stage is ONE tensor copy: a 5-D map over (8
//       channels, W, H, C / 8, N * D) puts the channel chunk outside the
//       rows, so one box (8 x cols x rows x chunks) lands chunk-major. One
//       box per 8-channel chunk (up to 32 a stage, from one thread) ran
//       5-32 % slower at the shapes this instance takes.
//     - 1 or 2 warpgroups (64 input channels each: 2 where Ci >= 128, which
//       then share the dy tile), BN = 32 or 64 output channels, 128 at 3 or
//       1 taps a block with two warpgroups; KWB x BN / 2 fp32 accumulators a
//       thread (160 at KWB = 5, BN = 64; 192 at KWB = 3, BN = 128). KWB is a
//       compile-time constant: each tap has its own accumulators, and a tap
//       loop at run time would make ptxas wait on the wgmmas at its back
//       edge.
//   * mma_sync, wide (Ci and Co >= 32, one of them >= 64, where wgmma does
//     not take the shape: native enc2.conv1 (32 -> 64) and the 2x8x8
//     bottleneck, where the wgmma instance measured 20-45 % slower): bf16
//     mma.sync.m16n8k16 with fp32 accumulators, A = x^T from the slab and
//     B = dy by ldmatrix.trans, both copied by cp.async through a 3-stage
//     ring; each of the block's 4 warps owns a 32 (i) x 32 (o) warp tile for
//     all KWB taps, on block tiles of 64 x 64 (64-position chunks), 64 x 32
//     or 32 x 64 (2 position groups taking disjoint k-steps of 128-position
//     chunks, adding their sums through shared memory in a fixed order).
//   * narrow (32 x 32 block tiles, 16 x 16 warp tiles, 2 stages, 5 blocks
//     an SM): the 1-channel input conv packed to 8 channels, conv_out's
//     Co = 1 padded to 8, the s2d entry conv's 12 packed lanes padded to
//     16, and Ci = Co = 32 (native level 1), where 4 position groups on a
//     wide 32 x 32 tile ran slower than this instance's occupancy.
//
// Ci and Co must be multiples of 8 (16-byte copies); the caller packs or pads
// the narrow 1-channel cases. The host's plan (ops/conv3d.py,
// conv3d_dw_persample_plan) mirrors make_plan below; a launch whose caller
// expects another split count is refused.

#include "hopper.cuh"  // mma.sync, wgmma, mbarrier and TMA helpers

namespace {

constexpr int TP = 64;       // positions per chunk (the GEMM's K per stage)
constexpr int THREADS = 128; // 4 warps in the mma.sync instances
// narrow instance: 2 warps along i x 2 along o, 16 x 16 each
constexpr int BI = 32;       // input channels per block (dW rows)
constexpr int BO = 32;       // output channels per block (dW columns)
constexpr int A_STRIDE = BI + 8;  // bf16 per slab position (pad: no bank conflicts)
constexpr int B_STRIDE = BO + 8;  // bf16 per dy position
// mma.sync wide instance
constexpr int WSTAGES = 3;   // cp.async ring depth
// wgmma instance: a chunk is WTP positions, a dy chunk WTP * 16 bytes
constexpr int WTP = 128;
constexpr int Y_CHUNK = WTP * 16;
constexpr int SMEM_MAX = 227 * 1024;          // dynamic shared memory a block may have
constexpr int SMEM_TWO_BLOCKS = 113 * 1024;   // ... and two blocks an SM may each have
constexpr int SMEM_ALIGN = 128;               // the wgmma ring starts 128-byte aligned

struct DwParams {
  const __nv_bfloat16* x;   // (N, D, H, W, ci)
  const __nv_bfloat16* dy;  // (N, D, H, W, co)
  float* out;               // (splits, N, T, ci, co); splits == 1: the result
  int n, d, h, w, ci, co;
  int kd, kh, kw;
  // a chunk holds P positions (TP, or TP per position group on the
  // mma.sync wide tile)
  int tw;                // columns per chunk (P when W >= P, else W; wgmma:
                         // the power of two >= W, at least 8)
  int rows;              // rows per chunk (1 when W >= P, else P / tw)
  int segs_per_row;      // ceil(W / P) when W >= P, else 1
  int chunks_per_plane;  // ceil(H / rows) * segs_per_row
  int itiles, otiles, dxgroups, splits, chunks_per_split;
  // wgmma instance
  int pitch;       // slab columns per row: tw + KWB - 1
  int slab_cap;    // slab positions: rows * pitch
  int a_k_stride;  // bytes between the two 8-position core matrices of A's k16 step
  int stages;      // ring buffers (3 or 4)
};

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// KWB: taps along W served by one block from one slab (1, 3 or 5).
template <int KWB>
__global__ void __launch_bounds__(THREADS)
conv3d_dw_kernel(const DwParams p) {
  constexpr int ISEGS = BI / 8, OSEGS = BO / 8;
  const int cols = p.tw + KWB - 1;    // slab columns per row
  const int slab_cap = p.rows * cols;
  const int buf_elems = slab_cap * A_STRIDE + TP * B_STRIDE;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_i = warp & 1;
  const int warp_o = warp >> 1;

  // ---- which tile, taps and chunk range this block computes ----
  int bx = blockIdx.x;
  const int split = bx % p.splits;
  bx /= p.splits;
  const int ot = bx % p.otiles;
  bx /= p.otiles;
  const int it = bx % p.itiles;
  bx /= p.itiles;
  const int dxg = bx % p.dxgroups;
  bx /= p.dxgroups;
  const int ty = bx % p.kh;
  bx /= p.kh;
  const int tz = bx % p.kd;
  const int nn = bx / p.kd;
  const int i0 = it * BI, o0 = ot * BO, dx0 = dxg * KWB;

  const int pd = (p.kd - 1) / 2, ph = (p.kh - 1) / 2, pw = (p.kw - 1) / 2;
  // chunks are ordered depth-major; a depth plane whose shifted input plane
  // lies outside the volume contributes nothing
  const int d_lo = max(0, pd - tz), d_hi = min(p.d, p.d + pd - tz);
  const int c_begin = max(split * p.chunks_per_split, d_lo * p.chunks_per_plane);
  const int c_end = min((split + 1) * p.chunks_per_split, d_hi * p.chunks_per_plane);
  const int num_chunks = max(0, c_end - c_begin);

  // slab position of each of this thread's ldmatrix rows, per k16 step (tap dx0)
  int a_pos[TP / 16];
#pragma unroll
  for (int kk = 0; kk < TP / 16; ++kk) {
    const int q = kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
    const int r = q / p.tw, c = q - (q / p.tw) * p.tw;
    a_pos[kk] = (r < p.rows) ? r * cols + c : 0;  // positions past the chunk: dy is 0
  }

  auto load_chunk = [&](int chunk, int buf) {
    const int dd = chunk / p.chunks_per_plane;
    const int rem = chunk - dd * p.chunks_per_plane;
    const int h0 = (rem / p.segs_per_row) * p.rows;
    const int w0 = (rem % p.segs_per_row) * p.tw;
    const int di = dd + tz - pd;
    __nv_bfloat16* slab = base + buf * buf_elems;
    __nv_bfloat16* dys = slab + slab_cap * A_STRIDE;

    const long long xplane = ((long long)nn * p.d + di) * p.h;
    for (int i = tid; i < slab_cap * ISEGS; i += THREADS) {
      const int pos = i / ISEGS, sg = i - (i / ISEGS) * ISEGS;
      const int r = pos / cols, c = pos - (pos / cols) * cols;
      const int hi = h0 + r + ty - ph, wi = w0 + c + dx0 - pw;
      const int ch = i0 + sg * 8;
      const bool ok = hi >= 0 && hi < p.h && wi >= 0 && wi < p.w && ch < p.ci;
      const __nv_bfloat16* src = ok ? p.x + ((xplane + hi) * p.w + wi) * p.ci + ch : p.x;
      cp_async16(smem_u32(slab + pos * A_STRIDE + sg * 8), src, ok ? 16 : 0);
    }

    const long long yplane = ((long long)nn * p.d + dd) * p.h;
    for (int i = tid; i < TP * OSEGS; i += THREADS) {
      const int q = i / OSEGS, sg = i - (i / OSEGS) * OSEGS;
      const int r = q / p.tw, c = q - (q / p.tw) * p.tw;
      const int ho = h0 + r, wo = w0 + c;
      const int ch = o0 + sg * 8;
      const bool ok = r < p.rows && ho < p.h && wo < p.w && ch < p.co;
      const __nv_bfloat16* src = ok ? p.dy + ((yplane + ho) * p.w + wo) * p.co + ch : p.dy;
      cp_async16(smem_u32(dys + q * B_STRIDE + sg * 8), src, ok ? 16 : 0);
    }
  };

  float acc[KWB][2][4];
#pragma unroll
  for (int dx = 0; dx < KWB; ++dx)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[dx][j][q] = 0.0f;

  if (num_chunks > 0) {
    load_chunk(c_begin, 0);
  }
  cp_async_commit();
  for (int s = 0; s < num_chunks; ++s) {
    const int buf = s & 1;
    if (s + 1 < num_chunks) load_chunk(c_begin + s + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const __nv_bfloat16* slab = base + buf * buf_elems;
    const uint32_t slab_addr = smem_u32(slab);
    const uint32_t dy_addr = smem_u32(slab + slab_cap * A_STRIDE);
    const int a_col = warp_i * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < TP / 16; ++kk) {
      // B = dy[positions kk*16.., o0 + warp_o*16 ..+16]: two n8 fragments
      uint32_t b[4];
      const int boff = (kk * 16 + (lane & 15)) * B_STRIDE + warp_o * 16 + (lane >> 4) * 8;
      ldmatrix_x4_trans(dy_addr + boff * 2, b);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
      for (int dx = 0; dx < KWB; ++dx) {
        // A = x^T[i0 + warp_i*16 ..+16, the same positions shifted by dx]
        uint32_t a[4];
        ldmatrix_x4_trans(slab_addr + ((a_pos[kk] + dx) * A_STRIDE + a_col) * 2, a);
        mma_bf16_16816(acc[dx][0], a, b0);
        mma_bf16_16816(acc[dx][1], a, b1);
      }
    }
    __syncthreads();
  }

  // ---- store this block's (partial) sums ----
  const int taps = p.kd * p.kh * p.kw;
  float* out = p.out + (long long)split * p.n * taps * p.ci * p.co;
#pragma unroll
  for (int dx = 0; dx < KWB; ++dx) {
    const int tap = (tz * p.kh + ty) * p.kw + dx0 + dx;
    const long long tap_base = ((long long)nn * taps + tap) * p.ci;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + warp_i * 16 + (lane >> 2) + half * 8;
      if (i >= p.ci) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + warp_o * 16 + j * 8 + (lane & 3) * 2 + e;
          if (o < p.co) out[(tap_base + i) * p.co + o] = acc[dx][j][half * 2 + e];
        }
      }
    }
  }
}

// mma.sync wide instance: a (32*WI) x (32*WO) tile of dW (64 x 64, 64 x 32
// or 32 x 64) for one sample, one (dz, dy) tap pair and KWB taps along W.
// Warp w
// owns warp tile (w % WT) of the block tile for the k-steps of position
// group w / WT. A chunk holds 64 positions per position group, so every
// warp takes 4 k-steps between two barriers.
template <int KWB, int WI, int WO>
__global__ void __launch_bounds__(THREADS)
conv3d_dw_kernel_wide(const DwParams p) {
  constexpr int WT = WI * WO;        // warps on the block tile
  constexpr int PG = 4 / WT;         // position groups
  constexpr int TPC = TP * PG;       // positions per chunk
  constexpr int KS = TP / 16;        // k16 steps a warp takes per chunk
  constexpr int TI = 32 * WI, TO = 32 * WO;
  constexpr int AS = TI + 8, BS = TO + 8;  // bf16 per slab / dy position (pad: no bank conflicts)
  constexpr int ISEGS = TI / 8, OSEGS = TO / 8;
  constexpr int XSTEP = THREADS / ISEGS, YSTEP = THREADS / OSEGS;  // positions a copy pass
  const int cols = p.tw + KWB - 1;  // slab columns per row
  const int slab_cap = p.rows * cols;
  const int buf_elems = slab_cap * AS + TPC * BS;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wt = warp % WT;
  const int warp_i = wt % WI, warp_o = wt / WI;
  const int pg = warp / WT;

  // ---- which tile, taps and chunk range this block computes ----
  int bx = blockIdx.x;
  const int split = bx % p.splits;
  bx /= p.splits;
  const int ot = bx % p.otiles;
  bx /= p.otiles;
  const int it = bx % p.itiles;
  bx /= p.itiles;
  const int dxg = bx % p.dxgroups;
  bx /= p.dxgroups;
  const int ty = bx % p.kh;
  bx /= p.kh;
  const int tz = bx % p.kd;
  const int nn = bx / p.kd;
  const int i0 = it * TI, o0 = ot * TO, dx0 = dxg * KWB;

  const int pd = (p.kd - 1) / 2, ph = (p.kh - 1) / 2, pw = (p.kw - 1) / 2;
  const int d_lo = max(0, pd - tz), d_hi = min(p.d, p.d + pd - tz);
  const int c_begin = max(split * p.chunks_per_split, d_lo * p.chunks_per_plane);
  const int c_end = min((split + 1) * p.chunks_per_split, d_hi * p.chunks_per_plane);
  const int num_chunks = max(0, c_end - c_begin);

  // slab position of each of this thread's ldmatrix rows, per k16 step of
  // its position group (tap dx0)
  int a_pos[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int q = (k * PG + pg) * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
    const int r = q / p.tw, c = q - (q / p.tw) * p.tw;
    a_pos[k] = (r < p.rows) ? r * cols + c : 0;  // positions past the chunk: dy is 0
  }

  // Each thread copies the same 16-byte segment of every XSTEP-th slab
  // position and YSTEP-th dy position in every chunk: its first row and
  // column are found once, then stepped without a division.
  const int xsg = tid % ISEGS, ysg = tid % OSEGS;
  const int xr0 = (tid / ISEGS) / cols, xc0 = (tid / ISEGS) % cols;
  const int yr0 = (tid / OSEGS) / p.tw, yc0 = (tid / OSEGS) % p.tw;

  auto load_chunk = [&](int chunk, int buf) {
    const int dd = chunk / p.chunks_per_plane;
    const int rem = chunk - dd * p.chunks_per_plane;
    const int h0 = (rem / p.segs_per_row) * p.rows;
    const int w0 = (rem % p.segs_per_row) * p.tw;
    const int di = dd + tz - pd;
    __nv_bfloat16* slab = base + buf * buf_elems;
    __nv_bfloat16* dys = slab + slab_cap * AS;

    const long long xplane = ((long long)nn * p.d + di) * p.h;
    const int xch = i0 + xsg * 8;
    int r = xr0, c = xc0;
    for (int pos = tid / ISEGS; pos < slab_cap; pos += XSTEP) {
      const int hi = h0 + r + ty - ph, wi = w0 + c + dx0 - pw;
      const bool ok = hi >= 0 && hi < p.h && wi >= 0 && wi < p.w && xch < p.ci;
      const __nv_bfloat16* src = ok ? p.x + ((xplane + hi) * p.w + wi) * p.ci + xch : p.x;
      cp_async16(smem_u32(slab + pos * AS + xsg * 8), src, ok ? 16 : 0);
      for (c += XSTEP; c >= cols; c -= cols) ++r;
    }

    const long long yplane = ((long long)nn * p.d + dd) * p.h;
    const int ych = o0 + ysg * 8;
    r = yr0; c = yc0;
    for (int q = tid / OSEGS; q < TPC; q += YSTEP) {
      const int ho = h0 + r, wo = w0 + c;
      const bool ok = r < p.rows && ho < p.h && wo < p.w && ych < p.co;
      const __nv_bfloat16* src = ok ? p.dy + ((yplane + ho) * p.w + wo) * p.co + ych : p.dy;
      cp_async16(smem_u32(dys + q * BS + ysg * 8), src, ok ? 16 : 0);
      for (c += YSTEP; c >= p.tw; c -= p.tw) ++r;
    }
  };

  // acc[tap][m16 tile along i][n8 tile along o][fragment]
  float acc[KWB][2][4][4];
#pragma unroll
  for (int dx = 0; dx < KWB; ++dx)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dx][m][nt][e] = 0.0f;

  // the ring: chunk s sits in stage s % 3; two chunks are in flight ahead
  for (int s = 0; s < WSTAGES - 1; ++s) {
    if (s < num_chunks) load_chunk(c_begin + s, s);
    cp_async_commit();
  }
  for (int s = 0; s < num_chunks; ++s) {
    cp_async_wait_one();  // this thread's copies of chunk s have landed
    __syncthreads();      // everyone's have, and everyone is done with chunk s - 1
    if (s + WSTAGES - 1 < num_chunks) {
      load_chunk(c_begin + s + WSTAGES - 1, (s + WSTAGES - 1) % WSTAGES);
    }
    cp_async_commit();

    const uint32_t slab_addr = smem_u32(base + (s % WSTAGES) * buf_elems);
    const uint32_t dy_addr = slab_addr + slab_cap * AS * 2;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int kk = k * PG + pg;
      // B = dy[positions kk*16 ..+16, o0 + warp_o*32 ..+32]: four n8 fragments
      uint32_t b[2][4];
#pragma unroll
      for (int hb = 0; hb < 2; ++hb) {
        const int boff = (kk * 16 + (lane & 15)) * BS + warp_o * 32 + hb * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(dy_addr + boff * 2, b[hb]);
      }
#pragma unroll
      for (int dx = 0; dx < KWB; ++dx) {
        // A = x^T[i0 + warp_i*32 ..+32, the same positions shifted by dx]
        const uint32_t arow =
            slab_addr + ((a_pos[k] + dx) * AS + warp_i * 32 + ((lane >> 3) & 1) * 8) * 2;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t a[4];
          ldmatrix_x4_trans(arow + m * 32, a);  // 16 channels on: 32 bytes
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint32_t bb[2] = {b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]};
            mma_bf16_16816(acc[dx][m][nt], a, bb);
          }
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the ring is free: it holds the position groups' sums

  if constexpr (PG > 1) {
    // position groups 1..PG-1 hand their sums to group 0, which adds them in
    // order: the same order every run
    constexpr int NE = KWB * 32;  // accumulators a thread
    float* red = reinterpret_cast<float*>(smem);
    if (pg > 0) {
      float* dst = red + (size_t)((pg - 1) * WT + wt) * NE * 32 + lane;
#pragma unroll
      for (int dx = 0; dx < KWB; ++dx)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dst[(((dx * 2 + m) * 4 + nt) * 4 + e) * 32] = acc[dx][m][nt][e];
    }
    __syncthreads();
    if (pg > 0) return;
#pragma unroll 1
    for (int g = 1; g < PG; ++g) {
      const float* src = red + (size_t)((g - 1) * WT + wt) * NE * 32 + lane;
#pragma unroll
      for (int dx = 0; dx < KWB; ++dx)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[dx][m][nt][e] += src[(((dx * 2 + m) * 4 + nt) * 4 + e) * 32];
    }
  }

  // ---- store this block's (partial) sums, two floats a store ----
  const int taps = p.kd * p.kh * p.kw;
  float* out = p.out + (long long)split * p.n * taps * p.ci * p.co;
#pragma unroll
  for (int dx = 0; dx < KWB; ++dx) {
    const int tap = (tz * p.kh + ty) * p.kw + dx0 + dx;
    const long long tap_base = ((long long)nn * taps + tap) * p.ci;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i0 + warp_i * 32 + m * 16 + (lane >> 2) + half * 8;
        if (i >= p.ci) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int o = o0 + warp_o * 32 + nt * 8 + (lane & 3) * 2;  // Co % 8 == 0: o + 1 < Co too
          if (o < p.co) {
            *reinterpret_cast<float2*>(out + (tap_base + i) * p.co + o) =
                make_float2(acc[dx][m][nt][half * 2], acc[dx][m][nt][half * 2 + 1]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- warpgroup MMA

// Bytes between the two 8-position core matrices of A's k16 step: 16
// positions of one slab row where a chunk row has 16 columns or more, else
// of two rows (chunk rows of 8 columns).
__host__ __device__ __forceinline__ int a_k_stride_of(int tw, int pitch) {
  return tw >= 16 ? 128 : pitch * 16;
}

// Shared bytes of one 8-channel chunk of the wgmma instance's slab (the
// chunks of a stage are one tensor copy, back to back), and a byte count
// rounded up to the 128-byte alignment of a tensor copy's destination.
__host__ __device__ __forceinline__ uint32_t x_chunk_bytes(int slab_cap) {
  return (uint32_t)slab_cap * 16;
}

__host__ __device__ __forceinline__ uint32_t round128(uint32_t bytes) {
  return (bytes + 127) & ~127u;
}

// Descriptors of the wgmma instance's operands at k16 step 0 and tap 0,
// both in the no-swizzle MN-major layout. A = x^T over the 8 slab chunks of
// a warpgroup's 64 input channels from x0: channels contiguous by 8, the
// chunks x_chunk bytes apart; positions 16 bytes apart, the step's second 8
// positions a_k_stride bytes on. B = dy from y0: output channels contiguous
// by 8, the chunks Y_CHUNK bytes apart; the step's second 8 positions 128
// bytes on. A step or a tap moves a descriptor by its offset in 16-byte
// units (one position), added to the start address field.
__device__ __forceinline__ uint64_t dw_desc_x(uint32_t x0, uint32_t x_chunk, int a_k_stride) {
  return smem_desc_a(x0, (uint32_t)a_k_stride, x_chunk);
}

__device__ __forceinline__ uint64_t dw_desc_dy(uint32_t y0) {
  return smem_desc_a(y0, 128, Y_CHUNK);
}

// One k16 step of KWB taps: acc[dx] += A (its positions dx later) * B.
template <int KWB, int NACC>
__device__ __forceinline__ void dw_k16_step(float (&acc)[KWB][NACC], uint64_t da, uint64_t db) {
#pragma unroll
  for (int dx = 0; dx < KWB; ++dx) wgmma_ss<1, 1>(acc[dx], da + dx, db);
}

// wgmma instance: a (64 * WG) x BN tile of dW (warpgroup g: input channels
// 64 g .. 64 g + 63 of the tile; both read one dy tile) for one sample,
// one (dz, dy) tap pair and KWB taps along W. Chunks of WTP positions come
// through a ring of p.stages buffers, filled p.stages - 2 chunks ahead by
// one thread's two tensor copies: one box of x (its 8 WG 8-channel chunks
// of rows x pitch positions, zero past every edge) and one of dy (BN / 8
// chunks of rows x tw).
template <int KWB, int WG, int BN>
__global__ void __launch_bounds__(WG * 128, WG == 1 ? 2 : 1)
conv3d_dw_kernel_wgmma(const DwParams p, const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmy) {
  constexpr int XSEGS = WG * 8;  // 8-channel chunks of x a stage
  constexpr int YSEGS = BN / 8;  // 8-channel chunks of dy a stage
  constexpr int KS = WTP / 16;   // k16 steps a chunk
  constexpr int NACC = BN / 2;   // accumulators a thread, per tap

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + SMEM_ALIGN - 1) & ~(uint32_t)(SMEM_ALIGN - 1);
  const uint32_t x_chunk = x_chunk_bytes(p.slab_cap);
  const uint32_t y_off = round128(XSEGS * x_chunk);  // dy follows the slab in a buffer
  const uint32_t stage_bytes = round128(y_off + YSEGS * Y_CHUNK);
  __shared__ __align__(8) uint64_t bar_mem[4];  // one mbarrier a ring buffer
  const uint32_t bars = smem_u32(bar_mem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int wl = (tid >> 5) & 3;  // warp within the warpgroup: rows 16 wl .. +15 of its m64

  // ---- which tile, taps and chunk range this block computes ----
  int bx = blockIdx.x;
  const int split = bx % p.splits;
  bx /= p.splits;
  const int ot = bx % p.otiles;
  bx /= p.otiles;
  const int it = bx % p.itiles;
  bx /= p.itiles;
  const int dxg = bx % p.dxgroups;
  bx /= p.dxgroups;
  const int ty = bx % p.kh;
  bx /= p.kh;
  const int tz = bx % p.kd;
  const int nn = bx / p.kd;
  const int i0 = it * 64 * WG, o0 = ot * BN, dx0 = dxg * KWB;

  const int pd = (p.kd - 1) / 2, ph = (p.kh - 1) / 2, pw = (p.kw - 1) / 2;
  const int d_lo = max(0, pd - tz), d_hi = min(p.d, p.d + pd - tz);
  const int c_begin = max(split * p.chunks_per_split, d_lo * p.chunks_per_plane);
  const int c_end = min((split + 1) * p.chunks_per_split, d_hi * p.chunks_per_plane);
  const int num_chunks = max(0, c_end - c_begin);

  // slab position of each k16 step's first position, at tap dx0
  int a_off[KS];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int r = kk * 16 / p.tw;
    a_off[kk] = r * p.pitch + kk * 16 - r * p.tw;
  }

  auto load_chunk = [&](int chunk, int buf) {
    if (tid != 0) return;
    const int dd = chunk / p.chunks_per_plane;
    const int rem = chunk - dd * p.chunks_per_plane;
    const int h0 = (rem / p.segs_per_row) * p.rows;
    const int w0 = (rem % p.segs_per_row) * p.tw;
    const uint32_t bar = bars + buf * 8;
    const uint32_t st = base + buf * stage_bytes;
    mbar_expect_tx(bar, XSEGS * p.slab_cap * 16 + YSEGS * WTP * 16);
    const int plane = nn * p.d + dd;  // depth is in the volume: N and D share a dimension
    tma_load_5d(st, &tmx, bar, 0, w0 + dx0 - pw, h0 + ty - ph, i0 / 8, plane + tz - pd);
    tma_load_5d(st + y_off, &tmy, bar, 0, w0, h0, o0 / 8, plane);
  };

  float acc[KWB][NACC];
#pragma unroll
  for (int dx = 0; dx < KWB; ++dx)
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[dx][j] = 0.0f;

  // Ring of S >= 3 buffers, filled S - 2 chunks ahead. Each chunk is one
  // commit group per warpgroup, and a warpgroup leaves a chunk with at most
  // that group in flight; so when the barrier of chunk s is passed, chunk
  // s - 2 is retired everywhere and its buffer can be refilled.
  const int S = p.stages;
  const int ahead = S - 2;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(bars + i * 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < ahead && s < num_chunks; ++s) load_chunk(c_begin + s, s);
  int buf = 0, next_buf = ahead;
  uint32_t phase = 0;  // of buffer buf's fills
  for (int s = 0; s < num_chunks; ++s) {
    mbar_wait(bars + buf * 8, phase);
    __syncthreads();  // every warpgroup has retired chunk s - 2
    if (s + ahead < num_chunks) load_chunk(c_begin + s + ahead, next_buf);

    const uint32_t st = base + buf * stage_bytes;
    const uint64_t da = dw_desc_x(st + wg * 8 * x_chunk, x_chunk, p.a_k_stride);
    const uint64_t db = dw_desc_dy(st + y_off);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) dw_k16_step<KWB, NACC>(acc, da + a_off[kk], db + kk * 16);
    wgmma_commit();
    wgmma_wait<1>();
    if (++buf == S) buf = 0, phase ^= 1;
    next_buf = next_buf + 1 == S ? 0 : next_buf + 1;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int dx = 0; dx < KWB; ++dx) fence_accumulators(acc[dx]);

  // ---- store this block's (partial) sums, two floats a store ----
  // accumulator 4j + 2h + e of lane l in warp wl: row 16 wl + l/4 + 8h of
  // the warpgroup's m64 (input channels), column 8j + 2(l%4) + e (output
  // channels)
  const int taps = p.kd * p.kh * p.kw;
  float* out = p.out + (long long)split * p.n * taps * p.ci * p.co;
#pragma unroll
  for (int dx = 0; dx < KWB; ++dx) {
    const int tap = (tz * p.kh + ty) * p.kw + dx0 + dx;
    const long long tap_base = ((long long)nn * taps + tap) * p.ci;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + wg * 64 + wl * 16 + (lane >> 2) + half * 8;
      if (i >= p.ci) continue;
      float* row = out + (tap_base + i) * p.co;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int o = o0 + j * 8 + (lane & 3) * 2;  // Co % 8 == 0: o + 1 < Co too
        if (o < p.co) {
          *reinterpret_cast<float2*>(row + o) =
              make_float2(acc[dx][j * 4 + half * 2], acc[dx][j * 4 + half * 2 + 1]);
        }
      }
    }
  }
}

// One k16 step of the wgmma instance through its own descriptors, for the
// card tests: out[dx] = x^T * dy for the 16 positions of k16 step 0 at tap
// dx = 0..4, 64 input x 64 output channels, one block. xs: the slab as the
// tensor copies lay it out, (8, slab_cap, 8) bf16 (8 channels a chunk), the
// step's positions q at slab positions (q / tw) * pitch + q % tw + dx; ys:
// dy as they lay it out, (8, WTP, 8) bf16, of which positions 0-15 are read;
// out: (5, 64, 64) fp32.
__global__ void __launch_bounds__(128)
conv3d_dw_wgmma_unit_kernel(const __nv_bfloat16* xs, const __nv_bfloat16* ys, float* out, int tw,
                            int pitch, int slab_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + SMEM_ALIGN - 1) & ~(uint32_t)(SMEM_ALIGN - 1);
  unsigned char* sbase = smem + (base - raw);
  const uint32_t x_chunk = x_chunk_bytes(slab_cap);
  const uint32_t y_off = round128(8 * x_chunk);
  const int tid = threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(xs);
  const uint4* yv = reinterpret_cast<const uint4*>(ys);
  for (int i = tid; i < 8 * slab_cap; i += 128) {  // x_chunk == slab_cap * 16: back to back
    *reinterpret_cast<uint4*>(sbase + i * 16) = xv[i];
  }
  for (int i = tid; i < 8 * WTP; i += 128) {
    *reinterpret_cast<uint4*>(sbase + y_off + i * 16) = yv[i];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the stores, seen by wgmma
  __syncthreads();

  float acc[5][32];
#pragma unroll
  for (int dx = 0; dx < 5; ++dx)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[dx][j] = 0.0f;
  wgmma_fence();
  dw_k16_step<5, 32>(acc, dw_desc_x(base, x_chunk, a_k_stride_of(tw, pitch)),
                     dw_desc_dy(base + y_off));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int dx = 0; dx < 5; ++dx) fence_accumulators(acc[dx]);

  const int lane = tid & 31, wl = tid >> 5;
#pragma unroll
  for (int dx = 0; dx < 5; ++dx)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = wl * 16 + (lane >> 2) + half * 8, o = j * 8 + (lane & 3) * 2;
        out[(dx * 64 + i) * 64 + o] = acc[dx][j * 4 + half * 2];
        out[(dx * 64 + i) * 64 + o + 1] = acc[dx][j * 4 + half * 2 + 1];
      }
}

// out[j] = sum over s of part[s][j], in order s = 0, 1, ...
__global__ void sum_partials_kernel(const float* part, float* out, long long total,
                                    int splits) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < total;
       j += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += part[k * total + j];
    out[j] = s;
  }
}

// Instance, tiles, chunking, splits and shared memory of one launch.
struct Plan {
  int instance;         // 0 narrow, 1 mma.sync wide, 2 wgmma
  int kwb;              // taps along W per block: 1, 3 or 5
  int wgs;              // wgmma: warpgroups (64 input channels each)
  int wi, wo;           // mma.sync wide: warps along i and o on the block tile
  int bi, bo, groups;   // block tile and position groups
  int tp;               // positions per chunk
  int tw, rows, segs, chunks_per_plane;
  int pitch, slab_cap, a_k_stride;  // wgmma: slab geometry
  int stages, threads;
  long long chunks, base;  // chunks per sample; blocks without a split
  int splits;
  size_t smem;
};

// widest: 2 any instance, 1 the mma.sync ones, 0 the narrow one only
Plan make_plan(int n, int d, int h, int wl, int ci, int co, int kd, int kh, int kw, int num_sms,
               int widest = 2) {
  Plan q{};
  q.kwb = (kw == 1 || kw == 3 || kw == 5) ? kw : 1;
  // planes under 128 positions (the 2x8x8 bottleneck) keep mma.sync, as in
  // K1-K3; 32 x 32 tiles (native level 1) stay narrow: with 4 position
  // groups their 2 blocks an SM ran slower than the narrow instance's 5
  if (widest >= 2 && ci >= 64 && co >= 32 && (long long)h * wl >= 128) {
    q.instance = 2;
  } else if (widest >= 1 && ci >= 32 && co >= 32 && (ci >= 64 || co >= 64)) {
    q.instance = 1;
  } else {
    q.instance = 0;
  }
  q.threads = THREADS;
  if (q.instance == 2) {
    q.wgs = ci >= 128 ? 2 : 1;
    q.bi = 64 * q.wgs;
    q.bo = (q.kwb != 5 && q.wgs == 2 && co >= 128) ? 128 : (co >= 64 ? 64 : 32);
    q.groups = 1;
    q.tp = WTP;
    q.threads = 128 * q.wgs;
    if (wl >= WTP) {
      q.tw = WTP; q.rows = 1; q.segs = (wl + WTP - 1) / WTP;
    } else {  // rows of a power-of-two width: a k16 step is one row or two
      q.tw = 8;
      while (q.tw < wl) q.tw *= 2;
      q.rows = WTP / q.tw; q.segs = 1;
    }
    q.pitch = q.tw + q.kwb - 1;
    q.slab_cap = q.rows * q.pitch;
    q.a_k_stride = a_k_stride_of(q.tw, q.pitch);
  } else {
    q.wi = (q.instance == 1 && ci >= 64) ? 2 : 1;
    q.wo = (q.instance == 1 && co >= 64) ? 2 : 1;
    q.bi = q.instance == 1 ? 32 * q.wi : BI;
    q.bo = q.instance == 1 ? 32 * q.wo : BO;
    q.groups = q.instance == 1 ? 4 / (q.wi * q.wo) : 1;
    q.tp = TP * q.groups;
    if (wl >= q.tp) {
      q.tw = q.tp; q.rows = 1; q.segs = (wl + q.tp - 1) / q.tp;
    } else {
      q.tw = wl; q.rows = q.tp / wl; q.segs = 1;
    }
  }
  q.chunks_per_plane = ((h + q.rows - 1) / q.rows) * q.segs;
  q.chunks = (long long)d * q.chunks_per_plane;
  q.base = (long long)n * kd * kh * (kw / q.kwb) * ((ci + q.bi - 1) / q.bi) *
           ((co + q.bo - 1) / q.bo);
  long long splits;
  if (q.instance == 0) {
    splits = (num_sms * 16 + q.base - 1) / q.base;  // ~2,100 blocks on 132 SMs, several each
  } else if ((long long)kd * kh * kw * ci * co * 4 > (long long)d * h * wl * (ci + co) * 2) {
    splits = 1;  // the fp32 dW outweighs x and dy: a split-sum pass only adds bytes
  } else {  // ~4 waves of 2 blocks an SM (1 of two warpgroups)
    const long long target = (long long)num_sms * 8 / (q.instance == 2 ? q.wgs : 1);
    splits = (target + q.base - 1) / q.base;
  }
  if (splits > q.chunks) splits = q.chunks;
  if (splits < 1) splits = 1;
  const long long per = (q.chunks + splits - 1) / splits;
  q.splits = (int)((q.chunks + per - 1) / per);
  if (q.instance == 2) {
    // as many stages (3-4) as leave two blocks an SM of one warpgroup, else
    // as fit one block
    const size_t stage =
        round128(round128(q.wgs * 8 * x_chunk_bytes(q.slab_cap)) + q.bo / 8 * Y_CHUNK);
    q.stages = q.wgs == 1 ? (int)((SMEM_TWO_BLOCKS - SMEM_ALIGN) / stage) : 0;
    if (q.stages < 3) q.stages = (int)((SMEM_MAX - SMEM_ALIGN) / stage);
    if (q.stages > 4) q.stages = 4;
    if (q.stages < 3) return make_plan(n, d, h, wl, ci, co, kd, kh, kw, num_sms, 1);
    q.smem = q.stages * stage + SMEM_ALIGN;
  } else if (q.instance == 1) {
    const size_t slab_cap = (size_t)q.rows * (q.tw + q.kwb - 1);
    q.stages = WSTAGES;
    const size_t ring = WSTAGES * (slab_cap * (q.bi + 8) + (size_t)q.tp * (q.bo + 8)) * 2;
    const size_t red = (size_t)(q.groups - 1) * (q.wi * q.wo) * q.kwb * 32 * 32 * 4;
    q.smem = ring > red ? ring : red;
    // a very narrow W makes the slab long: such a shape takes the narrow instance
    if (q.smem > SMEM_MAX) return make_plan(n, d, h, wl, ci, co, kd, kh, kw, num_sms, 0);
  } else {
    const size_t slab_cap = (size_t)q.rows * (q.tw + q.kwb - 1);
    q.stages = 2;
    q.smem = 2 * (slab_cap * A_STRIDE + (size_t)TP * B_STRIDE) * 2;
  }
  return q;
}

// The map of an NDHWC bf16 tensor as (8 channels, W, H, C / 8, N * D), the
// chunk dimension's stride (16 bytes) under the rows': one box of 8 x cols
// x rows x chunks lands chunk-major, [chunk][row][col][8], zero past W, H
// and C. Depth is never out of range where the kernel loads, so N and D
// share a dimension.
bool encode_chunked_map(CUtensorMap* map, const void* x, int n, int d, int h, int w, int c,
                        int cols, int rows, int chunks) {
  const PFN_cuTensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t e = 2;
  const cuuint64_t dims[5] = {8, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)c / 8,
                              (cuuint64_t)n * d};
  const cuuint64_t strides[4] = {(cuuint64_t)c * e, (cuuint64_t)w * c * e, 16,
                                 (cuuint64_t)h * w * c * e};
  const cuuint32_t box[5] = {8, (cuuint32_t)cols, (cuuint32_t)rows, (cuuint32_t)chunks, 1};
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims, strides,
                box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

using Kernel = void (*)(DwParams);
using WgmmaKernel = void (*)(DwParams, CUtensorMap, CUtensorMap);

// The mma.sync instances
template <int KWB>
Kernel wide_kernel(const Plan& q) {
  if (q.wi == 2) return q.wo == 2 ? &conv3d_dw_kernel_wide<KWB, 2, 2> : &conv3d_dw_kernel_wide<KWB, 2, 1>;
  return &conv3d_dw_kernel_wide<KWB, 1, 2>;
}

Kernel pick(const Plan& q) {
  switch (q.kwb) {
    case 1: return q.instance == 1 ? wide_kernel<1>(q) : &conv3d_dw_kernel<1>;
    case 3: return q.instance == 1 ? wide_kernel<3>(q) : &conv3d_dw_kernel<3>;
    default: return q.instance == 1 ? wide_kernel<5>(q) : &conv3d_dw_kernel<5>;
  }
}

// The wgmma instances: BN 32 or 64 at any KWB, 128 at KWB = 1 and 3 with
// two warpgroups
template <int KWB, int WG>
WgmmaKernel wgmma_kernel(int bn) {
  if (bn == 32) return &conv3d_dw_kernel_wgmma<KWB, WG, 32>;
  if (bn == 64) return &conv3d_dw_kernel_wgmma<KWB, WG, 64>;
  if constexpr (KWB != 5 && WG == 2) {
    if (bn == 128) return &conv3d_dw_kernel_wgmma<KWB, WG, 128>;
  }
  return nullptr;
}

WgmmaKernel pick_wgmma(const Plan& q) {
  switch (q.kwb) {
    case 1: return q.wgs == 2 ? wgmma_kernel<1, 2>(q.bo) : wgmma_kernel<1, 1>(q.bo);
    case 3: return q.wgs == 2 ? wgmma_kernel<3, 2>(q.bo) : wgmma_kernel<3, 1>(q.bo);
    default: return q.wgs == 2 ? wgmma_kernel<5, 2>(q.bo) : wgmma_kernel<5, 1>(q.bo);
  }
}

const void* kernel_of(const Plan& q) {
  return q.instance == 2 ? reinterpret_cast<const void*>(pick_wgmma(q))
                         : reinterpret_cast<const void*>(pick(q));
}

}  // namespace

extern "C" {

// The launch these shapes get on a card of num_sms SMs, into out[0..12]:
// instance (0 narrow, 1 mma.sync wide, 2 wgmma), taps along W per block,
// block tile rows and columns, position groups, splits, registers a
// thread, local (spill) bytes a thread, dynamic shared bytes, ring stages,
// blocks, threads a block, and the bytes between the two 8-position core
// matrices of A's k16 step (wgmma; else 0). Returns the cudaError_t of
// reading the kernel's attributes.
int conv3d_dw_persample_plan(int n, int d, int h, int wl, int ci, int co, int kd, int kh,
                             int kw, int num_sms, int* out) {
  const Plan q = make_plan(n, d, h, wl, ci, co, kd, kh, kw, num_sms);
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel_of(q));
  out[0] = q.instance; out[1] = q.kwb; out[2] = q.bi; out[3] = q.bo; out[4] = q.groups;
  out[5] = q.splits;
  out[6] = err == cudaSuccess ? a.numRegs : -1;
  out[7] = err == cudaSuccess ? (int)a.localSizeBytes : -1;
  out[8] = (int)q.smem;
  out[9] = q.stages;
  out[10] = (int)(q.base * q.splits);
  out[11] = q.threads;
  out[12] = q.a_k_stride;
  return (int)err;
}

// Launches dW on `stream`; returns the cudaError_t (0 on success). x: (n, d,
// h, wl, ci) bf16; dy: (n, d, h, wl, co) bf16; out: (n, kd, kh, kw, ci, co)
// fp32; work: (splits, n, kd, kh, kw, ci, co) fp32 when splits > 1, else
// unused. `splits` is the count the caller's plan expects for a card of
// num_sms SMs (it sized work for it): a launch whose own plan differs is
// refused. Does not synchronize and allocates nothing.
int conv3d_dw_persample_bf16(const void* x, const void* dy, void* out, void* work, int n, int d,
                             int h, int wl, int ci, int co, int kd, int kh, int kw, int num_sms,
                             int splits, void* stream) {
  if (kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0 || n <= 0 || d <= 0 || h <= 0 || wl <= 0 ||
      ci <= 0 || ci % 8 != 0 || co <= 0 || co % 8 != 0 || num_sms <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan q = make_plan(n, d, h, wl, ci, co, kd, kh, kw, num_sms);
  if (q.splits != splits || (q.splits > 1 && work == nullptr)) return (int)cudaErrorInvalidValue;
  DwParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.dy = static_cast<const __nv_bfloat16*>(dy);
  p.out = static_cast<float*>(q.splits > 1 ? work : out);
  p.n = n; p.d = d; p.h = h; p.w = wl; p.ci = ci; p.co = co;
  p.kd = kd; p.kh = kh; p.kw = kw;
  p.tw = q.tw; p.rows = q.rows; p.segs_per_row = q.segs;
  p.chunks_per_plane = q.chunks_per_plane;
  p.itiles = (ci + q.bi - 1) / q.bi;
  p.otiles = (co + q.bo - 1) / q.bo;
  p.dxgroups = kw / q.kwb;
  p.splits = q.splits;
  p.chunks_per_split = (int)((q.chunks + q.splits - 1) / q.splits);
  p.pitch = q.pitch; p.slab_cap = q.slab_cap; p.a_k_stride = q.a_k_stride;
  p.stages = q.stages;
  const long long blocks = q.base * q.splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* func = kernel_of(q);
  if (func == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(func, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q.smem);
  if (err != cudaSuccess) return (int)err;
  if (q.instance == 2) {
    CUtensorMap tmx, tmy;
    if (!encode_chunked_map(&tmx, x, n, d, h, wl, ci, q.pitch, q.rows, q.wgs * 8) ||
        !encode_chunked_map(&tmy, dy, n, d, h, wl, co, q.tw, q.rows, q.bo / 8)) {
      return (int)cudaErrorInvalidValue;
    }
    pick_wgmma(q)<<<(unsigned)blocks, q.threads, q.smem, s>>>(p, tmx, tmy);
  } else {
    pick(q)<<<(unsigned)blocks, q.threads, q.smem, s>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || q.splits == 1) return (int)err;
  const long long total = (long long)n * kd * kh * kw * ci * co;
  long long grid = (total + 255) / 256;
  if (grid > 132 * 16) grid = 132 * 16;
  sum_partials_kernel<<<(unsigned)grid, 256, 0, s>>>(static_cast<const float*>(work),
                                                     static_cast<float*>(out), total, q.splits);
  return (int)cudaGetLastError();
}

// One k16 step of the wgmma instance (conv3d_dw_wgmma_unit_kernel) on
// `stream`: xs (8, slab_cap, 8) bf16, ys (8, 64, 8) bf16, out (5, 64, 64)
// fp32. Returns the cudaError_t of the launch.
int conv3d_dw_persample_wgmma_unit(const void* xs, const void* ys, void* out, int tw, int pitch,
                                   int slab_cap, void* stream) {
  if (tw % 8 != 0 || pitch < tw + 4 || slab_cap < (tw >= 16 ? pitch : 2 * pitch)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = round128(8 * x_chunk_bytes(slab_cap)) + 8 * Y_CHUNK + SMEM_ALIGN;
  cudaError_t err = cudaFuncSetAttribute(conv3d_dw_wgmma_unit_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  conv3d_dw_wgmma_unit_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xs), static_cast<const __nv_bfloat16*>(ys),
      static_cast<float*>(out), tw, pitch, slab_cap);
  return (int)cudaGetLastError();
}

const char* conv3d_dw_persample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
