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
// bytes bound it. The design:
//
//   * a block computes a tile of dW for one sample, one (dz, dy) tap pair and
//     KWB consecutive taps along W (all kW of them when kW is 1, 3 or 5), so
//     the kW taps share one shared-memory slab: x is read kD*kH times, not
//     125 times (conv3d_same.cu's slab trick, seen from the weight side);
//   * positions are walked in chunks of 64 (128 on a wide tile with 2
//     position groups): one row segment, or several whole rows when W is
//     smaller than the chunk. Per chunk, cp.async copies the dy tile and the
//     x slab (the chunk's rows shifted by (dz, dy), widened by the column
//     halo) to shared memory. Halos and tails are zero-filled loads; depth
//     taps outside the volume skip the chunk;
//   * bf16 mma.sync.m16n8k16, fp32 accumulators: A = x^T from the slab with
//     ldmatrix.trans at the tap's shifted positions, B = dy with
//     ldmatrix.trans;
//   * two instances, chosen by the packed channel counts (Ci, Co):
//     - wide (Ci and Co >= 32, one of them >= 64): each of the block's 4
//       warps owns a 32 (i) x 32 (o) warp tile for all KWB taps. Per
//       16-position k-step it runs 2 ldmatrix.x4 for dy and 2 per tap for
//       x against 8 mma per tap: 3 mma per ldmatrix at KWB = 3, where 16 x 16
//       warp tiles give 1.5, so shared-memory loads no longer bound the mma
//       rate. The block tile is 64 x 64 (2 x 2 warps) where Ci and Co are
//       both >= 64, which halves the L2 re-reads of x and dy against 32-wide
//       tiles; else 64 x 32 or 32 x 64, with 2 warps on the tile and 2
//       position groups that take disjoint k-steps of 128-position chunks
//       and add their sums through shared memory at the end, in a fixed
//       order. Chunks come through a 3-stage cp.async ring with one
//       __syncthreads per chunk. The 160 accumulators a thread at KWB = 5
//       leave 2 blocks an SM;
//     - narrow (32 x 32 block tiles, 16 x 16 warp tiles, 2 stages, 5 blocks
//       an SM): the 1-channel input conv packed to 8 channels, conv_out's
//       Co = 1 padded to 8, the s2d entry conv's 12 packed lanes padded to
//       16, and Ci = Co = 32 (native level 1), where 4 position groups on a
//       wide 32 x 32 tile ran slower than this instance's occupancy;
//   * split over positions: where (sample, tap, tile) blocks alone would not
//     fill the card (level 1 has 200 of them), each block takes a contiguous
//     range of the sample's chunks and writes its fp32 partial sums to a
//     workspace; a second kernel adds the partials in a fixed order. No
//     atomics, so dW is bit-reproducible. The wide instance does not split
//     where the fp32 dW outweighs x and dy (the deep levels): there the
//     split-sum pass would only add bytes.
//
// Ci and Co must be multiples of 8 (16-byte copies); the caller packs or pads
// the narrow 1-channel cases. wgmma, TMA and a persistent schedule are left
// for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TP = 64;       // positions per chunk (the GEMM's K per stage)
constexpr int THREADS = 128; // 4 warps in either instance
// narrow instance: 2 warps along i x 2 along o, 16 x 16 each
constexpr int BI = 32;       // input channels per block (dW rows)
constexpr int BO = 32;       // output channels per block (dW columns)
constexpr int A_STRIDE = BI + 8;  // bf16 per slab position (pad: no bank conflicts)
constexpr int B_STRIDE = BO + 8;  // bf16 per dy position
// wide instance
constexpr int WSTAGES = 3;          // cp.async ring depth
constexpr int WIDE_BLOCKS = 132 * 8;  // split target: ~4 waves of 2 blocks per SM
constexpr int SMEM_MAX = 232448;      // dynamic shared memory a block may have

struct DwParams {
  const __nv_bfloat16* x;   // (N, D, H, W, ci)
  const __nv_bfloat16* dy;  // (N, D, H, W, co)
  float* out;               // (splits, N, T, ci, co); splits == 1: the result
  int n, d, h, w, ci, co;
  int kd, kh, kw;
  // a chunk holds P positions (TP, or TP per position group on a wide tile)
  int tw;                // columns per chunk (P when W >= P, else W)
  int rows;              // rows per chunk (1 when W >= P, else P / W)
  int segs_per_row;      // ceil(W / P) when W >= P, else 1
  int chunks_per_plane;  // ceil(H / rows) * segs_per_row
  int itiles, otiles, dxgroups, splits, chunks_per_split;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// Wide instance: a (32*WI) x (32*WO) tile of dW (64 x 64, 64 x 32 or 32 x
// 64) for one sample, one (dz, dy) tap pair and KWB taps along W. Warp w
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
  bool wide;
  int kwb;              // taps along W per block: 1, 3 or 5
  int wi, wo;           // wide: warps along i and o on the block tile
  int bi, bo, groups;   // block tile and position groups
  int tp;               // positions per chunk
  int tw, rows, segs, chunks_per_plane;
  long long chunks, base;  // chunks per sample; blocks without a split
  int splits;
  size_t smem;
};

Plan make_plan(int n, int d, int h, int wl, int ci, int co, int kd, int kh, int kw,
               bool wide = true) {
  Plan q;
  q.kwb = (kw == 1 || kw == 3 || kw == 5) ? kw : 1;
  // 32 x 32 tiles (native level 1) stay narrow: with 4 position groups
  // their 2 blocks an SM ran slower than the narrow instance's 5
  q.wide = wide && ci >= 32 && co >= 32 && (ci >= 64 || co >= 64);
  q.wi = (q.wide && ci >= 64) ? 2 : 1;
  q.wo = (q.wide && co >= 64) ? 2 : 1;
  q.bi = q.wide ? 32 * q.wi : BI;
  q.bo = q.wide ? 32 * q.wo : BO;
  q.groups = q.wide ? 4 / (q.wi * q.wo) : 1;
  q.tp = TP * q.groups;
  if (wl >= q.tp) {
    q.tw = q.tp; q.rows = 1; q.segs = (wl + q.tp - 1) / q.tp;
  } else {
    q.tw = wl; q.rows = q.tp / wl; q.segs = 1;
  }
  q.chunks_per_plane = ((h + q.rows - 1) / q.rows) * q.segs;
  q.chunks = (long long)d * q.chunks_per_plane;
  q.base = (long long)n * kd * kh * (kw / q.kwb) * ((ci + q.bi - 1) / q.bi) *
           ((co + q.bo - 1) / q.bo);
  long long splits;
  if (!q.wide) {
    splits = (2048 + q.base - 1) / q.base;  // ~2048 blocks (132 SMs, several each)
  } else if ((long long)kd * kh * kw * ci * co * 4 > (long long)d * h * wl * (ci + co) * 2) {
    splits = 1;  // the fp32 dW outweighs x and dy: a split-sum pass only adds bytes
  } else {
    splits = (WIDE_BLOCKS + q.base - 1) / q.base;
  }
  if (splits > q.chunks) splits = q.chunks;
  if (splits < 1) splits = 1;
  const long long per = (q.chunks + splits - 1) / splits;
  q.splits = (int)((q.chunks + per - 1) / per);
  const size_t slab_cap = (size_t)q.rows * (q.tw + q.kwb - 1);
  if (q.wide) {
    const size_t ring = WSTAGES * (slab_cap * (q.bi + 8) + (size_t)q.tp * (q.bo + 8)) * 2;
    const size_t red = (size_t)(q.groups - 1) * (q.wi * q.wo) * q.kwb * 32 * 32 * 4;
    q.smem = ring > red ? ring : red;
    // a very narrow W makes the slab long: such a shape takes the narrow instance
    if (q.smem > SMEM_MAX) return make_plan(n, d, h, wl, ci, co, kd, kh, kw, false);
  } else {
    q.smem = 2 * (slab_cap * A_STRIDE + (size_t)TP * B_STRIDE) * 2;
  }
  return q;
}

using Kernel = void (*)(DwParams);

template <int KWB>
Kernel wide_kernel(const Plan& q) {
  if (q.wi == 2) return q.wo == 2 ? &conv3d_dw_kernel_wide<KWB, 2, 2> : &conv3d_dw_kernel_wide<KWB, 2, 1>;
  return &conv3d_dw_kernel_wide<KWB, 1, 2>;
}

Kernel pick(const Plan& q) {
  switch (q.kwb) {
    case 1: return q.wide ? wide_kernel<1>(q) : &conv3d_dw_kernel<1>;
    case 3: return q.wide ? wide_kernel<3>(q) : &conv3d_dw_kernel<3>;
    default: return q.wide ? wide_kernel<5>(q) : &conv3d_dw_kernel<5>;
  }
}

}  // namespace

extern "C" {

// Number of position splits the kernel will use for these shapes: the
// caller allocates a (splits, n, kd, kh, kw, ci, co) fp32 workspace when it
// is above 1.
int conv3d_dw_persample_splits(int n, int d, int h, int wl, int ci, int co, int kd, int kh,
                               int kw) {
  return make_plan(n, d, h, wl, ci, co, kd, kh, kw).splits;
}

// The launch these shapes get, into out[0..8]: wide (1) or narrow (0), taps
// along W per block, block tile rows and columns, position groups, splits,
// registers a thread, local (spill) bytes a thread, dynamic shared bytes.
// Returns the cudaError_t of reading the kernel's attributes.
int conv3d_dw_persample_plan(int n, int d, int h, int wl, int ci, int co, int kd, int kh,
                             int kw, int* out) {
  const Plan q = make_plan(n, d, h, wl, ci, co, kd, kh, kw);
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, pick(q));
  out[0] = q.wide; out[1] = q.kwb; out[2] = q.bi; out[3] = q.bo; out[4] = q.groups;
  out[5] = q.splits;
  out[6] = err == cudaSuccess ? a.numRegs : -1;
  out[7] = err == cudaSuccess ? (int)a.localSizeBytes : -1;
  out[8] = (int)q.smem;
  return (int)err;
}

// Launches dW on `stream`; returns the cudaError_t (0 on success). x: (n, d,
// h, wl, ci) bf16; dy: (n, d, h, wl, co) bf16; out: (n, kd, kh, kw, ci, co)
// fp32; work: (splits, n, kd, kh, kw, ci, co) fp32 when
// conv3d_dw_persample_splits(...) > 1, else unused. Does not synchronize and
// allocates nothing.
int conv3d_dw_persample_bf16(const void* x, const void* dy, void* out, void* work, int n, int d,
                             int h, int wl, int ci, int co, int kd, int kh, int kw,
                             void* stream) {
  if (kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0 || n <= 0 || d <= 0 || h <= 0 || wl <= 0 ||
      ci <= 0 || ci % 8 != 0 || co <= 0 || co % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan q = make_plan(n, d, h, wl, ci, co, kd, kh, kw);
  if (q.splits > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
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
  const long long blocks = q.base * q.splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Kernel kern = pick(q);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q.smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)blocks, THREADS, q.smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || q.splits == 1) return (int)err;
  const long long total = (long long)n * kd * kh * kw * ci * co;
  long long grid = (total + 255) / 256;
  if (grid > 132 * 16) grid = 132 * 16;
  sum_partials_kernel<<<(unsigned)grid, 256, 0, s>>>(static_cast<const float*>(work),
                                                     static_cast<float*>(out), total, q.splits);
  return (int)cudaGetLastError();
}

const char* conv3d_dw_persample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
