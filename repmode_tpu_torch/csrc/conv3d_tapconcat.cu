// Per-sample 'same' 3-D convolution of a 4-lane input as one GEMM per tile
// over the concatenated taps, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/bench_enc1c1_kernel.py: make_kernel.conv
// (body _kernel), the tap-concat conv:
//
//     y[n, p, o] = sum_k P[n, p, k] * w[n, k, o],   k = tap * 4 + lane
//
// where P[n, p, :] concatenates the 45 shifted 4-lane slices of x around
// position p (taps (dz, dy, dx) over (5, 3, 3), lexicographic, 'same' zero
// padding). This is the space-to-depth (s2d) entry conv of training,
// encoder_block1.conv1: the 1-channel volume is 4 s2d lanes, and w is the
// sample's gate-merged s2d expert bank reshaped to (180, Co). x is NDHWC bf16
// (N, D, H, W, 4), w bf16 (N, 180, wco) with wco >= Co a multiple of 8, y bf16
// (N, D, H, W, Co), products summed in fp32.
//
// What bounds it: 2*180*Co operations per position against 8 bytes read and
// 2*Co written, about 180 operations per byte, below the card's ~295: the
// kernel is bound by the bytes of its output (268 MB at batch 8 of 32x128x128
// patches, Co = 128; a plain write of them, y.zero_(), takes 0.084 ms on an
// H100 80GB HBM3 at 700 W). Two instances, picked by the plan from the
// shapes alone (ops/conv3d.py: conv3d_tapconcat_persample_plan mirrors
// plan_launch below):
//
// wgmma (Co a multiple of 32, W even and >= 8, planes of 128 positions or
// more: the s2d entry conv of the net):
//   * persistent: one block (two where shared memory allows) an SM; the
//     tiles of 128 output positions, in (sample, Co tile, depth, row,
//     column) order, are cut into one contiguous range a block, so a block
//     loads a sample's weights only when its range enters a new (sample, Co
//     tile): at most twice a block at full width;
//   * the weights stay in shared memory: one tensor copy (TMA) per 64-wide
//     swizzle atom of Co, read in place from w through a 5-D map (Co, 4
//     lanes, 3 taps dx, 15 (dz, dy) groups, samples) whose box takes 4 taps
//     along dx: the fourth lies past the extent and is filled with zeros,
//     so each (dz, dy) group is K = 16 rows, taps dx 0..3 x 4 lanes, and
//     K = 15 x 16 = 240 (a third more MMA than 180, and no patch matrix);
//   * x comes in by TMA: a tile's plain slab (5 depths x rows + 2 x tw + 4
//     columns of 8 bytes, zero past the volume) is one box of a map that
//     pairs the columns (16 bytes, the least inner extent of a box),
//     loaded two tiles ahead into a ring of two;
//   * A is a paired slab built from it by the block's threads while the
//     previous tile's wgmma runs: entry (dz, r, s) holds x at columns w0 -
//     1 + s and w0 + s of one slab row, 16 bytes (every entry a descriptor
//     reaches is written, since uninitialised shared memory may hold NaN
//     and NaN x 0 is NaN; the writes are fenced to the async proxy before
//     wgmma reads them). For output column c, K 0-7 (taps dx 0, 1) are entry c and
//     K 8-15 (dx 2, 3) entry c + 2: the K-major no-swizzle descriptor
//     starts at entry c with a leading byte offset of 32 bytes, and one
//     k16 wgmma step is one (dz, dy) group, 15 a tile, fixed at compile
//     time. The fourth tap multiplies x at column c + 2 by zero weights:
//     a non-finite x there makes y at column c NaN, where the plain version
//     stays finite;
//   * two warpgroups of one m64 tile each, m64n{32,64,128}k16 with fp32
//     accumulators: a tile is 2 rows x 64 columns (W 64..127), 1 x 128 (W
//     >= 128; 128-column rows, 2 m64 segments) or 16 rows x 8 columns (W <
//     64: 8x8 patches, a core matrix a row);
//   * the epilogue writes the tile in bf16 to one of two staging tiles in
//     shared memory, in the 128-byte swizzle (64-byte or 32-byte for Co
//     tiles of 32), and one thread stores it by TMA (boxes of 64 channels x
//     the tile, clipped past every edge of y); the store of tile t drains
//     while tile t + 1 is multiplied, and the staging tile is written again
//     only after its store has read it (cp.async.bulk.wait_group.read).
//   At the full-width shape it takes 0.133 ms against the write floor's
//   0.084 (H100 80GB HBM3, 700 W, ops/kernels/k6_variants.py); leaving out
//   any one of its phases (stores, paired-slab build, wgmma, staging
//   writes) saves 5-9 us of it, and the loop with all four left out still
//   takes 0.058 ms: what holds it is the per-tile skeleton (two block
//   barriers, the waits on the tensor copies), not one phase. Three
//   staging tiles or three plain slabs in flight measured the same.
//
// mma_sync (the rest: Co not a multiple of 32, narrow planes; the first
// design, kept as it was):
//   * a block owns one sample, a 128-wide slice of Co, and TILES_PER_BLOCK
//     consecutive tiles of BM = 128 output positions (whole rows when W < 128)
//     of that sample; the sample's (180 x 128) weight slice is copied to
//     shared memory once (rows 180..191 zero-filled, K padded to 192) and
//     stays there for all of the block's tiles;
//   * per tile, cp.async copies the halo slab, 5 x (rows+2) x (cols+2)
//     positions of 4 lanes (8 bytes each), with zero-filled copies for the
//     depth, H and W halos: no padded copy of x exists anywhere;
//   * the block builds the tile's (128 x 192) patch matrix in shared memory
//     from the slab, 8 bytes per (position, tap), then runs 12 k-steps of bf16
//     mma.sync.m16n8k16 with fp32 accumulators (8 warps, 32 x 64 each); the
//     next tile's slab is loaded while the current tile is multiplied;
//   * each output is written once, as bf16 pairs, with no atomics. Its
//     phases run one after another: at the full-width shape leaving out the
//     stores saves 0.10 of its 0.39 ms, the patch build 0.12, the MMA 0.08,
//     the per-block weight copy 0.01 (ops/kernels/k6_variants.py).

#include "hopper.cuh"

namespace {

constexpr int CI = 4;              // input lanes
constexpr int KD = 5, KH = 3, KW = 3;
constexpr int TAPS = KD * KH * KW; // 45
constexpr int K = TAPS * CI;       // 180
constexpr int KP = 192;            // K padded to a multiple of 16
constexpr int TAP_SLOTS = KP / CI; // 48 (45 taps + 3 zero slots)
constexpr int BM = 128;            // output positions per tile
constexpr int BN = 128;            // output channels per block
constexpr int THREADS = 256;       // 8 warps: 4 along M (32 rows) x 2 along N (64 cols)
constexpr int WN = BN / 2;
constexpr int NT = WN / 8;         // n8 tiles per warp
constexpr int P_STRIDE = KP + 8;   // bf16 per patch row (pad: no bank conflicts)
constexpr int W_STRIDE = BN + 8;   // bf16 per weight row
constexpr int TILES_PER_BLOCK = 4;
constexpr int SMEM_MAX = 227 * 1024;
constexpr int SMEM_TWO_BLOCKS = 113 * 1024;

// ---------------------------------------------------------------- mma.sync

struct TcParams {
  const __nv_bfloat16* x;  // (N, D, H, W, 4)
  const __nv_bfloat16* w;  // (N, 180, wco)
  __nv_bfloat16* y;        // (N, D, H, W, cout)
  int n, d, h, w_len, cout, wco;
  int tw;               // columns per tile (BM when W >= BM, else W)
  int rows_per_tile;    // 1 when W >= BM, else BM / W
  int tiles_per_row;    // ceil(W / BM) when W >= BM, else 1
  int tiles_per_plane;
  int tiles_per_sample;
  int blocks_per_sample;
  int srows, scols;     // slab rows and columns: rows_per_tile + 2, tw + 2
};

__device__ __forceinline__ void cp_async_commit_and_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

struct Tile {
  int dd, h0, w0, rows, twv;
};

__device__ __forceinline__ Tile tile_of(const TcParams& p, int tt) {
  Tile t;
  const int tp = tt % p.tiles_per_plane;
  t.dd = tt / p.tiles_per_plane;
  t.h0 = (tp / p.tiles_per_row) * p.rows_per_tile;
  t.w0 = (tp % p.tiles_per_row) * p.tw;
  t.rows = min(p.rows_per_tile, p.h - t.h0);
  t.twv = min(p.tw, p.w_len - t.w0);
  return t;
}

// The halo slab of one tile: positions (dz, r, c) of the tile's rows
// h0-1 .. h0+rows_per_tile and columns w0-1 .. w0+tw around depth dd-2 ..
// dd+2, 8 bytes each; positions outside the volume are zero-filled copies.
__device__ __forceinline__ void load_slab(const TcParams& p, int nn, const Tile& t,
                                          __nv_bfloat16* slab) {
  const int per_dz = p.srows * p.scols;
  for (int i = threadIdx.x; i < KD * per_dz; i += THREADS) {
    const int dz = i / per_dz;
    const int rc = i - dz * per_dz;
    const int r = rc / p.scols, c = rc - (rc / p.scols) * p.scols;
    const int di = t.dd + dz - KD / 2, hi = t.h0 + r - KH / 2, wi = t.w0 + c - KW / 2;
    const bool ok = di >= 0 && di < p.d && hi >= 0 && hi < p.h && wi >= 0 && wi < p.w_len;
    const __nv_bfloat16* src =
        ok ? p.x + ((((long long)nn * p.d + di) * p.h + hi) * p.w_len + wi) * CI : p.x;
    cp_async8(smem_u32(slab + i * CI), src, ok ? 8 : 0);
  }
}

__global__ void __launch_bounds__(THREADS, 2) conv3d_tapconcat_kernel(const TcParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* patch = reinterpret_cast<__nv_bfloat16*>(smem);  // BM x P_STRIDE
  __nv_bfloat16* wsm = patch + BM * P_STRIDE;                      // KP x W_STRIDE
  __nv_bfloat16* slab = wsm + KP * W_STRIDE;                       // KD*srows*scols x 4

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 3;
  const int warp_n = warp >> 2;

  const int nn = blockIdx.x / p.blocks_per_sample;
  const int first = (blockIdx.x % p.blocks_per_sample) * TILES_PER_BLOCK;
  const int last = min(first + TILES_PER_BLOCK, p.tiles_per_sample);
  const int co0 = blockIdx.y * BN;
  if (first >= last) return;

  // the sample's weight slice, resident for all of the block's tiles
  const __nv_bfloat16* wsample = p.w + (long long)nn * K * p.wco;
  for (int i = tid; i < KP * (BN / 8); i += THREADS) {
    const int row = i / (BN / 8), sg = i - (i / (BN / 8)) * (BN / 8);
    const int o = co0 + sg * 8;
    const bool ok = row < K && o < p.wco;
    const __nv_bfloat16* src = ok ? wsample + (long long)row * p.wco + o : p.w;
    cp_async16(smem_u32(wsm + row * W_STRIDE + sg * 8), src, ok ? 16 : 0);
  }
  Tile t = tile_of(p, first);
  load_slab(p, nn, t, slab);
  cp_async_commit();

  for (int tt = first; tt < last; ++tt) {
    // this tile's slab (and, the first time, the weights) has arrived, and
    // every warp is done reading the previous tile's patch matrix
    cp_async_commit_and_wait_all();
    __syncthreads();

    // patch matrix: row m = output position (r, c) of the tile, column
    // slot*4 + lane = tap slot's lane; rows past the tile and slots 45..47 are 0
    for (int i = tid; i < BM * TAP_SLOTS; i += THREADS) {
      const int m = i / TAP_SLOTS, tap = i - (i / TAP_SLOTS) * TAP_SLOTS;
      const int r = m / t.twv, c = m - (m / t.twv) * t.twv;
      uint2 v = make_uint2(0u, 0u);
      if (r < t.rows && tap < TAPS) {
        const int dz = tap / (KH * KW), dy = (tap / KW) % KH, dx = tap % KW;
        v = *reinterpret_cast<const uint2*>(
            slab + ((dz * p.srows + r + dy) * p.scols + c + dx) * CI);
      }
      *reinterpret_cast<uint2*>(patch + m * P_STRIDE + tap * CI) = v;
    }
    __syncthreads();

    // the next tile's slab streams in while this tile is multiplied
    const Tile cur = t;
    if (tt + 1 < last) {
      t = tile_of(p, tt + 1);
      load_slab(p, nn, t, slab);
    }
    cp_async_commit();

    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.0f;

    const uint32_t p_addr = smem_u32(patch);
    const uint32_t w_addr = smem_u32(wsm);
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = warp_m * 32 + mt * 16 + (lane & 15);
        ldmatrix_x4(p_addr + (row * P_STRIDE + kk * 16 + (lane >> 4) * 8) * 2, a[mt]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b[2];
        const int off = (kk * 16 + (lane & 15)) * W_STRIDE + warp_n * WN + j * 8;
        ldmatrix_x2_trans(w_addr + off * 2, b);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][j], a[mt], b);
      }
    }

    // epilogue: round to bf16 and store, two channels per store
    const bool pairs = (p.cout & 1) == 0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = warp_m * 32 + mt * 16 + (lane >> 2) + half * 8;
        const int r = m / cur.twv, c = m - (m / cur.twv) * cur.twv;
        if (r >= cur.rows) continue;
        __nv_bfloat16* out = p.y + ((((long long)nn * p.d + cur.dd) * p.h + cur.h0 + r) *
                                        p.w_len + cur.w0 + c) * p.cout;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int co = co0 + warp_n * WN + j * 8 + (lane & 3) * 2;
          const float v0 = acc[mt][j][half * 2], v1 = acc[mt][j][half * 2 + 1];
          if (pairs && co + 1 < p.cout) {
            *reinterpret_cast<__nv_bfloat162*>(out + co) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (co < p.cout) out[co] = __float2bfloat16_rn(v0);
            if (co + 1 < p.cout) out[co + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}


// ---------------------------------------------------------------- warpgroup MMA

constexpr int GROUPS = KD * KH;  // (dz, dy) groups: one k16 step each
constexpr int KG = 16;           // K a group: taps dx 0..3 (3: zero weights) x 4 lanes
constexpr int WG_THREADS = 256;  // two warpgroups, one m64 tile each
constexpr int WG_BM = 128;       // output positions a tile

struct TcwParams {
  int d;                   // depth
  int co_tiles;            // ceil(Co / BN)
  int tw, rows;            // a tile: rows x tw positions (2 x 64, 1 x 128 or 16 x 8)
  int tiles_per_row, tiles_per_col;  // tiles along W and along H of a plane
  int items;               // tiles of every sample and Co tile
  int p2;                  // paired-slab entries a row: tw + 2
  int srows;               // slab rows: rows + 2
  int s2_bytes;            // one paired slab: 5 x srows x p2 entries of 16 bytes, 128-byte rounded
  int xrow;                // plain-slab positions a row: tw + 4 (columns w0 - 2 .. w0 + tw + 1)
  int x_bytes;             // one plain slab: 5 x srows x xrow positions of 8 bytes, 128-byte rounded
};

// The shared-memory layout of a Co tile of BN_ channels: ATOMS swizzle atoms
// of BA channels (RB bytes a row); the weights are 240 K rows an atom, a
// staging tile 128 positions an atom.
template <int BN_>
struct TcwLayout {
  static constexpr int BA = BN_ < 64 ? BN_ : 64;
  static constexpr int RB = BA * 2;
  static constexpr int ATOMS = BN_ / BA;
  static constexpr uint64_t SWIZZLE = RB == 128 ? 1 : (RB == 64 ? 2 : 3);
  static constexpr uint32_t W_ATOM = GROUPS * KG * RB;
  static constexpr uint32_t Y_ATOM = WG_BM * RB;
  static constexpr uint32_t W_BYTES = ATOMS * W_ATOM;
  static constexpr uint32_t Y_BYTES = ATOMS * Y_ATOM;
};

// A tile's place in the block's walk: (sample, Co tile) key, depth row, tile
// row and tile column; advanced one tile at a time, without divisions.
struct TcwCursor {
  int key, dd, tr, tc;
  __device__ __forceinline__ void advance(const TcwParams& p) {
    if (++tc < p.tiles_per_row) return;
    tc = 0;
    if (++tr < p.tiles_per_col) return;
    tr = 0;
    if (++dd < p.d) return;
    dd = 0;
    ++key;
  }
};

__device__ __forceinline__ TcwCursor tcw_cursor(const TcwParams& p, int it) {
  const int per_plane = p.tiles_per_col * p.tiles_per_row;
  const int per_key = p.d * per_plane;
  TcwCursor c;
  c.key = it / per_key;
  int rest = it - c.key * per_key;
  c.dd = rest / per_plane;
  rest -= c.dd * per_plane;
  c.tr = rest / p.tiles_per_row;
  c.tc = rest - c.tr * p.tiles_per_row;
  return c;
}

// One thread loads the plain slab of a tile by TMA onto `bar`: one box of
// 5 depths x srows rows x xrow positions of x (4 lanes, 8 bytes each) from
// column w0 - 2 (even: the map pairs the columns, 16 bytes a pair), zero
// past the volume; it lands [dz][row][position].
__device__ __forceinline__ void load_slab_tma(const TcwParams& p, const CUtensorMap* tmx,
                                              const TcwCursor& c, uint32_t dst, uint32_t bar) {
  mbar_expect_tx(bar, (uint32_t)(KD * p.srows * p.xrow * 8));
  tma_load_5d(dst, tmx, bar, 0, (c.tc * p.tw - 2) / 2, c.tr * p.rows - KH / 2, c.dd - KD / 2,
              c.key / p.co_tiles);
}

// Where a thread's entries of the paired slab lie: the first, entry tid
// (slab row `band`, entry s), and the step to the next, WG_THREADS entries
// on (the same for every tile).
struct PairWalk {
  int band, s, dband, ds;
};

__device__ __forceinline__ PairWalk pair_walk(const TcwParams& p) {
  PairWalk w;
  w.band = threadIdx.x / p.p2;
  w.s = threadIdx.x - w.band * p.p2;
  w.dband = WG_THREADS / p.p2;
  w.ds = WG_THREADS - w.dband * p.p2;
  return w;
}

// The paired slab from the plain one: entry (dz, r, s) = x at plain-slab
// positions s + 1 and s + 2 of its row, i.e. columns w0 - 1 + s and w0 + s,
// 16 bytes; every entry is written.
__device__ __forceinline__ void build_pairs(const TcwParams& p, PairWalk w, const uint2* xs,
                                            uint4* s2) {
  for (int e = threadIdx.x; e < KD * p.srows * p.p2; e += WG_THREADS) {
    const uint2* src = xs + w.band * p.xrow + w.s + 1;
    const uint2 lo = src[0], hi = src[1];
    s2[e] = make_uint4(lo.x, lo.y, hi.x, hi.y);
    w.s += w.ds;
    w.band += w.dband;
    if (w.s >= p.p2) {
      w.s -= p.p2;
      ++w.band;
    }
  }
}

// acc += the k16 step of (dz, dy) group g. A: the paired slab from `a`, the
// entry of the m64 tile's first position in slab row (dz, r0 + dy); its K
// 0-7 (taps dx 0, 1) at each position's entry, K 8-15 (dx 2, 3) two entries
// (32 bytes: the leading byte offset) later; 8-position core matrices `sbo`
// bytes apart. B: the group's 16 weight rows, MN-major, read with the
// transpose-B immediate, swizzle atoms W_ATOM bytes apart.
template <int BN_>
__device__ __forceinline__ void tcw_group_mma(float (&acc)[BN_ / 2], uint32_t a, uint32_t sbo,
                                              uint32_t w_base, int g) {
  using L = TcwLayout<BN_>;
  wgmma_ss<1, 0>(acc, smem_desc_a(a, 32, sbo),
                 smem_desc_mn(w_base + g * KG * L::RB, L::W_ATOM, 8 * L::RB, L::SWIZZLE));
}

// The slab offset of warpgroup wg's m64 tile (positions 64 wg .. 64 wg + 63
// of the tile, row-major): one row segment where tw >= 64 (its core
// matrices 128 bytes apart), else 8 rows of 8 (a slab row apart).
__device__ __forceinline__ void tcw_a_offsets(int tw, int p2, int wg, uint32_t& a_off,
                                              uint32_t& sbo) {
  const int r0 = wg * 64 / tw;
  a_off = (uint32_t)(r0 * p2 + wg * 64 - r0 * tw) * 16;
  sbo = tw >= 64 ? 128u : (uint32_t)p2 * 16;
}

// Accumulator 4j + 2h + e of lane l in warp wl of a warpgroup: row 16 wl +
// l/4 + 8h of its m64 tile, column 8j + 2(l%4) + e (the mma.m16n8k16 C
// fragment, once per 8 columns).
__device__ __forceinline__ int acc_row(int wl, int lane, int half) {
  return wl * 16 + (lane >> 2) + half * 8;
}

template <int BN_>
__global__ void __launch_bounds__(WG_THREADS, BN_ == 128 ? 1 : 2)
conv3d_tapconcat_kernel_wgmma(const TcwParams p, const __grid_constant__ CUtensorMap tmx,
                              const __grid_constant__ CUtensorMap tmw,
                              const __grid_constant__ CUtensorMap tmy) {
  using L = TcwLayout<BN_>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar_mem[3];  // the weights, plain slabs 0 and 1
  // weights, two staging tiles, two paired slabs, two plain slabs; the
  // first two at the swizzle's 1024-byte period (the swizzle is a function
  // of the address)
  const uint32_t raw = smem_u32(smem);
  const uint32_t w_base = (raw + SWIZZLE_ALIGN - 1) & ~(uint32_t)(SWIZZLE_ALIGN - 1);
  const uint32_t y_base = w_base + L::W_BYTES;
  const uint32_t s_base = y_base + 2 * L::Y_BYTES;
  const uint32_t x_base = s_base + 2 * p.s2_bytes;
  const uint32_t x_stage = (uint32_t)p.x_bytes;
  unsigned char* const gen = smem - raw;  // generic pointer = gen + shared address
  const uint32_t wbar = smem_u32(&bar_mem[0]), xbar = smem_u32(&bar_mem[1]);

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, wl = (tid >> 5) & 3;
  const int first = (int)((long long)blockIdx.x * p.items / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * p.items / gridDim.x);
  uint32_t a_off, sbo;
  tcw_a_offsets(p.tw, p.p2, wg, a_off, sbo);
  const uint32_t row_bytes = (uint32_t)p.p2 * 16;
  const PairWalk walk = pair_walk(p);

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(wbar + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  TcwCursor cur = tcw_cursor(p, first);
  TcwCursor ahead = cur;  // thread 0: the next tile whose plain slab to load
  if (tid == 0) {
    for (int k = 0; k < 2 && first + k < last; ++k) {
      load_slab_tma(p, &tmx, ahead, x_base + k * x_stage, xbar + 8 * k);
      ahead.advance(p);
    }
  }
  uint32_t xpar = 0;  // bit b: the parity of plain slab b's next fill
  if (first < last) {
    mbar_wait(xbar, 0);
    xpar ^= 1;
    build_pairs(p, walk, reinterpret_cast<const uint2*>(gen + x_base),
                reinterpret_cast<uint4*>(gen + s_base));
  }
  fence_proxy_async();

  int wkey = -1;  // the (sample, Co tile) whose weights are resident
  uint32_t wphase = 0;
  for (int it = first, buf = 0; it < last; ++it, buf ^= 1) {
    const int nn = cur.key / p.co_tiles, ct = cur.key - nn * p.co_tiles;
    const bool new_w = cur.key != wkey;  // uniform over the block
    // every thread's paired slab of this tile is written and fenced, the
    // plain slab it came from is free, every warpgroup retired the previous
    // tile's wgmma, and the store that last read staging tile `buf` (tile
    // it - 2's) has read it
    if (tid == 0) bulk_wait_read<1>();
    __syncthreads();
    if (tid == 0) {
      if (it + 2 < last) {
        load_slab_tma(p, &tmx, ahead, x_base + buf * x_stage, xbar + 8 * buf);
        ahead.advance(p);
      }
      if (new_w) {
        mbar_expect_tx(wbar, L::W_BYTES);
#pragma unroll
        for (int a = 0; a < L::ATOMS; ++a) {
          tma_load_5d(w_base + a * L::W_ATOM, &tmw, wbar, ct * BN_ + a * L::BA, 0, 0, 0, nn);
        }
      }
    }
    if (new_w) {
      mbar_wait(wbar, wphase);
      wphase ^= 1;
      wkey = cur.key;
    }

    float acc[BN_ / 2];
#pragma unroll
    for (int j = 0; j < BN_ / 2; ++j) acc[j] = 0.0f;
    const uint32_t a = s_base + buf * p.s2_bytes + a_off;
    wgmma_fence();
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      tcw_group_mma<BN_>(acc, a + (uint32_t)((g / KH) * p.srows + g % KH) * row_bytes, sbo,
                         w_base, g);
    }
    wgmma_commit();
    // the next tile's paired slab is built while the MMA runs (its buffer
    // was last read by the previous tile's wgmma, retired)
    if (it + 1 < last) {
      const int nb = buf ^ 1;
      mbar_wait(xbar + 8 * nb, (xpar >> nb) & 1);
      xpar ^= 1u << nb;
      build_pairs(p, walk, reinterpret_cast<const uint2*>(gen + x_base + nb * x_stage),
                  reinterpret_cast<uint4*>(gen + s_base + nb * p.s2_bytes));
      fence_proxy_async();
    }
    wgmma_wait<0>();
    fence_accumulators(acc);

    // ---- epilogue: bf16 pairs into the staging tile, swizzled as the
    // store's map reads it (16-byte chunk c of position row q at c ^ (q's
    // bits above the swizzle row)), then one thread stores it by TMA ----
    unsigned char* const yt = gen + y_base + buf * L::Y_BYTES;
#pragma unroll
    for (int j = 0; j < BN_ / 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t pos = wg * 64 + acc_row(wl, lane, half);
        const uint32_t off = pos * L::RB + (j * 8 % L::BA) * 2;
        const uint32_t swz = off ^ (((off >> 7) & (L::RB / 16 - 1)) << 4);
        *reinterpret_cast<__nv_bfloat162*>(yt + (j * 8 / L::BA) * L::Y_ATOM + swz +
                                           (lane & 3) * 4) =
            __floats2bfloat162_rn(acc[j * 4 + half * 2], acc[j * 4 + half * 2 + 1]);
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int a = 0; a < L::ATOMS; ++a) {
        tma_store_5d(&tmy, y_base + buf * L::Y_BYTES + a * L::Y_ATOM, ct * BN_ + a * L::BA,
                     cur.tc * p.tw, cur.tr * p.rows, cur.dd, nn);
      }
      bulk_commit();
    }
    cur.advance(p);
  }
  if (tid == 0) bulk_wait<0>();  // the stores have left shared memory before the block ends
}

// One k16 step of each group (dz 0, dy 0..2) through the wgmma instance's
// own descriptors and weight map (BN 128), for the card tests: out[dy] =
// the 128 x 128 fp32 product of the tile's A, from s2 (one depth plane of a
// paired slab, (128 / tw + 2) rows x (tw + 2) entries of 8 bf16), and the
// group's 16 weight rows (sample 0 of the map, tap dx 3 zero). tw 64 (2 rows
// of 64) or 8 (16 rows of 8).
__global__ void __launch_bounds__(WG_THREADS, 1)
conv3d_tapconcat_wgmma_unit_kernel(const uint4* s2, float* out, int tw,
                                   const __grid_constant__ CUtensorMap tmw) {
  using L = TcwLayout<128>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t wbar_mem;
  const uint32_t raw = smem_u32(smem);
  const uint32_t w_base = (raw + SWIZZLE_ALIGN - 1) & ~(uint32_t)(SWIZZLE_ALIGN - 1);
  const uint32_t s_base = w_base + L::W_BYTES;
  uint4* const s_ptr = reinterpret_cast<uint4*>(smem + (s_base - raw));
  const uint32_t wbar = smem_u32(&wbar_mem);
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, wl = (tid >> 5) & 3;
  const int p2 = tw + 2, entries = (WG_BM / tw + 2) * p2;

  if (tid == 0) {
    mbar_init(wbar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(wbar, L::W_BYTES);
    for (int a = 0; a < L::ATOMS; ++a) {
      tma_load_5d(w_base + a * L::W_ATOM, &tmw, wbar, a * L::BA, 0, 0, 0, 0);
    }
  }
  for (int i = tid; i < entries; i += WG_THREADS) s_ptr[i] = s2[i];
  fence_proxy_async();
  __syncthreads();
  mbar_wait(wbar, 0);

  uint32_t a_off, sbo;
  tcw_a_offsets(tw, p2, wg, a_off, sbo);
#pragma unroll
  for (int dy = 0; dy < KH; ++dy) {
    float acc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
    wgmma_fence();
    tcw_group_mma<128>(acc, s_base + a_off + dy * p2 * 16, sbo, w_base, dy);
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulators(acc);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pos = wg * 64 + acc_row(wl, lane, half), o = j * 8 + (lane & 3) * 2;
        out[(dy * WG_BM + pos) * 128 + o] = acc[j * 4 + half * 2];
        out[(dy * WG_BM + pos) * 128 + o + 1] = acc[j * 4 + half * 2 + 1];
      }
  }
}

// ---------------------------------------------------------------- host

// w (samples, 180, wco) read in place as (Co, 4 lanes, 3 taps dx, 15 (dz,
// dy) groups, samples) over its true extents, in boxes of `inner` Co x 4
// lanes x 4 taps x 15 groups x 1 written in the (inner * 2)-byte swizzle:
// row 16 g + 4 dx + lane of the box is weight row 12 g + 4 dx + lane, and
// the box's fourth tap, past dx's extent of 3, is filled with zeros.
bool encode_tapconcat_weight_map(CUtensorMap* map, const void* w, int samples, int co, int wco,
                                 int inner) {
  const PFN_cuTensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t e = 2;  // bytes a bf16
  const cuuint64_t wd[5] = {(cuuint64_t)co, CI, KW, (cuuint64_t)GROUPS, (cuuint64_t)samples};
  const cuuint64_t ws[4] = {(cuuint64_t)wco * e, (cuuint64_t)wco * CI * e,
                            (cuuint64_t)wco * CI * KW * e, (cuuint64_t)wco * K * e};
  const cuuint32_t wb[5] = {(cuuint32_t)inner, CI, 4, (cuuint32_t)GROUPS, 1};
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(w), wd, ws, wb, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(inner * 2),
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x (n, d, h, wl, 4) as (8, W / 2, H, D, N): two 4-lane positions a
// 16-byte pair (wl even), in boxes of one pair x xrow / 2 pairs x srows rows
// x 5 depths x 1, zero past every edge: one box a tile's plain slab.
bool encode_tapconcat_input_map(CUtensorMap* map, const void* x, int n, int d, int h, int wl,
                                int xrow, int srows) {
  const PFN_cuTensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t e = 2;  // bytes a bf16
  const cuuint64_t xd[5] = {2 * CI, (cuuint64_t)wl / 2, (cuuint64_t)h, (cuuint64_t)d,
                            (cuuint64_t)n};
  const cuuint64_t xs[4] = {xd[0] * e, xd[0] * xd[1] * e, xd[0] * xd[1] * xd[2] * e,
                            xd[0] * xd[1] * xd[2] * xd[3] * e};
  const cuuint32_t xb[5] = {2 * CI, (cuuint32_t)xrow / 2, (cuuint32_t)srows, KD, 1};
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), xd, xs, xb, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

using Kernel = void (*)(TcParams);
using WideKernel = void (*)(TcwParams, CUtensorMap, CUtensorMap, CUtensorMap);

// The planned launch: the mma.sync or the wgmma kernel (neither for a plan
// this source has no instance for), its Co tile, threads, dynamic shared
// bytes and grid.
struct Launch {
  Kernel kern;
  WideKernel wide;
  int bn;
  int threads;
  size_t smem;
  dim3 grid;
  bool ok() const { return kern != nullptr || wide != nullptr; }
  const void* func() const {
    return kern != nullptr ? reinterpret_cast<const void*>(kern)
                           : reinterpret_cast<const void*>(wide);
  }
};

// instance 0: mma.sync (BM 128, BN 128, TILES_PER_BLOCK tiles a block,
// the Co tile on grid y). instance 1: wgmma (Co a multiple of 32, W >= 8,
// H * W >= 128; BN 128, 64 or 32, the narrowest that covers Co up to 128;
// min(SMs x blocks an SM, tiles) persistent blocks, two an SM where the
// shared memory of one is at most 113 KB).
Launch plan_launch(TcParams& q, TcwParams& p, int n, int d, int h, int wl, int cout, int wco,
                   int instance, int num_sms) {
  Launch l{nullptr, nullptr, 0, 0, 0, dim3(1)};
  if (n <= 0 || d <= 0 || h <= 0 || wl <= 0 || cout <= 0 || wco < cout || wco % 8 != 0) {
    return l;
  }
  if (instance == 0) {
    q.n = n; q.d = d; q.h = h; q.w_len = wl; q.cout = cout; q.wco = wco;
    if (wl >= BM) {
      q.tw = BM;
      q.rows_per_tile = 1;
      q.tiles_per_row = (wl + BM - 1) / BM;
      q.tiles_per_plane = h * q.tiles_per_row;
    } else {
      q.tw = wl;
      q.rows_per_tile = BM / wl;
      q.tiles_per_row = 1;
      q.tiles_per_plane = (h + q.rows_per_tile - 1) / q.rows_per_tile;
    }
    q.tiles_per_sample = d * q.tiles_per_plane;
    q.blocks_per_sample = (q.tiles_per_sample + TILES_PER_BLOCK - 1) / TILES_PER_BLOCK;
    q.srows = q.rows_per_tile + KH - 1;
    q.scols = q.tw + KW - 1;
    l.kern = &conv3d_tapconcat_kernel;
    l.bn = BN;
    l.threads = THREADS;
    l.smem = (size_t)BM * P_STRIDE * 2 + (size_t)KP * W_STRIDE * 2 +
             (size_t)KD * q.srows * q.scols * CI * 2;
    l.grid = dim3((unsigned)((long long)n * q.blocks_per_sample), (unsigned)((cout + BN - 1) / BN));
  } else if (instance == 1) {
    if (cout % 32 != 0 || wl < 8 || wl % 2 != 0 || (long long)h * wl < WG_BM || num_sms <= 0) {
      return l;
    }
    p.d = d;
    p.tw = wl >= 128 ? 128 : (wl >= 64 ? 64 : 8);
    p.rows = WG_BM / p.tw;
    l.bn = cout >= 128 ? 128 : (cout >= 64 ? 64 : 32);
    p.co_tiles = (cout + l.bn - 1) / l.bn;
    p.tiles_per_row = (wl + p.tw - 1) / p.tw;
    p.tiles_per_col = (h + p.rows - 1) / p.rows;
    const long long items = (long long)n * p.co_tiles * d * p.tiles_per_col * p.tiles_per_row;
    if (items >= (1ll << 31)) return l;
    p.items = (int)items;
    p.p2 = p.tw + 2;
    p.srows = p.rows + KH - 1;
    p.s2_bytes = (KD * p.srows * p.p2 * 16 + 127) / 128 * 128;
    p.xrow = p.tw + 4;
    p.x_bytes = (KD * p.srows * p.xrow * 8 + 127) / 128 * 128;
    l.wide = l.bn == 128 ? &conv3d_tapconcat_kernel_wgmma<128>
             : l.bn == 64 ? &conv3d_tapconcat_kernel_wgmma<64>
                          : &conv3d_tapconcat_kernel_wgmma<32>;
    l.threads = WG_THREADS;
    l.smem = SWIZZLE_ALIGN + (size_t)GROUPS * KG * l.bn * 2 + 2 * (size_t)WG_BM * l.bn * 2 +
             2 * (size_t)p.s2_bytes + 2 * (size_t)p.x_bytes;
    const long long per_sm = l.smem <= SMEM_TWO_BLOCKS ? 2 : 1;
    l.grid = dim3((unsigned)(items < num_sms * per_sm ? items : num_sms * per_sm));
  } else {
    return l;
  }
  if (l.smem > SMEM_MAX) l.kern = nullptr, l.wide = nullptr;
  return l;
}

}  // namespace

extern "C" {

// What a plan launches, into out[0..4]: dynamic shared bytes, grid x, grid
// y, registers a thread, local (spill) bytes a thread. The plan's arguments
// are those of conv3d_tapconcat_bf16. Returns cudaErrorInvalidValue for a
// plan with no instance, else the cudaError_t of reading the kernel's
// attributes.
int conv3d_tapconcat_plan(int n, int d, int h, int wl, int cout, int wco, int instance,
                          int num_sms, int* out) {
  TcParams q;
  TcwParams p;
  const Launch l = plan_launch(q, p, n, d, h, wl, cout, wco, instance, num_sms);
  if (!l.ok()) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, l.func());
  out[0] = (int)l.smem;
  out[1] = (int)l.grid.x;
  out[2] = (int)l.grid.y;
  out[3] = err == cudaSuccess ? a.numRegs : -1;
  out[4] = err == cudaSuccess ? (int)a.localSizeBytes : -1;
  return (int)err;
}

// Launches the planned instance on `stream` and returns the cudaError_t of
// the launch (0 on success). x: (n, d, h, wl, 4) bf16; w: (n, 180, wco) bf16
// with wco a multiple of 8 and >= cout, rows tap-major (taps (5, 3, 3)) x 4
// lanes, read in place by both instances; y: (n, d, h, wl, cout) bf16.
// instance: 0 mma.sync, 1 wgmma (persistent over num_sms SMs). Does not
// synchronize and allocates nothing.
int conv3d_tapconcat_bf16(const void* x, const void* w, void* y, int n, int d, int h, int wl,
                          int cout, int wco, int instance, int num_sms, void* stream) {
  TcParams q;
  TcwParams p;
  const Launch l = plan_launch(q, p, n, d, h, wl, cout, wco, instance, num_sms);
  if (!l.ok()) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(l.func(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l.kern != nullptr) {
    q.x = static_cast<const __nv_bfloat16*>(x);
    q.w = static_cast<const __nv_bfloat16*>(w);
    q.y = static_cast<__nv_bfloat16*>(y);
    l.kern<<<l.grid, l.threads, l.smem, s>>>(q);
    return (int)cudaGetLastError();
  }
  const int ba = l.bn < 64 ? l.bn : 64;
  CUtensorMap tmx, tmw, tmy;
  if (!encode_tapconcat_input_map(&tmx, x, n, d, h, wl, p.xrow, p.srows) ||
      !encode_tapconcat_weight_map(&tmw, w, n, cout, wco, ba) ||
      !encode_output_map(&tmy, y, n, d, h, wl, cout, ba, p.tw, p.rows)) {
    return (int)cudaErrorInvalidValue;
  }
  l.wide<<<l.grid, l.threads, l.smem, s>>>(p, tmx, tmw, tmy);
  return (int)cudaGetLastError();
}

// One k16 step of each group (dz 0, dy 0..2) of the wgmma instance
// (conv3d_tapconcat_wgmma_unit_kernel) on `stream`: s2 ((128 / tw + 2) x (tw
// + 2) x 8) bf16, w (1, 180, 128) bf16, out (3, 128, 128) fp32; tw 64 or 8.
// Returns the cudaError_t of the launch.
int conv3d_tapconcat_wgmma_unit(const void* s2, const void* w, void* out, int tw, void* stream) {
  if (tw != 64 && tw != 8) return (int)cudaErrorInvalidValue;
  const size_t smem = SWIZZLE_ALIGN + TcwLayout<128>::W_BYTES +
                      (size_t)(WG_BM / tw + 2) * (tw + 2) * 16;
  CUtensorMap tmw;
  if (!encode_tapconcat_weight_map(&tmw, w, 1, 128, 128, 64)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv3d_tapconcat_wgmma_unit_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  conv3d_tapconcat_wgmma_unit_kernel<<<1, WG_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(s2), static_cast<float*>(out), tw, tmw);
  return (int)cudaGetLastError();
}

const char* conv3d_tapconcat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
