// DCNv2 backward: gradients of the deformable 3x3 conv for given offsets/mask,
// float32 or bf16 activations (gradients float32 either way).
//
// Replaces transmvsnet_tpu/ops/pallas/dcn_bwd.py::deform_conv2d_bwd (the TPU
// kernel _bwd_kernel; bf16 there). Its float32 instantiation serves the
// float32 path, where the JAX package differentiates dcn_rowsweep.py by
// autodiff of the floor-based XLA sampler (ops/pallas/vjp.py,
// pallas_bwd=None): the same gradient. Same function: for the forward
//   out[o, p] = sum_k sum_c m_k(p) * samp_kc(p) * w[k, c, o]
//   samp_kc(p) = bilinear(x[c], y + k/3 - 1 + dy_k(p), x + k%3 - 1 + dx_k(p))
// (zeros padding per corner) and the cotangent g[o, p], with
//   q_kc(p) = sum_o w[k, c, o] * g[o, p]
// it returns
//   dm_k   = sum_c q_kc * samp_kc
//   ddy_k  = m_k * sum_c q_kc * ((1 - wx) (v10 - v00) + wx (v11 - v01))
//   ddx_k  = m_k * sum_c q_kc * ((1 - wy) (v01 - v00) + wy (v11 - v10))
//   dx[c]  = scatter of q_kc * m_k * w_corner into the four corners
//   dw     = sum_p (m_k * samp_kc)(p) * g[o, p]
// where v_ab is the corner's value, zero off the image. The offset
// gradients follow the floor two-tap rule (v_hi - v_lo at floor(p)), not the
// derivative of the bilinear hat: the offset convs start at zero, every
// coordinate then lies on an integer, and there the hat's derivative would be
// zero and the offsets would never train.
//
// What bounds it on an H100. By the roofline (each input read once, each
// output written once) it is bound by arithmetic: per pixel 2 * 9 * C * C_out
// multiply-adds for the two contractions (q = W^T g and dw) and ~20 float32
// operations per (tap, channel) for the sample, the offset and mask sums and
// the dx scatter, against ~(2 C + 4 C_out + 216) bytes. What held the first
// design (two kernels, one thread per pixel) far above that bound was the
// scatter into dx, one float32 global atomic per (pixel, tap, channel, corner
// of nonzero weight), 9 C to 36 C per pixel and scattered further apart the
// larger the offsets, and a second kernel that gathered every sample again
// for dw. Shared-memory float atomics are no cure on this card: sm_90 has no
// float add for shared memory (atomicAdd compiles to a compare-and-swap
// loop), and a version of this kernel that accumulated dx in a shared window
// that way spent more time in those loops than the global atomics had cost.
//
// Design: one kernel, a persistent grid (as many blocks as fit on the card)
// whose blocks walk over tiles of 8 x 32 output pixels of one image; 512
// threads, two per pixel. x around the tile (rows -2..+9, columns -4..+35)
// and the tile's cotangents G are copied into shared memory asynchronously
// while the block finishes the tile before. Per tile and tap k:
// 1. Q_k = W_k . G on the tensor cores: [C x C_out] . [C_out x 256 pixels]
//    with mma.sync in 3xTF32 (each float32 operand split into a TF32 head and
//    tail; three products, so the sums keep float32 accuracy), into shared
//    memory.
// 2. Gather once: each thread samples the four corners of its pixel's tap
//    (from the staged x where they lie in it) for half of the C channels, and
//    forms from q and the corners the dm / ddy / ddx sums (through
//    sum_c q_kc v_ab per corner) and m * samp_kc, stored as a [C x 256]
//    shared tile S_k for dw. dm / ddy / ddx are written once per (tap, pixel),
//    without an atomic.
// 3. dx without a float atomic per channel. The dx window covers the tile
//    plus a halo of 2 pixels (12 x 36 cells), one cell per thread. Each
//    corner of nonzero weight that falls inside it is entered once, whatever
//    C is: when both floor shifts from the tap's own position are -1 or 0
//    (offsets in [-1, 1), the training path's regime), into one of 9 slots
//    of its cell that only this pixel can fill (no atomic at all); otherwise
//    into its cell's list, a slot handed out by an integer shared atomic.
//    After the tap the thread that owns the cell sums q_kc(pixel) * weight
//    over its slots and list for every channel into registers, and at the
//    end of the tile adds them into dx with one global atomic per nonzero
//    element (neighbouring windows overlap). A corner outside the window
//    (offsets beyond the halo), or beyond a full list, is added into dx for
//    every channel by the thread that found it, with global atomics: that
//    branch belongs to the kernel, so nothing is dropped however large the
//    offsets are.
// 4. dw_k += S_k . G^T on the tensor cores in 3xTF32: each warp sums its
//    share of the tile from zero there and adds it, on the CUDA cores, into
//    float32 registers that hold its share of every tap's [C x C_out] sums
//    for the whole walk (the tensor cores' own float32 sums drifted by ~1e-4
//    of the largest dw over a walk's thousands of steps); added into dw with
//    one atomic per element per warp at the end.
// Shared memory per block, in bytes: 4 * (9 Cp C_out (w, Cp = C rounded up
// to 16) + 260 (C_out + 2 C) (G, Q, S) + 768 + 15 * 432 (slots, lists))
// + 480 C sizeof(x) + 10 * 432: float32 231,456 at (C, C_out) = (32, 32),
// 196,384 at (32, 16), 178,848 at (32, 8); bf16 200,736, 165,664, 148,128.
// One block per SM, 16 warps; 128 registers a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dcn_fwd.cuh"

namespace {

using namespace dcn;  // load, copy_async, Split, mma_3xtf32, sample_at: shared with K1/K5

constexpr int kTaps = 9;
constexpr int kTileY = 8, kTileX = 32;  // output pixels per tile: a warp per row
constexpr int kPix = kTileY * kTileX;
constexpr int kHalo = 2;
constexpr int kWinY = kTileY + 2 * kHalo, kWinX = kTileX + 2 * kHalo;
constexpr int kCells = kWinY * kWinX;   // dx window cells
constexpr int kCap = 5;                 // list entries per cell and tap
constexpr int kXw = kTileX + 8;         // staged x columns: 4 more on each side
constexpr int kXcells = kWinY * kXw;    // staged x values per channel
constexpr int kThreads = 2 * kPix;      // two threads per pixel
constexpr int kWarps = kThreads / 32;
constexpr int kRow = kPix + 4;          // padded row of the G, Q and S tiles
static_assert(kCells <= kThreads, "a thread per window cell");

// Offsets, in 4-byte words, of a block's shared arrays.
template <typename T, int C, int COUT>
struct Smem {
  static constexpr int kMt = (C + 15) / 16;           // m16 tiles over the channels
  static constexpr int w = 0;                         // W in A-fragment order, per tap
  static constexpr int g = w + kTaps * kMt * 16 * COUT;  // [COUT][kRow] cotangents
  static constexpr int q = g + COUT * kRow;           // [C][kRow] q of one tap
  static constexpr int s = q + C * kRow;              // [C][kRow] m * samp of one tap
  static constexpr int red = s + C * kRow;            // [3][kPix] partial sums
  static constexpr int fw = red + 3 * kPix;           // [9][kCells] fixed-slot weights
  static constexpr int lw = fw + 9 * kCells;          // [kCap][kCells] list weights
  static constexpr int cnt = lw + kCap * kCells;      // [kCells] list lengths
  static constexpr int x = cnt + kCells;              // [C][kWinY][kXw] x around the tile, in T
  static constexpr int lj = x + (int)(sizeof(T) * C * kXcells / 4);  // [kCap][kCells] list pixels, 16 bits
  static constexpr size_t bytes = 4 * (size_t)lj + 2 * kCap * kCells;
  static_assert(g % 4 == 0 && x % 4 == 0, "16-byte alignment");
};

// Step 1: s_q[c][p] = sum_o W_k[c][o] G[o][p]. Warp w computes the pixel
// columns of n8 tiles w and w + 16 for every m16 tile of channels.
template <int C, int COUT>
__device__ __forceinline__ void q_tile(const float* s_wk, const float* s_g, float* s_q, int warp,
                                       int lane) {
  constexpr int kMt = Smem<float, C, COUT>::kMt;
  const int g = lane >> 2, t = lane & 3;
  float acc[kMt][2][4] = {};
#pragma unroll
  for (int kt = 0; kt < COUT / 8; ++kt) {
    Split<2> b[2] = {Split<2>({s_g[(kt * 8 + t) * kRow + warp * 8 + g],
                               s_g[(kt * 8 + t + 4) * kRow + warp * 8 + g]}),
                     Split<2>({s_g[(kt * 8 + t) * kRow + (warp + kWarps) * 8 + g],
                               s_g[(kt * 8 + t + 4) * kRow + (warp + kWarps) * 8 + g]})};
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
      const float4 av = reinterpret_cast<const float4*>(s_wk)[(mt * (COUT / 8) + kt) * 32 + lane];
      const Split<4> a({av.x, av.y, av.z, av.w});
      mma_3xtf32(acc[mt][0], a, b[0]);
      mma_3xtf32(acc[mt][1], a, b[1]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = (warp + h * kWarps) * 8 + 2 * t;
      const int r0 = mt * 16 + g, r1 = r0 + 8;
      if (r0 < C) *reinterpret_cast<float2*>(s_q + r0 * kRow + col) = make_float2(acc[mt][h][0], acc[mt][h][1]);
      if (r1 < C) *reinterpret_cast<float2*>(s_q + r1 * kRow + col) = make_float2(acc[mt][h][2], acc[mt][h][3]);
    }
  }
}

// Step 4's tiling: warp w owns the m16 x n8 tile (mt, nt) of dw_k over one
// share of the tile's pixels (k8 steps).
template <int C, int COUT>
struct DwTile {
  static constexpr int kMt = Smem<float, C, COUT>::kMt, kNt = COUT / 8, kTiles = kMt * kNt;
  static constexpr int kSplit = kWarps / kTiles, kSteps = kPix / 8 / kSplit;
  static_assert(kWarps % kTiles == 0, "dw tiling");
  int mt, nt, p0;
  __device__ explicit DwTile(int warp) {
    const int tile = warp % kTiles;
    mt = tile / kNt;
    nt = tile % kNt;
    p0 = warp / kTiles * kSteps * 8;
  }
};

// Step 4: acc += S_k[mt rows, pixels] . G[nt rows, pixels]^T.
template <int C, int COUT>
__device__ __forceinline__ void dw_tile(float (&acc)[4], const DwTile<C, COUT>& d, const float* s_s,
                                        const float* s_g, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = d.mt * 16 + g, r1 = r0 + 8;
  const float* s0 = s_s + r0 * kRow;
  const float* s1 = s_s + r1 * kRow;
  const float* gr = s_g + (d.nt * 8 + g) * kRow;
#pragma unroll 4
  for (int i = 0; i < DwTile<C, COUT>::kSteps; ++i) {
    const int p = d.p0 + i * 8 + t;
    // Rows past C (C = 8: the m16 tile is half empty) are zero.
    const Split<4> a({s0[p], r1 < C ? s1[p] : 0.f, s0[p + 4], r1 < C ? s1[p + 4] : 0.f});
    const Split<2> b({gr[p], gr[p + 4]});
    mma_3xtf32(acc, a, b);
  }
}

template <typename T, int C, int COUT>
__global__ void __launch_bounds__(kThreads, 1) dcn_bwd_kernel(
    const T* __restrict__ x,              // [N, C, H, W]
    const float* __restrict__ dy,         // [N, 9, H, W]
    const float* __restrict__ dx,         // [N, 9, H, W]
    const float* __restrict__ mask,       // [N, 9, H, W]
    const float* __restrict__ w,          // [9*C, COUT], row = tap*C + c
    const float* __restrict__ g,          // [N, COUT, H, W]
    float* __restrict__ dx_s,             // [N, C, H, W], zeroed by the caller
    float* __restrict__ ddy,              // [N, 9, H, W]
    float* __restrict__ ddx,              // [N, 9, H, W]
    float* __restrict__ dm,               // [N, 9, H, W]
    float* __restrict__ dw,               // [9*C, COUT], zeroed by the caller
    int N, int H, int W) {
  using S = Smem<T, C, COUT>;
  constexpr int kMt = S::kMt, kHalfC = C / 2, kHalfO = COUT / 2;
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem + S::w;
  float* s_g = smem + S::g;
  float* s_q = smem + S::q;
  float* s_s = smem + S::s;
  float* s_red = smem + S::red;
  float* s_fw = smem + S::fw;
  float* s_lw = smem + S::lw;
  int* s_cnt = reinterpret_cast<int*>(smem + S::cnt);
  unsigned short* s_lj = reinterpret_cast<unsigned short*>(smem + S::lj);
  T* s_x = reinterpret_cast<T*>(smem + S::x);

  // W in the A-fragment order of m16n8k8: per (tap, m tile, k step) 32 lanes
  // of 4 values, rows past C zero.
  for (int i = threadIdx.x; i < kTaps * kMt * 16 * COUT; i += kThreads) {
    const int e = i & 3, lane = (i >> 2) & 31, frag = i >> 7;
    const int kt = frag % (COUT / 8), mt = frag / (COUT / 8) % kMt, k = frag / (COUT / 8) / kMt;
    const int row = mt * 16 + (lane >> 2) + 8 * (e & 1), col = kt * 8 + (lane & 3) + 4 * (e >> 1);
    s_w[i] = row < C ? w[(k * C + row) * COUT + col] : 0.f;
  }
  for (int i = threadIdx.x; i < kCells; i += kThreads) s_cnt[i] = 0;
  for (int i = threadIdx.x; i < 9 * kCells; i += kThreads) s_fw[i] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = threadIdx.x % kPix;     // pixel of the tile
  const int half = threadIdx.x / kPix;  // which half of the channels (and corners)
  const int c_begin = half * kHalfC;
  const int ty = j / kTileX, tx = j % kTileX;
  const int cell = threadIdx.x;         // the window cell this thread owns, if < kCells
  const long long HW = (long long)H * W;
  const int tiles_y = (H + kTileY - 1) / kTileY, tiles_x = (W + kTileX - 1) / kTileX;
  const long long per_image = (long long)tiles_y * tiles_x;
  const long long tiles = N * per_image;
  const DwTile<C, COUT> dwt(warp);
  // Whether x's rows start on whole copies of four values.
  const bool quads = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  float acc[kTaps][4];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;

  // Tile t's x around it: rows [ty0 - 2, ty0 + 10), columns [tx0 - 4,
  // tx0 + 36), zero off the image. Copies of four values (16 or 8 bytes) run
  // asynchronously where they lie whole on the image and x's rows are aligned
  // to them; the rest are written here.
  const auto stage_x = [&](long long t) {
    const int n = (int)(t / per_image), r = (int)(t - n * per_image);
    const int ty0 = (r / tiles_x) * kTileY, tx0 = (r % tiles_x) * kTileX;
    for (int i = threadIdx.x; i < C * kWinY * (kXw / 4); i += kThreads) {
      const int row = i / (kXw / 4), quad = i - row * (kXw / 4);  // row over (c, y)
      const int c = row / kWinY, cy = ty0 - kHalo + row % kWinY, cx = tx0 - 4 + 4 * quad;
      T* dst = s_x + row * kXw + 4 * quad;
      const T* src = x + ((long long)n * C + c) * HW + (long long)cy * W + cx;
      const bool row_in = cy >= 0 && cy < H;
      if (row_in && quads && cx >= 0 && cx + 4 <= W) {
        copy_async<4 * sizeof(T)>(dst, src, 4 * sizeof(T));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = row_in && cx + e >= 0 && cx + e < W ? src[e] : T(0.f);
      }
    }
  };
  // Tile t's cotangents, this thread's pixel and half of the channels.
  const auto stage_g = [&](long long t) {
    const int n = (int)(t / per_image), r = (int)(t - n * per_image);
    const int oy = (r / tiles_x) * kTileY + ty, ox = (r % tiles_x) * kTileX + tx;
    const bool inside = oy < H && ox < W;
    const float* gb = g + (long long)n * COUT * HW + (inside ? (long long)oy * W + ox : 0);
#pragma unroll
    for (int o = half * kHalfO; o < (half + 1) * kHalfO; ++o)
      copy_async<4>(s_g + o * kRow + j, gb + (inside ? o * HW : 0), inside ? 4 : 0);
  };
  if (blockIdx.x < tiles) {
    stage_x(blockIdx.x);
    stage_g(blockIdx.x);
  }

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n = (int)(t / per_image);
    const int r = (int)(t - n * per_image);
    const int ty0 = (r / tiles_x) * kTileY, tx0 = (r % tiles_x) * kTileX;
    const int wy0 = ty0 - kHalo, wx0 = tx0 - kHalo;  // the window's origin
    const int oy = ty0 + ty, ox = tx0 + tx;
    const bool inside = oy < H && ox < W;
    const long long pix = (long long)oy * W + ox;
    float cacc[C];  // the cell's dx, per channel
#pragma unroll
    for (int c = 0; c < C; ++c) cacc[c] = 0.f;
    const T* xb = x + (long long)n * C * HW;
    float* dxb = dx_s + (long long)n * C * HW;
    const long long kofs = (long long)n * kTaps * HW + pix;
    copy_async_wait();  // this tile's x and g (staged during the last tile)
    __syncthreads();

    for (int k = 0; k < kTaps; ++k) {
      // This tap's offsets and mask, in flight during step 1.
      float tap_m = 0.f, tap_dy = 0.f, tap_dx = 0.f;
      if (inside) {
        tap_m = mask[kofs + k * HW];
        tap_dy = dy[kofs + k * HW];
        tap_dx = dx[kofs + k * HW];
      }
      q_tile<C, COUT>(s_w + k * kMt * 16 * COUT, s_g, s_q, warp, lane);
      __syncthreads();

      // Step 2 and the lists of step 3.
      float part[3] = {0.f, 0.f, 0.f};  // dm, ddy, ddx over this half's channels
      bool any = false;
      if (inside) {
        const float m = tap_m;
        const Sample s = sample_at((float)(oy + k / 3 - 1) + tap_dy, (float)(ox + k % 3 - 1) + tap_dx, H, W);
        any = s.v00 || s.v01 || s.v10 || s.v11;
        if (any) {
          const float w00 = (1.f - s.wx) * (1.f - s.wy), w01 = s.wx * (1.f - s.wy);
          const float w10 = (1.f - s.wx) * s.wy, w11 = s.wx * s.wy;
          // m times the scatter weights: zero for a corner off the image.
          const float b00 = s.v00 ? m * w00 : 0.f, b01 = s.v01 ? m * w01 : 0.f;
          const float b10 = s.v10 ? m * w10 : 0.f, b11 = s.v11 ? m * w11 : 0.f;
          // This half enters corners (half, 0) and (half, 1) of nonzero weight.
          // The floor corner's shift from the tap's own position: with both
          // shifts in {-1, 0} (offsets in [-1, 1)) the corner is the cell's
          // contribution from direction shift + corner, one of 9, which only
          // this pixel can give: a fixed slot, no atomic.
          const int sy = s.y0 - (oy + k / 3 - 1), sx = s.x0 - (ox + k % 3 - 1);
          const bool fixed = (sy == -1 || sy == 0) && (sx == -1 || sx == 0);
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const float bw = half ? (b ? b11 : b10) : (b ? b01 : b00);
            if (bw == 0.f) continue;
            const int cy = s.y0 + half - wy0, cx = s.x0 + b - wx0;
            if (fixed) {
              s_fw[((sy + half + 1) * 3 + sx + b + 1) * kCells + cy * kWinX + cx] = bw;
              continue;
            }
            bool direct = true;
            if ((unsigned)cy < (unsigned)kWinY && (unsigned)cx < (unsigned)kWinX) {
              const int at = cy * kWinX + cx;
              const int slot = atomicAdd(s_cnt + at, 1);
              if (slot < kCap) {
                s_lj[slot * kCells + at] = (unsigned short)j;
                s_lw[slot * kCells + at] = bw;
                direct = false;
              }
            }
            if (direct) {
              const long long idx = half ? (b ? s.i11 : s.i10) : (b ? s.i01 : s.i00);
              for (int c = 0; c < C; ++c) atomicAdd(dxb + c * HW + idx, s_q[c * kRow + j] * bw);
            }
          }
          float t00 = 0.f, t01 = 0.f, t10 = 0.f, t11 = 0.f;  // sum_c q_kc v_ab
          // corner(c, a, b): the corner's value of channel c, on the image.
          const auto channels = [&](auto corner) {
#pragma unroll
            for (int cc = 0; cc < kHalfC; ++cc) {
              const int c = c_begin + cc;
              const float q = s_q[c * kRow + j];
              const float v00 = s.v00 ? corner(c, 0, 0) : 0.f;
              const float v01 = s.v01 ? corner(c, 0, 1) : 0.f;
              const float v10 = s.v10 ? corner(c, 1, 0) : 0.f;
              const float v11 = s.v11 ? corner(c, 1, 1) : 0.f;
              t00 = fmaf(q, v00, t00);
              t01 = fmaf(q, v01, t01);
              t10 = fmaf(q, v10, t10);
              t11 = fmaf(q, v11, t11);
              s_s[c * kRow + j] = b00 * v00 + b01 * v01 + b10 * v10 + b11 * v11;
            }
          };
          // From the staged window when all four corners lie in it, else
          // from x in device memory.
          const int ly = s.y0 - wy0, lx = s.x0 - (tx0 - 4);
          if ((unsigned)ly < (unsigned)(kWinY - 1) && (unsigned)lx < (unsigned)(kXw - 1)) {
            const T* xw = s_x + ly * kXw + lx;
            channels([&](int c, int a, int b) { return to_float(xw[c * kXcells + a * kXw + b]); });
          } else {
            channels([&](int c, int a, int b) {
              return load(xb + c * HW + (a ? (b ? s.i11 : s.i10) : (b ? s.i01 : s.i00)));
            });
          }
          part[0] = w00 * t00 + w01 * t01 + w10 * t10 + w11 * t11;
          part[1] = m * ((1.f - s.wx) * (t10 - t00) + s.wx * (t11 - t01));
          part[2] = m * ((1.f - s.wy) * (t01 - t00) + s.wy * (t11 - t10));
        }
      }
      if (!any) {
#pragma unroll
        for (int cc = 0; cc < kHalfC; ++cc) s_s[(c_begin + cc) * kRow + j] = 0.f;
      }
      if (half == 1) {
#pragma unroll
        for (int i = 0; i < 3; ++i) s_red[i * kPix + j] = part[i];
      }
      __syncthreads();

      // The last pass has read this tile's x: stage the next tile's.
      if (k == kTaps - 1 && t + gridDim.x < tiles) stage_x(t + gridDim.x);
      if (half == 0 && inside) {
        dm[kofs + k * HW] = part[0] + s_red[j];
        ddy[kofs + k * HW] = part[1] + s_red[kPix + j];
        ddx[kofs + k * HW] = part[2] + s_red[2 * kPix + j];
      }
      // Step 4, the tile's share summed on the tensor cores from zero and
      // added into acc here: the tensor cores' float32 sums drift over the
      // many tiles of a walk, an add in the CUDA cores rounds each time.
      // Constant indices into acc keep it in registers.
#pragma unroll
      for (int kk = 0; kk < kTaps; ++kk) {
        if (kk == k) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          dw_tile<C, COUT>(part, dwt, s_s, s_g, lane);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[kk][i] += part[i];
        }
      }
      // Step 3: the cell's fixed slots and list, for every channel.
      if (cell < kCells) {
        const int ly = cell / kWinX, lx = cell % kWinX;
#pragma unroll
        for (int f = 0; f < 9; ++f) {
          const float fw = s_fw[f * kCells + cell];
          if (fw != 0.f) {
            // The pixel that gave it: the cell less the tap and the direction.
            const int py = ly - kHalo - (k / 3 - 1) - (f / 3 - 1);
            const int px = lx - kHalo - (k % 3 - 1) - (f % 3 - 1);
            const float* qj = s_q + py * kTileX + px;
#pragma unroll
            for (int c = 0; c < C; ++c) cacc[c] = fmaf(qj[c * kRow], fw, cacc[c]);
            s_fw[f * kCells + cell] = 0.f;
          }
        }
        const int len = min(s_cnt[cell], kCap);
        for (int l = 0; l < len; ++l) {
          const float* qj = s_q + s_lj[l * kCells + cell];
          const float lw = s_lw[l * kCells + cell];
#pragma unroll
          for (int c = 0; c < C; ++c) cacc[c] = fmaf(qj[c * kRow], lw, cacc[c]);
        }
        s_cnt[cell] = 0;
      }
      __syncthreads();
    }

    if (t + gridDim.x < tiles) stage_g(t + gridDim.x);
    // The window into dx. Only cells on the image hold a contribution.
    if (cell < kCells) {
      const int cy = wy0 + cell / kWinX, cx = wx0 + cell % kWinX;
      if (cy >= 0 && cy < H && cx >= 0 && cx < W) {
        float* d = dxb + (long long)cy * W + cx;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (cacc[c] != 0.f) atomicAdd(d + c * HW, cacc[c]);
      }
    }
  }

  // dw: the (row g | g + 8, columns 2t, 2t + 1) entries of each tap's tile.
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = dwt.mt * 16 + gq, col = dwt.nt * 8 + 2 * tq;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    float* d = dw + k * C * COUT;
    if (r0 < C) {
      atomicAdd(d + r0 * COUT + col, acc[k][0]);
      atomicAdd(d + r0 * COUT + col + 1, acc[k][1]);
    }
    if (r0 + 8 < C) {
      atomicAdd(d + (r0 + 8) * COUT + col, acc[k][2]);
      atomicAdd(d + (r0 + 8) * COUT + col + 1, acc[k][3]);
    }
  }
}

template <typename T, int C, int COUT>
cudaError_t launch(const void* x, const void* dy, const void* dx, const void* mask,
                   const void* w, const void* g, void* dx_s, void* ddy, void* ddx, void* dm,
                   void* dw, int N, int H, int W, cudaStream_t stream) {
  const auto kernel = dcn_bwd_kernel<T, C, COUT>;
  constexpr size_t smem = Smem<T, C, COUT>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles =
      (long long)N * ((H + kTileY - 1) / kTileY) * ((W + kTileX - 1) / kTileX);
  const long long fit = (long long)sms * per_sm;
  const unsigned blocks = (unsigned)(tiles < fit ? tiles : fit);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dy), static_cast<const float*>(dx),
      static_cast<const float*>(mask), static_cast<const float*>(w), static_cast<const float*>(g),
      static_cast<float*>(dx_s), static_cast<float*>(ddy), static_cast<float*>(ddx),
      static_cast<float*>(dm), static_cast<float*>(dw), N, H, W);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t dispatch_cout(int cout, const void* x, const void* dy, const void* dx,
                          const void* mask, const void* w, const void* g, void* dx_s, void* ddy,
                          void* ddx, void* dm, void* dw, int N, int H, int W, cudaStream_t s) {
  switch (cout) {
    case 8: return launch<T, C, 8>(x, dy, dx, mask, w, g, dx_s, ddy, ddx, dm, dw, N, H, W, s);
    case 16: return launch<T, C, 16>(x, dy, dx, mask, w, g, dx_s, ddy, ddx, dm, dw, N, H, W, s);
    case 32: return launch<T, C, 32>(x, dy, dx, mask, w, g, dx_s, ddy, ddx, dm, dw, N, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int C, int cout, const void* x, const void* dy, const void* dx,
                     const void* mask, const void* w, const void* g, void* dx_s, void* ddy,
                     void* ddx, void* dm, void* dw, int N, int H, int W, cudaStream_t s) {
  switch (C) {
    case 8:
      return dispatch_cout<T, 8>(cout, x, dy, dx, mask, w, g, dx_s, ddy, ddx, dm, dw, N, H, W, s);
    case 16:
      return dispatch_cout<T, 16>(cout, x, dy, dx, mask, w, g, dx_s, ddy, ddx, dm, dw, N, H, W, s);
    case 32:
      return dispatch_cout<T, 32>(cout, x, dy, dx, mask, w, g, dx_s, ddy, ddx, dm, dw, N, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x is bf16 when bf16 != 0, else float32. Returns a cudaError_t code: 0 on
// success, else the first launch error.
extern "C" int dcn_bwd(const void* x, const void* dy, const void* dx, const void* mask,
                       const void* w, const void* g, void* dx_s, void* ddy, void* ddx, void* dm,
                       void* dw, int N, int C, int COUT, int H, int W, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)dispatch<__nv_bfloat16>(C, COUT, x, dy, dx, mask, w, g, dx_s, ddy, ddx, dm, dw, N,
                                        H, W, s);
  return (int)dispatch<float>(C, COUT, x, dy, dx, mask, w, g, dx_s, ddy, ddx, dm, dw, N, H, W, s);
}

extern "C" const char* dcn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
