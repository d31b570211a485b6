// The DCNv2 forward body shared by K1 (dcn_fused.cu: offset conv inside, bf16)
// and K5 (dcn.cu: offsets and mask given, float32 or bf16), and the helpers
// that K3 (dcn_bwd.cu) shares with them (namespace dcn).
//
// The function, for every output pixel p = (y, x) and output channel o:
//   out[o] = bias[o] + sum_k sum_c m_k * bilinear(x[c], y+k/3-1+dy_k, x+k%3-1+dx_k) * w[k, c, o]
// with per-corner zero padding, accumulated in float32 and rounded once to
// the activation type. K1 computes dy, dx and the mask logits itself, a 3x3
// conv of x with 27 outputs (dy_k = off[2k], dx_k = off[2k+1],
// m_k = sigmoid(off[18+k])); K5 reads them.
//
// The body (dcn_fwd::dcn_fwd_kernel). A persistent grid (one block of 16
// warps per SM) walks over tiles of 8 x 32 output pixels of one image; each
// warp owns 16 pixels (half a tile row, one m16 tile of mma.sync) from their
// taps to their output, so the tap loop needs no block barrier and one warp's
// sampling overlaps another's tensor-core products. Per tile:
// 1. Offsets. K1: x around the tile (rows -1..+8, columns -4..+35, planar)
//    is copied with cp.async during the tile before, turned channels-
//    innermost (10 x 34 cells) and multiplied on the tensor cores: an
//    implicit GEMM [pixels x 9C] . [9C x 32 (27 used)]. x is exact in bf16,
//    so only the weights are split, into bf16 head and tail: two products,
//    float32 sums, exact to ~2^-17 (K3's backward recomputes the offsets in
//    float32, and floors must not flip between the two). K5: the tile's 27
//    float32 offset/mask planes, copied with cp.async during the tile
//    before. Either way the offsets stay in shared memory.
// 2. The box. The rows and columns that the tile's corners span (on the
//    image) are reduced over the block; that box, up to the shared memory
//    left (1,244 cells for K1, 894 for K5 float32, 1,609 for K5 bf16 at C =
//    C_out = 32) and else cut to the tile widened equally on each side, is
//    copied from x into shared memory channels-innermost (one cell = one
//    pixel's C channels, padded to an odd number of 16 bytes: consecutive
//    cells fall on different banks). A corner in the box costs one 16-byte
//    load per 8 bf16 (4 float32) channels; planar storage, as K3 keeps x,
//    costs one load per channel, and a build of this body with planar
//    cells was 1.3-1.5x slower for K1, 1.4-1.6x for K5 bf16 and 1.2x for
//    K5 float32 on an H100 (tools/compare_dcn.py). A corner outside a cut
//    box is gathered from x in device memory (L2): nothing is dropped,
//    however large the offsets, even where the cut box holds none.
// 3. The taps. Each lane sets up one pixel's tap (floor corner, weights
//    times mask); each thread of a quad (t = lane % 4) takes the setups of
//    its two pixels by shuffles and samples C/4 consecutive channels of them:
//    bilinear x mask in float32, per-corner zero padding, directly in
//    registers in the A-fragment layout (a quad's channels fill its k slots;
//    B is stored in the same order). When the box is whole the sampler has
//    no branch, and the next tap is sampled while this tap's products run.
//    The contraction [pixels x 9C] . [9C x C_out] runs on the tensor cores
//    with split operands and float32 accumulators summed per tile from zero:
//    bf16 x in 3xBF16 (s_hi w_hi + s_hi w_lo + s_lo w_hi), float32 x in
//    3xTF32 (K3's bit-mask split). Why split: one bf16 product, the TPU
//    kernel's rounding, is ~2^-8 off and misses the forward gate |d| <=
//    2^-7 |p| + 1e-3 max|p| against the float32 plain version; one TF32
//    product misses float32's 1e-4; three products are float32-accurate
//    (tests/test_torch_dcn_split.py emulates all three). The weights are
//    split once per block, for the whole walk.
// 4. The epilogue: bias added in float32, rounded once to the activation
//    type, staged through shared memory and stored along W, one coalesced
//    row of 16 pixels per output channel. No atomics: bitwise repeatable.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace dcn {

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Copies BYTES from global to shared memory without the issuing thread
// waiting: the first SRC_BYTES are read, the rest is zero.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(BYTES), "r"(src_bytes)
               : "memory");
}

// Waits for this thread's asynchronous copies.
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// d += a . b for one m16n8k8 tile in TF32, float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A float32 fragment of N values split into TF32 head and tail: the head is
// x cut to TF32 (its low 13 bits cleared), the tail the exact rest, which the
// tensor core cuts to TF32 in turn; x = hi + lo up to ~2^-20 |x|. (A bit mask
// where cvt.rna.tf32 would round: the conversion runs at a quarter of the
// rate and cost more than the products.)
template <int N>
struct Split {
  unsigned hi[N], lo[N];
  __device__ __forceinline__ explicit Split(const float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      hi[i] = __float_as_uint(x[i]) & 0xffffe000u;
      lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i]));
    }
  }
};

// d += a . b in 3xTF32: the tails' products first, the heads' last; the
// tail-by-tail product (~2^-20 relative) is left out.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Split<4>& a, const Split<2>& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// One bilinear sample: the floor corner, corner validity, fractional
// weights, clamped indices.
struct Sample {
  bool v00, v01, v10, v11;
  float wx, wy;
  int y0, x0;
  long long i00, i01, i10, i11;
};

// Clamped before the int cast, as the forward kernel and the plain sampler
// are: anything beyond [-2, size+1] has no valid corner.
__device__ __forceinline__ Sample sample_at(float py, float px, int H, int W) {
  Sample s;
  const float fy = floorf(py), fx = floorf(px);
  s.wy = py - fy;
  s.wx = px - fx;
  const int y0 = (int)fminf(fmaxf(fy, -2.f), (float)H + 1.f);
  const int x0 = (int)fminf(fmaxf(fx, -2.f), (float)W + 1.f);
  const int y1 = y0 + 1, x1 = x0 + 1;
  s.y0 = y0;
  s.x0 = x0;
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y1 >= 0 && y1 < H;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x1 >= 0 && x1 < W;
  s.v00 = vy0 && vx0;
  s.v01 = vy0 && vx1;
  s.v10 = vy1 && vx0;
  s.v11 = vy1 && vx1;
  const int cy0 = min(max(y0, 0), H - 1), cy1 = min(max(y1, 0), H - 1);
  const int cx0 = min(max(x0, 0), W - 1), cx1 = min(max(x1, 0), W - 1);
  s.i00 = (long long)cy0 * W + cx0;
  s.i01 = (long long)cy0 * W + cx1;
  s.i10 = (long long)cy1 * W + cx0;
  s.i11 = (long long)cy1 * W + cx1;
  return s;
}

}  // namespace dcn

namespace dcn_fwd {

using dcn::copy_async;
using dcn::copy_async_wait;
using dcn::Split;

constexpr int kTaps = 9;
constexpr int kOffCh = 27;               // 9 (dy, dx) pairs, 9 mask logits
constexpr int kTileY = 8, kTileX = 32;   // output pixels per tile
constexpr int kPix = kTileY * kTileX;
constexpr int kWarps = kPix / 16;        // a warp per 16 pixels (half a row): one m16 tile
constexpr int kThreads = 32 * kWarps;
constexpr int kRow = kPix + 4;           // row of the offset / output staging arrays, floats
constexpr int kXtY = kTileY + 2, kXtX = kTileX + 2;  // the offset conv's input: tile + 1 px
constexpr int kPx = kTileX + 8;          // columns of its planar copy: 4 more on each side
constexpr int kSmemMax = 232448;         // shared memory one block may use on sm_90

// How a pixel's C channels meet mma.sync. The four threads of a quad
// (t = lane % 4) each hold C/4 consecutive channels, which fill the quad's
// k slots of every k step in an order of the kernel's choosing (the product
// does not depend on the order of k, as long as A and B agree).
template <typename T, int C>
struct Frag;
template <int C>
struct Frag<__nv_bfloat16, C> {
  static constexpr int kK = C >= 16 ? 16 : 8;  // m16n8k16; m16n8k8 at C = 8
  static constexpr int kSteps = C / kK;
  static constexpr int kBw = kK / 4;           // B words per lane and (step, n tile): heads, tails
};
template <int C>
struct Frag<float, C> {
  static constexpr int kK = 8;                 // m16n8k8 in TF32
  static constexpr int kSteps = C / 8;
  static constexpr int kBw = 2;                // two float32 values, split in registers
};

// Offsets, in 4-byte words, of a block's shared arrays; each a multiple of
// four (16-byte alignment). The staged cells take what is left.
template <typename T, int C, int COUT, bool FUSED>
struct Smem {
  using F = Frag<T, C>;
  static constexpr int kNt = COUT / 8;
  static constexpr int kRows = COUT > kOffCh ? COUT : kOffCh;  // offsets, then the output
  static constexpr int kCell16 = (C * (int)sizeof(T) / 16) | 1;  // cell stride in 16 bytes, odd
  static constexpr int kCell = kCell16 * 16 / (int)sizeof(T);   // ... in values of T
  static constexpr int w = 0;                                   // [9][steps][kNt][32][kBw]
  static constexpr int woff = w + kTaps * F::kSteps * kNt * 32 * F::kBw;
  static constexpr int off = woff + (FUSED ? kTaps * F::kSteps * 4 * 32 * F::kBw : 0);
  static constexpr int bias = off + (FUSED ? 1 : 2) * kRows * kRow;  // K5: two, prefetched
  static constexpr int boff = bias + 32;
  static constexpr int box = boff + 32;
  static constexpr int px = box + 8;                             // K1: [C][kXtY][kPx] planar x
  static constexpr int cells = px + (FUSED ? C * kXtY * kPx * (int)sizeof(T) / 4 : 0);
  static constexpr int kCells = (kSmemMax - 4 * cells) / (16 * kCell16);  // the box's capacity
  static constexpr size_t bytes = 4 * (size_t)cells + (size_t)16 * kCell16 * kCells;
  static_assert(woff % 4 == 0 && off % 4 == 0 && px % 4 == 0 && cells % 4 == 0, "alignment");
  static_assert(kCells >= kXtY * kXtX && kCells >= kPix, "room for the offset conv's input");
  static_assert(!FUSED || sizeof(T) == 2, "K1 takes bf16 activations");
};

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}

// (a, b) packed as bf16 head and tail: a = hi.x + lo.x up to ~2^-17 |a|.
__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a - __low2float(h), b - __high2float(h)));
}

// N 32-bit words from shared memory at p (aligned to their size, or 16).
template <int N>
__device__ __forceinline__ void load_words(const void* p, unsigned (&u)[N]) {
  if constexpr (N == 1) {
    u[0] = *static_cast<const unsigned*>(p);
  } else if constexpr (N == 2) {
    const uint2 v = *static_cast<const uint2*>(p);
    u[0] = v.x;
    u[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 v = static_cast<const uint4*>(p)[i];
      u[4 * i] = v.x;
      u[4 * i + 1] = v.y;
      u[4 * i + 2] = v.z;
      u[4 * i + 3] = v.w;
    }
  }
}

// s += wgt * (N values of T at p in shared memory).
template <typename T, int N>
__device__ __forceinline__ void add_values(float (&s)[N], const T* p, float wgt) {
  constexpr int kW = N * (int)sizeof(T) / 4;
  unsigned u[kW];
  load_words<kW>(p, u);
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    if constexpr (sizeof(T) == 4) {
      s[i] = fmaf(wgt, __uint_as_float(u[i]), s[i]);
    } else {
      s[2 * i] = fmaf(wgt, __uint_as_float(u[i] << 16), s[2 * i]);
      s[2 * i + 1] = fmaf(wgt, __uint_as_float(u[i] & 0xffff0000u), s[2 * i + 1]);
    }
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes of one cell: the values of 16 / sizeof(T) consecutive channel
// planes at one pixel of x (device memory), as raw bits.
__device__ __forceinline__ uint4 gather_chunk(const float* p, long long HW) {
  return make_uint4(__float_as_uint(__ldg(p)), __float_as_uint(__ldg(p + HW)),
                    __float_as_uint(__ldg(p + 2 * HW)), __float_as_uint(__ldg(p + 3 * HW)));
}
__device__ __forceinline__ uint4 gather_chunk(const __nv_bfloat16* p, long long HW) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  unsigned u[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    u[e] = (unsigned)__ldg(q + 2 * e * HW) | ((unsigned)__ldg(q + (2 * e + 1) * HW) << 16);
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// B fragments of a [9*C, ncols] row-major float32 matrix (row = tap*C + c)
// over NT n tiles of 8 columns (columns past ncols zero), in the order the
// loops read them: [tap][step][n tile][lane][kBw words]. Lane (g, t) of a
// step holds column 8 nt + g at its quad's channels: bf16 k16 b0 = (c0,
// c0+1), b1 = (c0+2, c0+3) with c0 = t C/4 + 4 step, heads then tails; bf16
// k8 b0 = (c0, c0+1), c0 = 2t; TF32 b0 = c0, b1 = c0+1 with c0 = t C/4 +
// 2 step. The A fragments below take the samples in the same order.
template <typename T, int C, int NT>
__device__ void fill_b(unsigned* dst, const float* __restrict__ src, int ncols) {
  using F = Frag<T, C>;
  constexpr int kCt = C / 4;
  for (int i = threadIdx.x; i < kTaps * F::kSteps * NT * 32; i += blockDim.x) {
    const int lane = i & 31, frag = i >> 5;
    const int nt = frag % NT, s = frag / NT % F::kSteps, k = frag / NT / F::kSteps;
    const int o = nt * 8 + (lane >> 2), c0 = (lane & 3) * kCt;
    const auto at = [&](int c) { return o < ncols ? src[(k * C + c) * ncols + o] : 0.f; };
    unsigned* d = dst + i * F::kBw;
    if constexpr (std::is_same<T, float>::value) {
      d[0] = __float_as_uint(at(c0 + 2 * s));
      d[1] = __float_as_uint(at(c0 + 2 * s + 1));
    } else if constexpr (F::kK == 16) {
      split_bf16(at(c0 + 4 * s), at(c0 + 4 * s + 1), d[0], d[2]);
      split_bf16(at(c0 + 4 * s + 2), at(c0 + 4 * s + 3), d[1], d[3]);
    } else {
      split_bf16(at(c0), at(c0 + 1), d[0], d[1]);
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[2], const unsigned (&b)[1]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b[0]));
}

// The A fragment of k step st from packed bf16 pairs of the rows' pixels g
// (p0) and g + 8 (p1), this thread's channels in order.
template <int K, int NW>
struct AFrag;
template <int NW>
struct AFrag<16, NW> {
  unsigned r[4];
  __device__ __forceinline__ AFrag(const unsigned (&p0)[NW], const unsigned (&p1)[NW], int st)
      : r{p0[2 * st], p1[2 * st], p0[2 * st + 1], p1[2 * st + 1]} {}
};
template <int NW>
struct AFrag<8, NW> {
  unsigned r[2];
  __device__ __forceinline__ AFrag(const unsigned (&p0)[NW], const unsigned (&p1)[NW], int)
      : r{p0[0], p1[0]} {}
};

// Head and tail B fragments of one (step, n tile) from the packed words.
template <int K>
struct BFrag;
template <>
struct BFrag<16> {
  unsigned hi[2], lo[2];
  __device__ __forceinline__ void load(const unsigned* p) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    hi[0] = v.x, hi[1] = v.y, lo[0] = v.z, lo[1] = v.w;
  }
};
template <>
struct BFrag<8> {
  unsigned hi[1], lo[1];
  __device__ __forceinline__ void load(const unsigned* p) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    hi[0] = v.x, lo[0] = v.y;
  }
};

// This thread's A operand of one tap, split into heads and tails: from
// s[h][i], its channel i of pixel g + 8h. bf16: packed bf16 pairs; float32:
// the TF32 fragments of each k step (K3's bit-mask split).
template <typename T, int C>
struct Operand;
template <int C>
struct Operand<__nv_bfloat16, C> {
  static constexpr int kW = C / 8;  // packed words per pixel
  unsigned hi[2][kW], lo[2][kW];
  __device__ __forceinline__ explicit Operand(const float (&s)[2][C / 4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < kW; ++i) split_bf16(s[h][2 * i], s[h][2 * i + 1], hi[h][i], lo[h][i]);
  }
};
template <int C>
struct Operand<float, C> {
  static constexpr int kSteps = C / 8;
  unsigned hi[kSteps][4], lo[kSteps][4];
  __device__ __forceinline__ explicit Operand(const float (&s)[2][C / 4]) {
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const Split<4> a({s[0][2 * st], s[1][2 * st], s[0][2 * st + 1], s[1][2 * st + 1]});
#pragma unroll
      for (int i = 0; i < 4; ++i) hi[st][i] = a.hi[i], lo[st][i] = a.lo[i];
    }
  }
};

// Accumulator sets of a warp's m16 tile over NT n tiles: product p of the
// three split products (tails first) goes to set p * kSets / 3. With fewer n
// tiles than products, back-to-back products into one accumulator would wait
// on each other; the sets are added in a fixed order at the end.
template <int NT>
constexpr int kSets = NT == 1 ? 3 : NT == 2 ? 2 : 1;

// acc += S . W_k for the warp's m16 tile; bk is tap k's B fragments. Per k
// step each of the three split products runs over the n tiles in turn.
template <typename T, int C, int NT>
__device__ __forceinline__ void contract(float (&acc)[kSets<NT>][NT][4], const Operand<T, C>& a,
                                         const unsigned* bk, int lane) {
  using F = Frag<T, C>;
  constexpr int kS = kSets<NT>;  // product p into set p * kS / 3
#pragma unroll
  for (int st = 0; st < F::kSteps; ++st) {
    if constexpr (sizeof(T) == 4) {
      unsigned bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 bv = *reinterpret_cast<const uint2*>(bk + ((st * NT + nt) * 32 + lane) * 2);
        const Split<2> b({__uint_as_float(bv.x), __uint_as_float(bv.y)});
        bh[nt][0] = b.hi[0], bh[nt][1] = b.hi[1], bl[nt][0] = b.lo[0], bl[nt][1] = b.lo[1];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) dcn::mma_tf32(acc[0][nt], a.lo[st], bh[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) dcn::mma_tf32(acc[kS / 3][nt], a.hi[st], bl[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) dcn::mma_tf32(acc[2 * kS / 3][nt], a.hi[st], bh[nt]);
    } else {
      constexpr int kW = C / 8;
      const AFrag<F::kK, kW> ah(a.hi[0], a.hi[1], st), al(a.lo[0], a.lo[1], st);
      BFrag<F::kK> b[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) b[nt].load(bk + ((st * NT + nt) * 32 + lane) * F::kBw);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[0][nt], al.r, b[nt].hi);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[kS / 3][nt], ah.r, b[nt].lo);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[2 * kS / 3][nt], ah.r, b[nt].hi);
    }
  }
}

// The staged box of x: rows [y0, y0 + h), columns [x0, x0 + w), all on the
// image; whole when it holds every corner on the image that the tile's
// samples touch (not cut to capacity). A cut box may be empty (h = 0) when
// the corners lie far from the tile.
struct Box {
  int y0, x0, h, w;
  bool whole;
};

// One pixel's bilinear sample for one tap: the corner weights times the
// mask (zero for a corner off the image, and for a pixel off the image) and
// the floor corner, packed (y0 << 16 | x0 & 0xffff: both lie in [-2, size +
// 1], or y0 = -30000 for a pixel off the image; the wrappers take H, W <=
// 32766, so x0 fits 16 bits).
struct Tap {
  float w00, w01, w10, w11;
  int yx;
};
constexpr int kNoPixel = -30000 * 65536;

// Tap k at output pixel (oy, ox), without branches; off points at the
// pixel's column of the offsets (finite also for a pixel off the image):
// rows k (dy), 9 + k (dx), 18 + k (mask).
__device__ __forceinline__ Tap tap_at(const float* off, int k, int oy, int ox, int H, int W) {
  const bool in = oy < H && ox < W;
  const float m = off[(2 * kTaps + k) * kRow];
  const float py = (float)(oy + k / 3 - 1) + off[k * kRow];
  const float px = (float)(ox + k % 3 - 1) + off[(kTaps + k) * kRow];
  const float fy = floorf(py), fx = floorf(px);
  const float wy = py - fy, wx = px - fx;
  // Clamp before the int cast; anything beyond [-2, size+1] samples zero.
  const int y0 = (int)fminf(fmaxf(fy, -2.f), (float)H + 1.f);
  const int x0 = (int)fminf(fmaxf(fx, -2.f), (float)W + 1.f);
  const bool vy0 = in && y0 >= 0 && y0 < H, vy1 = in && y0 + 1 >= 0 && y0 + 1 < H;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
  return {(vy0 && vx0) ? (1.f - wx) * (1.f - wy) * m : 0.f, (vy0 && vx1) ? wx * (1.f - wy) * m : 0.f,
          (vy1 && vx0) ? (1.f - wx) * wy * m : 0.f, (vy1 && vx1) ? wx * wy * m : 0.f,
          in ? (int)((unsigned)y0 << 16 | ((unsigned)x0 & 0xffffu)) : kNoPixel};
}

// The tap of the pixel whose lane is src.
__device__ __forceinline__ Tap shfl(const Tap& p, int src) {
  return {__shfl_sync(0xffffffffu, p.w00, src), __shfl_sync(0xffffffffu, p.w01, src),
          __shfl_sync(0xffffffffu, p.w10, src), __shfl_sync(0xffffffffu, p.w11, src),
          __shfl_sync(0xffffffffu, p.yx, src)};
}

// s = this thread's N channels (from c0) of a tap's sample. WHOLE (the box
// holds every corner on the image; it is not empty): all four corners from
// the box, without branches (a corner off the image has weight zero and
// reads the nearest cell). Else each corner of weight from the box where it
// lies in it, from x in device memory where not.
template <bool WHOLE, typename T, int N, int CELL>
__device__ __forceinline__ void sample(float (&s)[N], const Tap& tp, const Box& box, const T* cells,
                                       const T* __restrict__ xn, int c0, int W, long long HW) {
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = 0.f;
  const int y0 = tp.yx >> 16, x0 = (int)(short)(tp.yx & 0xffff);
  if constexpr (WHOLE) {
    const int r0 = min(max(y0 - box.y0, 0), box.h - 1), r1 = min(max(y0 + 1 - box.y0, 0), box.h - 1);
    const int q0 = min(max(x0 - box.x0, 0), box.w - 1), q1 = min(max(x0 + 1 - box.x0, 0), box.w - 1);
    const T* p = cells + c0;
    add_values<T, N>(s, p + (r0 * box.w + q0) * CELL, tp.w00);
    add_values<T, N>(s, p + (r0 * box.w + q1) * CELL, tp.w01);
    add_values<T, N>(s, p + (r1 * box.w + q0) * CELL, tp.w10);
    add_values<T, N>(s, p + (r1 * box.w + q1) * CELL, tp.w11);
  } else {
    const auto corner = [&](int y, int x, float wgt) {
      if (wgt == 0.f) return;  // off the image, or no weight
      const int cy = y - box.y0, cx = x - box.x0;
      if (cy >= 0 && cy < box.h && cx >= 0 && cx < box.w) {
        add_values<T, N>(s, cells + (cy * box.w + cx) * CELL + c0, wgt);
      } else {
        const T* g = xn + (long long)c0 * HW + (long long)y * W + x;
#pragma unroll
        for (int i = 0; i < N; ++i) s[i] = fmaf(wgt, dcn::load(g + i * HW), s[i]);
      }
    };
    corner(y0, x0, tp.w00);
    corner(y0, x0 + 1, tp.w01);
    corner(y0 + 1, x0, tp.w10);
    corner(y0 + 1, x0 + 1, tp.w11);
  }
}

// The warp's nine taps into acc (its m16 tile: pixels g and g + 8 of its
// 16). Each lane sets up the tap of pixel lane % 16 (off, oy, ox: its
// offsets and position); each thread takes the setups of its two pixels by
// shuffles and samples its channels of them. Software-pipelined: the next
// tap is sampled while this tap's products run on the tensor cores (the
// last turn samples tap 8 again).
template <bool WHOLE, typename T, int C, int NT, int CELL>
__device__ __forceinline__ void taps(float (&acc)[kSets<NT>][NT][4], const float* off, int oy, int ox, int H, int W,
                                     const Box& box, const T* cells, const T* __restrict__ xn, long long HW,
                                     const unsigned* s_w, int lane) {
  using F = Frag<T, C>;
  constexpr int kCt = C / 4;
  const int g = lane >> 2, t = lane & 3;
  float s[2][kCt];
  const auto take = [&](int k) {
    const Tap mine = tap_at(off, k, oy, ox, H, W);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sample<WHOLE, T, kCt, CELL>(s[h], shfl(mine, h * 8 + g), box, cells, xn, t * kCt, W, HW);
  };
  take(0);
#pragma unroll 1
  for (int k = 0; k < kTaps; ++k) {
    const Operand<T, C> a(s);
    take(min(k + 1, kTaps - 1));
    contract<T, C, NT>(acc, a, s_w + k * F::kSteps * NT * 32 * F::kBw, lane);
  }
}

// K1's offset conv for the warp's 16 pixels (tile row ty, columns x0 ..
// x0 + 15): off[r][col] (off points at the warp's first pixel) gets dy
// (rows 0-8), dx (9-17) and sigmoid(logit) (18-26). xt: the tile + 1 px,
// channels innermost.
template <int C, int CELL>
__device__ __forceinline__ void offset_conv(float* off, const __nv_bfloat16* xt, const unsigned* woff,
                                            const float* boff, int ty, int x0, int lane) {
  using F = Frag<__nv_bfloat16, C>;
  constexpr int kW = C / 8, kCt = C / 4;
  const int g = lane >> 2, t = lane & 3;
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 1
  for (int k = 0; k < kTaps; ++k) {
    unsigned a[2][kW];  // x of pixel g + 8h shifted by the tap: exact bf16 pairs
#pragma unroll
    for (int h = 0; h < 2; ++h)
      load_words<kW>(xt + ((ty + k / 3) * kXtX + x0 + h * 8 + g + k % 3) * CELL + t * kCt, a[h]);
#pragma unroll
    for (int st = 0; st < F::kSteps; ++st) {
      const AFrag<F::kK, kW> ax(a[0], a[1], st);
      BFrag<F::kK> b[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) b[nt].load(woff + (((k * F::kSteps + st) * 4 + nt) * 32 + lane) * F::kBw);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[nt], ax.r, b[nt].lo);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[nt], ax.r, b[nt].hi);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = nt * 8 + 2 * t + (e & 1), col = g + 8 * (e >> 1);
      if (j >= kOffCh) continue;
      const float v = acc[nt][e] + boff[j];
      if (j < 2 * kTaps) {
        off[((j & 1) ? kTaps + j / 2 : j / 2) * kRow + col] = v;
      } else {
        off[j * kRow + col] = 1.f / (1.f + expf(-v));
      }
    }
}

template <typename T, int C, int COUT, bool FUSED>
__global__ void __launch_bounds__(kThreads, 1) dcn_fwd_kernel(
    const T* __restrict__ x,           // [N, C, H, W]
    const float* __restrict__ woff,    // K1: [9*C, 27], row = tap*C + c
    const float* __restrict__ boff,    // K1: [27]
    const float* __restrict__ dy,      // K5: [N, 9, H, W]
    const float* __restrict__ dx,      // K5: [N, 9, H, W]
    const float* __restrict__ mask,    // K5: [N, 9, H, W]
    const float* __restrict__ w,       // [9*C, COUT], row = tap*C + c
    const float* __restrict__ bias,    // [COUT]
    T* __restrict__ out,               // [N, COUT, H, W]
    int N, int H, int W) {
  using S = Smem<T, C, COUT, FUSED>;
  constexpr int kNt = S::kNt, kCell = S::kCell;
  extern __shared__ __align__(16) float smem[];
  unsigned* s_w = reinterpret_cast<unsigned*>(smem + S::w);
  unsigned* s_woff = reinterpret_cast<unsigned*>(smem + S::woff);
  float* s_bias = smem + S::bias;
  float* s_boff = smem + S::boff;
  int* s_box = reinterpret_cast<int*>(smem + S::box);
  T* s_px = reinterpret_cast<T*>(smem + S::px);
  T* s_cells = reinterpret_cast<T*>(smem + S::cells);

  fill_b<T, C, kNt>(s_w, w, COUT);
  if constexpr (FUSED) fill_b<T, C, 4>(s_woff, woff, kOffCh);
  if (threadIdx.x < COUT) s_bias[threadIdx.x] = bias[threadIdx.x];
  if (FUSED && threadIdx.x < kOffCh) s_boff[threadIdx.x] = boff[threadIdx.x];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // Warp w: the 16 pixels of tile row w / 2 from column 16 (w % 2), one m16
  // tile; lane <-> pixel lane % 16 for the setups.
  const int wy = warp / 2, wx = warp % 2 * 16, wp = wy * kTileX + wx;
  const long long HW = (long long)H * W;
  const int tiles_y = (H + kTileY - 1) / kTileY, tiles_x = (W + kTileX - 1) / kTileX;
  const long long per_image = (long long)tiles_y * tiles_x;
  const long long tiles = N * per_image;
  const auto tile_of = [&](long long tt, int& n, int& ty0, int& tx0) {
    n = (int)(tt / per_image);
    const int r = (int)(tt - n * per_image);
    ty0 = (r / tiles_x) * kTileY;
    tx0 = (r % tiles_x) * kTileX;
  };

  // The next tile's input, copied while this one runs. K1: x around it,
  // planar, rows [ty0 - 1, ty0 + 9), columns [tx0 - 4, tx0 + 36), zero off
  // the image; copies of four values where they lie whole on the image and
  // x's rows are aligned to them, the rest written here. K5: its 27 offset
  // and mask planes, rows [dy 0-8 | dx 0-8 | mask 0-8] of an offsets array.
  const bool x_quads = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  const bool off_quads = W % 4 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(dx) % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  const auto prefetch = [&](long long tt, float* s_off_next) {
    int n, ty0, tx0;
    tile_of(tt, n, ty0, tx0);
    if constexpr (FUSED) {
      const T* xn = x + (long long)n * C * HW;
      for (int i = threadIdx.x; i < C * kXtY * (kPx / 4); i += kThreads) {
        const int row = i / (kPx / 4), quad = i - row * (kPx / 4);  // row over (c, y)
        const int c = row / kXtY, cy = ty0 - 1 + row % kXtY, cx = tx0 - 4 + 4 * quad;
        T* d = s_px + row * kPx + 4 * quad;
        const T* src = xn + (long long)c * HW + (long long)cy * W + cx;
        const bool row_in = cy >= 0 && cy < H;
        if (row_in && x_quads && cx >= 0 && cx + 4 <= W) {
          copy_async<4 * sizeof(T)>(d, src, 4 * sizeof(T));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) d[e] = row_in && cx + e >= 0 && cx + e < W ? src[e] : T(0.f);
        }
      }
    } else {
      for (int i = threadIdx.x; i < kOffCh * kTileY * (kTileX / 4); i += kThreads) {
        const int quad = i % (kTileX / 4), r = i / (kTileX / 4) % kTileY, j = i / (kTileX / 4) / kTileY;
        const float* plane = (j < kTaps ? dy : j < 2 * kTaps ? dx : mask) + ((long long)n * kTaps + j % kTaps) * HW;
        const int oy = ty0 + r, ox = tx0 + 4 * quad;
        float* d = s_off_next + j * kRow + r * kTileX + 4 * quad;
        const float* src = plane + (long long)oy * W + ox;
        if (oy < H && off_quads && ox + 4 <= W) {
          copy_async<16>(d, src, 16);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool in = oy < H && ox + e < W;
            copy_async<4>(d + e, in ? src + e : plane, in ? 4 : 0);
          }
        }
      }
    }
  };

  float* s_off_base = smem + S::off;
  int buf = 0;
  if (blockIdx.x < tiles) prefetch(blockIdx.x, s_off_base);

  for (long long tt = blockIdx.x; tt < tiles; tt += gridDim.x) {
    int n, ty0, tx0;
    tile_of(tt, n, ty0, tx0);
    float* s_off = s_off_base + buf * S::kRows * kRow;
    const T* xn = x + (long long)n * C * HW;
    const bool more = tt + gridDim.x < tiles;
    copy_async_wait();  // this tile's input, copied during the last one
    if (threadIdx.x == 0) {
      s_box[0] = INT_MAX;
      s_box[1] = INT_MIN;
      s_box[2] = INT_MAX;
      s_box[3] = INT_MIN;
    }
    __syncthreads();

    // 1. The offsets, into s_off.
    if constexpr (FUSED) {
      // x around the tile, channels innermost, into the cells' space.
      constexpr int kE = 8;  // bf16 channels per 16-byte chunk
      const unsigned short* px16 = reinterpret_cast<const unsigned short*>(s_px);
      for (int i = threadIdx.x; i < kXtY * kXtX * (C / kE); i += kThreads) {
        const int q = i / (kXtY * kXtX), cell = i - q * (kXtY * kXtX);
        const int r = cell / kXtX, c = cell - r * kXtX;
        const unsigned short* src = px16 + (q * kE * kXtY + r) * kPx + c + 3;
        unsigned u[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          u[e] = (unsigned)src[2 * e * kXtY * kPx] | ((unsigned)src[(2 * e + 1) * kXtY * kPx] << 16);
        *reinterpret_cast<uint4*>(s_cells + cell * kCell + q * kE) = make_uint4(u[0], u[1], u[2], u[3]);
      }
      __syncthreads();
      if (more) prefetch(tt + gridDim.x, nullptr);
      offset_conv<C, kCell>(s_off + wp, s_cells, s_woff, s_boff, wy, wx, lane);
      __syncwarp();
    } else {
      if (more) prefetch(tt + gridDim.x, s_off_base + (buf ^ 1) * S::kRows * kRow);
    }

    // 2. The box the tile's corners span on the image: over the lane's
    // pixel and every other tap (from lane / 16), then over the warp and the
    // block.
    const int oy = ty0 + wy, ox = tx0 + wx + lane % 16;
    const float* off = s_off + wp + lane % 16;  // the lane's pixel's offsets
    {
      int ymin = INT_MAX, ymax = INT_MIN, xmin = INT_MAX, xmax = INT_MIN;
      if (oy < H && ox < W) {
#pragma unroll
        for (int k = lane / 16; k < kTaps; k += 2) {
          const float py = (float)(oy + k / 3 - 1) + off[k * kRow];
          const float px = (float)(ox + k % 3 - 1) + off[(kTaps + k) * kRow];
          const int y0 = (int)fminf(fmaxf(floorf(py), -2.f), (float)H + 1.f);
          const int x0 = (int)fminf(fmaxf(floorf(px), -2.f), (float)W + 1.f);
          const int ylo = max(y0, 0), yhi = min(y0 + 1, H - 1);
          const int xlo = max(x0, 0), xhi = min(x0 + 1, W - 1);
          if (ylo <= yhi && xlo <= xhi) {
            ymin = min(ymin, ylo);
            ymax = max(ymax, yhi);
            xmin = min(xmin, xlo);
            xmax = max(xmax, xhi);
          }
        }
      }
      ymin = __reduce_min_sync(0xffffffffu, ymin);
      ymax = __reduce_max_sync(0xffffffffu, ymax);
      xmin = __reduce_min_sync(0xffffffffu, xmin);
      xmax = __reduce_max_sync(0xffffffffu, xmax);
      if (lane == 0) {
        atomicMin(s_box, ymin);
        atomicMax(s_box + 1, ymax);
        atomicMin(s_box + 2, xmin);
        atomicMax(s_box + 3, xmax);
      }
    }
    __syncthreads();

    // The box, cut to capacity if need be: the tile widened by e on each
    // side, for the largest e that fits (e = 0, the tile, always does).
    // (No corner on the image at all: an empty box.)
    const bool none = s_box[0] > s_box[1];
    Box box{s_box[0], s_box[2], none ? 0 : s_box[1] - s_box[0] + 1, none ? 0 : s_box[3] - s_box[2] + 1, true};
    if (box.h * box.w > S::kCells) {
      const int ry1 = s_box[1], rx1 = s_box[3];
      for (int e = 0;; ++e) {
        const int y0 = max(s_box[0], ty0 - e), y1 = min(ry1, ty0 + kTileY - 1 + e);
        const int x0 = max(s_box[2], tx0 - e), x1 = min(rx1, tx0 + kTileX - 1 + e);
        const int h = max(y1 - y0 + 1, 0), wd = max(x1 - x0 + 1, 0);
        if (e > 0 && h * wd > S::kCells) break;
        box = Box{y0, x0, h, wd, false};
      }
    }
    {
      // Item i: chunk q (16 bytes of channels) of cell i % area; a batch of
      // kBatch items per thread is loaded before any is stored.
      constexpr int kE = 16 / (int)sizeof(T), kChunks = C / kE, kBatch = 8;
      const int area = box.h * box.w;
      for (int i0 = threadIdx.x; i0 < area * kChunks; i0 += kBatch * kThreads) {
        uint4 v[kBatch];
        int at[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int i = i0 + b * kThreads;
          at[b] = -1;
          if (i < area * kChunks) {
            const int q = i / area, cell = i - q * area, cy = cell / box.w, cx = cell - cy * box.w;
            v[b] = gather_chunk(xn + (long long)(q * kE) * HW + (long long)(box.y0 + cy) * W + box.x0 + cx, HW);
            at[b] = cell * kCell + q * kE;
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (at[b] >= 0) *reinterpret_cast<uint4*>(s_cells + at[b]) = v[b];
      }
    }
    __syncthreads();

    // 3. The taps (none if no corner of the tile lies on the image: then
    // every sample is zero). A cut box, even an empty one, takes the
    // branching sampler, which gathers the corners outside it from x.
    float acc[kSets<kNt>][kNt][4];
#pragma unroll
    for (int i = 0; i < kSets<kNt>; ++i)
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) acc[i][nt][0] = acc[i][nt][1] = acc[i][nt][2] = acc[i][nt][3] = 0.f;
    if (box.whole && !none) {
      taps<true, T, C, kNt, kCell>(acc, off, oy, ox, H, W, box, s_cells, xn, HW, s_w, lane);
    } else if (!none) {
      taps<false, T, C, kNt, kCell>(acc, off, oy, ox, H, W, box, s_cells, xn, HW, s_w, lane);
    }

    // 4. Bias, one rounding, coalesced rows of 16 pixels per output channel
    // (staged in the warp's own columns of s_off).
    __syncwarp();
    float* stage = s_off + wp;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = nt * 8 + 2 * t + (e & 1), col = g + 8 * (e >> 1);
        float v = acc[0][nt][e];
#pragma unroll
        for (int i = 1; i < kSets<kNt>; ++i) v += acc[i][nt][e];
        stage[o * kRow + col] = v + s_bias[o];
      }
    __syncwarp();
    if (oy < H && ox < W) {
      T* dst = out + (long long)n * COUT * HW + (long long)oy * W + ox;
#pragma unroll 8
      for (int o = lane / 16; o < COUT; o += 2) store(dst + o * HW, stage[o * kRow + lane % 16]);
    }
    if constexpr (!FUSED) buf ^= 1;
  }
}

template <typename T, int C, int COUT, bool FUSED>
cudaError_t launch(const void* x, const void* woff, const void* boff, const void* dy, const void* dx,
                   const void* mask, const void* w, const void* bias, void* out, int N, int H, int W,
                   cudaStream_t stream) {
  const auto kernel = dcn_fwd_kernel<T, C, COUT, FUSED>;
  constexpr size_t smem = Smem<T, C, COUT, FUSED>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (long long)N * ((H + kTileY - 1) / kTileY) * ((W + kTileX - 1) / kTileX);
  const long long fit = (long long)sms * per_sm;
  const unsigned blocks = (unsigned)(tiles < fit ? tiles : fit);
  if (blocks == 0) return cudaSuccess;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(woff), static_cast<const float*>(boff),
      static_cast<const float*>(dy), static_cast<const float*>(dx), static_cast<const float*>(mask),
      static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<T*>(out), N, H, W);
  return cudaGetLastError();
}

// The instantiation for (C, C_out), each in {8, 16, 32}.
template <typename T, bool FUSED>
cudaError_t dispatch(int C, int COUT, const void* x, const void* woff, const void* boff, const void* dy,
                     const void* dx, const void* mask, const void* w, const void* bias, void* out, int N,
                     int H, int W, cudaStream_t s) {
#define DCN_FWD_CASE(c, co)                                                                        \
  if (C == c && COUT == co)                                                                        \
    return launch<T, c, co, FUSED>(x, woff, boff, dy, dx, mask, w, bias, out, N, H, W, s);
  DCN_FWD_CASE(8, 8) DCN_FWD_CASE(8, 16) DCN_FWD_CASE(8, 32)
  DCN_FWD_CASE(16, 8) DCN_FWD_CASE(16, 16) DCN_FWD_CASE(16, 32)
  DCN_FWD_CASE(32, 8) DCN_FWD_CASE(32, 16) DCN_FWD_CASE(32, 32)
#undef DCN_FWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace dcn_fwd
