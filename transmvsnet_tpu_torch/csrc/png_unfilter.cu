// PNG row unfiltering on the host, for data/image_io.py's PNG decoder on
// the card's machine: DTU's training images and visibility masks are
// 1600x1200 PNGs, six per sample.
//
// Replaces no TPU kernel: the JAX package decodes PNGs with PIL, which the
// card's machine is not promised. The numpy decoder (image_io._unfilter,
// the plain version, kept for the CPU and the tests) has to walk the
// anti-diagonals, H + W numpy steps, because the Average and Paeth filters
// make each byte depend on its left neighbour: ~1 s per 1600x1200 image.
// This routine walks the bytes in order instead, one pass, no kernel.
//
// Host code and not a device kernel: the sample is assembled on the host
// (the /2 nearest resize and crop, the pyramids), so an unfilter on the
// card would add a host-device-host round trip per image; inflate stays in
// zlib. What bounds it is the serial chain of each channel along a row
// (Sub, Average and Paeth read the byte bpp to the left). The design keeps
// that chain in registers: the loop is instantiated per pixel size (1, 3,
// 4 bytes), so the left and up-left pixels never go through memory, where
// each byte would wait on the store of the one bpp before it. It keeps no
// state, so the data loader's threads call it at once (ctypes releases the
// interpreter lock for the call).
//
// png_unfilter(rows, height, stride, bpp, out): rows is [height, stride]
// uint8, each row its filter type (0-4) and then stride - 1 filtered
// bytes; out is [height, stride - 1], the unfiltered bytes; bpp is 1, 3 or
// 4. Returns 0, BAD_FILTER for a filter type above 4 (out then holds the
// rows before it) or BAD_BPP.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int BAD_FILTER = 1;
constexpr int BAD_BPP = 2;

// Paeth's predictor without branches: on noisy rows its choice is
// unpredictable, and a mispredicted branch per byte costs more than the
// arithmetic.
inline int paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  const int b_or_c = pb <= pc ? b : c;
  const int take_a = -((pa <= pb) & (pa <= pc));  // all ones or zero
  return (a & take_a) | (b_or_c & ~take_a);
}

// One row of filter TYPE (1 Sub, 3 Average, 4 Paeth; 0 and 2 need no left
// pixel). a and c hold the pixel to the left and the one above it, per
// channel, in registers (the loop over the BPP channels unrolls).
template <int BPP, int TYPE>
void unfilter_row(const uint8_t* src, const uint8_t* up, uint8_t* dst, long long n) {
  int a[BPP] = {}, c[BPP] = {};
  for (long long i = 0; i < n; i += BPP) {
    for (int k = 0; k < BPP; ++k) {
      const int b = up[i + k];
      const int pred = TYPE == 1 ? a[k] : TYPE == 3 ? (a[k] + b) >> 1 : paeth(a[k], b, c[k]);
      const int v = (src[i + k] + pred) & 255;
      dst[i + k] = (uint8_t)v;
      a[k] = v;
      c[k] = b;
    }
  }
}

template <int BPP>
int unfilter(const uint8_t* rows, long long height, long long stride, uint8_t* out) {
  const long long n = stride - 1;
  const std::vector<uint8_t> zero_row(n, 0);  // the row above the first
  for (long long y = 0; y < height; ++y) {
    const uint8_t* src = rows + y * stride + 1;
    uint8_t* dst = out + y * n;
    const uint8_t* up = y ? dst - n : zero_row.data();
    const int type = rows[y * stride];
    if (type == 0) {
      std::memcpy(dst, src, n);
    } else if (type == 2) {
      for (long long i = 0; i < n; ++i) dst[i] = (uint8_t)(src[i] + up[i]);
    } else if (type == 1) {
      unfilter_row<BPP, 1>(src, up, dst, n);
    } else if (type == 3) {
      unfilter_row<BPP, 3>(src, up, dst, n);
    } else if (type == 4) {
      unfilter_row<BPP, 4>(src, up, dst, n);
    } else {
      return BAD_FILTER;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

int png_unfilter(const uint8_t* rows, long long height, long long stride, int bpp, uint8_t* out) {
  if (stride < 1 || (stride - 1) % (bpp > 0 ? bpp : 1)) return BAD_BPP;
  switch (bpp) {
    case 1: return unfilter<1>(rows, height, stride, out);
    case 3: return unfilter<3>(rows, height, stride, out);
    case 4: return unfilter<4>(rows, height, stride, out);
    default: return BAD_BPP;
  }
}

const char* png_unfilter_error_string(int code) {
  switch (code) {
    case BAD_FILTER: return "PNG row filter type above 4";
    case BAD_BPP: return "PNG rows of 1, 3 or 4 bytes per pixel, whole pixels per row";
    default: return "unknown error";
  }
}

}  // extern "C"
