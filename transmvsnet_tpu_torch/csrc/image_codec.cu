// JPEG decode and encode through nvJPEG, for the image readers and writers
// of data/image_io.py on a machine that has neither libjpeg's Python
// bindings (cv2, PIL) nor torchvision.
//
// Replaces no TPU kernel: the JAX package decodes and encodes JPEGs with
// PIL and cv2 on the host. This file holds no kernel of its own; it is a
// plain C interface over the CUDA toolkit's libnvjpeg (linked with
// -lnvjpeg, see ops/cuda/build.py), loaded with ctypes like the kernels.
//
// - Decode: a baseline or progressive JPEG to interleaved RGB uint8 in
//   device memory (NVJPEG_OUTPUT_RGBI: already RGB, no channel swap), the
//   chroma interpolated as libjpeg's default upsampling does. Huffman
//   decoding runs on the host, the IDCT, upsampling and colour conversion
//   on the card. They are not libjpeg's: a decode differs from PIL's or
//   cv2's by under a level on average (half a level darker), a few at
//   most.
// - Encode: Y, Cb and Cr planes in device memory, 4:2:0, to a baseline
//   JPEG at cv2.imwrite's defaults (quality 95, standard Huffman tables),
//   copied into a host buffer.
//
// One nvJPEG handle, one decode state and one encoder state serve every
// caller; a mutex serialises the calls, which the data loader makes from
// several threads. Each call synchronises its stream before it returns, so
// the state is free for the next caller and the host buffers may be freed.
// Returns 0 on success, a cudaError_t code, or NVJPEG_CODE_BASE plus an
// nvjpegStatus_t code.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstring>
#include <mutex>

namespace {

constexpr int NVJPEG_CODE_BASE = 1000;
constexpr int BUFFER_TOO_SMALL = 2000;

std::mutex codec_mutex;
nvjpegHandle_t handle = nullptr;
nvjpegJpegState_t decode_state = nullptr;
nvjpegEncoderState_t encode_state = nullptr;
nvjpegEncoderParams_t encode_params = nullptr;

int status_code(nvjpegStatus_t s) { return s == NVJPEG_STATUS_SUCCESS ? 0 : NVJPEG_CODE_BASE + (int)s; }

// Creates the handle and decode state on first use; the caller holds the mutex.
int ensure_decoder() {
  if (handle == nullptr) {
    // Chroma interpolated, as libjpeg's default ("fancy") upsampling does;
    // nvJPEG's default replicates it, 5 levels off libjpeg on average on
    // the 4:2:0 test fixture against 0.7 interpolated.
    int code = status_code(nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT, nullptr, nullptr,
                                          NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION, &handle));
    if (code) {
      handle = nullptr;
      return code;
    }
  }
  if (decode_state == nullptr) {
    int code = status_code(nvjpegJpegStateCreate(handle, &decode_state));
    if (code) {
      decode_state = nullptr;
      return code;
    }
  }
  return 0;
}

int ensure_encoder(cudaStream_t stream) {
  int code = ensure_decoder();
  if (code) return code;
  if (encode_state == nullptr) {
    code = status_code(nvjpegEncoderStateCreate(handle, &encode_state, stream));
    if (code) {
      encode_state = nullptr;
      return code;
    }
  }
  if (encode_params == nullptr) {
    code = status_code(nvjpegEncoderParamsCreate(handle, &encode_params, stream));
    if (code) {
      encode_params = nullptr;
      return code;
    }
  }
  return 0;
}

}  // namespace

// Width, height and number of colour components of a JPEG in host memory.
extern "C" int image_codec_jpeg_info(const unsigned char* data, size_t length, int* width, int* height,
                                     int* components) {
  std::lock_guard<std::mutex> lock(codec_mutex);
  int code = ensure_decoder();
  if (code) return code;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t subsampling;
  code = status_code(nvjpegGetImageInfo(handle, data, length, components, &subsampling, widths, heights));
  if (code) return code;
  *width = widths[0];
  *height = heights[0];
  return 0;
}

// Decodes the JPEG in host memory into out, [height, width, 3] RGB uint8 on
// the card (width and height as image_codec_jpeg_info gave them).
extern "C" int image_codec_jpeg_decode(const unsigned char* data, size_t length, unsigned char* out,
                                       int width, int height, void* stream) {
  (void)height;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  std::lock_guard<std::mutex> lock(codec_mutex);
  int code = ensure_decoder();
  if (code) return code;
  nvjpegImage_t dst;
  std::memset(&dst, 0, sizeof(dst));
  dst.channel[0] = out;
  dst.pitch[0] = (size_t)width * 3;
  code = status_code(nvjpegDecode(handle, decode_state, data, length, NVJPEG_OUTPUT_RGBI, &dst, s));
  if (code) return code;
  return (int)cudaStreamSynchronize(s);
}

// Encodes an image given as libjpeg's colour conversion and 4:2:0
// downsampling leave it (data/image_io.py computes both on the card: Y
// [height, width], Cb and Cr [ceil(height/2), ceil(width/2)], uint8, each
// plane contiguous) as a baseline JPEG at the given quality into out (host
// memory of capacity bytes); *length receives the JPEG's size. Returns
// BUFFER_TOO_SMALL with *length set when the JPEG does not fit. nvJPEG's
// own RGB input path converts colour otherwise: R and B came out ~2 levels
// darker than libjpeg's encode of the same image.
extern "C" int image_codec_jpeg_encode(const unsigned char* y, const unsigned char* cb, const unsigned char* cr,
                                       int width, int height, int quality, unsigned char* out, size_t capacity,
                                       size_t* length, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  std::lock_guard<std::mutex> lock(codec_mutex);
  int code = ensure_encoder(s);
  if (code) return code;
  if ((code = status_code(nvjpegEncoderParamsSetQuality(encode_params, quality, s)))) return code;
  if ((code = status_code(nvjpegEncoderParamsSetSamplingFactors(encode_params, NVJPEG_CSS_420, s))))
    return code;
  if ((code = status_code(nvjpegEncoderParamsSetOptimizedHuffman(encode_params, 0, s)))) return code;
  nvjpegImage_t src;
  std::memset(&src, 0, sizeof(src));
  src.channel[0] = const_cast<unsigned char*>(y);
  src.channel[1] = const_cast<unsigned char*>(cb);
  src.channel[2] = const_cast<unsigned char*>(cr);
  src.pitch[0] = (size_t)width;
  src.pitch[1] = src.pitch[2] = (size_t)(width + 1) / 2;
  code = status_code(nvjpegEncodeYUV(handle, encode_state, encode_params, &src, NVJPEG_CSS_420, width, height, s));
  if (code) return code;
  size_t size = 0;
  if ((code = status_code(nvjpegEncodeRetrieveBitstream(handle, encode_state, nullptr, &size, s))))
    return code;
  if ((code = (int)cudaStreamSynchronize(s))) return code;
  *length = size;
  if (size > capacity) return BUFFER_TOO_SMALL;
  if ((code = status_code(nvjpegEncodeRetrieveBitstream(handle, encode_state, out, &size, s)))) return code;
  *length = size;
  return (int)cudaStreamSynchronize(s);
}

extern "C" const char* image_codec_error_string(int code) {
  if (code == BUFFER_TOO_SMALL) return "the encoded JPEG exceeds the output buffer";
  if (code >= NVJPEG_CODE_BASE) {
    switch (code - NVJPEG_CODE_BASE) {
      case NVJPEG_STATUS_NOT_INITIALIZED: return "nvJPEG: not initialized";
      case NVJPEG_STATUS_INVALID_PARAMETER: return "nvJPEG: invalid parameter";
      case NVJPEG_STATUS_BAD_JPEG: return "nvJPEG: bad JPEG";
      case NVJPEG_STATUS_JPEG_NOT_SUPPORTED: return "nvJPEG: JPEG not supported";
      case NVJPEG_STATUS_ALLOCATOR_FAILURE: return "nvJPEG: allocator failure";
      case NVJPEG_STATUS_EXECUTION_FAILED: return "nvJPEG: execution failed";
      case NVJPEG_STATUS_ARCH_MISMATCH: return "nvJPEG: architecture mismatch";
      case NVJPEG_STATUS_INTERNAL_ERROR: return "nvJPEG: internal error";
      case NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED: return "nvJPEG: implementation not supported";
      default: return "nvJPEG: unknown status";
    }
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
