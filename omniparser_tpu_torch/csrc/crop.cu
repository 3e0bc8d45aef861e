// Bilinear crop-resize of K boxes, gathered straight from the uint8 image.
//
// Replaces the TPU kernel `_crop_kernel` / `pallas_crop_resize`
// (omniparser_tpu/ops/pallas_crop.py).  That kernel needs a planar float
// copy of the image, fixed-point box metadata in scalar memory, 16-row
// bands copied per output row and a two-hot weight matrix so that the
// column interpolation becomes a matrix product: all answers to the TPU's
// tiling rules.  None applies here.
//
// What bounds it on this card: bytes.  The output, K*out_h*out_w*3 floats
// (6.3 MB for 128 caption crops of 64x64), is written once; the source
// pixels under the boxes are read once, at most 2*out_h rows by 2*out_w
// columns of them per box.  Arithmetic is a few operations an output float.
//
// One kernel for every shape: each thread makes two output pixels of one
// box, neighbouring lanes on neighbouring pixels, so a warp's tap loads
// fall on a few cache lines and its stores on one contiguous run.  Each
// pixel reads its four taps (3 bytes each) and turns the bytes into floats
// by an integer OR and one subtraction, exact, off the slow conversion
// unit.  Designs that stage tap rows or tap columns in shared memory per
// (box, band of rows), reuse a tap row across output rows, or write bands
// with 16-byte or bulk stores all measured slower on the H100 at the main
// path's shapes (scripts/crop_band_variants.cu, timed by
// scripts/kernel_variants.py; PERF.md): at 6 us a launch the per-block
// chain of loads and barriers costs more than the loads it saves.
//
// Sampling, exactly as the plain version (`resize_grid`, `line_grid`,
// `_bilinear_gather`): crop bounds truncated to integers, width and height
// at least 1; half-pixel centres; the coordinate is clamped inside the
// crop BEFORE the shift by the crop's origin, then inside the unpadded
// image; top and bottom along x first, then along y.  mode 0 stretches the
// box to the patch (caption crops); mode 1 keeps the aspect ratio with one
// scale s = max(ch/out_h, cw/out_w), left-anchored and vertically centred
// (OCR line crops).  Compiled with -fmad=false, so every product and sum
// rounds as PyTorch's elementwise kernels round them.

#include <cuda_runtime.h>
#include <stdint.h>

#define CROP_THREADS 128
#define CROP_PIXELS 2  // output pixels a thread

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// One box's crop in source pixels and its sampling rule.
struct Crop {
  float x1, y1, cw, ch, sx, sy, off_y;  // sx, sy: source pixels per output pixel
};

__device__ __forceinline__ Crop crop_of(const float* __restrict__ bx, float h, float w,
                                        int out_h, int out_w, int mode) {
  Crop g;
  g.x1 = truncf(bx[0] * w);
  g.y1 = truncf(bx[1] * h);
  const float x2 = truncf(bx[2] * w);
  const float y2 = truncf(bx[3] * h);
  g.cw = fmaxf(x2 - g.x1, 1.0f);
  g.ch = fmaxf(y2 - g.y1, 1.0f);
  g.sx = g.cw / (float)out_w;
  g.sy = g.ch / (float)out_h;
  g.off_y = 0.0f;
  if (mode != 0) {
    g.sx = g.sy = fmaxf(g.sy, g.sx);
    g.off_y = ((float)out_h - g.ch / g.sx) / 2.0f;
  }
  return g;
}

// Source x of output column c, clamped as the plain version clamps it.
__device__ __forceinline__ float src_x(const Crop& g, int c, float w) {
  const float js = ((float)c + 0.5f) * g.sx - 0.5f;
  return clampf(g.x1 + clampf(js, 0.0f, fmaxf(g.cw - 1.0f, 0.0f)), 0.0f, w - 1.0f);
}

__device__ __forceinline__ float src_y(const Crop& g, int r, float h) {
  const float is = (((float)r - g.off_y) + 0.5f) * g.sy - 0.5f;
  return clampf(g.y1 + clampf(is, 0.0f, fmaxf(g.ch - 1.0f, 0.0f)), 0.0f, h - 1.0f);
}

// A byte as float, exactly, without the conversion unit: 2^23 + b - 2^23.
__device__ __forceinline__ float u8f(unsigned b) {
  return __uint_as_float(0x4B000000u | b) - 8388608.0f;
}

// First tap index; the second is min(first + 1, size - 1).
__device__ __forceinline__ int tap0(float v, int size) {
  return min(max((int)floorf(v), 0), size - 1);
}

// Two pixels a thread, 256 a block (pixels p and p + 128 of the block's
// run): their loads are independent and go out together, and the box's
// geometry is computed once for both.
__global__ void __launch_bounds__(CROP_THREADS)
    crop_resize_kernel(const uint8_t* __restrict__ img, const float* __restrict__ boxes,
                       float* __restrict__ out, int img_h, int img_w, int orig_h, int orig_w,
                       int out_h, int out_w, int mode) {
  const int k = blockIdx.x;
  const float h = (float)orig_h;
  const float w = (float)orig_w;
  const Crop g = crop_of(boxes + (size_t)k * 4, h, w, out_h, out_w, mode);
#pragma unroll
  for (int j = 0; j < CROP_PIXELS; ++j) {
    const int p = (blockIdx.y * CROP_PIXELS + j) * CROP_THREADS + threadIdx.x;
    if (p >= out_h * out_w) break;
    const int r = p / out_w;
    const int c = p - r * out_w;
    const float xs = src_x(g, c, w);
    const float ys = src_y(g, r, h);
    const float fx = xs - floorf(xs);
    const float fy = ys - floorf(ys);
    const int x0 = tap0(xs, img_w), xb = min(x0 + 1, img_w - 1);
    const int y0 = tap0(ys, img_h), yb = min(y0 + 1, img_h - 1);
    const uint8_t* p00 = img + ((size_t)y0 * img_w + x0) * 3;
    const uint8_t* p01 = img + ((size_t)y0 * img_w + xb) * 3;
    const uint8_t* p10 = img + ((size_t)yb * img_w + x0) * 3;
    const uint8_t* p11 = img + ((size_t)yb * img_w + xb) * 3;
    float* o = out + (((size_t)k * out_h + r) * out_w + c) * 3;
#pragma unroll
    for (int ch3 = 0; ch3 < 3; ++ch3) {
      const float top = u8f(p00[ch3]) * (1.0f - fx) + u8f(p01[ch3]) * fx;
      const float bot = u8f(p10[ch3]) * (1.0f - fx) + u8f(p11[ch3]) * fx;
      o[ch3] = top * (1.0f - fy) + bot * fy;
    }
  }
}

// img [img_h,img_w,3] uint8; boxes [k,4] float32 normalised xyxy; out
// [k,out_h,out_w,3] float32; out_h*out_w <= 65535*256.
extern "C" int crop_resize_launch(const void* img, const void* boxes, void* out, int k,
                                  int img_h, int img_w, int orig_h, int orig_w, int out_h,
                                  int out_w, int mode, void* stream) {
  if (k <= 0) return 0;
  const int per_block = CROP_THREADS * CROP_PIXELS;
  dim3 grid(k, (out_h * out_w + per_block - 1) / per_block);
  crop_resize_kernel<<<grid, CROP_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (const float*)boxes, (float*)out, img_h, img_w, orig_h, orig_w, out_h,
      out_w, mode);
  return (int)cudaGetLastError();
}
