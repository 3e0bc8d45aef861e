// Bilinear crop-resize of K boxes, gathered straight from the uint8 image.
//
// Replaces the TPU kernel `_crop_kernel` / `pallas_crop_resize`
// (omniparser_tpu/ops/pallas_crop.py).  That kernel needs a planar float
// copy of the image, fixed-point box metadata in scalar memory, 16-row
// bands copied per output row and a two-hot weight matrix so that the
// column interpolation becomes a matrix product: all answers to the TPU's
// tiling rules.  None applies here.  Each thread owns one output pixel,
// computes its source coordinate from the box, reads its four taps (3
// bytes each) from the interleaved uint8 image and writes three floats.
//
// What bounds it on this card: bytes.  The output, K*out_h*out_w*3 floats
// (6.3 MB for 128 caption crops of 64x64), is written once, contiguous per
// thread; the source pixels under the boxes are read through L2 and are
// at most the image itself.  Arithmetic is a few dozen operations a pixel.
//
// Sampling, exactly as the plain version (`resize_grid`, `line_grid`,
// `_bilinear_gather`): crop bounds truncated to integers, width and height
// at least 1; half-pixel centres; the coordinate is clamped inside the
// crop BEFORE the shift by the crop's origin, then inside the unpadded
// image.  mode 0 stretches the box to the patch (caption crops); mode 1
// keeps the aspect ratio with one scale s = max(ch/out_h, cw/out_w),
// left-anchored and vertically centred (OCR line crops).

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__global__ void crop_resize_kernel(const uint8_t* __restrict__ img,
                                   const float* __restrict__ boxes,
                                   float* __restrict__ out, int img_h, int img_w,
                                   int orig_h, int orig_w, int out_h, int out_w,
                                   int mode) {
  const int k = blockIdx.x;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  if (p >= out_h * out_w) return;
  const int r = p / out_w;
  const int c = p - r * out_w;
  const float h = (float)orig_h;
  const float w = (float)orig_w;
  const float* bx = boxes + (size_t)k * 4;
  const float x1 = truncf(bx[0] * w);
  const float y1 = truncf(bx[1] * h);
  const float x2 = truncf(bx[2] * w);
  const float y2 = truncf(bx[3] * h);
  const float cw = fmaxf(x2 - x1, 1.0f);
  const float ch = fmaxf(y2 - y1, 1.0f);
  float js, is;
  if (mode == 0) {
    js = ((float)c + 0.5f) * (cw / (float)out_w) - 0.5f;
    is = ((float)r + 0.5f) * (ch / (float)out_h) - 0.5f;
  } else {
    const float s = fmaxf(ch / (float)out_h, cw / (float)out_w);
    const float off_y = ((float)out_h - ch / s) / 2.0f;
    is = (((float)r - off_y) + 0.5f) * s - 0.5f;
    js = ((float)c + 0.5f) * s - 0.5f;
  }
  float xs = x1 + clampf(js, 0.0f, fmaxf(cw - 1.0f, 0.0f));
  float ys = y1 + clampf(is, 0.0f, fmaxf(ch - 1.0f, 0.0f));
  xs = clampf(xs, 0.0f, w - 1.0f);
  ys = clampf(ys, 0.0f, h - 1.0f);
  const float x0f = floorf(xs);
  const float y0f = floorf(ys);
  const float fx = xs - x0f;
  const float fy = ys - y0f;
  const int x0 = min(max((int)x0f, 0), img_w - 1);
  const int xb = min(x0 + 1, img_w - 1);
  const int y0 = min(max((int)y0f, 0), img_h - 1);
  const int yb = min(y0 + 1, img_h - 1);
  const uint8_t* p00 = img + ((size_t)y0 * img_w + x0) * 3;
  const uint8_t* p01 = img + ((size_t)y0 * img_w + xb) * 3;
  const uint8_t* p10 = img + ((size_t)yb * img_w + x0) * 3;
  const uint8_t* p11 = img + ((size_t)yb * img_w + xb) * 3;
  float* o = out + (((size_t)k * out_h + r) * out_w + c) * 3;
#pragma unroll
  for (int ch3 = 0; ch3 < 3; ++ch3) {
    const float top = (float)p00[ch3] * (1.0f - fx) + (float)p01[ch3] * fx;
    const float bot = (float)p10[ch3] * (1.0f - fx) + (float)p11[ch3] * fx;
    o[ch3] = top * (1.0f - fy) + bot * fy;
  }
}

// img [img_h,img_w,3] uint8; boxes [k,4] float32 normalised xyxy; out
// [k,out_h,out_w,3] float32.
extern "C" int crop_resize_launch(const void* img, const void* boxes, void* out,
                                  int k, int img_h, int img_w, int orig_h,
                                  int orig_w, int out_h, int out_w, int mode,
                                  void* stream) {
  if (k <= 0) return 0;
  const int threads = 256;
  dim3 grid(k, (out_h * out_w + threads - 1) / threads);
  crop_resize_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (const float*)boxes, (float*)out, img_h, img_w,
      orig_h, orig_w, out_h, out_w, mode);
  return (int)cudaGetLastError();
}
