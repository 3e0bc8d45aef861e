// The crop-gather as one block per (box, band of output rows): the design
// that csrc/crop.cu was measured against and did not take.  Built only by
// scripts/kernel_variants.py, which times each variant beside the shipped
// kernel on one card and holds it to the shipped kernel bit for bit.
//
// A block makes R output rows of one box:
//  1. the box's geometry once; per output column its taps (x0, xb, fx) and
//     per output row (y0, yb, fy), into shared memory;
//  2. the 2R tap rows staged in shared memory: for a narrow box (taps
//     spanning at most 2*out_w pixels) the byte span [3*min x0, 3*(max xb+1))
//     of each image row, by 16-byte cp.async copies; for a wider box only the
//     pixels at each column's two taps (byte loads);
//  3. each pixel interpolated from shared memory, in the shipped kernel's
//     order and rounding (its helpers are included below);
//  4. the band written: straight from registers (STORE_DIRECT), or staged in
//     shared memory and written by 16-byte stores (STORE_VEC16) or by one
//     bulk shared-to-global copy (STORE_BULK).
//
// Takes what the shipped kernel takes where out_w <= 512, out_w % 4 == 0 and
// the image's byte count is a multiple of 16 (the two main-path grids).

#include "../omniparser_tpu_torch/csrc/crop.cu"

#define STORE_DIRECT 0
#define STORE_VEC16 1
#define STORE_BULK 2

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Shared memory layout of a block, in bytes from the start.
struct BandSmem {
  int pitch;  // bytes of one staged tap row
  int taps, obuf, cx0, cxb, cfx, ry0, ryb, rfy, shift, total;
};

__host__ __device__ inline BandSmem band_smem(int R, int out_w, int store) {
  BandSmem s;
  // a narrow span is at most 6*out_w bytes, plus up to 15 bytes of alignment
  // in front and 15 behind; a wide row holds 6 bytes a column
  s.pitch = 16 * ((6 * out_w + 15) / 16 + 2);
  s.taps = 0;
  s.obuf = s.taps + 2 * R * s.pitch;
  s.cx0 = s.obuf + (store == STORE_DIRECT ? 0 : R * out_w * 12);
  s.cxb = s.cx0 + 4 * out_w;
  s.cfx = s.cxb + 4 * out_w;
  s.ry0 = s.cfx + 4 * out_w;
  s.ryb = s.ry0 + 4 * R;
  s.rfy = s.ryb + 4 * R;
  s.shift = s.rfy + 4 * R;
  s.total = s.shift + 4 * 2 * R;
  return s;
}

template <int R, int THREADS, int STORE>
__global__ void __launch_bounds__(THREADS)
    crop_band_kernel(const uint8_t* __restrict__ img, const float* __restrict__ boxes,
                     float* __restrict__ out, int img_h, int img_w, int orig_h, int orig_w,
                     int out_h, int out_w, int mode) {
  extern __shared__ __align__(16) unsigned char sm[];
  const BandSmem L = band_smem(R, out_w, STORE);
  unsigned char* taps = sm + L.taps;
  float* obuf = (float*)(sm + L.obuf);
  int* cx0 = (int*)(sm + L.cx0);
  int* cxb = (int*)(sm + L.cxb);
  float* cfx = (float*)(sm + L.cfx);
  int* ry0 = (int*)(sm + L.ry0);
  int* ryb = (int*)(sm + L.ryb);
  float* rfy = (float*)(sm + L.rfy);
  int* shift = (int*)(sm + L.shift);
  const int tid = threadIdx.x;
  const int k = blockIdx.x, r0 = blockIdx.y * R;
  const int rows = min(R, out_h - r0);
  const float h = (float)orig_h, w = (float)orig_w;
  const Crop g = crop_of(boxes + (size_t)k * 4, h, w, out_h, out_w, mode);

  // 1. the separable grid
  for (int c = tid; c < out_w; c += THREADS) {
    const float xs = src_x(g, c, w);
    cfx[c] = xs - floorf(xs);
    const int x0 = tap0(xs, img_w);
    cx0[c] = x0;
    cxb[c] = min(x0 + 1, img_w - 1);
  }
  for (int r = tid; r < rows; r += THREADS) {
    const float ys = src_y(g, r0 + r, h);
    rfy[r] = ys - floorf(ys);
    const int y0 = tap0(ys, img_h);
    ry0[r] = y0;
    ryb[r] = min(y0 + 1, img_h - 1);
  }
  __syncthreads();

  // 2. the tap rows; taps are monotone in the column
  const int xlo = cx0[0], xhi = cxb[out_w - 1];
  const bool narrow = xhi - xlo + 1 <= 2 * out_w;
  if (narrow) {
    const int nvec = (3 * (xhi - xlo + 1) + 15) / 16 + 1;
    for (int i = tid; i < 2 * rows * nvec; i += THREADS) {
      const int q = i / nvec, v = i - q * nvec;
      const int y = (q & 1) ? ryb[q >> 1] : ry0[q >> 1];
      const size_t start = ((size_t)y * img_w + xlo) * 3;
      const size_t a0 = start & ~(size_t)15;
      if (v == 0) shift[q] = (int)(start - a0);
      if (a0 + 16 * v < ((size_t)y * img_w + xhi + 1) * 3)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_addr(taps + q * L.pitch + 16 * v)),
                     "l"(img + a0 + 16 * v)
                     : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int i = tid; i < 2 * rows * out_w; i += THREADS) {
      const int q = i / out_w, c = i - q * out_w;
      const int y = (q & 1) ? ryb[q >> 1] : ry0[q >> 1];
      const uint8_t* a = img + ((size_t)y * img_w + cx0[c]) * 3;
      const uint8_t* b = img + ((size_t)y * img_w + cxb[c]) * 3;
      unsigned char* d = taps + q * L.pitch + 6 * c;
      d[0] = a[0], d[1] = a[1], d[2] = a[2], d[3] = b[0], d[4] = b[1], d[5] = b[2];
    }
  }
  __syncthreads();

  // 3. the pixels
  for (int p = tid; p < rows * out_w; p += THREADS) {
    const int r = p / out_w, c = p - r * out_w;
    const float fx = cfx[c], fy = rfy[r];
    const unsigned char* t0 = taps + (2 * r) * L.pitch;
    const unsigned char* t1 = taps + (2 * r + 1) * L.pitch;
    int a0, b0, a1, b1;  // byte offsets of the x0 and xb taps in rows 2r, 2r+1
    if (narrow) {
      a0 = shift[2 * r] + 3 * (cx0[c] - xlo), b0 = shift[2 * r] + 3 * (cxb[c] - xlo);
      a1 = shift[2 * r + 1] + 3 * (cx0[c] - xlo), b1 = shift[2 * r + 1] + 3 * (cxb[c] - xlo);
    } else {
      a0 = a1 = 6 * c, b0 = b1 = 6 * c + 3;
    }
    float v[3];
#pragma unroll
    for (int ch3 = 0; ch3 < 3; ++ch3) {
      const float top = u8f(t0[a0 + ch3]) * (1.0f - fx) + u8f(t0[b0 + ch3]) * fx;
      const float bot = u8f(t1[a1 + ch3]) * (1.0f - fx) + u8f(t1[b1 + ch3]) * fx;
      v[ch3] = top * (1.0f - fy) + bot * fy;
    }
    if (STORE == STORE_DIRECT) {
      float* o = out + (((size_t)k * out_h + r0 + r) * out_w + c) * 3;
      o[0] = v[0], o[1] = v[1], o[2] = v[2];
    } else {
      obuf[3 * p] = v[0], obuf[3 * p + 1] = v[1], obuf[3 * p + 2] = v[2];
    }
  }

  // 4. the band, contiguous in the output
  if (STORE != STORE_DIRECT) {
    float* dst = out + ((size_t)k * out_h + r0) * out_w * 3;
    const int bytes = rows * out_w * 12;
    if (STORE == STORE_VEC16) {
      __syncthreads();
      for (int i = tid; i < bytes / 16; i += THREADS) ((float4*)dst)[i] = ((const float4*)obuf)[i];
    } else {
      // the generic-proxy writes above must be visible to the bulk copy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (tid == 0) {
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                     "r"(smem_addr(obuf)), "r"(bytes)
                     : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    }
  }
}

struct BandVariant {
  const char* name;
  int rows, threads, store;
  void (*kernel)(const uint8_t*, const float*, float*, int, int, int, int, int, int, int);
  size_t smem_set;
};

#define V(R, T, S, NAME) {NAME, R, T, S, crop_band_kernel<R, T, S>, 48 * 1024}
static BandVariant variants[] = {
    V(4, 128, STORE_DIRECT, "band4_t128_direct"),   V(4, 128, STORE_VEC16, "band4_t128_vec16"),
    V(4, 128, STORE_BULK, "band4_t128_bulk"),       V(8, 256, STORE_DIRECT, "band8_t256_direct"),
    V(8, 256, STORE_VEC16, "band8_t256_vec16"),     V(8, 256, STORE_BULK, "band8_t256_bulk"),
    V(16, 256, STORE_BULK, "band16_t256_bulk"),     V(2, 128, STORE_VEC16, "band2_t128_vec16"),
    V(1, 128, STORE_DIRECT, "band1_t128_direct"),
};
#undef V

extern "C" const char* crop_band_variant_name(int i) {
  return i >= 0 && i < (int)(sizeof(variants) / sizeof(variants[0])) ? variants[i].name : nullptr;
}

// crop_resize_launch's arguments, after the variant's index.
extern "C" int crop_band_launch(int i, const void* img, const void* boxes, void* out, int k,
                                int img_h, int img_w, int orig_h, int orig_w, int out_h, int out_w,
                                int mode, void* stream) {
  if (crop_band_variant_name(i) == nullptr || out_w > 512 || out_w % 4 != 0 ||
      ((size_t)img_h * img_w * 3) % 16 != 0 || ((uintptr_t)img & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (k <= 0) return 0;
  BandVariant& v = variants[i];
  const size_t smem = (size_t)band_smem(v.rows, out_w, v.store).total;
  if (smem > v.smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute((const void*)v.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (err != cudaSuccess) return (int)err;
    v.smem_set = smem;
  }
  dim3 grid(k, (out_h + v.rows - 1) / v.rows);
  v.kernel<<<grid, v.threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (const float*)boxes, (float*)out, img_h, img_w, orig_h, orig_w, out_h,
      out_w, mode);
  return (int)cudaGetLastError();
}
