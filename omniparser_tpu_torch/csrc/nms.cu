// Greedy NMS keep mask over score-sorted boxes, bitmask form.
//
// Replaces the TPU kernel `_nms_kernel` / `pallas_nms_keep`
// (omniparser_tpu/ops/pallas_kernels.py).  That kernel holds the whole
// [N,N] float32 IoU matrix in on-chip memory and reads the keep vector
// through a one-hot reduction, which limits it to N <= 1024.  Neither
// device carries over: here N = 4096 (the detector's prefilter window) and
// the matrix is never formed.
//
// What bounds it on this card: the function itself moves only the boxes,
// the valid bytes and the keep bytes (N * 18 bytes), so the bound is the
// pair arithmetic, N^2/2 IoU evaluations.  The design's own traffic is the
// suppression bitmask, N * ceil(N/64) 64-bit words (2 MB at N = 4096,
// upper triangle only), written once by the first kernel and read row by
// row, for kept boxes only, by the second.  The second kernel is one warp
// and sequential by nature (box i's fate depends on every kept box before
// it); it walks only over boxes that are still alive, by find-first-set on
// the alive word, so suppressed and invalid boxes cost nothing.
//
// IoU as in the plain version: area = (x2-x1)*(y2-y1); per-axis overlap
// clamped at 0; union = (area_i + area_j) - inter; iou = inter/union where
// union > 0, else 0; j is suppressed by a kept i < j when iou > thr
// (strict).  The file is compiled with -fmad=false so that every product
// and sum rounds as PyTorch's elementwise kernels round them.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

__global__ void nms_mask_kernel(const float4* __restrict__ boxes, int n, int cb,
                                float thr, u64* __restrict__ mask) {
  const int row_blk = blockIdx.y;
  const int col_blk = blockIdx.x;
  if (col_blk < row_blk) return;  // lower triangle is never read
  __shared__ float4 cbox[64];
  __shared__ float carea[64];
  const int t = threadIdx.x;
  const int j0 = col_blk * 64;
  if (j0 + t < n) {
    float4 b = boxes[j0 + t];
    cbox[t] = b;
    carea[t] = (b.z - b.x) * (b.w - b.y);
  }
  __syncthreads();
  const int i = row_blk * 64 + t;
  if (i >= n) return;
  const float4 a = boxes[i];
  const float aarea = (a.z - a.x) * (a.w - a.y);
  const int lim = min(64, n - j0);
  u64 bits = 0;
  for (int k = 0; k < lim; ++k) {
    if (j0 + k <= i) continue;
    const float4 b = cbox[k];
    const float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
    const float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
    const float inter = iw * ih;
    const float uni = (aarea + carea[k]) - inter;
    const float iou = uni > 0.0f ? inter / uni : 0.0f;
    if (iou > thr) bits |= (1ull << k);
  }
  mask[(size_t)i * cb + col_blk] = bits;
}

// One warp.  Shared: removed[cb], validbits[cb], keepbits[cb].
__global__ void nms_scan_kernel(const u64* __restrict__ mask,
                                const uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ keep, int n, int cb) {
  extern __shared__ u64 sm[];
  u64* removed = sm;
  u64* vbits = sm + cb;
  u64* kbits = sm + 2 * cb;
  const int lane = threadIdx.x;
  for (int p = lane; p < cb; p += 32) {
    u64 v = 0;
    for (int k = 0; k < 64; ++k) {
      const int i = p * 64 + k;
      if (i < n && valid[i]) v |= (1ull << k);
    }
    vbits[p] = v;
    removed[p] = 0;
    kbits[p] = 0;
  }
  __syncwarp();
  for (int w = 0; w < cb; ++w) {
    u64 processed = 0;
    while (true) {
      const u64 cand = vbits[w] & ~removed[w] & ~processed;
      if (!cand) break;
      const int b = __ffsll((long long)cand) - 1;
      processed |= (b == 63) ? ~0ull : ((2ull << b) - 1ull);
      const int i = w * 64 + b;
      __syncwarp();  // every lane has read removed[w] before it changes
      if (lane == 0) kbits[w] |= (1ull << b);
      for (int p = w + lane; p < cb; p += 32)
        removed[p] |= mask[(size_t)i * cb + p];
      __syncwarp();
    }
  }
  __syncwarp();
  for (int i = lane; i < n; i += 32)
    keep[i] = (uint8_t)((kbits[i >> 6] >> (i & 63)) & 1ull);
}

// boxes [n,4] float32 (16-byte aligned), valid [n] uint8/bool, keep [n]
// uint8/bool out, mask scratch [n * ceil(n/64)] uint64.
extern "C" int nms_keep_launch(const void* boxes, const void* valid, void* keep,
                               void* mask, int n, float thr, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int cb = (n + 63) / 64;
  dim3 grid(cb, cb);
  nms_mask_kernel<<<grid, 64, 0, s>>>((const float4*)boxes, n, cb, thr, (u64*)mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<1, 32, 3 * cb * sizeof(u64), s>>>(
      (const u64*)mask, (const uint8_t*)valid, (uint8_t*)keep, n, cb);
  return (int)cudaGetLastError();
}
