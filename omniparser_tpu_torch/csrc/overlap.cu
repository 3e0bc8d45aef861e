// The merge pass's three matrices in one launch.
//
// Replaces the TPU kernel `_overlap_kernel` / `pallas_overlap_matrices`
// (omniparser_tpu/ops/pallas_kernels.py), which computes whole [N,N] and
// [N,M] arrays in on-chip memory as broadcasts of column vectors against
// their transposes.  Here each thread owns one pair: column j of row i
// gives ratio[i,j] (icon i against icon j) and, for j < M, a[i,j] and
// b[i,j] (icon i against OCR box j).
//
// What bounds it on this card: bytes.  The inputs are (N + M) * 16 bytes;
// the outputs are N*N*4 + 2*N*M bytes (1.3 MB at N = 512, M = 256) and are
// written once, coalesced along j.  Per pair there are about 25 float
// operations, far below what the card can do for each byte it writes.
//
//   ratio[i,j] = max(inter / ((area_i + area_j - inter) + 1e-6),
//                    inter / area_i, inter / area_j)
//                the last two only when both areas are > 0
//   a[i,k] = area_ocr_k > 0 and inter(i,k) / area_ocr_k > 0.80
//   b[i,k] = area_i     > 0 and inter(i,k) / area_i     > 0.80
//
// Compiled with -fmad=false: a and b are held bit for bit against PyTorch.

#include <cuda_runtime.h>
#include <stdint.h>

#define INSIDE_THRESHOLD 0.80f
#define UNION_EPS 1e-6f

__device__ __forceinline__ float box_area(const float4 b) {
  return (b.z - b.x) * (b.w - b.y);
}

__device__ __forceinline__ float box_inter(const float4 a, const float4 b) {
  const float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
  const float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
  return iw * ih;
}

__global__ void overlap_kernel(const float4* __restrict__ icons,
                               const float4* __restrict__ ocr, int n, int m,
                               float* __restrict__ ratio, uint8_t* __restrict__ a,
                               uint8_t* __restrict__ b) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n) return;
  const float4 bi = icons[i];
  const float ai = box_area(bi);
  if (j < n) {
    const float4 bj = icons[j];
    const float aj = box_area(bj);
    const float inter = box_inter(bi, bj);
    const float iou = inter / (((ai + aj) - inter) + UNION_EPS);
    const bool both = (ai > 0.0f) && (aj > 0.0f);
    const float ra = both ? inter / ai : 0.0f;
    const float rb = both ? inter / aj : 0.0f;
    ratio[(size_t)i * n + j] = fmaxf(iou, fmaxf(ra, rb));
  }
  if (j < m) {
    const float4 bo = ocr[j];
    const float ao = box_area(bo);
    const float inter = box_inter(bo, bi);
    a[(size_t)i * m + j] = (uint8_t)((ao > 0.0f) && (inter / ao > INSIDE_THRESHOLD));
    b[(size_t)i * m + j] = (uint8_t)((ai > 0.0f) && (inter / ai > INSIDE_THRESHOLD));
  }
}

// icons [n,4], ocr [m,4] float32 (16-byte aligned); ratio [n,n] float32;
// a, b [n,m] uint8/bool.
extern "C" int overlap_matrices_launch(const void* icons, const void* ocr,
                                       void* ratio, void* a, void* b, int n, int m,
                                       void* stream) {
  if (n <= 0) return 0;
  const int cols = n > m ? n : m;
  dim3 block(32, 8);
  dim3 grid((cols + 31) / 32, (n + 7) / 8);
  overlap_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float4*)icons, (const float4*)ocr, n, m, (float*)ratio,
      (uint8_t*)a, (uint8_t*)b);
  return (int)cudaGetLastError();
}
