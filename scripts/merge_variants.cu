// Design variants of the fused merge kernel (csrc/overlap.cu,
// merge_masks_kernel), timed beside it by scripts/kernel_variants.py.  The
// shipped kernel is "rows 2, warps a row 8, skip, block ticket"; the first
// design tried is the first variant.
//
// One templated kernel, three knobs:
//   RPB  rows (icons) a block;
//   WPR  warps a row: the row's 32-wide chunks of icons (suppression) and
//        of OCR boxes (containment) are dealt round-robin to its warps.
//        With WPR > 1 a row's suppression flag lives in shared memory
//        (each warp stops at its own hit or at a sibling's), and the
//        containment ballots go to shared memory, where after a block
//        barrier each warp finds the row's k_stop as the first nonzero
//        b-word and stores the absorb bits of its own chunks.
//   EPI  the epilogue: the block's removed bits OR-ed into a launch bitmask,
//        an atomic ticket and the last block's ocr_keep, done by the whole
//        block between barriers or by warp 0 alone;
// and a runtime switch `skip`: no division for a pair whose intersection
// is 0, where no ratio can pass (exact for thresholds >= 0: the ratios are
// then 0, -0 or NaN).  Two "breakdown" builds do not give the kernel's
// outputs and only time its parts: one without the ticket and ocr_keep,
// one empty kernel on the same grid.
// Same arithmetic and the same -fmad=false build: every variant must give
// the shipped kernel's bits.

#include <cuda_runtime.h>
#include <stdint.h>

#define INSIDE_THRESHOLD 0.80f
#define UNION_EPS 1e-6f
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ float box_area(const float4 b) {
  return (b.z - b.x) * (b.w - b.y);
}

__device__ __forceinline__ float box_inter(const float4 a, const float4 b) {
  const float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
  const float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
  return iw * ih;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

static size_t variant_smem_bytes(int n, int m, int rpb) {
  const int words = (m + 31) / 32;
  return (size_t)(n + m) * 20 + (size_t)words * 4 * (1 + 2 * rpb) + (size_t)(n + m);
}

// EPI: how the block's removed bits reach the launch's bitmask and the last
// block: 0 every thread ORs, fences and meets at block barriers (the
// shipped epilogue); 1 warp 0 alone ORs, fences, takes the ticket and, in
// the last block, writes ocr_keep; 2 none (a breakdown build)
#define EPI_BLOCK 0
#define EPI_WARP 1
#define EPI_NONE 2

template <int RPB, int WPR, int EPI = EPI_BLOCK>
__global__ void __launch_bounds__(RPB * WPR * 32)
merge_variant_kernel(const float4* __restrict__ icons, const uint8_t* __restrict__ icon_valid,
                     const float4* __restrict__ ocr, const uint8_t* __restrict__ ocr_valid,
                     int n, int m, float thr, int skip, uint8_t* __restrict__ icon_keep,
                     uint8_t* __restrict__ ocr_keep, uint8_t* __restrict__ absorb,
                     uint8_t* __restrict__ icon_suppressed, unsigned int* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (m + 31) / 32;
  float4* s_icon = (float4*)smem;
  float4* s_ocr = s_icon + n;
  float* s_iarea = (float*)(s_ocr + m);
  float* s_oarea = s_iarea + n;
  unsigned int* s_removed = (unsigned int*)(s_oarea + m);
  unsigned int* s_aw = s_removed + words;       // [RPB][words]
  unsigned int* s_bw = s_aw + RPB * words;      // [RPB][words]
  uint8_t* s_ivalid = (uint8_t*)(s_bw + RPB * words);
  uint8_t* s_ovalid = s_ivalid + n;
  __shared__ int s_sup[RPB];
  __shared__ bool s_last;

  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const float4 b = icons[t];
    s_icon[t] = b;
    s_iarea[t] = box_area(b);
    s_ivalid[t] = icon_valid[t];
  }
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const float4 b = ocr[t];
    s_ocr[t] = b;
    s_oarea[t] = box_area(b);
    s_ovalid[t] = ocr_valid[t];
  }
  for (int t = threadIdx.x; t < words * (1 + 2 * RPB); t += blockDim.x) s_removed[t] = 0u;
  if (threadIdx.x < RPB) s_sup[threadIdx.x] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = warp / WPR, w = warp % WPR;
  const int i = blockIdx.x * RPB + r;
  const bool row = i < n;
  const float4 bi = row ? s_icon[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float ai = row ? s_iarea[i] : 0.0f;
  const bool vi = row && s_ivalid[i] != 0;
  const bool skip_sup = skip && thr >= 0.0f;

  bool found = false;
  if (vi) {
    for (int c = w; c * 32 < n; c += WPR) {
      if (WPR > 1 && __any_sync(FULL_MASK, *(volatile int*)&s_sup[r] != 0)) break;
      const int j = c * 32 + lane;
      bool hit = false;
      if (j < n && j != i && s_ivalid[j] && ai > s_iarea[j]) {
        const float inter = box_inter(bi, s_icon[j]);
        if (!(skip_sup && inter == 0.0f)) {
          const float aj = s_iarea[j];
          const float iou = inter / (((ai + aj) - inter) + UNION_EPS);
          const bool both = (ai > 0.0f) && (aj > 0.0f);
          const float ra = both ? inter / ai : 0.0f;
          const float rb = both ? inter / aj : 0.0f;
          hit = max_nan(iou, max_nan(ra, rb)) > thr;
        }
      }
      if (__any_sync(FULL_MASK, hit)) {
        found = true;
        if (WPR > 1 && lane == 0) s_sup[r] = 1;
        break;
      }
    }
  }
  if (WPR > 1) __syncthreads();
  const bool sup = WPR == 1 ? found : vi && s_sup[r] != 0;
  const bool pass = vi && !sup;

  int k_stop = m;
  if (WPR == 1) {
    // the shipped kernel's row: chunks in order, stop at the first b
    uint8_t* out = absorb + (size_t)i * m;
    for (int k0 = 0; k0 < m; k0 += 32) {
      const int k = k0 + lane;
      bool ab = false;
      if (pass && k_stop == m) {
        bool a = false, b = false;
        if (k < m && s_ovalid[k]) {
          const float inter = box_inter(s_ocr[k], bi);
          if (!(skip && inter == 0.0f)) {
            const float ao = s_oarea[k];
            a = (ao > 0.0f) && (inter / ao > INSIDE_THRESHOLD);
            b = !a && (ai > 0.0f) && (inter / ai > INSIDE_THRESHOLD);
          }
        }
        const unsigned int bw = __ballot_sync(FULL_MASK, b);
        if (bw) k_stop = k0 + __ffs(bw) - 1;
        ab = a && k < k_stop;
        const unsigned int aw = __ballot_sync(FULL_MASK, ab);
        if (lane == 0 && aw) atomicOr(&s_removed[k0 >> 5], aw);
      }
      if (row && k < m) out[k] = (uint8_t)ab;
    }
  } else {
    if (pass) {
      for (int c = w; c < words; c += WPR) {
        const int k = c * 32 + lane;
        bool a = false, b = false;
        if (k < m && s_ovalid[k]) {
          const float inter = box_inter(s_ocr[k], bi);
          if (!(skip && inter == 0.0f)) {
            const float ao = s_oarea[k];
            a = (ao > 0.0f) && (inter / ao > INSIDE_THRESHOLD);
            b = !a && (ai > 0.0f) && (inter / ai > INSIDE_THRESHOLD);
          }
        }
        const unsigned int aw = __ballot_sync(FULL_MASK, a);
        const unsigned int bw = __ballot_sync(FULL_MASK, b);
        if (lane == 0) {
          s_aw[r * words + c] = aw;
          s_bw[r * words + c] = bw;
        }
      }
    }
    __syncthreads();
    if (pass) {
      for (int base = 0; base < words; base += 32) {
        const unsigned int word = base + lane < words ? s_bw[r * words + base + lane] : 0u;
        const unsigned int nz = __ballot_sync(FULL_MASK, word != 0u);
        if (nz) {
          const int first = base + __ffs(nz) - 1;
          k_stop = first * 32 + __ffs(s_bw[r * words + first]) - 1;
          break;
        }
      }
    }
    if (row) {
      uint8_t* out = absorb + (size_t)i * m;
      for (int c = w; c < words; c += WPR) {
        const int k = c * 32 + lane;
        const bool ab = pass && ((s_aw[r * words + c] >> lane) & 1u) && k < k_stop;
        const unsigned int aw = __ballot_sync(FULL_MASK, ab);
        if (lane == 0 && aw) atomicOr(&s_removed[c], aw);
        if (k < m) out[k] = (uint8_t)ab;
      }
    }
  }
  if (row && w == 0 && lane == 0) {
    icon_suppressed[i] = (uint8_t)sup;
    icon_keep[i] = (uint8_t)(pass && k_stop == m);
  }
  if (EPI == EPI_NONE) return;  // a breakdown build: ocr_keep is not written
  __syncthreads();

  if (EPI == EPI_WARP) {
    if (warp != 0) return;
    for (int t = lane; t < words; t += 32) {
      const unsigned int bits = s_removed[t];
      if (bits) atomicOr(&scratch[t], bits);
    }
    __threadfence();
    __syncwarp();
    bool last = false;
    if (lane == 0) {
      last = atomicAdd(&scratch[words], 1u) == gridDim.x - 1;
      __threadfence();
    }
    if (!__shfl_sync(FULL_MASK, last, 0)) return;
    for (int k = lane; k < m; k += 32) {
      const unsigned int bits = __ldcg(&scratch[k >> 5]);
      ocr_keep[k] = (uint8_t)(s_ovalid[k] && !((bits >> (k & 31)) & 1u));
    }
    __syncwarp();
    for (int t = lane; t <= words; t += 32) scratch[t] = 0u;
    return;
  }
  for (int t = threadIdx.x; t < words; t += blockDim.x) {
    const unsigned int bits = s_removed[t];
    if (bits) atomicOr(&scratch[t], bits);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&scratch[words], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    const unsigned int bits = __ldcg(&scratch[k >> 5]);
    ocr_keep[k] = (uint8_t)(s_ovalid[k] && !((bits >> (k & 31)) & 1u));
  }
  __syncthreads();
  for (int t = threadIdx.x; t <= words; t += blockDim.x) scratch[t] = 0u;
}

// a breakdown build: the launch alone, on the grid of rows 2, warps a row 8
template <int RPB, int WPR>
__global__ void __launch_bounds__(RPB * WPR * 32)
merge_empty_kernel(const float4*, const uint8_t*, const float4*, const uint8_t*, int, int,
                   float, int, uint8_t*, uint8_t*, uint8_t*, uint8_t*, unsigned int*) {}

typedef void (*variant_fn)(const float4*, const uint8_t*, const float4*, const uint8_t*, int,
                           int, float, int, uint8_t*, uint8_t*, uint8_t*, uint8_t*,
                           unsigned int*);

struct Variant {
  const char* name;
  variant_fn fn;
  int rpb, wpr, skip;
};

#define V(R, W, E, SKIP, NAME) {NAME, merge_variant_kernel<R, W, E>, R, W, SKIP}
static const Variant VARIANTS[] = {
    V(4, 1, EPI_BLOCK, 0, "rows 4, warps a row 1, no skip, block ticket (the first design)"),
    V(4, 1, EPI_BLOCK, 1, "rows 4, warps a row 1, skip, block ticket"),
    V(8, 1, EPI_BLOCK, 1, "rows 8, warps a row 1, skip, block ticket"),
    V(2, 1, EPI_BLOCK, 1, "rows 2, warps a row 1, skip, block ticket"),
    V(4, 2, EPI_BLOCK, 1, "rows 4, warps a row 2, skip, block ticket"),
    V(4, 4, EPI_BLOCK, 0, "rows 4, warps a row 4, no skip, block ticket"),
    V(4, 4, EPI_BLOCK, 1, "rows 4, warps a row 4, skip, block ticket"),
    V(2, 8, EPI_BLOCK, 1, "rows 2, warps a row 8, skip, block ticket"),
    V(4, 8, EPI_BLOCK, 1, "rows 4, warps a row 8, skip, block ticket"),
    V(8, 4, EPI_BLOCK, 1, "rows 8, warps a row 4, skip, block ticket"),
    V(16, 2, EPI_BLOCK, 1, "rows 16, warps a row 2, skip, block ticket"),
    V(1, 16, EPI_BLOCK, 1, "rows 1, warps a row 16, skip, block ticket"),
    V(8, 1, EPI_WARP, 1, "rows 8, warps a row 1, skip, warp ticket"),
    V(4, 4, EPI_WARP, 1, "rows 4, warps a row 4, skip, warp ticket"),
    V(8, 4, EPI_WARP, 1, "rows 8, warps a row 4, skip, warp ticket"),
    V(2, 8, EPI_WARP, 1, "rows 2, warps a row 8, skip, warp ticket"),
    V(4, 8, EPI_WARP, 1, "rows 4, warps a row 8, skip, warp ticket"),
    V(2, 16, EPI_WARP, 1, "rows 2, warps a row 16, skip, warp ticket"),
    V(2, 8, EPI_NONE, 1, "breakdown: rows 2, warps a row 8, skip, no ticket"),
    {"breakdown: rows 2, warps a row 8, empty kernel", merge_empty_kernel<2, 8>, 2, 8, 1},
};
#undef V

extern "C" const char* merge_variant_name(int v) {
  return v >= 0 && v < (int)(sizeof(VARIANTS) / sizeof(VARIANTS[0])) ? VARIANTS[v].name
                                                                       : nullptr;
}

// the arguments of merge_masks_launch, with the variant's index first
extern "C" int merge_variant_launch(int v, const void* icons, const void* icon_valid,
                                    const void* ocr, const void* ocr_valid, int n, int m,
                                    float thr, void* icon_keep, void* ocr_keep, void* absorb,
                                    void* icon_suppressed, void* scratch, void* stream) {
  if (!merge_variant_name(v) || n < 0 || m < 1) return (int)cudaErrorInvalidValue;
  const Variant& var = VARIANTS[v];
  const size_t smem = variant_smem_bytes(n, m, var.rpb);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)var.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = n > 0 ? (n + var.rpb - 1) / var.rpb : 1;
  var.fn<<<blocks, var.rpb * var.wpr * 32, smem, (cudaStream_t)stream>>>(
      (const float4*)icons, (const uint8_t*)icon_valid, (const float4*)ocr,
      (const uint8_t*)ocr_valid, n, m, thr, var.skip, (uint8_t*)icon_keep,
      (uint8_t*)ocr_keep, (uint8_t*)absorb, (uint8_t*)icon_suppressed,
      (unsigned int*)scratch);
  return (int)cudaGetLastError();
}
