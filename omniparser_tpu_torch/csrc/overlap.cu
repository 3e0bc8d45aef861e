// The merge pass on the card: two entries.
//
// overlap_matrices_launch replaces the TPU kernel `_overlap_kernel` /
// `pallas_overlap_matrices` (omniparser_tpu/ops/pallas_kernels.py) one to
// one: whole [N,N] and [N,M] arrays, which the Pallas kernel built in
// on-chip memory as broadcasts of column vectors against their transposes.
// Here each thread owns one pair: column j of row i gives ratio[i,j] (icon i
// against icon j) and, for j < M, a[i,j] and b[i,j] (icon i against OCR box
// j).  Bound by bytes: the outputs are N*N*4 + 2*N*M bytes (1.3 MB at
// N = 512, M = 256), written once, coalesced along j.
//
// merge_masks_launch is what the main path launches: the whole merge
// decision (`merge_icons_and_ocr`, omniparser_tpu/ops/overlap.py), which on
// the TPU was the Pallas matrices kept in VMEM with XLA's fused reductions
// behind them.  Eager PyTorch around overlap_matrices took about 35 launches
// and a 1 MB round trip of `ratio` through device memory; this kernel takes
// one launch and writes only the four outputs.  Its design:
//   - every block stages all icon and OCR boxes, their areas and valid
//     flags in shared memory (21 bytes a box: 16 KB at N = 512, M = 256),
//     so that the rows read on-chip memory only;
//   - MERGE_ROWS rows (icons) a block, MERGE_ROW_WARPS warps a row (512 rows
//     -> 256 blocks of 512 threads); a row's 32-wide chunks are dealt to its
//     warps.  Suppression: lanes take j, the three divisions of the ratio
//     are done only where j != i, valid_j, area_i > area_j hold and the
//     boxes intersect, and a row's warps stop at the first __any_sync hit
//     of any of them (a flag in shared memory).  Containment: each warp
//     ballots a and b of its chunks into shared memory; after a block
//     barrier the row's k_stop is the first nonzero b-word's __ffs, and
//     each warp stores its chunks' absorb bits, a & (k < k_stop), coalesced;
//   - ocr_removed = absorb.any(0) is the one reduction across rows: each
//     row's absorb ballots are OR-ed into a block bitmask in shared memory,
//     the block's words into a launch bitmask in device memory (atomicOr),
//     and the last block to finish (an atomic ticket after __threadfence)
//     reads that bitmask through L2, writes ocr_keep and zeroes the
//     bitmask and the ticket for the next launch on its stream.
// Bound: operations and bytes are both tiny (about 22 float operations a
// pair of icons and 16 an icon and an OCR box; 145 KB in and out at
// 512 x 256), so it waits on latency: the launch, the staging, a row's
// chain of chunks and the ticket.
//
//   ratio[i,j] = max(inter / ((area_i + area_j - inter) + 1e-6),
//                    inter / area_i, inter / area_j)
//                the last two only when both areas are > 0
//   a[i,k] = area_ocr_k > 0 and inter(i,k) / area_ocr_k > 0.80
//   b[i,k] = area_i     > 0 and inter(i,k) / area_i     > 0.80
//
// Compiled with -fmad=false, IEEE division: ratio, a and b are held bit for
// bit against PyTorch, and thresholds are compared in float32 as PyTorch
// compares a float32 tensor with a Python float.

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

// ------------------------------------------------------------------ //
// The fused merge
// ------------------------------------------------------------------ //

// Rows (icons) a block, and warps a row.  Chosen on an H100 among 1 to 16
// rows and 1 to 16 warps a row (scripts/merge_variants.cu times them): with
// one warp a row, the row's serial chain of chunks made the kernel about
// three times slower.
#define MERGE_ROWS 2
#define MERGE_ROW_WARPS 8
#define MERGE_THREADS (MERGE_ROWS * MERGE_ROW_WARPS * 32)
#define FULL_MASK 0xffffffffu

// torch.maximum / jnp.maximum: NaN when either operand is NaN (fmaxf
// returns the other one)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// Shared memory: icon boxes [n] and OCR boxes [m] (float4), their areas;
// the block's removed bitmask [words] and each row's a- and b-ballots
// [MERGE_ROWS][words]; the valid flags (bytes).
static size_t merge_smem_bytes(int n, int m) {
  const int words = (m + 31) / 32;
  return (size_t)(n + m) * 20 + (size_t)words * 4 * (1 + 2 * MERGE_ROWS) + (size_t)(n + m);
}

__global__ void __launch_bounds__(MERGE_THREADS)
merge_masks_kernel(const float4* __restrict__ icons, const uint8_t* __restrict__ icon_valid,
                   const float4* __restrict__ ocr, const uint8_t* __restrict__ ocr_valid,
                   int n, int m, float thr, uint8_t* __restrict__ icon_keep,
                   uint8_t* __restrict__ ocr_keep, uint8_t* __restrict__ absorb,
                   uint8_t* __restrict__ icon_suppressed, unsigned int* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (m + 31) / 32;
  float4* s_icon = (float4*)smem;
  float4* s_ocr = s_icon + n;
  float* s_iarea = (float*)(s_ocr + m);
  float* s_oarea = s_iarea + n;
  unsigned int* s_removed = (unsigned int*)(s_oarea + m);
  unsigned int* s_aw = s_removed + words;
  unsigned int* s_bw = s_aw + MERGE_ROWS * words;
  uint8_t* s_ivalid = (uint8_t*)(s_bw + MERGE_ROWS * words);
  uint8_t* s_ovalid = s_ivalid + n;
  __shared__ int s_sup[MERGE_ROWS];
  __shared__ bool s_last;

  for (int t = threadIdx.x; t < n; t += MERGE_THREADS) {
    const float4 b = icons[t];
    s_icon[t] = b;
    s_iarea[t] = box_area(b);
    s_ivalid[t] = icon_valid[t];
  }
  for (int t = threadIdx.x; t < m; t += MERGE_THREADS) {
    const float4 b = ocr[t];
    s_ocr[t] = b;
    s_oarea[t] = box_area(b);
    s_ovalid[t] = ocr_valid[t];
  }
  for (int t = threadIdx.x; t < words * (1 + 2 * MERGE_ROWS); t += MERGE_THREADS)
    s_removed[t] = 0u;
  if (threadIdx.x < MERGE_ROWS) s_sup[threadIdx.x] = 0;
  __syncthreads();

  // warp w of row r takes the chunks w, w + 8, w + 16, ... of 32 boxes
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x >> 5) / MERGE_ROW_WARPS;
  const int w = (threadIdx.x >> 5) % MERGE_ROW_WARPS;
  const int i = blockIdx.x * MERGE_ROWS + r;
  const bool row = i < n;
  const float4 bi = row ? s_icon[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float ai = row ? s_iarea[i] : 0.0f;
  const bool vi = row && s_ivalid[i] != 0;
  unsigned int* aw_row = s_aw + r * words;
  unsigned int* bw_row = s_bw + r * words;

  // suppressed_by[i,j] = j != i & valid_j & area_i > area_j & ratio > thr.
  // A disjoint pair has ratios 0, -0 or NaN, none above a threshold >= 0:
  // its three divisions are skipped.
  const bool skip_disjoint = thr >= 0.0f;
  if (vi) {
    for (int c = w; c * 32 < n; c += MERGE_ROW_WARPS) {
      if (__any_sync(FULL_MASK, *(volatile int*)&s_sup[r] != 0)) break;  // a sibling found one
      const int j = c * 32 + lane;
      bool hit = false;
      if (j < n && j != i && s_ivalid[j] && ai > s_iarea[j]) {
        const float inter = box_inter(bi, s_icon[j]);
        if (!(skip_disjoint && inter == 0.0f)) {
          const float aj = s_iarea[j];
          const float iou = inter / (((ai + aj) - inter) + UNION_EPS);
          const bool both = (ai > 0.0f) && (aj > 0.0f);
          const float ra = both ? inter / ai : 0.0f;
          const float rb = both ? inter / aj : 0.0f;
          hit = max_nan(iou, max_nan(ra, rb)) > thr;
        }
      }
      if (__any_sync(FULL_MASK, hit)) {
        if (lane == 0) s_sup[r] = 1;
        break;
      }
    }
  }
  __syncthreads();
  const bool sup = vi && s_sup[r] != 0;
  const bool pass = vi && !sup;

  // containment, a- and b-ballots of the warp's chunks into shared memory
  // (a disjoint pair has neither: 0 is not above 0.80)
  if (pass) {
    for (int c = w; c < words; c += MERGE_ROW_WARPS) {
      const int k = c * 32 + lane;
      bool a = false, b = false;
      if (k < m && s_ovalid[k]) {
        const float inter = box_inter(s_ocr[k], bi);
        if (inter != 0.0f) {
          const float ao = s_oarea[k];
          a = (ao > 0.0f) && (inter / ao > INSIDE_THRESHOLD);
          b = !a && (ai > 0.0f) && (inter / ai > INSIDE_THRESHOLD);
        }
      }
      const unsigned int a_bits = __ballot_sync(FULL_MASK, a);
      const unsigned int b_bits = __ballot_sync(FULL_MASK, b);
      if (lane == 0) {
        aw_row[c] = a_bits;
        bw_row[c] = b_bits;
      }
    }
  }
  __syncthreads();

  // k_stop: the first b in ascending k, from the first nonzero b-word; the
  // row absorbs the a-boxes before it
  int k_stop = m;
  if (pass) {
    for (int base = 0; base < words; base += 32) {
      const unsigned int word = base + lane < words ? bw_row[base + lane] : 0u;
      const unsigned int nonzero = __ballot_sync(FULL_MASK, word != 0u);
      if (nonzero) {
        const int first = base + __ffs(nonzero) - 1;
        k_stop = first * 32 + __ffs(bw_row[first]) - 1;
        break;
      }
    }
  }
  if (row) {
    uint8_t* out = absorb + (size_t)i * m;
    for (int c = w; c < words; c += MERGE_ROW_WARPS) {
      const int k = c * 32 + lane;
      const bool ab = pass && ((aw_row[c] >> lane) & 1u) && k < k_stop;
      const unsigned int ab_bits = __ballot_sync(FULL_MASK, ab);
      if (lane == 0 && ab_bits) atomicOr(&s_removed[c], ab_bits);
      if (k < m) out[k] = (uint8_t)ab;
    }
    if (w == 0 && lane == 0) {
      icon_suppressed[i] = (uint8_t)sup;  // sup is only ever set for a valid icon
      icon_keep[i] = (uint8_t)(pass && k_stop == m);
    }
  }
  __syncthreads();

  // ocr_removed = absorb.any(0): the block's bits into the launch's bitmask
  // scratch[0, words), then a ticket scratch[words]; the last block to take
  // one sees every block's bits
  for (int t = threadIdx.x; t < words; t += MERGE_THREADS) {
    const unsigned int bits = s_removed[t];
    if (bits) atomicOr(&scratch[t], bits);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&scratch[words], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int k = threadIdx.x; k < m; k += MERGE_THREADS) {
    const unsigned int bits = __ldcg(&scratch[k >> 5]);
    ocr_keep[k] = (uint8_t)(s_ovalid[k] && !((bits >> (k & 31)) & 1u));
  }
  __syncthreads();
  for (int t = threadIdx.x; t <= words; t += MERGE_THREADS) scratch[t] = 0u;
}

// icons [n,4], ocr [m,4] float32 (16-byte aligned); icon_valid [n],
// ocr_valid [m] bool; outputs icon_keep [n], ocr_keep [m], absorb [n,m]
// row-major, icon_suppressed [n], bool; scratch: (m+31)/32 + 1 words,
// zero before the launch and zero again after it.  n >= 0, m >= 1 and
// merge_smem_bytes(n, m) within the block's shared memory.
extern "C" int merge_masks_launch(const void* icons, const void* icon_valid,
                                  const void* ocr, const void* ocr_valid, int n, int m,
                                  float thr, void* icon_keep, void* ocr_keep, void* absorb,
                                  void* icon_suppressed, void* scratch, void* stream) {
  if (n < 0 || m < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = merge_smem_bytes(n, m);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_masks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = n > 0 ? (n + MERGE_ROWS - 1) / MERGE_ROWS : 1;
  merge_masks_kernel<<<blocks, MERGE_THREADS, smem, (cudaStream_t)stream>>>(
      (const float4*)icons, (const uint8_t*)icon_valid, (const float4*)ocr,
      (const uint8_t*)ocr_valid, n, m, thr, (uint8_t*)icon_keep, (uint8_t*)ocr_keep,
      (uint8_t*)absorb, (uint8_t*)icon_suppressed, (unsigned int*)scratch);
  return (int)cudaGetLastError();
}
