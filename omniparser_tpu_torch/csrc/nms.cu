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
// pair arithmetic, N^2/2 IoU evaluations.  What the design pays on top is
// the greedy scan, sequential by nature: box i's fate depends on every kept
// box before it.
//
// Two launches.
//  1. nms_mask_kernel: one block per upper-triangle pair of 64-box blocks
//     (cb*(cb+1)/2 blocks, no idle lower half).  Thread i writes the word
//     "IoU(i, 64p+k) > thr and 64p+k > i" for k < 64 into column p of a
//     column-major, triangle-packed bitmask: column p holds the words of
//     rows 0 .. 64(p+1), contiguous, at word 32*p*(p+1).  Neighbouring
//     threads write neighbouring words, so the stores coalesce.
//  2. The scan, one block of 256 threads, walks the 64-box blocks that
//     hold a valid box, in order.  Column w of the bitmask arrives in
//     shared memory by a bulk asynchronous copy (cp.async.bulk, completing
//     on an mbarrier), four stages deep, so that later columns are in flight
//     while block w resolves.  What the kept boxes of earlier blocks remove
//     from block w is the OR of their words in column w, read through the
//     list of kept boxes; block w's own greedy order then runs on its
//     diagonal words, already in shared memory, and keeps every candidate
//     that suppresses nothing in one step.  No step of a block waits on a
//     dependent global read, and the cost follows the number of blocks, no
//     longer the number of keeps.
//     - nms_scan_fast_kernel (N <= 4096, the main path): every column fits
//       one stage.  Warp 0 resolves block after block; warps 1..7 compute,
//       one block ahead, the OR over all kept boxes but those of the last
//       resolved block, so warp 0 ORs at most 64 words itself.  One block
//       barrier a block hands the kept list and that OR over.
//     - nms_scan_stream_kernel (N > 4096; any N <= 65536): one warp does
//       it all and streams each column through the stages in 2048-word
//       tiles.
//
// IoU as in the plain version: area = (x2-x1)*(y2-y1); per-axis overlap
// clamped at 0; union = (area_i + area_j) - inter; iou = inter/union where
// union > 0, else 0; j is suppressed by a kept i < j when iou > thr
// (strict).  The file is compiled with -fmad=false so that every product
// and sum rounds as PyTorch's elementwise kernels round them.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

#define SCAN_THREADS 256
// Column copies: the one being read and three in flight.  With 2 the
// pipelined scan's helpers wait on each copy (its scan 31% slower at the
// main path's window on the H100); 3 is within 4% of 4; the streaming scan
// does not move (scripts/kernel_variants.py, PERF.md).
#define SCAN_STAGES 4
#define STREAM_CHUNK 2048  // words of a column tile in the streaming scan

__global__ void nms_mask_kernel(const float4* __restrict__ boxes, int n, float thr,
                                u64* __restrict__ maskT) {
  // linear block id -> (row_blk <= col_blk), column by column
  const int id = blockIdx.x;
  int col_blk = (int)((sqrtf(8.0f * (float)id + 1.0f) - 1.0f) * 0.5f);
  while ((col_blk + 1) * (col_blk + 2) / 2 <= id) ++col_blk;
  while (col_blk * (col_blk + 1) / 2 > id) --col_blk;
  const int row_blk = id - col_blk * (col_blk + 1) / 2;

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
  u64 bits = 0;
  if (i < n) {
    const float4 a = boxes[i];
    const float aarea = (a.z - a.x) * (a.w - a.y);
    const int lim = min(64, n - j0);
    for (int k = 0; k < lim; ++k) {
      if (j0 + k <= i) continue;
      const float4 b = cbox[k];
      const float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
      const float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
      const float inter = iw * ih;
      // inter == 0 gives iou 0 exactly; only overlapping pairs divide
      float iou = 0.0f;
      if (inter != 0.0f) {
        const float uni = (aarea + carea[k]) - inter;
        iou = uni > 0.0f ? inter / uni : 0.0f;
      }
      if (iou > thr) bits |= (1ull << k);
    }
  }
  maskT[(size_t)32 * col_blk * (col_blk + 1) + i] = bits;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(u64* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(u64* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread: announce `bytes` on the barrier and start the bulk copy.
__device__ __forceinline__ void bulk_load(u64* dst, const u64* src, uint32_t bytes, u64* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Valid bytes -> bit words vbits[rows/64]: each thread reads 16 bytes, four
// neighbouring lanes make a word (rows and 16*blockDim are multiples of
// 64, so whole warps take part).
__device__ __forceinline__ void valid_bits(const uint8_t* __restrict__ valid, int n, int rows,
                                           u64* vbits) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const bool vec = ((uintptr_t)valid & 15) == 0;
  for (int base = 16 * tid; base - 16 * tid < rows; base += 16 * nt) {
    unsigned m = 0;
    if (vec && base + 16 <= n) {
      const uint4 q = *(const uint4*)(valid + base);
      const unsigned part[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) m |= (((part[j >> 2] >> (8 * (j & 3))) & 0xffu) != 0) << j;
    } else {
      for (int j = 0; j < 16; ++j) m |= (base + j < n && valid[base + j] != 0) << j;
    }
    const u64 word = (u64)m | (u64)__shfl_down_sync(0xffffffffu, m, 1) << 16 |
                     (u64)__shfl_down_sync(0xffffffffu, m, 2) << 32 |
                     (u64)__shfl_down_sync(0xffffffffu, m, 3) << 48;
    if ((lane & 3) == 0 && base < rows) vbits[base >> 6] = word;
  }
}

// Greedy inside one block on its diagonal words diag[64] (bits above b
// only), from the candidates cand.  nz: the boxes whose word is not 0.
// Candidates that suppress nothing are kept in one step with all of them
// before the next candidate that does.
__device__ __forceinline__ u64 resolve_block(const u64* diag, u64 cand, u64 nz) {
  u64 kept = 0;
  while (cand) {
    const u64 sup = cand & nz;
    if (!sup) return kept | cand;
    const int b = __ffsll((long long)sup) - 1;
    const u64 take = cand & (b == 63 ? ~0ull : (2ull << b) - 1ull);
    kept |= take;
    cand &= ~(take | diag[b]);
  }
  return kept;
}

// Append block w's kept boxes (bits `kept`) to the kept list at position nk.
__device__ __forceinline__ void append_kept(uint16_t* klist, int nk, int w, u64 kept, int lane) {
  if ((kept >> lane) & 1ull)
    klist[nk + __popcll(kept & ((1ull << lane) - 1ull))] = (uint16_t)(64 * w + lane);
  if ((kept >> (lane + 32)) & 1ull)
    klist[nk + __popcll(kept & ((1ull << (lane + 32)) - 1ull))] = (uint16_t)(64 * w + lane + 32);
}

// The next column after `w` whose block holds a valid box (cb if none).
__device__ __forceinline__ int next_live(const u64* vbits, int w, int cb) {
  while (w < cb && vbits[w] == 0) ++w;
  return w;
}

// The scan for any N: warp 0 alone, each column in STREAM_CHUNK-word tiles.
// Dynamic shared memory: SCAN_STAGES column stages of STREAM_CHUNK words, then
// vbits[cb], kbits[cb], kcount[cb+1] (kept boxes in the blocks before p),
// klist[64*cb] (the kept boxes in order, as 16-bit indices).
__global__ void __launch_bounds__(SCAN_THREADS)
    nms_scan_stream_kernel(const u64* __restrict__ maskT, const uint8_t* __restrict__ valid,
                           uint8_t* __restrict__ keep, int n, int cb) {
  extern __shared__ __align__(16) u64 sm[];
  __shared__ __align__(8) u64 full[SCAN_STAGES];
  const int chunk = STREAM_CHUNK;
  u64* vbits = sm + SCAN_STAGES * chunk;
  u64* kbits = vbits + cb;
  int* kcount = (int*)(kbits + cb);
  uint16_t* klist = (uint16_t*)(kcount + cb + 1);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int rows = cb * 64;

  valid_bits(valid, n, rows, vbits);
  for (int p = tid; p < cb; p += nt) kbits[p] = 0;
  if (tid == 0) {
    for (int q = 0; q < SCAN_STAGES; ++q) mbar_init(&full[q], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp 0 walks the blocks; the other warps wait at the closing barrier.
  // tiles (w, c): words [c*chunk, min((c+1)*chunk, 64(w+1))) of column w,
  // over the live columns in order; tile t lands in stage t % SCAN_STAGES,
  // and the copies of the next SCAN_STAGES-1 tiles are in flight meanwhile
  if (tid < 32) {
    int iw = next_live(vbits, 0, cb), ic = 0;  // the next tile to copy
    auto start_copy = [&](int t) {
      if (iw >= cb) return;
      const int lo = ic * chunk, len = 64 * (iw + 1);
      const uint32_t words = (uint32_t)(min(lo + chunk, len) - lo);
      if (lane == 0) {
        bulk_load(sm + (t % SCAN_STAGES) * chunk, maskT + (size_t)32 * iw * (iw + 1) + lo,
                  words * 8, &full[t % SCAN_STAGES]);
      }
      if (++ic * chunk >= len) {
        iw = next_live(vbits, iw + 1, cb);
        ic = 0;
      }
    };
    for (int t = 0; t < SCAN_STAGES - 1; ++t) start_copy(t);
    int w = next_live(vbits, 0, cb), c = 0, filled = -1, nk = 0;
    u64 acc = 0;
    for (int t = 0; w < cb; ++t) {
      const int len = 64 * (w + 1);
      const int lo = c * chunk, hi = min(lo + chunk, len);
      // the stage of tile t+STAGES-1 was last read in tile t-1, which
      // closed with __syncwarp
      start_copy(t + SCAN_STAGES - 1);
      // the kept boxes whose words lie in this tile: those of its blocks
      if (c == 0) {
        for (int q = filled + 1 + lane; q <= w; q += 32) kcount[q] = nk;
        filled = w;
        __syncwarp();
      }
      const int kb = kcount[lo >> 6], ke = kcount[min(hi, 64 * w) >> 6];
      const u64* col = sm + (t % SCAN_STAGES) * chunk;
      mbar_wait(&full[t % SCAN_STAGES], (uint32_t)((t / SCAN_STAGES) & 1));
      // which diagonal words are not 0 (read ahead of the OR, which they do
      // not depend on)
      const u64* diag = col + (64 * w - lo);
      u64 nz = 0;
      if (hi == len)
        nz = (u64)__ballot_sync(0xffffffffu, diag[lane] != 0) |
             (u64)__ballot_sync(0xffffffffu, diag[lane + 32] != 0) << 32;
      // what the kept boxes of earlier blocks remove from block w: the OR
      // of their words, read through the kept list, eight list entries in
      // flight per lane
      for (int j = kb + lane; j < ke; j += 256) {
        int idx[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) idx[u] = j + 32 * u < ke ? klist[j + 32 * u] : -1;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (idx[u] >= 0) acc |= col[idx[u] - lo];
      }
      if (hi == len) {
        const u64 removed =
            (u64)__reduce_or_sync(0xffffffffu, (unsigned)acc) |
            (u64)__reduce_or_sync(0xffffffffu, (unsigned)(acc >> 32)) << 32;
        const u64 kept = resolve_block(diag, vbits[w] & ~removed, nz);
        append_kept(klist, nk, w, kept, lane);
        if (lane == 0) kbits[w] = kept;
        nk += __popcll(kept);
        acc = 0;
        w = next_live(vbits, w + 1, cb);
        c = 0;
      } else {
        ++c;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += nt) keep[i] = (uint8_t)((kbits[i >> 6] >> (i & 63)) & 1ull);
}

// The scan for N <= 4096 (every column fits one stage): warp 0 resolves
// the live blocks in order while warps 1..7 work one block ahead.  With
// live[m] the m-th block that holds a valid box, what the kept boxes remove
// from live[m] is P | Q: P, the OR of the words of the kept boxes of
// live[0..m-2], which the helper warps compute while warp 0 resolves
// live[m-1]; Q, the OR of the (at most 64) words of live[m-1]'s kept boxes,
// which warp 0 reads itself.  One block barrier a block hands over the
// kept list one way and P the other.  A helper lane also starts the column
// copies, three ahead, off warp 0's path.
// Dynamic shared memory: SCAN_STAGES stages of 64*cb words, then vbits[cb],
// kbits[cb], live[cb], klist[64*cb].
__global__ void __launch_bounds__(SCAN_THREADS)
    nms_scan_fast_kernel(const u64* __restrict__ maskT, const uint8_t* __restrict__ valid,
                         uint8_t* __restrict__ keep, int n, int cb) {
  extern __shared__ __align__(16) u64 sm[];
  __shared__ __align__(8) u64 full[SCAN_STAGES];
  __shared__ u64 partial[2][SCAN_THREADS / 32];
  __shared__ int nks[2], nlive_s;
  const int rows = cb * 64;
  u64* vbits = sm + SCAN_STAGES * rows;
  u64* kbits = vbits + cb;
  int* live = (int*)(kbits + cb);
  uint16_t* klist = (uint16_t*)(live + cb);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;

  valid_bits(valid, n, rows, vbits);
  for (int p = tid; p < cb; p += nt) kbits[p] = 0;
  if (tid < SCAN_THREADS / 32) partial[0][tid] = partial[1][tid] = 0;
  if (tid == 0) {
    for (int q = 0; q < SCAN_STAGES; ++q) mbar_init(&full[q], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    nks[0] = 0;
  }
  __syncthreads();
  if (tid == 0) {
    int m = 0;
    for (int w = 0; w < cb; ++w)
      if (vbits[w]) live[m++] = w;
    nlive_s = m;
  }
  __syncthreads();
  const int nlive = nlive_s;
  auto start_copy = [&](int m) {  // column live[m] into stage m % SCAN_STAGES
    if (m < nlive) {
      const int w = live[m];
      bulk_load(sm + (m % SCAN_STAGES) * rows, maskT + (size_t)32 * w * (w + 1),
                (uint32_t)(64 * (w + 1)) * 8, &full[m % SCAN_STAGES]);
    }
  };
  if (tid == 32)
    for (int m = 0; m < SCAN_STAGES - 1; ++m) start_copy(m);

  int nk = 0;         // warp 0: kept boxes so far
  u64 prev_kept = 0;  // warp 0: the kept bits of live[m-1]
  for (int m = 0; m < nlive; ++m) {
    __syncthreads();  // klist up to live[m-1] and P of live[m] are published
    if (warp == 0) {
      const int w = live[m];
      const u64* col = sm + (m % SCAN_STAGES) * rows;
      mbar_wait(&full[m % SCAN_STAGES], (uint32_t)((m / SCAN_STAGES) & 1));
      const u64* diag = col + 64 * w;
      const u64 nz = (u64)__ballot_sync(0xffffffffu, diag[lane] != 0) |
                     (u64)__ballot_sync(0xffffffffu, diag[lane + 32] != 0) << 32;
      u64 acc = lane > 0 && lane < SCAN_THREADS / 32 ? partial[m & 1][lane] : 0;
      if (m > 0) {
        const u64* prev = col + 64 * live[m - 1];
        if ((prev_kept >> lane) & 1ull) acc |= prev[lane];
        if ((prev_kept >> (lane + 32)) & 1ull) acc |= prev[lane + 32];
      }
      const u64 removed = (u64)__reduce_or_sync(0xffffffffu, (unsigned)acc) |
                          (u64)__reduce_or_sync(0xffffffffu, (unsigned)(acc >> 32)) << 32;
      const u64 kept = resolve_block(diag, vbits[w] & ~removed, nz);
      append_kept(klist, nk, w, kept, lane);
      if (lane == 0) {
        kbits[w] = kept;
        nks[(m + 1) & 1] = nk + __popcll(kept);
      }
      nk += __popcll(kept);
      prev_kept = kept;
    } else {
      // the stage of live[m-1] is free: warp 0 and the helpers are past it
      if (tid == 32) start_copy(m + SCAN_STAGES - 1);
      // P of live[m+1]: the kept boxes of live[0..m-1]
      u64 acc = 0;
      if (m + 1 < nlive) {
        const u64* col = sm + ((m + 1) % SCAN_STAGES) * rows;
        mbar_wait(&full[(m + 1) % SCAN_STAGES], (uint32_t)(((m + 1) / SCAN_STAGES) & 1));
        const int nka = nks[m & 1];
        const int nh = nt - 32;  // helper threads
        for (int j = tid - 32; j < nka; j += 4 * nh) {
          int idx[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) idx[u] = j + u * nh < nka ? klist[j + u * nh] : -1;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (idx[u] >= 0) acc |= col[idx[u]];
        }
      }
      acc = (u64)__reduce_or_sync(0xffffffffu, (unsigned)acc) |
            (u64)__reduce_or_sync(0xffffffffu, (unsigned)(acc >> 32)) << 32;
      if (lane == 0) partial[(m + 1) & 1][warp] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += nt) keep[i] = (uint8_t)((kbits[i >> 6] >> (i & 63)) & 1ull);
}

static size_t scan_fast_smem_bytes(int cb) {
  return (size_t)(SCAN_STAGES * 64 * cb + 2 * cb) * sizeof(u64) + (size_t)cb * sizeof(int) +
         (size_t)64 * cb * sizeof(uint16_t);
}

static size_t scan_stream_smem_bytes(int cb) {
  return (size_t)(SCAN_STAGES * STREAM_CHUNK + 2 * cb) * sizeof(u64) +
         (size_t)(cb + 1) * sizeof(int) +
         (size_t)64 * cb * sizeof(uint16_t);
}

// Set a kernel's dynamic shared memory limit where it needs more than 48 KB:
// once a device, since the attribute belongs to the device's context (a
// process that launches on several cards sets it on each).  set[d]: the
// limit set on device d so far, 0 for the 48 KB default.
static const int MAX_DEVICES = 64;

static int allow_smem(const void* kernel, size_t bytes, size_t* set) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (bytes <= set[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  set[dev] = bytes;
  return 0;
}

// boxes [n,4] float32 (16-byte aligned); mask scratch [32*cb*(cb+1)] uint64.
extern "C" int nms_mask_launch(const void* boxes, void* mask, int n, float thr, void* stream) {
  const int cb = (n + 63) / 64;
  nms_mask_kernel<<<cb * (cb + 1) / 2, 64, 0, (cudaStream_t)stream>>>((const float4*)boxes, n,
                                                                       thr, (u64*)mask);
  return (int)cudaGetLastError();
}

// valid [n] uint8/bool, keep [n] uint8/bool out, mask as written by
// nms_mask_launch.  n <= 4096: the pipelined scan.
extern "C" int nms_scan_fast_launch(const void* valid, void* keep, const void* mask, int n,
                                    void* stream) {
  static size_t smem_set[MAX_DEVICES] = {};
  if (n > 4096) return (int)cudaErrorInvalidValue;
  const int cb = (n + 63) / 64;
  const size_t smem = scan_fast_smem_bytes(cb);
  const int err = allow_smem((const void*)nms_scan_fast_kernel, smem, smem_set);
  if (err != 0) return err;
  nms_scan_fast_kernel<<<1, SCAN_THREADS, smem, (cudaStream_t)stream>>>(
      (const u64*)mask, (const uint8_t*)valid, (uint8_t*)keep, n, cb);
  return (int)cudaGetLastError();
}

// The same arguments, any n <= 65536 (nms_keep sends it n > 4096): the
// streaming scan.  Its columns stream in STREAM_CHUNK-word tiles so that
// the kept list (128 KB at N = 65536) still fits beside the stages.
extern "C" int nms_scan_stream_launch(const void* valid, void* keep, const void* mask, int n,
                                      void* stream) {
  static size_t smem_set[MAX_DEVICES] = {};
  if (n > 65536) return (int)cudaErrorInvalidValue;
  const int cb = (n + 63) / 64;
  const size_t smem = scan_stream_smem_bytes(cb);
  const int err = allow_smem((const void*)nms_scan_stream_kernel, smem, smem_set);
  if (err != 0) return err;
  nms_scan_stream_kernel<<<1, SCAN_THREADS, smem, (cudaStream_t)stream>>>(
      (const u64*)mask, (const uint8_t*)valid, (uint8_t*)keep, n, cb);
  return (int)cudaGetLastError();
}
