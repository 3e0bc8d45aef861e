// Decode attention of a beam search, read through the beams' ancestry table.
//
// Replaces no TPU kernel.  The JAX package's beam search
// (omniparser_tpu/models/generate.py) gathers every layer's key/value cache
// by source beam after every step, in XLA, and attends over the whole
// static cache.  On this card that gather was the largest single cost of
// BLIP-2's 5-beam decode: it reads and writes the whole cache each step
// (62 GB a step for 128 crops x 5 beams x 148 positions x 32 layers), at
// the memory's rate already.  This kernel lets the cache stay where it was
// written and reads it through the table instead.
//
// Layout (ops/beam_attention.py): prefix_k/v [B, H, P, hd], written once by
// the prefill and shared by a crop's K beams; gen_k/v [B*K, H, T, hd], where
// step s wrote the fed token of beam slot j at row (b*K + j, h, s);
// parents [B, K, T] int32: entry (b, j, p) is the slot that holds position
// p of current beam j.  q [B*K, H, 1, hd] is already scaled; out likewise.
//
// What bounds it: bytes.  With K <= 8 query rows a (crop, head) there are
// at most 16 operations a key or value element, far below the card's
// balance of operations to bytes, so no tensor cores.  One block a (crop,
// head) serves the crop's K beams: each prefix row is read once and used
// for all K query rows; then each beam's own rows 0..step are read through
// the table, each row one head's hd contiguous elements; rows past step are
// never read.  A block waits on few round trips to memory, each with many
// bytes in flight: in pass 1 a row is read in 16-byte pieces by S lanes (at
// most BA_PIECES pieces a lane, so hd 80 in bfloat16 takes 2 lanes) and its
// dots are summed by shuffles; in pass 2 thread (r, j, c) sums piece c of
// beam j's output over every R-th position with BA_ROWS rows in flight,
// neighbouring lanes on neighbouring pieces of one row.
//
// Rounding mirrors `attend` (ops/beam_attention.py) and PyTorch's products
// in the stores' dtype: q.k summed in float32, each score rounded to the
// dtype; softmax in float32 over the visible positions (what the masked
// form gives: a masked slot's exp is exactly 0); each probability rounded
// to the dtype; p.v summed in float32 and written in the dtype.  All K x L
// scores stay in shared memory, so the two passes need no second read of
// the keys.  Only the order of the sums differs from the plain version.
// -fmad=false (the build's global flag) costs nothing here: bytes bound it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BA_THREADS 256
#define BA_PIECES 8  // 16-byte pieces a lane holds of a row in pass 1
#define BA_ROWS 8    // rows a thread has in flight in pass 2

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int VEC = 4;  // elements a 16-byte piece
  __device__ static void unpack(uint4 r, float* x) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
  __device__ static float to_float(float v) { return v; }
  __device__ static float from_float(float v) { return v; }
  __device__ static float round(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static void unpack(uint4 r, float* x) {
    const unsigned int w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little-endian: the lower half is the first element
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from_float(float v) { return __float2bfloat16_rn(v); }
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
};

template <>
struct Elem<__half> {
  static constexpr int VEC = 8;
  __device__ static void unpack(uint4 r, float* x) {
    const unsigned int w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
      x[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
    }
  }
  __device__ static float to_float(__half v) { return __half2float(v); }
  __device__ static __half from_float(float v) { return __float2half_rn(v); }
  __device__ static float round(float v) { return __half2float(__float2half_rn(v)); }
};

__device__ __forceinline__ uint4 load_piece(const void* base, size_t row, int hd, int piece,
                                            int vec, int esize) {
  const char* p = (const char*)base + (row * (size_t)hd + (size_t)piece * vec) * esize;
  return __ldg((const uint4*)p);
}

// Pass 1 over rows [0, count): each row is read by a segment of S lanes, a
// lane taking the row's pieces lane, lane + S, ... (at most BA_PIECES), and
// its dots with the query rows j0 .. j0 + nq - 1 are summed across the
// segment.  Every lane of a warp runs the same trip count and the same
// shuffles; `row_of` gives (row in the store, first query row, score slot).
template <typename T, typename RowOf>
__device__ __forceinline__ void score_rows(const T* __restrict__ store, int count, int nq,
                                           int hd, int S, const float* qs, float* sc, int L,
                                           RowOf row_of) {
  constexpr int VEC = Elem<T>::VEC;
  const int pieces = hd / VEC;
  const int nseg = blockDim.x / S, seg = threadIdx.x / S, lane = threadIdx.x % S;
  for (int base = 0; base < count; base += nseg) {
    const int w = base + seg;
    size_t row = 0;
    int j0 = 0, pos = 0;
    if (w < count) row_of(w, row, j0, pos);
    uint4 raw[BA_PIECES];
#pragma unroll
    for (int i = 0; i < BA_PIECES; ++i) {
      const int c = lane + i * S;
      raw[i] = (w < count && c < pieces) ? load_piece(store, row, hd, c, VEC, (int)sizeof(T))
                                         : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int jq = 0; jq < nq; ++jq) {
      const float* qj = qs + (j0 + jq) * hd;
      float d = 0.0f;
#pragma unroll
      for (int i = 0; i < BA_PIECES; ++i) {
        const int c = lane + i * S;
        if (c < pieces) {
          float x[VEC];
          Elem<T>::unpack(raw[i], x);
#pragma unroll
          for (int e = 0; e < VEC; ++e) d += x[e] * qj[c * VEC + e];
        }
      }
      for (int o = S >> 1; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (lane == 0 && w < count) sc[(j0 + jq) * L + pos] = Elem<T>::round(d);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BA_THREADS)
    beam_attention_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                          const T* __restrict__ pv, const T* __restrict__ gk,
                          const T* __restrict__ gv, const int32_t* __restrict__ parents,
                          T* __restrict__ out, int K, int H, int P, int Tn, int hd, int step,
                          int S, int R) {
  constexpr int VEC = Elem<T>::VEC;
  constexpr int ES = (int)sizeof(T);
  extern __shared__ float smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int n = step + 1;  // each beam's own positions
  const int L = P + n;     // the positions a beam attends to
  const int G = hd / VEC;  // 16-byte pieces of a row
  float* qs = smem;                              // [K][hd]
  float* sc = qs + K * hd;                       // [K][L] scores, then probabilities
  float* red = sc + K * L;                       // [R][K][hd] partial outputs
  int* slot_row = (int*)(red + R * K * hd);      // [K][n] gen row of (beam, position)
  const size_t prefix_row0 = ((size_t)b * H + h) * P;

  for (int i = threadIdx.x; i < K * hd; i += blockDim.x) {
    const int j = i / hd, d = i - j * hd;
    qs[i] = Elem<T>::to_float(q[(((size_t)b * K + j) * H + h) * hd + d]);
  }
  for (int i = threadIdx.x; i < K * n; i += blockDim.x) {
    const int j = i / n, p = i - j * n;
    const int slot = parents[((size_t)b * K + j) * Tn + p];
    slot_row[i] = ((b * K + slot) * H + h) * Tn + p;
  }
  __syncthreads();

  // ---- pass 1: scores.  The prefix rows, each read once for all K query
  // rows; then each beam's own rows 0..step through the table.
  score_rows<T>(pk, P, K, hd, S, qs, sc, L, [&](int w, size_t& row, int& j0, int& pos) {
    row = prefix_row0 + w;
    j0 = 0;
    pos = w;
  });
  score_rows<T>(gk, K * n, 1, hd, S, qs, sc, L, [&](int w, size_t& row, int& j0, int& pos) {
    row = (size_t)slot_row[w];
    j0 = w / n;
    pos = P + (w - j0 * n);
  });
  __syncthreads();

  // ---- softmax in float32, a warp a beam ----------------------------------
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32, nwarp = blockDim.x / 32;
  for (int j = warp; j < K; j += nwarp) {
    float* s = sc + j * L;
    float m = -INFINITY;
    for (int i = wl; i < L; i += 32) m = fmaxf(m, s[i]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
    for (int i = wl; i < L; i += 32) sum += expf(s[i] - m);
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int i = wl; i < L; i += 32) s[i] = Elem<T>::round(expf(s[i] - m) / sum);
  }
  __syncthreads();

  // ---- pass 2: p.v.  Thread (r, j, c) sums piece c of beam j's output over
  // the positions r, r + R, ..., BA_ROWS rows in flight; neighbouring lanes
  // read neighbouring pieces of one row.
  const int t = threadIdx.x;
  if (t < R * K * G) {
    const int c = t % G, j = (t / G) % K, r = t / (G * K);
    const float* pj = sc + j * L;
    const int* own = slot_row + j * n;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    for (int w0 = r; w0 < L; w0 += R * BA_ROWS) {
      uint4 raw[BA_ROWS];
      float pw[BA_ROWS];
#pragma unroll
      for (int u = 0; u < BA_ROWS; ++u) {
        const int w = w0 + u * R;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        pw[u] = 0.0f;
        if (w < L) {
          pw[u] = pj[w];
          raw[u] = w < P ? load_piece(pv, prefix_row0 + w, hd, c, VEC, ES)
                         : load_piece(gv, (size_t)own[w - P], hd, c, VEC, ES);
        }
      }
#pragma unroll
      for (int u = 0; u < BA_ROWS; ++u) {
        float x[VEC];
        Elem<T>::unpack(raw[u], x);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += pw[u] * x[e];
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[(r * K + j) * hd + c * VEC + e] = acc[e];
  }
  __syncthreads();
  for (int o = t; o < K * hd; o += blockDim.x) {
    const int j = o / hd, d = o - j * hd;
    float v = 0.0f;
    for (int r = 0; r < R; ++r) v += red[(r * K + j) * hd + d];
    out[(((size_t)b * K + j) * H + h) * hd + d] = Elem<T>::from_float(v);
  }
}

template <typename T>
static int launch(const void* q, const void* pk, const void* pv, const void* gk,
                  const void* gv, const int32_t* parents, void* out, int B, int K, int H,
                  int P, int Tn, int hd, int step, cudaStream_t stream) {
  constexpr int VEC = Elem<T>::VEC;
  const int pieces = hd / VEC;
  if (hd % VEC != 0 || pieces < 1 || pieces > 32 || K < 1 || K * pieces > BA_THREADS ||
      step < 0 || step >= Tn || P < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int S = 1;  // lanes a row in pass 1: at most BA_PIECES pieces a lane
  while (S * BA_PIECES < pieces) S <<= 1;
  const int R = BA_THREADS / (K * pieces);  // position groups in pass 2
  const int n = step + 1;
  const size_t smem = sizeof(float) * ((size_t)K * hd + (size_t)K * (P + n) +
                                       (size_t)R * K * hd + (size_t)K * n);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        beam_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  beam_attention_kernel<T><<<B * H, BA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)pk, (const T*)pv, (const T*)gk, (const T*)gv, parents, (T*)out,
      K, H, P, Tn, hd, step, S, R);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16, 2 float16.  Returns a cudaError_t.
extern "C" int beam_attention_launch(const void* q, const void* prefix_k, const void* prefix_v,
                                     const void* gen_k, const void* gen_v,
                                     const int32_t* parents, void* out, int B, int K, int H,
                                     int P, int Tn, int hd, int step, int dtype,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(q, prefix_k, prefix_v, gen_k, gen_v, parents, out, B, K, H, P, Tn,
                           hd, step, s);
    case 1:
      return launch<__nv_bfloat16>(q, prefix_k, prefix_v, gen_k, gen_v, parents, out, B, K,
                                   H, P, Tn, hd, step, s);
    case 2:
      return launch<__half>(q, prefix_k, prefix_v, gen_k, gen_v, parents, out, B, K, H, P,
                            Tn, hd, step, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
