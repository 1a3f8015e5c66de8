// Grouped split-KV decode attention for Hopper, sm_90a.
//
// Replaces no TPU kernel: the reference decodes with plain attention
// (repro/models/attention.py, _sdpa_xla, over a mask of the whole cache),
// and so did the port, whose grouped einsums cloned the permuted K and V of
// every slot, all S positions, in every layer and step before reading the
// clones again. This kernel computes what that path computes, one query
// position per slot against the layer's (b, S, hkv, d) cache read in
// place: slot r attends rows 0 .. min(length[r], S - 1), the row written
// at length[r] included (an idle slot past the end reads all S rows).
// Scores are the fp32 dot products times the scale in fp32, the softmax is
// fp32, and the output is rounded once to the input type.
//
// What bounds it on the H100: about 2 operations per byte read (each K
// and V element is used once per query head of its group: 3 or 4 heads),
// against the ~295 the card needs before its tensor cores are the limit.
// So the design moves each live byte once and nothing else:
//
//  * decode_attn_partial: one block of 128 threads takes one (slot, kv
//    head) and one chunk of CHUNK positions, and holds that kv head's whole
//    query group (up to 8 heads; larger groups take more blocks). Each
//    live K row, then each live V row, is read once for the group as
//    16-byte loads by D/8 neighbouring threads (8 elements each), 64 bytes
//    of rows in flight per thread per load batch and many resident blocks
//    per SM. A block whose chunk starts past its slot's last row returns
//    at once, so dead positions cost no bytes. The chunk's scores go to
//    shared memory, its softmax runs there (max, exp, sum: the chunk's
//    fp32 partials m and l), and the block writes the unnormalised fp32
//    output partial of each head of the group to scratch.
//  * decode_attn_merge: one block per (slot, q head) combines the live
//    chunks' partials in chunk order (no atomics: a call repeats bit for
//    bit) and writes the output in the input type.
//
// The grid depends only on b, hkv, the group and S, never on the lengths,
// which are read on the device: the launch captures into a CUDA graph and
// replays with whatever lengths the graph's input holds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int CHUNK = 256;  // positions per split
constexpr int NT = 128;     // threads per partial block
constexpr int EPT = 8;      // elements of a row per thread

// Eight consecutive elements of one row, loaded as 16-byte pieces (one for
// bf16, two for fp32) through the read-only path.
template <typename T>
struct Row8;

template <>
struct Row8<bf16> {
  uint4 r;
  __device__ __forceinline__ void load(const bf16* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { r = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void get(float (&f)[EPT]) const {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void get(float (&f)[EPT]) const {
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// The block's place in the grid: ((split * b + slot) * hkv + kv head)
// * n_ht + head tile, chunks outermost, so every slot's first chunk is
// dispatched before any slot's second.
struct Place {
  int split, ib, ikv, ht;
  __device__ Place(int bid, int b, int hkv, int n_ht) {
    ht = bid % n_ht;
    bid /= n_ht;
    ikv = bid % hkv;
    bid /= hkv;
    ib = bid % b;
    split = bid / b;
  }
};

// GT: the most q heads a block holds (registers are sized for it); gt of
// them, at most the group's remainder, are live in head tile ht.
template <typename T, int D, int GT>
__global__ void __launch_bounds__(NT)
decode_attn_partial(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ length,
                    float* __restrict__ o_part, float* __restrict__ ml_part,
                    int b, int S, int h, int hkv, int n_ht, int gt,
                    int n_splits, int64_t q_sb, int64_t q_sh, int64_t k_sb,
                    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                    int64_t v_sh, float scale) {
  constexpr int TPR = D / EPT;         // threads per row
  constexpr int NTEAM = NT / TPR;      // rows read at once by the block
  // rows per thread in one load batch: 64 bytes in flight per thread (more
  // rows took more registers than the loads in flight gained), 32 in fp32
  // with 8 heads, whose rows and output partials spill otherwise
  constexpr int U =
      64 / (EPT * sizeof(T)) / (sizeof(T) == 4 && GT == 8 ? 2 : 1);
  constexpr int BATCH = NTEAM * U;     // rows per load batch
  static_assert(CHUNK % BATCH == 0, "a chunk is whole load batches");
  __shared__ float sQ[GT][D];          // the group's q heads in fp32
  __shared__ float sP[GT][CHUNK];      // scores, then probabilities
  __shared__ float sAcc[NTEAM][GT][D];  // each team's output partial
  __shared__ float sM[GT], sL[GT];

  const Place at(blockIdx.x, b, hkv, n_ht);
  const int last = min(length[at.ib], S - 1);
  const int c0 = at.split * CHUNK;
  if (c0 > last) return;  // the chunk holds no live row of this slot
  const int n = min(CHUNK, last - c0 + 1);
  const int group = h / hkv;
  const int g0 = at.ht * gt;
  const int ng = min(gt, group - g0);
  const int ih0 = at.ikv * group + g0;

  const int tid = threadIdx.x;
  const int team = tid / TPR, e0 = (tid % TPR) * EPT;

  // q in shared memory, not registers: the registers go to the rows in
  // flight and the output partials, with room to spare
  for (int i = tid; i < ng * D; i += NT)
    sQ[i / D][i % D] = to_float(q[at.ib * q_sb + (ih0 + i / D) * q_sh +
                                  i % D]);
  __syncthreads();

  // scores: team t takes rows t, t + NTEAM, ...; the row's dot products
  // are summed over its TPR threads by butterfly shuffles
  const T* kp = k + at.ib * k_sb + at.ikv * k_sh + (int64_t)c0 * k_ss + e0;
  const T* vp = v + at.ib * v_sb + at.ikv * v_sh + (int64_t)c0 * v_ss + e0;
  for (int r0 = 0; r0 < n; r0 += BATCH) {
    Row8<T> rows[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * NTEAM + team;
      if (r < n)
        rows[u].load(kp + r * k_ss);
      else
        rows[u].zero();
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g >= ng) break;
      float qf[EPT];
#pragma unroll
      for (int e = 0; e < EPT; ++e) qf[e] = sQ[g][e0 + e];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * NTEAM + team;
        float kf[EPT];
        rows[u].get(kf);
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPT; ++e) s = fmaf(qf[e], kf[e], s);
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (e0 == 0 && r < n) sP[g][r] = s * scale;
      }
    }
  }
  __syncthreads();

  // the chunk's softmax, one warp per head: m, p = exp(s - m), l = sum p
  const int warp = tid >> 5, lane = tid & 31;
  for (int g = warp; g < ng; g += NT / 32) {
    float m = -INFINITY;
    for (int r = lane; r < n; r += 32) m = fmaxf(m, sP[g][r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float p = expf(sP[g][r] - m);
      sP[g][r] = p;
      l += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) sM[g] = m, sL[g] = l;
  }
  __syncthreads();

  // P V over the chunk, each team over its rows, then over the teams
  float acc[GT][EPT];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[g][e] = 0.f;
  for (int r0 = 0; r0 < n; r0 += BATCH) {
    Row8<T> rows[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * NTEAM + team;
      if (r < n)
        rows[u].load(vp + r * v_ss);
      else
        rows[u].zero();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * NTEAM + team;
      if (r >= n) continue;
      float vf[EPT];
      rows[u].get(vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g >= ng) break;
        const float p = sP[g][r];
#pragma unroll
        for (int e = 0; e < EPT; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g >= ng) break;
#pragma unroll
    for (int e = 0; e < EPT; ++e) sAcc[team][g][e0 + e] = acc[g][e];
  }
  __syncthreads();

  // partials of head ih: o_part[ib, ih, split, :], ml_part[ib, ih, split]
  const int64_t head0 = (int64_t)at.ib * h + ih0;
  for (int idx = tid; idx < ng * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    float s = 0.f;
#pragma unroll 8
    for (int t = 0; t < NTEAM; ++t) s += sAcc[t][g][d];
    o_part[((head0 + g) * n_splits + at.split) * D + d] = s;
  }
  if (tid < ng) {
    float* ml = ml_part + ((head0 + tid) * n_splits + at.split) * 2;
    ml[0] = sM[tid];
    ml[1] = sL[tid];
  }
}

// One block of D threads per (slot, q head): the live chunks' partials
// combined in chunk order, o = sum_i o_i e^(m_i - M) / sum_i l_i e^(m_i - M).
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_attn_merge(const float* __restrict__ o_part,
                  const float* __restrict__ ml_part,
                  const int* __restrict__ length, T* __restrict__ o, int S,
                  int h, int n_splits) {
  const int ih = blockIdx.x % h, ib = blockIdx.x / h, d = threadIdx.x;
  const int n_live = min(length[ib], S - 1) / CHUNK + 1;
  const int64_t head = (int64_t)ib * h + ih;
  const float* ml = ml_part + head * n_splits * 2;
  const float* op = o_part + head * n_splits * D + d;
  float m = -INFINITY;
  for (int i = 0; i < n_live; ++i) m = fmaxf(m, ml[2 * i]);
  float l = 0.f, acc = 0.f;
  for (int i = 0; i < n_live; ++i) {
    const float w = expf(ml[2 * i] - m);
    l = fmaf(ml[2 * i + 1], w, l);
    acc = fmaf(op[i * D], w, acc);
  }
  store(o + head * D + d, acc / l);
}

template <typename T, int D, int GT>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* length, void* o, float* o_part,
                     float* ml_part, int b, int S, int h, int hkv, int n_ht,
                     int gt, const int64_t* st, float scale,
                     cudaStream_t stream) {
  const int n_splits = (S + CHUNK - 1) / CHUNK;
  decode_attn_partial<T, D, GT><<<n_splits * b * hkv * n_ht, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, o_part, ml_part, b, S, h, hkv, n_ht,
      gt, n_splits, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_merge<T, D><<<b * h, D, 0, stream>>>(
      o_part, ml_part, length, static_cast<T*>(o), S, h, n_splits);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* length, void* o, float* o_part,
                     float* ml_part, int b, int S, int h, int hkv,
                     const int64_t* st, float scale, cudaStream_t stream) {
  // a group of up to 4 heads in one block; larger groups in the fewest
  // tiles of at most 8, each re-reading the kv head's rows
  const int group = h / hkv;
  if (group <= 4)
    return launch_t<T, D, 4>(q, k, v, length, o, o_part, ml_part, b, S, h,
                             hkv, 1, group, st, scale, stream);
  const int n_ht = (group + 7) / 8;
  return launch_t<T, D, 8>(q, k, v, length, o, o_part, ml_part, b, S, h, hkv,
                           n_ht, (group + n_ht - 1) / n_ht, st, scale,
                           stream);
}

template <typename T>
cudaError_t launch(int d, const void* q, const void* k, const void* v,
                   const int* length, void* o, float* o_part, float* ml_part,
                   int b, int S, int h, int hkv, const int64_t* st,
                   float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_d<T, 32>(q, k, v, length, o, o_part, ml_part, b, S, h,
                             hkv, st, scale, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, length, o, o_part, ml_part, b, S, h,
                             hkv, st, scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, length, o, o_part, ml_part, b, S, h,
                              hkv, st, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Positions per split: the scratch holds ceil(S / CHUNK) partials per (slot,
// q head).
extern "C" int decode_attention_chunk(void) { return CHUNK; }

// dtype: 0 = float32, 1 = bfloat16. q (b, 1, h, d), k and v (b, S, hkv, d)
// with the strides given (elements: q batch, q head, k batch, seq, head, v
// batch, seq, head; head_dim contiguous; every k and v row on a 16-byte
// boundary); length (b,) int32 on the device; o a contiguous (b, 1, h, d)
// of q's type; o_part (b, h, ceil(S / CHUNK), d) and ml_part (b, h,
// ceil(S / CHUNK), 2) fp32 scratch. Returns cudaGetLastError after the
// launches (0 on success).
extern "C" int decode_attention_fwd(int dtype, int d, const void* q,
                                    const void* k, const void* v,
                                    const int* length, void* o,
                                    float* o_part, float* ml_part, int b,
                                    int S, int h, int hkv,
                                    const int64_t* strides, float scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || S < 1 || hkv < 1 || h % hkv) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(d, q, k, v, length, o, o_part, ml_part, b, S, h,
                         hkv, strides, scale, s);
  if (dtype == 1)
    return launch<bf16>(d, q, k, v, length, o, o_part, ml_part, b, S, h, hkv,
                        strides, scale, s);
  return cudaErrorInvalidValue;
}
