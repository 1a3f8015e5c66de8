// Causal GQA flash attention (forward) for Hopper, sm_90a.
//
// Replaces the TPU Pallas kernel repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_bhsd) and computes what it
// computes: scores are scaled by d^-0.5 in fp32, the online softmax
// (running max m, running sum l, output accumulator) is fp32, the kv head
// of q-head ih is ih*hkv/h, keys in the future are masked with -1e30 and
// tiles wholly in the future are never visited, and the output is
// acc / max(l, 1e-30) cast to the input type.
//
// Layout: the public (b, s, h, d) layout with the strides the caller gives
// (head_dim contiguous), so no transpose is needed around the call. Any
// sequence length: ragged q and kv tiles are masked, rows past the end
// are zero-filled.
//
// Two routes, chosen by the input type:
//
// bf16 (flash_fwd_mma, the model path): FlashAttention-2 on the tensor
// cores, at q.k width DK and value width DV (equal but for latent
// attention's expanded prefill, DeepSeek-V2's 192 / 128: its own
// instantiation, with no padding of v). One block owns 64 q rows of one (batch, head) and has two groups
// of 4 warps; each warp owns 16 rows, and the two groups walk alternate
// kv tiles of 64 rows and combine their partial softmaxes at the end, so
// the longest block's serial walk is half as long. S = Q K^T and P V run
// on mma.sync m16n8k16 (bf16 in, fp32 accumulate) fed by ldmatrix; S, the
// running max and sum and the output accumulator stay in registers, and P
// is rounded to bf16 in registers and fed straight to the P V product, so
// no score tile goes through shared memory. Each group's K and V tiles
// arrive by 16-byte cp.async in its own two-stage ring: its next tile
// loads while this one computes. Rows of shared memory are padded by 16
// bytes, so ldmatrix is free of bank conflicts.
//
// fp32 (flash_fwd_f32): scalar fp32 FMAs from shared memory, the first
// version's design, kept because the fp32 tolerance (2e-5) cannot be held
// on bf16 or TF32 tensor cores. One block per (batch, head, 64-row q
// tile) with Q, one K or V tile and the score tile in shared memory.
//
// What bounds it on the H100: causal attention does about 2*d*s^2 flops
// per q-head and, in bf16 with qwen3's 16/8 heads, moves about 6*s*d bytes
// per q-head, so s/3 flops per byte: below ~900 tokens the bound is the
// bytes, above it the bf16 tensor cores. At the main path's shapes (b = 1,
// s <= 512, ~1 GFLOP) both bounds are a few microseconds and the time is
// the latency of the longest block's serial walk over its kv tiles: the
// last q tile of a causal prompt walks them all. So the grid launches the
// last q tiles first, and 64-row q tiles give 128 blocks at qwen3's
// s = 512 (16 heads) and 256 at zamba2's (32 heads), filling the 132 SMs.
// wgmma with TMA and warp specialisation pays off only for long prompts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/mma_sm90.cuh"

namespace {

using namespace mma_sm90;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16 route: mma.sync
// ---------------------------------------------------------------------------

constexpr int MQ = 64;        // q rows per block, 16 per warp of a group
constexpr int MKV = 64;       // kv rows per tile
constexpr int MGT = 128;      // threads per warp group
constexpr int MNT = 2 * MGT;  // threads per block: two warp groups

template <int DK, int DV>
constexpr size_t mma_smem_bytes() {
  // Q, then for each warp group two stages of (K, V); rows padded by 8
  // elements (16 bytes). The combine buffer reuses the K/V stages.
  return sizeof(bf16) *
         ((size_t)MQ * (DK + 8) + 4 * (size_t)MKV * (DK + 8 + DV + 8));
}

// Rows [row0, row0 + 64) of one head into a padded shared tile by 16-byte
// cp.async, spread over `nt` threads; rows at or past n_rows are
// zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int64_t row_stride, int row0,
                                                int n_rows, int tid, int nt) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int idx = tid; idx < MKV * CH; idx += nt) {
    const int r = idx / CH, c = idx % CH;
    const int row = row0 + r;
    const bool live = row < n_rows;
    cp_async16(dst + r * (D + 8) + c * 8,
               src + (live ? row * row_stride : 0) + c * 8, live);
  }
}

// barrier of one warp group (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int gid) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(gid + 1), "n"(MGT) : "memory");
}

// at least one block per SM: without the bound ptxas caps d = 64 at 128
// registers (two blocks per SM) and spills
template <int DK, int DV>
__global__ void __launch_bounds__(MNT, 1)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, int nb,
              int sq, int skv, int h, int hkv, int64_t q_sb, int64_t q_ss,
              int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
              int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
              int64_t o_ss, int64_t o_sh, float scale, int causal) {
  static_assert(DK % 16 == 0 && DV % 16 == 0,
                "head dims must be multiples of 16");
  constexpr int LD = DK + 8;   // padded row of Q and K
  constexpr int LDV = DV + 8;  // padded row of V
  constexpr int KD = DK / 16;  // k steps of Q K^T
  constexpr int ND = DV / 8;   // 8-column tiles of the output
  constexpr int STAGE = MKV * (LD + LDV);  // one stage: K, then V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);

  // longest (last) q tiles first; then heads, then batch
  const int n_qt = (sq + MQ - 1) / MQ;
  const int per_qt = h * nb;
  const int qt = n_qt - 1 - (int)(blockIdx.x / per_qt);
  const int ih = (int)(blockIdx.x % per_qt) % h;
  const int ib = (int)(blockIdx.x % per_qt) / h;
  const int ikv = (int)((int64_t)ih * hkv / h);

  // warp group gid walks kv tiles gid, gid + 2, ...; its warp w % 4 owns
  // rows 16 (w % 4) .. + 15 of the q tile, as the same warp of the other
  // group does
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = warp >> 2, gtid = threadIdx.x & (MGT - 1);
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * MQ;
  const int row_w = q0 + (warp & 3) * 16;  // this warp's first row
  bf16* sKV = sQ + MQ * LD + gid * 2 * STAGE;  // stage st: K, then V

  const bf16* qp = q + ib * q_sb + ih * q_sh;
  const bf16* kp = k + ib * k_sb + ikv * k_sh;
  const bf16* vp = v + ib * v_sb + ikv * v_sh;

  const int q_end = min(q0 + MQ, sq);
  const int kv_end = causal ? min(skv, q_end) : skv;
  const int n_kv = (kv_end + MKV - 1) / MKV;

  load_tile_async<DK>(sQ, qp, q_ss, q0, sq, threadIdx.x, MNT);
  if (gid < n_kv) {
    load_tile_async<DK>(sKV, kp, k_ss, gid * MKV, skv, gtid, MGT);
    load_tile_async<DV>(sKV + MKV * LD, vp, v_ss, gid * MKV, skv, gtid, MGT);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    ldmatrix_x4(qf[kd], sQ + ((warp & 3) * 16 + (lane & 15)) * LD + kd * 16 +
                            (lane >> 4) * 8);

  const float sl2 = scale * LOG2E;  // softmax in base 2
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  int stage = 0;
  for (int it = gid; it < n_kv; it += 2, stage ^= 1) {
    const int kv0 = it * MKV;
    const bf16* sK = sKV + stage * STAGE;
    const bf16* sV = sK + MKV * LD;
    if (it + 2 < n_kv) {
      bf16* nk = sKV + (stage ^ 1) * STAGE;
      load_tile_async<DK>(nk, kp, k_ss, kv0 + 2 * MKV, skv, gtid, MGT);
      load_tile_async<DV>(nk + MKV * LD, vp, v_ss, kv0 + 2 * MKV, skv, gtid,
                          MGT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    group_sync(gid);

    // S = Q K^T, 16 x 64 per warp: eight independent accumulators
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t kf[4];
        ldmatrix_x4(kf, sK + (c * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                            kd * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * c], qf[kd], kf[0], kf[1]);
        mma_bf16(s[2 * c + 1], qf[kd], kf[2], kf[3]);
      }

    // scale (base 2), mask, and the online softmax of rows g and g + 8
    const bool masked = (causal && kv0 + MKV > row_w) || kv0 + MKV > skv;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_w + g + (e >> 1) * 8;
        const int col = kv0 + j * 8 + 2 * t + (e & 1);
        const bool live =
            !masked || (col < skv && (!causal || col <= row));
        s[j][e] = live ? s[j][e] * sl2 : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_r[e >> 1]);
        l_r[e >> 1] += s[j][e];
      }

    // acc += P V, P rounded to bf16 in registers
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t pa[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                              pack_bf16(s[2 * c][2], s[2 * c][3]),
                              pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                              pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int dn = 0; dn < ND / 2; ++dn) {
        uint32_t vf[4];
        ldmatrix_x4_trans(
            vf, sV + (c * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LDV +
                    dn * 16 + ((lane >> 4) << 3));
        mma_bf16(acc[2 * dn], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dn + 1], pa, vf[2], vf[3]);
      }
    }
    group_sync(gid);  // the group is done with this stage before it refills
  }

  // group 1 hands its (acc, m, l) to the same lane of group 0 through
  // shared memory (the K/V stages, free now), one column per thread
  static_assert((ND * 4 + 4) * MGT * sizeof(float) <=
                    4 * STAGE * sizeof(bf16),
                "the combine buffer fits in the K/V stages");
  float* sX = reinterpret_cast<float*>(sQ + MQ * LD);  // (ND*4 + 4) x MGT
  __syncthreads();
  if (gid == 1) {
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sX[(j * 4 + e) * MGT + gtid] = acc[j][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sX[(ND * 4 + r) * MGT + gtid] = m_r[r];
      sX[(ND * 4 + 2 + r) * MGT + gtid] = l_r[r];
    }
  }
  __syncthreads();
  if (gid == 1) return;

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = sX[(ND * 4 + r) * MGT + gtid];
    const float mt = fmaxf(m_r[r], m1);
    const float c0 = exp2f(m_r[r] - mt), c1 = exp2f(m1 - mt);
    l_r[r] = l_r[r] * c0 + sX[(ND * 4 + 2 + r) * MGT + gtid] * c1;
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e)
        acc[j][e] = acc[j][e] * c0 + sX[(j * 4 + e) * MGT + gtid] * c1;
    // the row sums are spread over the 4 lanes of a quad
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv[r] = 1.f / fmaxf(l_r[r], 1e-30f);
  }
  bf16* op = o + ib * o_sb + ih * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_w + g + r * 8;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + row * o_ss + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * r] * inv[r],
                                acc[j][2 * r + 1] * inv[r]);
  }
}

// ---------------------------------------------------------------------------
// fp32 route: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // q rows per block
constexpr int BKV = 64;       // kv rows per tile
constexpr int NT = 256;       // threads per block, a 16 x 16 grid
constexpr int SP = BKV + 1;   // padded row of the score tile

template <int D>
constexpr size_t f32_smem_bytes() {
  // Q tile, one K/V tile (rows padded by one float), score tile, per-row
  // scale
  return sizeof(float) * (2 * BQ * (D + 1) + BQ * SP + BQ);
}

// Copies rows [row0, row0 + 64) of one head into a (64, D + 1) fp32 tile,
// zero past n_rows, multiplied by `mul`.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t row_stride, int row0,
                                          int n_rows, float mul) {
  for (int idx = threadIdx.x; idx < BKV * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < n_rows ? src[row * row_stride + c] * mul : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int sq,
              int skv, int h, int hkv, int64_t q_sb, int64_t q_ss,
              int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
              int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
              int64_t o_ss, int64_t o_sh, float scale, int causal) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;               // BQ x DP
  float* sKV = sQ + BQ * DP;      // BKV x DP
  float* sS = sKV + BKV * DP;     // BQ x SP
  float* sRow = sS + BQ * SP;     // BQ

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int ih = blockIdx.y, ib = blockIdx.z;
  const int ikv = (int)((int64_t)ih * hkv / h);

  const float* qp = q + ib * q_sb + ih * q_sh;
  const float* kp = k + ib * k_sb + ikv * k_sh;
  const float* vp = v + ib * v_sb + ikv * v_sh;

  load_tile<D>(sQ, qp, q_ss, q0, sq, scale);

  // softmax phase: row sr is owned by 4 neighbouring lanes, 16 columns each
  const int sr = tid >> 2, part = tid & 3;
  float m_i = NEG_INF, l_i = 0.f;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  const int q_end = min(q0 + BQ, sq);
  const int kv_end = causal ? min(skv, q_end) : skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile's P V product is done
    load_tile<D>(sKV, kp, k_ss, kv0, skv, 1.f);
    __syncthreads();

    // S = (q * scale) K^T: rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * DP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sKV[(tx + 16 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + tx + 16 * j;
        const bool live = col < skv && (!causal || col <= row);
        sS[(ty + 16 * i) * SP + tx + 16 * j] = live ? s[i][j] : NEG_INF;
      }
    }
    __syncthreads();  // K is read and S is whole

    load_tile<D>(sKV, vp, v_ss, kv0, skv, 1.f);

    // online softmax of row sr over this tile
    {
      float* srow = sS + sr * SP + part * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = expf(m_i - m_new);
      l_i = l_i * corr + sum;
      m_i = m_new;
      if (part == 0) sRow[sr] = corr;
    }
    __syncthreads();  // P, the row corrections and V are in place

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = sRow[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = sKV[kk * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  __syncthreads();
  if (part == 0) sRow[sr] = fmaxf(l_i, 1e-30f);
  __syncthreads();
  float* op = o + ib * o_sb + ih * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    if (row >= sq) continue;
    const float l = sRow[r];
#pragma unroll
    for (int j = 0; j < NC; ++j) op[row * o_ss + tx + 16 * j] = acc[i][j] / l;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int DK, int DV>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int b, int sq, int skv, int h, int hkv,
                       const int64_t* st, float scale, int causal,
                       cudaStream_t stream) {
  auto kernel = flash_fwd_mma<DK, DV>;
  constexpr size_t smem = mma_smem_bytes<DK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (sq + MQ - 1) / MQ * h * b;
  kernel<<<blocks, MNT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), b, sq, skv, h, hkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, int b, int sq, int skv, int h, int hkv,
                   const int64_t* st, float scale, int causal,
                   cudaStream_t stream) {
  if (dtype == 1)
    return launch_mma<D, D>(q, k, v, o, b, sq, skv, h, hkv, st, scale, causal,
                            stream);
  auto kernel = flash_fwd_f32<D>;
  constexpr size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, skv, h, hkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (scalar route), 1 = bfloat16 (tensor-core route; every
// row of q, k, v must start on a 16-byte boundary). d is the head dim of q
// and k, dv that of v and o: equal, or 192 and 128 in bf16. strides
// (elements): q, k, v, o each as (batch, seq, head); head dims must be
// contiguous. Returns cudaGetLastError after the launch (0 on success).
extern "C" int flash_attention_fwd(int dtype, int d, int dv, const void* q,
                                   const void* k, const void* v, void* o,
                                   int b, int sq, int skv, int h, int hkv,
                                   const int64_t* strides, float scale,
                                   int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (dv != d) {
    if (dtype == 1 && d == 192 && dv == 128)
      return launch_mma<192, 128>(q, k, v, o, b, sq, skv, h, hkv, strides,
                                  scale, causal, s);
    return cudaErrorInvalidValue;
  }
  switch (d) {
    case 32:
      return launch<32>(dtype, q, k, v, o, b, sq, skv, h, hkv, strides, scale,
                        causal, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, b, sq, skv, h, hkv, strides, scale,
                        causal, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, b, sq, skv, h, hkv, strides,
                         scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}
