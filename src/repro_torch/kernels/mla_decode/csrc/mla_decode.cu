// Multi-head latent attention decode (DeepSeek-V2's absorbed form) for
// Hopper, sm_90a.
//
// Replaces no TPU kernel: the reference has no latent attention. A decode
// step of MLA with W_kv_b's key half folded into the query is one
// multi-query attention per slot: every query head q = [q~ (512), q_pe (64)]
// against the slot's latent rows [c (512), k_pe (64)] as they lie in the
// cache, the values being the same rows' first 512 columns. Slot r attends
// rows 0 .. min(length[r], S - 1), the row written at length[r] included.
// Scores are fp32 sums of the bf16 products times the scale, the softmax
// is fp32, the probabilities are rounded to bf16 for the P V product (as
// the flash kernel rounds them), and the output is rounded once to bf16.
//
// What bounds it on the H100: a row is 1,152 bytes and is used by the 16
// heads of its slot for 16 x (576 + 512) multiply-adds, about 30 operations
// a byte: under the card's ~295, so the bytes bound it, but above what its
// scalar fp32 units can do at 3.35 TB/s (the grouped decode kernel's
// design, one FMA per element and head, would take about twice the byte
// bound). So both products run on the tensor cores, where the 16 heads of a
// slot are exactly one m16 tile:
//
//  * mla_decode_partial: one block of 8 warps per (slot, group of 16
//    heads, chunk of CHUNK rows). It walks the chunk's live rows in tiles
//    of 64 through a two-stage cp.async ring in shared memory (each live
//    row read once, dead rows of the last tile zero-filled, chunks past the
//    slot's last row return at once). Per tile: S = Q R^T (16 x 64, each
//    warp 8 rows over the 576 columns, mma.sync m16n8k16), the online
//    softmax update in shared memory, then O += P R[:, :512] (each warp 64
//    of the 512 output columns in registers, the tile's rows read again
//    from shared memory, not from device memory). The block writes its
//    unnormalised fp32 output and its (max, sum) per head to scratch.
//  * mla_decode_merge: one block per (slot, head) combines the live
//    chunks' partials in chunk order (no atomics: a call repeats bit for
//    bit) and writes the bf16 output.
//
// The grid depends only on b, h and S, never on the lengths, which are read
// on the device: the launch captures into a CUDA graph and replays with
// whatever lengths the graph's input holds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int CHUNK = 256;  // rows per split
constexpr int TILE = 64;    // rows per tile of the ring
constexpr int HG = 16;      // query heads per block: one m16 tile
constexpr int NW = 8;       // warps per block
constexpr int NT = NW * 32;
constexpr float LOG2E = 1.4426950408889634f;

template <int DK, int DV>
struct Smem {
  static constexpr int LD = DK + 8;     // padded row: ldmatrix conflict-free
  static constexpr int LDP = TILE + 8;  // padded row of P
  static constexpr int LDS = TILE + 4;  // row of the fp32 score tile
  static constexpr size_t bytes =
      sizeof(bf16) * ((size_t)(HG + 2 * TILE) * LD + HG * LDP) +
      sizeof(float) * (HG * LDS + 3 * HG);
};

// `rows` rows of DK bf16 from src (row stride `stride`) into a padded
// shared tile by 16-byte cp.async over the block; rows at or past `live`
// are zero-filled
template <int DK>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int64_t stride, int rows,
                                          int live) {
  constexpr int CH = DK / 8;
  for (int idx = threadIdx.x; idx < rows * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r < live;
    cp_async16(dst + r * (DK + 8) + c * 8, src + (ok ? r * stride : 0) + c * 8,
               ok);
  }
}

// The block's place: ((split * b + slot) * n_hg + head group), chunks
// outermost, so every slot's first chunk is dispatched before any second.
template <int DK, int DV>
__global__ void __launch_bounds__(NT, 1)
mla_decode_partial(const bf16* __restrict__ q, const bf16* __restrict__ cache,
                   const int* __restrict__ length, float* __restrict__ o_part,
                   float* __restrict__ ml_part, int b, int S, int h,
                   int n_splits, int64_t q_sb, int64_t q_sh, int64_t c_sb,
                   int64_t c_ss, float scale) {
  static_assert(DK % 16 == 0 && DV % (8 * NW * 2) == 0, "tile widths");
  using SM = Smem<DK, DV>;
  constexpr int LD = SM::LD, LDP = SM::LDP, LDS = SM::LDS;
  constexpr int KS = DK / 16;      // k steps of S = Q R^T
  constexpr int NO = DV / NW / 8;  // 8-column output tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // HG x LD
  bf16* sR = sQ + HG * LD;                        // 2 stages of TILE x LD
  bf16* sP = sR + 2 * TILE * LD;                  // HG x LDP
  float* sS = reinterpret_cast<float*>(sP + HG * LDP);  // HG x LDS
  float* sM = sS + HG * LDS;                      // running max (base 2)
  float* sL = sM + HG;                            // running sum
  float* sC = sL + HG;                            // this tile's correction

  const int n_hg = h / HG;
  int bid = blockIdx.x;
  const int hg = bid % n_hg;
  bid /= n_hg;
  const int ib = bid % b, split = bid / b;
  const int last = min(length[ib], S - 1);
  const int c0 = split * CHUNK;
  if (c0 > last) return;  // the chunk holds no live row of this slot
  const int n = min(CHUNK, last - c0 + 1);
  const int n_tiles = (n + TILE - 1) / TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qp = q + ib * q_sb + (int64_t)hg * HG * q_sh;
  const bf16* rp = cache + ib * c_sb + (int64_t)c0 * c_ss;

  load_rows<DK>(sQ, qp, q_sh, HG, HG);
  load_rows<DK>(sR, rp, c_ss, TILE, min(TILE, n));
  cp_async_commit();
  if (tid < HG) sM[tid] = -INFINITY, sL[tid] = 0.f;

  const float sl2 = scale * LOG2E;  // the softmax in base 2
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int r0 = it * TILE;
    const bf16* sT = sR + (it & 1) * TILE * LD;
    if (it + 1 < n_tiles) {
      // the other stage was last read in tile it - 1, which every thread
      // finished before the barrier that ended it
      load_rows<DK>(sR + ((it + 1) & 1) * TILE * LD, rp + (r0 + TILE) * c_ss,
                    c_ss, TILE, min(TILE, n - r0 - TILE));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q R^T: warp w takes rows 8w .. 8w + 7 of the tile
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; kk += 2) {
      uint32_t rf[4];
      ldmatrix_x4(rf, sT + (warp * 8 + (lane & 7)) * LD + kk * 16 +
                          (lane >> 3) * 8);
      uint32_t qa[4];
      ldmatrix_x4(qa, sQ + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
      mma_bf16(s, qa, rf[0], rf[1]);
      if (kk + 1 < KS) {
        ldmatrix_x4(qa, sQ + (lane & 15) * LD + (kk + 1) * 16 +
                            (lane >> 4) * 8);
        mma_bf16(s, qa, rf[2], rf[3]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = warp * 8 + 2 * t + (e & 1);
      sS[(g + (e >> 1) * 8) * LDS + col] =
          r0 + col < n ? s[e] * sl2 : -INFINITY;
    }
    __syncthreads();

    // the online softmax: 16 threads a head, 4 columns each
    {
      const int hd = tid >> 4, sub = tid & 15;
      float* row = sS + hd * LDS + sub * 4;
      float mx = fmaxf(fmaxf(row[0], row[1]), fmaxf(row[2], row[3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[hd];
      const float m_new = fmaxf(m_old, mx);
      float p[4], sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = exp2f(row[c] - m_new);
        sum += p[c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      uint32_t* pp = reinterpret_cast<uint32_t*>(sP + hd * LDP + sub * 4);
      pp[0] = pack_bf16(p[0], p[1]);
      pp[1] = pack_bf16(p[2], p[3]);
      __syncwarp();
      if (sub == 0) {
        const float corr = exp2f(m_old - m_new);
        sC[hd] = corr;
        sM[hd] = m_new;
        sL[hd] = sL[hd] * corr + sum;
      }
    }
    __syncthreads();

    // O = O corr + P R[:, :DV]: warp w takes columns 64w .. 64w + 63
    const float corr0 = sC[g], corr1 = sC[g + 8];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= corr0, acc[j][1] *= corr0;
      acc[j][2] *= corr1, acc[j][3] *= corr1;
    }
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t pa[4];
      ldmatrix_x4(pa, sP + (lane & 15) * LDP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dn = 0; dn < NO / 2; ++dn) {
        uint32_t vf[4];
        ldmatrix_x4_trans(
            vf, sT + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                    warp * (DV / NW) + dn * 16 + ((lane >> 4) << 3));
        mma_bf16(acc[2 * dn], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dn + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage and P are read before they are refilled
  }

  // partials: o_part[ib, split, head, :], ml_part[ib, split, head, :]
  const int64_t head0 = ((int64_t)ib * n_splits + split) * h + hg * HG;
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int col = warp * (DV / NW) + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(o_part + (head0 + g + r * 8) * DV + col) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  if (tid < HG) {
    float* ml = ml_part + (head0 + tid) * 2;
    ml[0] = sM[tid];
    ml[1] = sL[tid];
  }
}

// One block of DV / 4 threads per (slot, head): the live chunks' partials
// combined in chunk order, o = sum_i o_i 2^(m_i - M) / sum_i l_i 2^(m_i - M).
template <int DV>
__global__ void __launch_bounds__(DV / 4)
mla_decode_merge(const float* __restrict__ o_part,
                 const float* __restrict__ ml_part,
                 const int* __restrict__ length, bf16* __restrict__ o, int S,
                 int h, int n_splits) {
  const int ih = blockIdx.x % h, ib = blockIdx.x / h, d = threadIdx.x * 4;
  const int n_live = min(length[ib], S - 1) / CHUNK + 1;
  const int64_t stride = (int64_t)h;  // heads between two splits' rows
  const int64_t head = (int64_t)ib * n_splits * h + ih;
  float m = -INFINITY;
  for (int i = 0; i < n_live; ++i)
    m = fmaxf(m, ml_part[(head + i * stride) * 2]);
  float l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < n_live; ++i) {
    const int64_t row = head + i * stride;
    const float w = exp2f(ml_part[row * 2] - m);
    l = fmaf(ml_part[row * 2 + 1], w, l);
    const float4 p = *reinterpret_cast<const float4*>(o_part + row * DV + d);
    acc[0] = fmaf(p.x, w, acc[0]);
    acc[1] = fmaf(p.y, w, acc[1]);
    acc[2] = fmaf(p.z, w, acc[2]);
    acc[3] = fmaf(p.w, w, acc[3]);
  }
  const float inv = 1.f / l;
  bf16* op = o + ((int64_t)ib * h + ih) * DV + d;
  *reinterpret_cast<uint32_t*>(op) = pack_bf16(acc[0] * inv, acc[1] * inv);
  *reinterpret_cast<uint32_t*>(op + 2) = pack_bf16(acc[2] * inv,
                                                   acc[3] * inv);
}

template <int DK, int DV>
cudaError_t launch(const void* q, const void* cache, const int* length,
                   void* o, float* o_part, float* ml_part, int b, int S,
                   int h, const int64_t* st, float scale,
                   cudaStream_t stream) {
  const int n_splits = (S + CHUNK - 1) / CHUNK;
  auto kernel = mla_decode_partial<DK, DV>;
  constexpr size_t smem = Smem<DK, DV>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_splits * b * (h / HG), NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(cache), length,
      o_part, ml_part, b, S, h, n_splits, st[0], st[1], st[2], st[3], scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mla_decode_merge<DV><<<b * h, DV / 4, 0, stream>>>(
      o_part, ml_part, length, static_cast<bf16*>(o), S, h, n_splits);
  return cudaGetLastError();
}

}  // namespace

// Rows per split: the scratch holds ceil(S / CHUNK) partials per (slot,
// head).
extern "C" int mla_decode_chunk(void) { return CHUNK; }

// q (b, h, dk) bf16 with strides (batch, head) in elements, dk contiguous;
// cache (b, S, dk) bf16 with strides (batch, seq), every row on a 16-byte
// boundary; length (b,) int32 on the device; o a contiguous (b, h, dv)
// bf16; o_part (b, ceil(S / CHUNK), h, dv) and ml_part (b, ceil(S / CHUNK),
// h, 2) fp32 scratch. h a multiple of 16. Returns cudaGetLastError after
// the launches (0 on success).
extern "C" int mla_decode_fwd(int dk, int dv, const void* q,
                              const void* cache, const int* length, void* o,
                              float* o_part, float* ml_part, int b, int S,
                              int h, const int64_t* strides, float scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || S < 1 || h < HG || h % HG) return cudaErrorInvalidValue;
  if (dk == 576 && dv == 512)
    return launch<576, 512>(q, cache, length, o, o_part, ml_part, b, S, h,
                            strides, scale, s);
  return cudaErrorInvalidValue;
}
