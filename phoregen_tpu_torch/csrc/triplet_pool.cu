// All-k factorized triplet pool for Hopper (sm_90a), float32 throughout.
//
// Replaces the Pallas TPU kernel `_kernel` of
// phoregen_tpu/ops/pallas_triplet.py (entry `triplet_pool_pallas`). For each
// graph b and target bond (j, i):
//
//   angle(k, i)   at i between j->i and k->i, from positions
//   pre(k, i, :)  = act(LN(a_kj[k, j] + a_ji[j, i] + enc(angle) @ w_ang))
//   score(k, h)   = <pre(k, i), q(j, i, h)> / sqrt(Wt)
//   alpha         = softmax over k, masked to m[k] m[i] m[j], k != i != j != k,
//                   denominator floor 1e-30 (a fully masked column gives 0)
//   out(j, i, h)  = sum_k alpha(k, h) * pre(k, i, :)
//
// Design (what differs from the TPU kernel, and why):
// - Parallelism. The Pallas grid is (B, j) with the whole [k, i, Wt] tile of
//   one (b, j) resident in fast memory (819 KB at N = 80, more than a
//   block's shared memory). Here a block is (b, j, TP_WARPS targets i) and
//   each warp owns one target from start to end: the block shares the loads
//   of a_kj[:, j], positions, w_ang and LayerNorm (all cp.async, one wait),
//   then its warps run without another block barrier. 256 threads, about
//   100 KB of shared memory and at most 128 registers: two blocks an SM.
// - A warp walks the sources k in chunks of 32, one per lane. A lane builds
//   its triplet (k, i) alone: geometry, atan2f and the encoding once (one
//   sincosf a frequency; 1/1 repeats 1 and is not computed twice), enc @
//   w_ang with w_ang read as uniform float4 broadcasts, the sum, the
//   LayerNorm (E[(x - mu)^2] form) and the activation on the Wt features
//   in registers; then it scores all heads
//   against q(j, i) from the same registers (the flagship's 16 heads in one
//   pass: 16 independent FMA chains) and stores the row once, 16 bytes a
//   store, into the warp's padded tile.
// - The softmax over k is online across chunks: lane (head, part) reduces
//   the chunk's scores of one head, the running maximum rescales the pool
//   accumulated so far. The pool is a register-tiled product: a lane owns
//   4 heads x 4 features and takes two 16-byte shared loads per 16 FMAs.
//   The division by the denominator (floor 1e-30) comes last, so a fully
//   masked column pools to exactly 0.
// - The products of the angle are kept unfused (`__fmul_rn`, `__fadd_rn`):
//   the cancellation in |a|^2 |b|^2 - (a.b)^2 then rounds as the plain
//   elementwise version does, which matters at nearly collinear triplets.
// - Work that the mask removes is skipped: sources run only up to the
//   graph's last valid atom (padding sits at the tail), and a block's warps
//   take the next TP_WARPS targets among the valid atoms other than j;
//   inside the range the element mask still applies (a masked triplet gets
//   weight 0), so a mask with holes gives the reference's result. Each
//   block zeroes the rows of its own TP_WARPS slots that are no target.
// - Widths. Wt up to 32, heads at most 32 (`ops/pallas_triplet.py` splits
//   more heads into groups of at most 32, one launch each). The inputs'
//   feature rows are padded to a multiple of 4 (Wp = up4(Wt), zeros past
//   Wt in a_kj, a_ji, q, w_ang and the LayerNorm parameters; the wrapper
//   pads them): the padded features of a pre row are 0 before the
//   LayerNorm, which takes its mean and variance over the true Wt, and
//   meet zero query features, so they change no score; the output's
//   padded features are dropped by the wrapper. num_ang is any count:
//   above 7 (more bands than the lane's registers hold) the general build
//   takes each band's sincosf twice, once for its sine row and once for
//   its cosine row. The flagship's Wt = 32 and 16 heads (num_ang <= 7) get
//   a build with both fixed at compile time; other widths run the general
//   build. With only the heads fixed the flagship's build spills and runs
//   15-18% slower, so Wt is fixed too.
// - Bound on the H100: the function writes the output once in full
//   (B*N*N*heads*Wt*4 bytes) and reads q once on the pairs of two valid
//   atoms, the bulk of its traffic, and does about (2*NENC + 8 + 4*heads)
//   * Wt float32 operations per valid triplet; `ops/kernel_check.py` works
//   out both from the inputs. What holds this kernel above it: the triplet
//   phase (transcendentals of the angle, one 16-byte shared load per four
//   FMAs for w_ang and q), the lanes past the last source of a graph in its
//   last chunk, and 16 warps an SM to hide the latencies. Its measured time
//   stands beside the bound in PERF.md (B = 16, 16 heads, Wt = 32, NVIDIA
//   H100 80GB HBM3 at 700 W: 0.94 to 0.96 ms against a bound of 0.18 at
//   N = 80, 0.22 to 0.23 against 0.036 at N = 48, over three chip runs).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TP_WARPS 8                 // target atoms i per block, one warp each
#define TP_NT (32 * TP_WARPS)      // threads per block
#define TP_KC 32                   // sources per chunk, one per lane
#define TP_MAX_BANDS 14            // 2 * num_ang for num_ang <= 7
#define LN_EPS_F 1e-6f
#define CROSS_SQ_EPS_F 1e-12f
#define DENOM_FLOOR_F 1e-30f

struct TPDims {
  int B, N, heads, Wt, num_ang, norm, act;
};

// activation codes, in the order of `ops/pallas_triplet.py::ACT_CODES`
enum {
  ACT_RELU = 0, ACT_GELU, ACT_SILU, ACT_TANH, ACT_SIGMOID, ACT_LEAKYRELU,
  ACT_ELU, ACT_SELU, ACT_SOFTPLUS, ACT_IDENTITY, ACT_COUNT
};

template <int A>
__device__ __forceinline__ float act1(float x) {
  if constexpr (A == ACT_RELU) {
    return fmaxf(x, 0.f);
  } else if constexpr (A == ACT_GELU) {  // tanh form, jax.nn.gelu's default
    const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.f + tanhf(u));
  } else if constexpr (A == ACT_SILU) {
    return x / (1.f + expf(-x));
  } else if constexpr (A == ACT_TANH) {
    return tanhf(x);
  } else if constexpr (A == ACT_SIGMOID) {
    return 1.f / (1.f + expf(-x));
  } else if constexpr (A == ACT_LEAKYRELU) {
    return x >= 0.f ? x : 0.01f * x;
  } else if constexpr (A == ACT_ELU) {
    return x > 0.f ? x : expm1f(x);
  } else if constexpr (A == ACT_SELU) {
    return 1.0507009873554805f *
           (x > 0.f ? x : 1.6732632423543772f * expm1f(x));
  } else if constexpr (A == ACT_SOFTPLUS) {
    return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
  } else {
    return x;
  }
}

template <int A>
__device__ __forceinline__ void act_row(float4 (&y)[8], int W4) {
#pragma unroll
  for (int c4 = 0; c4 < 8; ++c4)
    if (c4 < W4)
      y[c4] = make_float4(act1<A>(y[c4].x), act1<A>(y[c4].y),
                          act1<A>(y[c4].z), act1<A>(y[c4].w));
}

// The activation on a row of 4*W4 features. The switch stands outside the
// element loop: inside it, it costs more than the row's arithmetic.
__device__ __forceinline__ void apply_act(float4 (&y)[8], int W4, int act) {
  switch (act) {
    case ACT_RELU: act_row<ACT_RELU>(y, W4); break;
    case ACT_GELU: act_row<ACT_GELU>(y, W4); break;
    case ACT_SILU: act_row<ACT_SILU>(y, W4); break;
    case ACT_TANH: act_row<ACT_TANH>(y, W4); break;
    case ACT_SIGMOID: act_row<ACT_SIGMOID>(y, W4); break;
    case ACT_LEAKYRELU: act_row<ACT_LEAKYRELU>(y, W4); break;
    case ACT_ELU: act_row<ACT_ELU>(y, W4); break;
    case ACT_SELU: act_row<ACT_SELU>(y, W4); break;
    case ACT_SOFTPLUS: act_row<ACT_SOFTPLUS>(y, W4); break;
    default: break;
  }
}

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }

// Row pitch (floats) of a shared tile whose rows a warp reads or writes one
// row a lane, 16 bytes at a time: an odd number of float4s puts the 8 lanes
// of each quarter-warp on 8 different bank groups. w is a multiple of 4.
__host__ __device__ inline int odd_pitch(int w) {
  return ((w >> 2) & 1) ? w : w + 4;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// 16 bytes from device memory into shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// 4 bytes from device memory into shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// Waits for every cp_async16 / cp_async4 of this thread.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float el(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// y += s * w, componentwise (one FMA each)
__device__ __forceinline__ void fma4(float4& y, float s, const float4& w) {
  y.x = fmaf(s, w.x, y.x); y.y = fmaf(s, w.y, y.y);
  y.z = fmaf(s, w.z, y.z); y.w = fmaf(s, w.w, y.w);
}

// Scores of heads h0..h0+G-1 for the lane's pre row y against q (rows of
// Wt, zero past the last head), times inv_sw, into erow[h0..h0+G); -inf
// where the triplet is masked or the head is padding.
template <int G>
__device__ __forceinline__ void score_heads(const float4 (&y)[8], int W4,
                                            const float* qs, int Wt, int h0,
                                            int NH, bool vk, float inv_sw,
                                            float* erow) {
  float sc[G];
#pragma unroll
  for (int h = 0; h < G; ++h) sc[h] = 0.f;
  if (vk) {
#pragma unroll
    for (int c4 = 0; c4 < 8; ++c4) {
      if (c4 < W4) {
#pragma unroll
        for (int h = 0; h < G; ++h) {
          const float4 q4 = ld4(qs + (h0 + h) * Wt + c4 * 4);
          sc[h] = fmaf(y[c4].x, q4.x, sc[h]);
          sc[h] = fmaf(y[c4].y, q4.y, sc[h]);
          sc[h] = fmaf(y[c4].z, q4.z, sc[h]);
          sc[h] = fmaf(y[c4].w, q4.w, sc[h]);
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < G; h += 4) {
    float sv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      sv[u] = vk && h0 + h + u < NH ? sc[h + u] * inv_sw : -INFINITY;
    st4(erow + h0 + h, make_float4(sv[0], sv[1], sv[2], sv[3]));
  }
}

// Shared-memory layout, in floats. Block part: a_kj[:, j] rows, positions,
// mask, w_ang, LayerNorm scale | bias, encoding frequencies. Then one part
// per warp: q(j, i) [heads][Wt], a_ji(j, i) [Wt], the chunk's pre rows
// [32][PP], its softmax numerators [32][EP], the pool accumulators
// [heads][Wt], and per head the running maximum, sum and rescale factor.
struct TPLay {
  int AP, PP, EP, NHP;
  int akj, pos, msk, wang, lns, fr, warp0;
  int q, aji, pt, et, acc, wm, wl, wsc, wstride;
  int total;
};

__host__ __device__ inline TPLay tp_layout(const TPDims& d) {
  TPLay L;
  const int Wt = up4(d.Wt), NENC = 1 + 4 * d.num_ang;
  L.NHP = up4(d.heads);
  L.AP = odd_pitch(Wt);
  L.PP = odd_pitch(Wt);
  // a lane stores its scores 16 bytes at a time; lane (h, p) of the
  // softmax reads bank p * NHP + h (conflict-free)
  L.EP = L.NHP;
  int o = 0;
  L.akj = o; o += d.N * L.AP;
  L.pos = o; o += up4(3 * d.N);
  L.msk = o; o += up4(d.N);
  L.wang = o; o += NENC * Wt;
  L.lns = o; o += 2 * Wt;
  L.fr = o; o += up4(2 * d.num_ang);
  L.warp0 = o;
  int w = 0;
  L.q = w; w += L.NHP * Wt;
  L.aji = w; w += Wt;
  L.pt = w; w += TP_KC * L.PP;
  L.et = w; w += TP_KC * L.EP;
  L.acc = w; w += L.NHP * Wt;
  L.wm = w; w += L.NHP;
  L.wl = w; w += L.NHP;
  L.wsc = w; w += L.NHP;
  L.wstride = w;
  L.total = o + TP_WARPS * w;
  return L;
}

// W4C, NHC: Wt / 4 and heads fixed at compile time (the flagship's 8 and
// 16), or 0 for the widths of `d` (rows of up4(d.Wt) features).
template <int W4C, int NHC>
__global__ void __launch_bounds__(TP_NT, 2)
triplet_pool_kernel(TPDims d, const float* __restrict__ a_kj,
                    const float* __restrict__ a_ji,
                    const float* __restrict__ q,
                    const float* __restrict__ pos,
                    const float* __restrict__ mask,
                    const float* __restrict__ w_ang,
                    const float* __restrict__ ln_s,
                    const float* __restrict__ ln_b, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  const TPLay L = tp_layout(d);
  const int i0 = blockIdx.x * TP_WARPS, j = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W4 = W4C ? W4C : (d.Wt + 3) >> 2, Wt = 4 * W4;
  // the true width: the LayerNorm's and the scores' scale
  const float wv = W4C ? (float)Wt : (float)d.Wt;
  const int NH = NHC ? NHC : d.heads, HW = NH * Wt;
  const int N = d.N;
  const int NA = d.num_ang, NENC = 1 + 4 * NA;
  const float* mb = mask + (size_t)b * N;

  // nk = 1 + the graph's last valid slot (0: none), nv = its valid slots;
  // every warp finds the same
  int nk = 0, nv = 0;
  for (int t0 = 0; t0 < N; t0 += 32) {
    const unsigned bal =
        __ballot_sync(0xffffffffu, t0 + lane < N && mb[t0 + lane] > 0.f);
    if (bal) nk = t0 + 32 - __clz(bal);
    nv += __popc(bal);
  }
  // The targets i of (b, j) are the valid slots other than j, nl of them;
  // the block's warps take targets number i0 .. i0 + TP_WARPS - 1 in slot
  // order, so that no warp of a block idles on padding or on j. Rows
  // i0 .. i0 + TP_WARPS - 1 of the output that are no target are zeroed
  // here.
  const bool jv = mb[j] > 0.f;
  const int nl = jv ? nv - 1 : 0;
  {
    const int ir = i0 + warp;
    if (ir < N && !(jv && ir < nk && mb[ir] > 0.f && ir != j)) {
      float* o = out + (((size_t)b * N + j) * N + ir) * HW;
      for (int c = lane; c < HW / 4; c += 32) st4(o + c * 4, zero4());
    }
  }
  if (i0 >= nl) return;
  int i = -1;  // the warp's target: valid slot number i0 + warp other than j
  for (int t0 = 0, r = i0 + warp; t0 < nk && i < 0; t0 += 32) {
    const bool v = t0 + lane < nk && mb[t0 + lane] > 0.f && t0 + lane != j;
    const unsigned bal = __ballot_sync(0xffffffffu, v);
    const int cnt = __popc(bal);
    if (r < cnt) {
      const unsigned hit = __ballot_sync(
          0xffffffffu, v && __popc(bal & ((1u << lane) - 1u)) == r);
      i = t0 + __ffs(hit) - 1;
    } else {
      r -= cnt;
    }
  }

  float* akj = sm + L.akj;    // [nk][AP]
  float* posl = sm + L.pos;   // [nk][3]
  float* msk = sm + L.msk;    // [nk]
  float* wang = sm + L.wang;  // [NENC][Wt]
  float* lns = sm + L.lns;    // [2][Wt]
  float* fr = sm + L.fr;      // [2 * num_ang]
  for (int idx = tid; idx < nk * W4; idx += TP_NT) {
    const int k = idx / W4, c4 = idx - k * W4;
    cp_async16(akj + k * L.AP + c4 * 4,
               a_kj + (((size_t)b * N + k) * N + j) * Wt + c4 * 4);
  }
  const bool live = i >= 0;
  const size_t pair = ((size_t)b * N + j) * N + (live ? i : 0);
  float* wr = sm + L.warp0 + warp * L.wstride;
  float* qs = wr + L.q;
  float* ajs = wr + L.aji;
  if (live) {
    for (int c = lane; c < HW / 4; c += 32)
      cp_async16(qs + c * 4, q + pair * HW + c * 4);
    for (int c = lane; c < W4; c += 32)
      cp_async16(ajs + c * 4, a_ji + pair * Wt + c * 4);
    for (int c = HW + lane * 4; c < L.NHP * Wt; c += 128)
      st4(qs + c, zero4());
  }
  // every load in flight before the first wait
  for (int idx = tid; idx < nk * 3; idx += TP_NT)
    cp_async4(posl + idx, pos + (size_t)b * N * 3 + idx);
  for (int idx = tid; idx < nk; idx += TP_NT) cp_async4(msk + idx, mb + idx);
  for (int idx = tid; idx < NENC * Wt; idx += TP_NT)
    cp_async4(wang + idx, w_ang + idx);
  for (int idx = tid; idx < Wt; idx += TP_NT) {
    if (d.norm) {
      cp_async4(lns + idx, ln_s + idx);
      cp_async4(lns + Wt + idx, ln_b + idx);
    } else {
      lns[idx] = 1.f;
      lns[Wt + idx] = 0.f;
    }
  }
  // [1..NA, 1/1..1/NA], as ops/rbf.py::angular_encoding_freq_bands
  for (int idx = tid; idx < 2 * NA; idx += TP_NT)
    fr[idx] = idx < NA ? (float)(idx + 1) : 1.0f / (float)(idx - NA + 1);
  cp_async_wait();
  __syncthreads();
  // no block barrier from here on: each warp finishes its own i
  if (!live) return;

  float* pt = wr + L.pt;      // [32][PP] pre rows of the chunk
  float* et = wr + L.et;      // [32][EP] softmax numerators of the chunk
  float* acc = wr + L.acc;    // [NHP][Wt] pool accumulators
  float* wm = wr + L.wm;      // [NHP] running maximum
  float* wl = wr + L.wl;      // [NHP] running sum
  float* wsc = wr + L.wsc;    // [NHP] rescale of the accumulators
  for (int c = lane; c < L.NHP * W4; c += 32) st4(acc + c * 4, zero4());
  for (int c = lane; c < L.NHP; c += 32) {
    wm[c] = -INFINITY;
    wl[c] = 0.f;
    wsc[c] = 0.f;
  }
  __syncwarp();

  const float pix = posl[i * 3], piy = posl[i * 3 + 1], piz = posl[i * 3 + 2];
  const float rjx = posl[j * 3] - pix, rjy = posl[j * 3 + 1] - piy,
              rjz = posl[j * 3 + 2] - piz;
  const float njsq = __fadd_rn(
      __fadd_rn(__fmul_rn(rjx, rjx), __fmul_rn(rjy, rjy)),
      __fmul_rn(rjz, rjz));
  const float inv_sw = 1.f / sqrtf(wv);
  const int NHP = NHC ? (NHC + 3) & ~3 : L.NHP;
  const int P = 32 / NHP;  // lanes a head in the softmax
  const int ntask = (NHP >> 2) * W4;

  for (int k0 = 0; k0 < nk; k0 += TP_KC) {
    const int k = k0 + lane, kc = min(TP_KC, nk - k0);
    const bool vk = k < nk && msk[k] > 0.f && k != i && k != j;
    if (__ballot_sync(0xffffffffu, vk) == 0u) continue;

    // the lane's pre row, features in registers
    float4 y[8];
#pragma unroll
    for (int c4 = 0; c4 < 8; ++c4) y[c4] = zero4();
    if (vk) {
      const float rkx = posl[k * 3] - pix, rky = posl[k * 3 + 1] - piy,
                  rkz = posl[k * 3 + 2] - piz;
      const float dot = __fadd_rn(
          __fadd_rn(__fmul_rn(rjx, rkx), __fmul_rn(rjy, rky)),
          __fmul_rn(rjz, rkz));
      const float nksq = __fadd_rn(
          __fadd_rn(__fmul_rn(rkx, rkx), __fmul_rn(rky, rky)),
          __fmul_rn(rkz, rkz));
      const float cross_sq =
          __fsub_rn(__fmul_rn(njsq, nksq), __fmul_rn(dot, dot));
      const float ang = atan2f(sqrtf(fmaxf(cross_sq, CROSS_SQ_EPS_F)), dot);
      // enc(ang) @ w_ang, enc = [ang, sin(ang f) x 2NA, cos(ang f) x 2NA],
      // summed in that order
#pragma unroll
      for (int c4 = 0; c4 < 8; ++c4) {
        if (c4 < W4) {
          const float4 w4 = ld4(wang + c4 * 4);
          y[c4] = make_float4(ang * w4.x, ang * w4.y, ang * w4.z, ang * w4.w);
        }
      }
      if (W4C != 0 || 2 * NA <= TP_MAX_BANDS) {
        // band NA has frequency 1/1, as band 0: its sine and cosine are
        // reused
        float cs[TP_MAX_BANDS], s0 = 0.f;
#pragma unroll
        for (int m = 0; m < TP_MAX_BANDS; ++m) {
          cs[m] = 0.f;
          if (m < 2 * NA) {
            float s, c;
            if (m > 0 && m == NA) {
              s = s0;
              c = cs[0];
            } else {
              sincosf(ang * fr[m], &s, &c);
            }
            if (m == 0) s0 = s;
            cs[m] = c;
            const float* wrow = wang + (1 + m) * Wt;
#pragma unroll
            for (int c4 = 0; c4 < 8; ++c4)
              if (c4 < W4) fma4(y[c4], s, ld4(wrow + c4 * 4));
          }
        }
#pragma unroll
        for (int m = 0; m < TP_MAX_BANDS; ++m) {
          if (m < 2 * NA) {
            const float* wrow = wang + (1 + 2 * NA + m) * Wt;
#pragma unroll
            for (int c4 = 0; c4 < 8; ++c4)
              if (c4 < W4) fma4(y[c4], cs[m], ld4(wrow + c4 * 4));
          }
        }
      } else {
        // more bands than registers hold: the sines, then the cosines, in
        // the same order, each band's sincosf taken once for each
        for (int h = 0; h < 2; ++h) {
          for (int m = 0; m < 2 * NA; ++m) {
            float s, c;
            sincosf(ang * fr[m], &s, &c);
            const float* wrow = wang + (1 + 2 * NA * h + m) * Wt;
#pragma unroll
            for (int c4 = 0; c4 < 8; ++c4)
              if (c4 < W4) fma4(y[c4], h ? c : s, ld4(wrow + c4 * 4));
          }
        }
      }
      // + a_kj[k, j] + a_ji[j, i], then LayerNorm and the activation
      float s1 = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < 8; ++c4) {
        if (c4 < W4) {
          const float4 k4 = ld4(akj + k * L.AP + c4 * 4);
          const float4 j4 = ld4(ajs + c4 * 4);
          y[c4] = make_float4((k4.x + j4.x) + y[c4].x, (k4.y + j4.y) + y[c4].y,
                              (k4.z + j4.z) + y[c4].z, (k4.w + j4.w) + y[c4].w);
          s1 += (y[c4].x + y[c4].y) + (y[c4].z + y[c4].w);
        }
      }
      if (d.norm) {
        const float mu = s1 / wv;
        float s2 = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < 8; ++c4) {
          if (c4 < W4) {
            const float4 v = y[c4];
            s2 += ((v.x - mu) * (v.x - mu) + (v.y - mu) * (v.y - mu)) +
                  ((v.z - mu) * (v.z - mu) + (v.w - mu) * (v.w - mu));
          }
        }
        // the padded features (0, past the true width) are no part of the
        // variance
        if (W4C == 0) s2 -= (Wt - d.Wt) * (mu * mu);
        const float rs = rsqrtf(s2 / wv + LN_EPS_F);
#pragma unroll
        for (int c4 = 0; c4 < 8; ++c4) {
          if (c4 < W4) {
            const float4 ls = ld4(lns + c4 * 4), lb = ld4(lns + Wt + c4 * 4);
            const float4 v = y[c4];
            y[c4] = make_float4((v.x - mu) * rs * ls.x + lb.x,
                                (v.y - mu) * rs * ls.y + lb.y,
                                (v.z - mu) * rs * ls.z + lb.z,
                                (v.w - mu) * rs * ls.w + lb.w);
          }
        }
      }
      apply_act(y, W4, d.act);
    }
#pragma unroll
    for (int c4 = 0; c4 < 8; ++c4)
      if (c4 < W4) st4(pt + lane * L.PP + c4 * 4, y[c4]);

    // scores of all heads from the registers into the chunk's tile: the
    // flagship's 16 heads in one pass (16 independent FMA chains), other
    // widths four heads a pass
    if constexpr (NHC == 16) {
      score_heads<16>(y, W4, qs, Wt, 0, NH, vk, inv_sw, et + lane * L.EP);
    } else {
      for (int h0 = 0; h0 < NH; h0 += 4)
        score_heads<4>(y, W4, qs, Wt, h0, NH, vk, inv_sw, et + lane * L.EP);
    }
    __syncwarp();

    // masked softmax statistics of the chunk, merged into the running ones:
    // lane (h, p) takes head h and sources p, p + P, ...; the P parts of a
    // head combine by shuffles
    {
      const int h = lane % NHP, p = lane / NHP;
      const bool on = p < P;
      float mx = -INFINITY;
      if (on)
        for (int kk = p; kk < TP_KC; kk += P)
          mx = fmaxf(mx, et[kk * L.EP + h]);
      for (int o = 1; o < P; o <<= 1)
        mx = fmaxf(mx, __shfl_sync(0xffffffffu, mx,
                                   h + NHP * ((p + o) & (P - 1))));
      const float mo = on ? wm[h] : -INFINITY;
      const float mn = fmaxf(mo, mx);
      float su = 0.f;
      if (on)
        for (int kk = p; kk < TP_KC; kk += P) {
          float* e = et + kk * L.EP + h;
          const float v = *e == -INFINITY ? 0.f : expf(*e - mn);
          *e = v;
          su += v;
        }
      for (int o = 1; o < P; o <<= 1)
        su += __shfl_sync(0xffffffffu, su, h + NHP * ((p + o) & (P - 1)));
      if (on && p == 0) {
        const float scl = mn == -INFINITY ? 0.f : expf(mo - mn);
        wm[h] = mn;
        wl[h] = fmaf(wl[h], scl, su);
        wsc[h] = scl;
      }
    }
    __syncwarp();

    // pool: a lane owns heads 4hq..4hq+3 x features 4c4..4c4+3
    for (int t = lane; t < ntask; t += 32) {
      const int hq = t / W4, c4 = t - hq * W4;
      const float4 s4 = ld4(wsc + hq * 4);
      float4 a[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float4 v = ld4(acc + (hq * 4 + h) * Wt + c4 * 4);
        const float s = el(s4, h);
        a[h] = make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
      }
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        const float4 e4 = ld4(et + kk * L.EP + hq * 4);
        const float4 p4 = ld4(pt + kk * L.PP + c4 * 4);
        fma4(a[0], e4.x, p4);
        fma4(a[1], e4.y, p4);
        fma4(a[2], e4.z, p4);
        fma4(a[3], e4.w, p4);
      }
#pragma unroll
      for (int h = 0; h < 4; ++h) st4(acc + (hq * 4 + h) * Wt + c4 * 4, a[h]);
    }
    __syncwarp();  // the chunk's tiles are free, the statistics final
  }

  // out(j, i, h, :) = acc[h] / max(sum[h], 1e-30), 16-byte stores
  for (int idx = lane; idx < NH * W4; idx += 32) {
    const int h = idx / W4;
    const float dn = fmaxf(wl[h], DENOM_FLOOR_F);
    const float4 v = ld4(acc + idx * 4);
    st4(out + pair * HW + idx * 4,
        make_float4(v.x / dn, v.y / dn, v.z / dn, v.w / dn));
  }
}

static const size_t kTpMaxSmem = 232448;

typedef decltype(&triplet_pool_kernel<0, 0>) TPKernel;

// The flagship's widths get the build with them fixed at compile time.
static TPKernel tp_kernel(const TPDims& d) {
  return d.Wt == 32 && d.heads == 16 && 2 * d.num_ang <= TP_MAX_BANDS
             ? triplet_pool_kernel<8, 16>
             : triplet_pool_kernel<0, 0>;
}

static int tp_dims(const int* dims, TPDims* d) {
  d->B = dims[0]; d->N = dims[1]; d->heads = dims[2]; d->Wt = dims[3];
  d->num_ang = dims[4]; d->norm = dims[5]; d->act = dims[6];
  if (d->B < 1 || d->B > 65535 || d->N < 1 || d->N > 65535 || d->heads < 1 ||
      d->heads > 32 || d->Wt < 1 || d->Wt > 32 || d->num_ang < 1 ||
      d->act < 0 || d->act >= ACT_COUNT)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)tp_layout(*d).total * sizeof(float);
  if (bytes > kTpMaxSmem) return (int)cudaErrorInvalidValue;
  return 0;
}

extern "C" {

// Pointer slots, every feature row padded to Wp = up4(Wt) with zeros:
// a_kj [B,N,N,Wp] (k, j), a_ji [B,N,N,Wp] (j, i), q [B,N,N,heads,Wp] (j, i),
// pos [B,N,3], mask [B,N] (1 = valid), w_ang [1+4*num_ang, Wp],
// ln_scale [Wp], ln_bias [Wp], out [B,N,N,heads*Wp] (j, i); a_kj, a_ji, q
// and out 16-byte aligned. dims: B, N, heads (at most 32), Wt (the true
// width, at most 32), num_ang, norm, act.
int tp_triplet_pool(const void* const* p, int np, const int* dims,
                    void* stream) {
  if (np != 9) return (int)cudaErrorInvalidValue;
  TPDims d;
  int rc = tp_dims(dims, &d);
  if (rc) return rc;
  const size_t bytes = (size_t)tp_layout(d).total * sizeof(float);
  const TPKernel kern = tp_kernel(d);
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (ce != cudaSuccess) return (int)ce;
  const float* const* f = reinterpret_cast<const float* const*>(p);
  dim3 grid((d.N + TP_WARPS - 1) / TP_WARPS, d.N, d.B);
  kern<<<grid, TP_NT, bytes, (cudaStream_t)stream>>>(
      d, f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7],
      reinterpret_cast<float*>(const_cast<void*>(p[8])));
  return (int)cudaGetLastError();
}

// The launch of tp_triplet_pool at these dims: out = dynamic shared memory
// a block (bytes), resident blocks an SM, threads a block, target atoms a
// block. Returns a cudaError_t code.
int tp_launch_plan(const int* dims, int* out) {
  TPDims d;
  int rc = tp_dims(dims, &d);
  if (rc) return rc;
  const size_t bytes = (size_t)tp_layout(d).total * sizeof(float);
  const TPKernel kern = tp_kernel(d);
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (ce != cudaSuccess) return (int)ce;
  int blocks = 0;
  ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, TP_NT,
                                                     bytes);
  if (ce != cudaSuccess) return (int)ce;
  out[0] = (int)bytes; out[1] = blocks; out[2] = TP_NT; out[3] = TP_WARPS;
  return 0;
}

}  // extern "C"
