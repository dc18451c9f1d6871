// Fused layer-stack stage kernels for Hopper (sm_90a), float32 arithmetic
// throughout (the matrix products in 3xTF32 on the tensor cores); the
// inter-stage blocks pre_t and q_z may be stored in bf16.
//
// These replace the four Pallas TPU kernels that `layer_stack_pallas`
// (phoregen_tpu/ops/layer_stack.py) runs per attention layer:
//   ls_stage_node       <- _stage_pallas o _stage_node         (stage A)
//   ls_stage_trip_pre   <- _stage_pallas o _stage_triplet_pre  (stage B1)
//   ls_stage_trip_att   <- _att_pallas / _head_att_accumulate  (stage B2)
//   ls_stage_pos        <- _stage_pallas o _stage_pos          (stage C)
// and the two merged kernels of fused_stack 'pallas3' / 'pallas2':
//   ls_stage_node_pre   <- _stage_pallas o _stage_node_pre     (A + B1)
//   ls_stage_att_pos    <- _att_pos_pallas                     (B2 + C)
// The merged kernels and the single ones run the SAME __device__ bodies
// (node_body, trip_pre_body, trip_att_pairs, pos_body), so the settings
// cannot drift apart.
//
// Design notes (what differs from the TPU kernels, and why):
// - Parallelism. The Pallas kernels run grid (B,) — one graph per step,
//   right for one TPU core. Here A runs one block per (graph, two nodes), C
//   one block per (graph, two ligand destinations), B2 + C one per (graph,
//   ligand destination), B2 one per (graph, j, chunk of i), 512 threads
//   each, one block an SM (launch bounds 512 x 1, up to 128 registers a
//   thread); B1 one block per (graph, j) of 256 threads, two blocks an SM.
//   A and C take two nodes a block (plan_nodes: where the bond grid's rows
//   a pass do not shrink beside them) so that their kNN edge products run
//   on 2 * K = 64 rows a weight pass instead of 32 (measured on the H100:
//   9% off stage A; C's in PERF.md); the bond-grid attention of a node then
//   runs once for each of the two, and not at all for a padded ligand slot
//   (its pool would add exact zeros; C keeps a padded slot's position).
//   B2 + C has no room for a second destination.
// - Stages A and C fold their queries into their key layers: a score is
//   (LN(pre_k) @ k2W + k2b) . q over a head's columns = LN(pre_k) @ W_kq +
//   b_kq with W_kq = k2W's head slices times q's, exact algebra. The key
//   layer (H x H, used only in that dot) becomes H x heads, one product on
//   a weight in shared memory (mm_fold) for both the kNN edges (the G
//   destinations' score columns side by side) and the bond grid. Stage C's
//   value layer is heads wide and rides in the same product, in one weight
//   pass: 4.4 M to about 3.1 M multiply-adds a destination at NL=80; stage
//   A's is H wide and stays a streamed `mm` beside it. The queries and
//   W_kq, b_kq come from one grid-wide phase a stage before its main
//   kernel (node_pos_query_kernel: the queries as one product over 16
//   rows, each thread's k2W slice read once for all of them): C's for
//   every ligand row, A's kNN-edge folds for every row and its bond-grid
//   folds for every ligand row; a block copies its own by cp.async
//   (load_fold). Made inside C's blocks, the single-row query products and
//   two k2W reads a destination, chains of L2 round trips, took 12% of C's
//   block cycles and its LayerNorms and softmaxes slowed beside them
//   (PERF.md).
// - One product routine, `mm`, serves every matrix product of the six
//   kernels and `rows_gemm` but two: the folded layers (`mm_fold`, the same
//   tiles on a weight that lies in shared memory) and B1's encoding
//   product. Products whose width is a multiple of 4 run
//   on the tensor cores in error-compensated 3xTF32 (`mm_tc`): warp-level
//   mma.sync m16n8k8 TF32 tiles, each operand split in registers into a
//   TF32 hi and lo part, three products (lo.hi + hi.lo + hi.hi) into a
//   float32 sum; A's fragments come from shared memory by ldmatrix, the
//   weight's from a two-deep shared-memory ring of k-slices (16 rows of 128
//   columns or 8 of 256, row pitch 8 mod 32 floats) filled by cp.async, one
//   block barrier a slice. The rows' errors against their plain versions
//   are several times a float32 FMA loop's and far inside the 1e-4
//   tolerance (see mm). Stage A's and B2's products take 1.3x-1.6x fewer
//   cycles than on an FMA loop (PERF.md); mma.sync does not reach the
//   tensor cores' wgmma rate, the next step. Single-row
//   products (`vec_mat`) split the sum over k across the block and reduce.
//   The layout of a call is chosen by shape with no integer division: a
//   division is some 30 instructions, and a product's fixed cost counts at
//   these widths.
// - Rows per weight pass. B2 takes a whole column of a destination (all
//   sources j, up to 80 pairs) through its two products at once, so
//   `tq_W1` and `t_out_W` are read once a block, not once per 8 pairs.
//   Where q_h of all heads fits beside a whole column (the flagship at NL <=
//   48), B2 alone takes all heads in one pass over the pre_t tiles; else
//   heads go in groups of 256 / Wt (8 at the flagship): q_h of the group
//   [pairs][256] is computed, a warp per pair streams the pair's pre_t tile
//   (K8 x Wt, contiguous, 16-byte cp.async, rows rotated against bank
//   conflicts) into its own buffer and writes `pooled` over the q_h slots it
//   has consumed, and the group's slice of `t_out_W` accumulates into the
//   output tile. In B2 + C that tile IS stage C's `rows` tile: hb_new is
//   written once and never read back. Each head group re-reads the pre_t
//   tiles (2 passes at the flagship, 419 MB each at NL=80, B=16). Measured
//   on the H100 with groups of 4 (4 passes) the tile phase ran at the
//   memory's rate, not the FMAs': the 132 blocks' tiles (43 MB) do not stay
//   in L2 between passes. One pass over a column of 80 (16 heads, q_h 165
//   KB) does not fit; one pass over 48 + 32 pairs a block measured 6%
//   slower than two over 80 (trip_att_heads).
//   Pairs that the masks void (padding, j == i) skip tile and attention; a
//   padded destination only copies hb + t_out_b and x, and the products of
//   B2 and of the bond grid's attention (A, C) run on the sources up to a
//   graph's last atom only, not on the padding behind it.
// - Shared memory of B2 + C at the flagship (NL=80): rows 41 KB | q_h 81 KB
//   (then C's first-layer tile) | q_z 41 KB, then 16 pre_t tile buffers
//   64 KB, then C's folded product's tile and weight | weight ring 17 KB
//   (between a group's two products it holds the warps' softmax weights) |
//   scores and values: 14 KB; 223,328 bytes, one block an SM.
//   ls_launch_plan reports it. The
//   kNN edge attention of the same destination runs first and lies over the
//   same regions.
// - Wide phases: edge features over (edge, rbf) pairs; each softmax a warp
//   per head with lanes over sources; pools and closing sums split over the
//   block or a warp.
// - B1 (bound by its pre_t write) runs two blocks of 256 threads an SM, its
//   q_z rows in passes small enough for that (48 at NL=80: 92 KB a block),
//   so that one block's stores overlap another's products; the q_z rows and
//   their node terms come in by cp.async, the node terms as the product's
//   starting sum. Its pre_t phase gives a lane one (i, k8) triplet: the
//   angle (atan2f, as the reference) and 11 distinct encodings from three
//   sincosf (2a and 3a by the double- and triple-angle identities; band 1
//   appears twice among the reference's 13, its t_Wang rows are summed).
//   A warp's 32 triplets go as a [32][16] tile through mma.sync m16n8k8 in
//   3xTF32 against the merged t_Wang, split once into registers, starting
//   from a_kj + a_ji; the weight's columns are permuted so that a quad of
//   lanes holds a triplet's Wt features, four consecutive a lane: the
//   LayerNorm takes two shuffles and a lane stores 16 bytes at a time.
//   Every slot of pre_t and q_z is written, padded ones included.
// - Gathers load by index (nbr_idx, trip_idx, lig3_idx) instead of the
//   TPU's one-hot selection matmuls. The node projections that neighbours
//   gather (h @ [e_Wn_h|q_W0|b_Wn], ...) are a grid-wide phase: each stage
//   entry first launches `rows_gemm` (the same `mm` on 80-row tiles), then
//   its main kernels — a fixed sequence of launches, one count. A + B1 runs
//   ONE rows_gemm on [nodeA_W | nodeB_W], then B1's grid and A's grid, each
//   with its own shared-memory footprint (measured equal, within 1%, to one
//   grid whose blocks take either role; two grids need no third kernel).
// - Bounds on the H100 (flagship, B=16, NL=80, NP=96): with every
//   operation at the float32 FMA rate outside the tensor cores (67
//   TFLOP/s), every stage is bound by operations except B1, whose pre_t
//   write (B*NL*NL*K8*Wt*4 = 419 MB) makes it bound by bytes (3.35 TB/s);
//   with the matrix products at 3xTF32's 165 TFLOP/s
//   (kernel_check.bound_tc_ms) the bounds fall by a third or more. The
//   measured times sit beside both bounds in PERF.md.
// - bf16 blocks (`fused_block_dtype`, the JAX package's
//   layer_stack_pallas(block_dtype=bf16)): B1 and A + B1 have a form that
//   stores pre_t and q_z as bf16 (rounded to nearest even from the float32
//   results), B2 and B2 + C one that reads them and widens (Blk<T>; the
//   `_bf16` entries). B1's pre_t write, the one row bound by bytes, halves;
//   B2's pre_t tiles are staged as bf16 (8-byte cp.async) and its q_z rows
//   widened on load. All arithmetic stays float32.
// - Neighbour tables wider than the flagship's kNN 32 (the hybrid cutoff:
//   NL + k sources a ligand row, 112 at NL = 80) take the kNN edge tiles in
//   passes of at most ECMAX rows (edge_chunk), keeping the edge values of
//   all passes apart until the pool has read them; the bond grid's rows a
//   pass shrink to fit (plan_rows).
// Widths must be multiples of 4 (H, Wt: 16-byte loads); heads may be any
// count (a value product with heads % 4 != 0 takes a scalar loop).
// Numerics kept from the reference: LayerNorm as E[x^2]-mu^2, the masked
// softmax with (1-mask)*-1e9 and a denominator floor of 1.0, the cross
// product clamp at 1e-12 before the sqrt, atan2f for the triplet angle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NEG_INF_F (-1e9f)
#define LN_EPS_F 1e-6f
#define CROSS_SQ_EPS_F 1e-12f
#define NRBF 20
#define FE 93     // [edge type x rbf (80) | edge type (4) | dire (9)]
#define FEP 100   // row pitch of the edge-feature tile; columns 93..95 are 0
#define NT 512    // threads per block
#define NW 16     // warps per block
#define NT1 256   // threads per block of stage B1 (two blocks an SM)
#define NW1 8
#define KS 16     // weight rows per staged slice
#define NCMAX 128 // columns per staged pass
#define PD 4      // pad of shared-memory row pitches
#define RMAX 80   // most source rows per pass in A, B2, C
#define RING_HALF (KS * (NCMAX + 8))  // a slice of the weight ring
#define RING_FLOATS (2 * RING_HALF)

__constant__ float c_rbf_off[NRBF] = {
    0.0f, 1.0f, 1.25f, 1.5f, 1.75f, 2.0f, 2.25f, 2.5f, 2.75f, 3.0f,
    3.5f, 4.0f, 4.5f, 5.0f, 5.5f, 6.0f, 7.0f, 8.0f, 9.0f, 10.0f};
#define RBF_COEFF (-0.5f)  // -0.5 / (offset[1] - offset[0])^2

struct Dims {
  int B, NP, NL, K, K8, H, heads, Wt;
};

#define MAXARGS 40
struct Args {
  const void* p[MAXARGS];
};
#define FP(i) (reinterpret_cast<const float*>(a.p[i]))
#define IP(i) (reinterpret_cast<const int*>(a.p[i]))
#define OUTP(i) (reinterpret_cast<float*>(const_cast<void*>(a.p[i])))

// ---------------------------------------------------------------- helpers

__host__ __device__ inline int imax(int x, int y) { return x > y ? x : y; }
__host__ __device__ inline int imin(int x, int y) { return x < y ? x : y; }
__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Column chunk c4 of row k of a [rows][4*W4] tile whose rows are rotated by
// the row index, so that lanes reading one chunk of 8 consecutive rows fall
// on different banks (W4 a power of two; any other W4 gets a valid, less
// spread, rotation).
__device__ __forceinline__ int rot4(int c4, int k, int W4) {
  const int t = c4 + (k & (W4 - 1));
  return t >= W4 ? t - W4 : t;
}

// 16 bytes from device memory into shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// 8 bytes from device memory into shared memory, asynchronously.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// Waits for every cp_async16 / cp_async8 of this thread.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Element type of the inter-stage blocks pre_t and q_z (B1 writes them, B2
// reads them): float, or bf16 (`fused_block_dtype`), which halves their
// bytes. All arithmetic stays float32: B1 rounds its float32 results to
// nearest even when it stores them, B2 widens what it loads. Blk<T> moves 4
// consecutive elements (16 bytes of float, 8 of bf16) at a time.
typedef __nv_bfloat16 bf16;
template <class T> struct Blk;
template <> struct Blk<float> {
  static __device__ __forceinline__ float4 ld(const float* p) { return ld4(p); }
  static __device__ __forceinline__ void st(float* p, float4 v) { st4(p, v); }
  static __device__ __forceinline__ float at(const float* p) { return *p; }
  static __device__ __forceinline__ void cp(float* dst, const float* src) {
    cp_async16(dst, src);
  }
};
template <> struct Blk<bf16> {
  static __device__ __forceinline__ float4 ld(const bf16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
    return make_float4(__bfloat162float(e[0]), __bfloat162float(e[1]),
                       __bfloat162float(e[2]), __bfloat162float(e[3]));
  }
  static __device__ __forceinline__ void st(bf16* p, float4 v) {
    uint2 u;
    bf16* e = reinterpret_cast<bf16*>(&u);
    e[0] = __float2bfloat16_rn(v.x); e[1] = __float2bfloat16_rn(v.y);
    e[2] = __float2bfloat16_rn(v.z); e[3] = __float2bfloat16_rn(v.w);
    *reinterpret_cast<uint2*>(p) = u;
  }
  static __device__ __forceinline__ float at(const bf16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void cp(bf16* dst, const bf16* src) {
    cp_async8(dst, src);
  }
};

// LayerNorm (E[x^2] - mu^2 form) and optional ReLU over M rows of width Wd
// in shared memory; one warp per row.
__device__ void ln_rows(float* X, int ldx, int M, int Wd,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, bool relu) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int r = warp; r < M; r += nw) {
    float* row = X + (size_t)r * ldx;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < Wd; c += 32) {
      const float v = row[c];
      s += v;
      s2 += v * v;
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / Wd;
    const float var = s2 / Wd - mu * mu;
    const float rs = rsqrtf(var + LN_EPS_F);
    for (int c = lane; c < Wd; c += 32) {
      const float y = (row[c] - mu) * rs * scale[c] + bias[c];
      row[c] = relu ? fmaxf(y, 0.f) : y;
    }
  }
}

// ------------------------------------------------------- the product loop

// Weight operand in device memory: element (k, c) lies at
// W[(c / cbw) * cbs + k * ldw + c % cbw] — a plain row-major matrix (one
// column block), or per-head blocks [h][k][cbw] as tq_W1 is packed.
struct WSrc {
  const float* W;
  int ldw, cbw, cbs;
};

__device__ __forceinline__ WSrc wmat(const float* W, int ldw) {
  WSrc ws;
  ws.W = W; ws.ldw = ldw; ws.cbw = 1 << 30; ws.cbs = 0;
  return ws;
}

// A thread's share of staging columns [c0, c0 + nc) of the weight into ring
// rows of `pitch` floats: the 16-byte chunk at column c0 + cl of slice rows
// kk0, kk0 + step, ...; worked out once a column chunk, so that a slice
// costs no division (and a power-of-two width and a plain weight none at
// all: an integer division is some 30 instructions, and a product's fixed
// cost counts at the widths here).
struct StageMap {
  const float* src;  // (row 0, column c0 + cl)
  int ldw, kk0, step, cl, pitch;
};

template <int NTH>
__device__ __forceinline__ StageMap stage_map(const WSrc& ws, int c0, int nc,
                                              int pitch) {
  const int n4 = nc >> 2, tid = threadIdx.x;
  StageMap m;
  int q;
  if ((n4 & (n4 - 1)) == 0) {
    const int l = __ffs(n4) - 1;
    m.step = NTH >> l; q = tid >> l;
  } else {
    m.step = NTH / n4; q = tid / n4;
  }
  m.kk0 = q < m.step ? q : 1 << 20;  // spare threads stage nothing
  m.cl = (tid - q * n4) * 4;
  const int c = c0 + m.cl;
  m.src = c < ws.cbw ? ws.W + c
                     : ws.W + (size_t)(c / ws.cbw) * ws.cbs + c % ws.cbw;
  m.ldw = ws.ldw;
  m.pitch = pitch;
  return m;
}

// Rows [k0, k0 + ks) of the weight into one ring buffer [ks][pitch]; rows
// from Kd on are zero.
__device__ __forceinline__ void stage_slice(const StageMap& m, int Kd, int k0,
                                            int ks, float* buf) {
  for (int kk = m.kk0; kk < ks; kk += m.step) {
    float* dst = buf + kk * m.pitch + m.cl;
    if (k0 + kk < Kd)
      cp_async16(dst, m.src + (size_t)(k0 + kk) * m.ldw);
    else
      st4(dst, make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// Scalar form for a plain weight whose width is no multiple of 4.
__device__ void mm_narrow(const float* A, int lda, int M,
                          const float* __restrict__ W, int ldw, int Kd, int Nc,
                          const float* __restrict__ bias, float* out,
                          int ldo) {
  for (int idx = threadIdx.x; idx < M * Nc; idx += blockDim.x) {
    const int m = idx / Nc, c = idx % Nc;
    float acc = 0.f;
    for (int k = 0; k < Kd; ++k)
      acc = fmaf(A[m * lda + k], __ldg(W + (size_t)k * ldw + c), acc);
    out[(size_t)m * ldo + c] = acc + (bias ? bias[c] : 0.f);
  }
  __syncthreads();
}

// ------------------------------------------- tensor-core products, 3xTF32

// x = hi + lo with hi = x rounded to TF32 (10 mantissa bits, to nearest,
// ties away from zero: cvt.rna.tf32.f32's rounding of a finite x, in two
// integer operations) and lo = x - hi, exact in float32, of which the
// tensor core reads the top 11 significant bits. Rounding lo to TF32 as
// well gave the same errors on the card and cost 2-5% a row; truncating
// hi doubled the products' error, enough to fail chip_smoke.py's bf16
// training check (PERF.md).
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// d += a b over one m16n8k8 tile, TF32 operands, float32 accumulator.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The lane's A fragment of a 16 x 8 tile from shared memory in one
// instruction: four 8 x 4 float matrices, lane l giving the address of row
// l % 8 of matrix l / 8 (see mm_tc).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// One k-step of one row tile against the warp's TN column tiles: the A
// fragment `a` (float32 bits) is split here, the weight fragments come
// split (bh, bl); the three products go small terms first, lo.hi + hi.lo
// + hi.hi.
template <int TN>
__device__ __forceinline__ void tile_step(const uint32_t (&a)[4],
                                          const uint32_t (&bh)[TN][2],
                                          const uint32_t (&bl)[TN][2],
                                          float (&acc)[TN][4]) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(a[q], ah[q], al[q]);
#pragma unroll
  for (int n = 0; n < TN; ++n) {
    mma_tf32(acc[n], al, bh[n]);
    mma_tf32(acc[n], ah, bl[n]);
    mma_tf32(acc[n], ah, bh[n]);
  }
}

// The lane's weight fragments of one k-step from a ring slice (wb: row 0
// of the k-step at the lane's column gr of the warp's first column tile;
// rows `pitch` floats apart), split.
template <int TN>
__device__ __forceinline__ void split_b(const float* wb, int pitch, int tq,
                                        uint32_t (&bh)[TN][2],
                                        uint32_t (&bl)[TN][2]) {
#pragma unroll
  for (int n = 0; n < TN; ++n) {
    split_tf32(__float_as_uint(wb[tq * pitch + n * 8]), bh[n][0], bl[n][0]);
    split_tf32(__float_as_uint(wb[(tq + 4) * pitch + n * 8]), bh[n][1],
               bl[n][1]);
  }
}

// The tensor-core form of `mm`. The block's NWS warps form wm rows x wn
// columns of warps; a warp owns TM x TN tiles of 16 rows x 8 columns (m16n8k8
// fragments: lane (gr, tq) = (lane / 4, lane % 4) holds A elements
// (gr | gr + 8, tq | tq + 4) of a tile, weight elements (tq | tq + 4, gr)
// and outputs (gr | gr + 8, 2 tq | 2 tq + 1)). A pass covers wn * TN * 8
// columns and wm * TM * 16 rows. The weight columns of a pass go through
// the two-deep ring as slices of ks rows (16 rows of 128 columns, 8 of 256)
// at a pitch of 8 mod 32 floats, so that a warp's weight-fragment loads
// fall on 32 banks; one block barrier a slice. A's fragments come from
// shared memory by ldmatrix (rows at lda = 4 mod 32, or 20, on 32 banks);
// rows beyond M read row M - 1 and are not stored. The k loop is straight
// code over the warp's TM x TN tiles, so that their independent mma chains
// and the next tile's loads overlap; a warp with no tile inside the product
// skips it. A k-step that runs past Kd (the last one, when Kd % 8 != 0)
// loads A by element and reads its columns from Kd on as 0; the ring's
// rows there are 0 as well, so nothing that lies in shared memory beyond
// the matrix reaches a stored value.
template <int TM, int TN, int NWS>
__device__ __noinline__ void mm_tc(const float* A, int lda, int M, WSrc ws,
                                   int Kd, int Nc,
                                   const float* __restrict__ bias, float* out,
                                   int ldo, bool accumulate, float* ring,
                                   int lwm) {
  constexpr int LNW = NWS == 16 ? 4 : NWS == 8 ? 3 : NWS == 4 ? 2 : 0;
  static_assert(NWS == 1 << LNW, "a power-of-two warp count");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int wm = 1 << lwm, wn = NWS >> lwm;
  const int wc = warp & (wn - 1), wr = warp >> (LNW - lwm);
  const int cw = wn * TN * 8;
  // ldmatrix: lane l addresses row l % 8 (+ 8 for matrices 1 and 3) and
  // column + 4 for matrices 2 and 3 of a tile
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 4;
  const uint32_t a_sh = (uint32_t)__cvta_generic_to_shared(A);
  for (int c0 = 0; c0 < Nc; c0 += cw) {
    const int nc = imin(cw, Nc - c0);
    const int pitch = ((nc + 31) & ~31) + 8;
    int ks = 8;  // slice rows: a multiple of 8, up to 64, as the ring holds
    while (ks < 64 && (ks + 8) * pitch <= RING_HALF) ks += 8;
    const StageMap sp = stage_map<NWS * 32>(ws, c0, nc, pitch);
    const int wcol = wc * TN * 8;
    const bool col_live = wcol < nc;
    for (int m0 = 0; m0 < M; m0 += wm * TM * 16) {
      const int mb = m0 + wr * TM * 16;
      const int live = col_live ? imin(TM, (M - mb + 15) >> 4) : 0;
      float acc[TM][TN][4];
      uint32_t aa[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int n = 0; n < TN; ++n)
          acc[r][n][0] = acc[r][n][1] = acc[r][n][2] = acc[r][n][3] = 0.f;
        aa[r] = a_sh + (uint32_t)(imin(mb + r * 16 + lrow, M - 1) * lda +
                                  lcol) * 4u;
      }
      stage_slice(sp, Kd, 0, ks, ring);
      for (int k0 = 0, s = 0; k0 < Kd; k0 += ks, s ^= 1) {
        cp_async_wait();
        __syncthreads();
        if (k0 + ks < Kd)
          stage_slice(sp, Kd, k0 + ks, ks, ring + (s ^ 1) * RING_HALF);
        if (live > 0) {
          const float* wb = ring + s * RING_HALF + wcol + gr;
          const int kr = imin(ks, Kd - k0), kf = kr & ~7;
#pragma unroll 2
          for (int kk = 0; kk < kf; kk += 8) {
            uint32_t bh[TN][2], bl[TN][2];
            split_b<TN>(wb + kk * pitch, pitch, tq, bh, bl);
#pragma unroll
            for (int r = 0; r < TM; ++r) {
              uint32_t a[4];
              ldmatrix_x4(a, aa[r] + (uint32_t)(k0 + kk) * 4u);
              tile_step<TN>(a, bh, bl, acc[r]);
            }
          }
          if (kf < kr) {  // the k-step that runs past Kd
            uint32_t bh[TN][2], bl[TN][2];
            split_b<TN>(wb + kf * pitch, pitch, tq, bh, bl);
            const int ka = k0 + kf + tq;
#pragma unroll
            for (int r = 0; r < TM; ++r) {
              const float* ar = A + imin(mb + r * 16 + gr, M - 1) * lda;
              const float* ar8 = A + imin(mb + r * 16 + gr + 8, M - 1) * lda;
              uint32_t a[4];
              a[0] = ka < Kd ? __float_as_uint(ar[ka]) : 0u;
              a[1] = ka < Kd ? __float_as_uint(ar8[ka]) : 0u;
              a[2] = ka + 4 < Kd ? __float_as_uint(ar[ka + 4]) : 0u;
              a[3] = ka + 4 < Kd ? __float_as_uint(ar8[ka + 4]) : 0u;
              tile_step<TN>(a, bh, bl, acc[r]);
            }
          }
        }
      }
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int c = c0 + wcol + n * 8 + 2 * tq;
        if (!col_live || c >= Nc) continue;
        const float b0 = bias ? __ldg(bias + c) : 0.f;
        const float b1 = bias ? __ldg(bias + c + 1) : 0.f;
#pragma unroll
        for (int r = 0; r < TM; ++r) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = mb + r * 16 + gr + 8 * h;
            if (r >= live || row >= M) continue;
            float2* o = reinterpret_cast<float2*>(out + (size_t)row * ldo + c);
            float2 v = make_float2(acc[r][n][2 * h] + b0,
                                   acc[r][n][2 * h + 1] + b1);
            if (accumulate) {
              const float2 old = *o;
              v.x += old.x; v.y += old.y;
            }
            *o = v;
          }
        }
      }
      __syncthreads();  // the ring's slice 0 is staged again next pass
    }
  }
}

// The tensor-core product of a folded key layer (mm_fold): the
// weight W [up8(Kd)][pitch] lies in shared memory (made by load_fold, rows
// from Kd on zero, pitch 8 or 24 mod 32 so that a warp's fragment loads
// fall on 32 banks) and is read in place, no ring and no barrier inside;
// the columns from nsplit on (a multiple of 16, so that no warp's tiles
// straddle it) read A from A + aoff. Otherwise as mm_tc, 16 warps. Kept
// apart from mm_tc: the same branches inside it made the ring-path products
// of stages A and B2 15-33% slower on the H100, and streaming the folds
// through mm's ring instead (two products, keys and values) made stage C
// 7-8% slower (PERF.md).
template <int TM, int TN>
__device__ __noinline__ void mm_tc_sh(const float* A, int lda, int M,
                                      const float* W, int pitch, int Kd,
                                      int Nc, float* out, int ldo, int lwm,
                                      int nsplit, int aoff) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int wm = 1 << lwm, wn = NW >> lwm;
  const int wc = warp & (wn - 1), wr = warp >> (4 - lwm);
  const int cw = wn * TN * 8;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 4;
  for (int c0 = 0; c0 < Nc; c0 += cw) {
    const int wcol = c0 + wc * TN * 8;
    if (wcol >= Nc) continue;
    const float* Aw = wcol >= nsplit ? A + aoff : A;
    const uint32_t a_sh = (uint32_t)__cvta_generic_to_shared(Aw);
    const float* wb = W + wcol + gr;
    for (int m0 = 0; m0 < M; m0 += wm * TM * 16) {
      const int mb = m0 + wr * TM * 16;
      const int live = imin(TM, (M - mb + 15) >> 4);
      if (live <= 0) continue;
      float acc[TM][TN][4];
      uint32_t aa[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int n = 0; n < TN; ++n)
          acc[r][n][0] = acc[r][n][1] = acc[r][n][2] = acc[r][n][3] = 0.f;
        aa[r] = a_sh + (uint32_t)(imin(mb + r * 16 + lrow, M - 1) * lda +
                                  lcol) * 4u;
      }
      const int kf = Kd & ~7;
#pragma unroll 2
      for (int kk = 0; kk < kf; kk += 8) {
        uint32_t bh[TN][2], bl[TN][2];
        split_b<TN>(wb + kk * pitch, pitch, tq, bh, bl);
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          uint32_t a[4];
          ldmatrix_x4(a, aa[r] + (uint32_t)kk * 4u);
          tile_step<TN>(a, bh, bl, acc[r]);
        }
      }
      if (kf < Kd) {  // the k-step that runs past Kd
        uint32_t bh[TN][2], bl[TN][2];
        split_b<TN>(wb + kf * pitch, pitch, tq, bh, bl);
        const int ka = kf + tq;
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float* ar = Aw + imin(mb + r * 16 + gr, M - 1) * lda;
          const float* ar8 = Aw + imin(mb + r * 16 + gr + 8, M - 1) * lda;
          uint32_t a[4];
          a[0] = ka < Kd ? __float_as_uint(ar[ka]) : 0u;
          a[1] = ka < Kd ? __float_as_uint(ar8[ka]) : 0u;
          a[2] = ka + 4 < Kd ? __float_as_uint(ar[ka + 4]) : 0u;
          a[3] = ka + 4 < Kd ? __float_as_uint(ar8[ka + 4]) : 0u;
          tile_step<TN>(a, bh, bl, acc[r]);
        }
      }
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int c = wcol + n * 8 + 2 * tq;
        if (c >= Nc) continue;
#pragma unroll
        for (int r = 0; r < TM; ++r) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = mb + r * 16 + gr + 8 * h;
            if (r >= live || row >= M) continue;
            *reinterpret_cast<float2*>(out + (size_t)row * ldo + c) =
                make_float2(acc[r][n][2 * h], acc[r][n][2 * h + 1]);
          }
        }
      }
    }
  }
  __syncthreads();
}

// The tile shape (TM, TN) and the warps' grid (2^LWM rows of warps) of a
// product of M rows and Nc columns on NWS warps (see mm).
template <int NWS>
__device__ __forceinline__ void mm_shape(int M, int Nc, int& TM, int& TN,
                                         int& LWM) {
  constexpr int LNW = NWS == 16 ? 4 : NWS == 8 ? 3 : NWS == 4 ? 2 : 0;
  // every divisor below is a power of two once the loops are unrolled
  const int ntm = (M + 15) >> 4, ntn = (Nc + 7) >> 3;
  int best = 1 << 30;
  TM = TN = 1;
  LWM = 0;
#pragma unroll
  for (int tn = 1; tn <= 2; ++tn) {
#pragma unroll
    for (int lwm = 0; lwm <= LNW; ++lwm) {
      const int wm = 1 << lwm, wn = NWS >> lwm;
      const int tm = imin(5, (ntm + wm - 1) >> lwm);
      const int cols = (ntn + wn * tn - 1) / (wn * tn);   // column passes
      const int rows =                                     // row passes
          ntm <= wm * tm ? 1 : (ntm + wm * tm - 1) / (wm * tm);
      const int live = imin(tm, ntm);                     // busiest warp
      const int cost = cols * rows * (live * (1 + 8 + 12 * tn) + tn * 6);
      if (cost < best) { best = cost; TM = tm; TN = tn; LWM = lwm; }
    }
  }
}

// out[m*ldo + c] (= or +=) bias[c] + sum_k A[m*lda + k] * W(k, c) for
// m < M, c < Nc. A lies in shared memory, 16-byte aligned, with lda % 4 ==
// 0; its columns from Kd on are not read. `out` lies in shared or device
// memory with 16-byte aligned rows; `ring` is RING_FLOATS of shared memory.
// NWS: the block's warps (16, or 8 in stage B1). Every thread of the block
// must call it; A must be complete (a barrier) before the call, and a
// barrier ends it.
//
// Every product whose width is a multiple of 4 runs on the tensor cores in
// 3xTF32 (mm_tc): each operand x is split in registers into TF32 parts
// (split_tf32: hi = rna(x), lo = x - hi) and a tile's sum takes lo.hi +
// hi.lo + hi.hi, small terms first, in float32. What it leaves out, lo.lo
// and lo's bits beyond TF32, is ~2^-21 of |x||w| at most; the tensor
// core's float32 accumulation adds more than that. Against their plain
// versions the layer-stack rows read max abs errors of a few 1e-7 to a few
// 1e-6, several times those of a float32 FMA loop (measured on the card:
// PERF.md), far inside the 1e-4 tolerances; plain TF32 (hi.hi
// alone) would come near them (tests/test_torch_port_tf32_split.py
// emulates both in numpy). The
// tile shape (TM, TN) and the warps' grid (wm rows of warps) are fixed by
// the product's shape: the one with the least work a k-step on the busiest
// warp, counting an ldmatrix and 4 x 2 for its split a row tile, two
// loads and 2 x 2 for their split a column tile, and three mma a tile at
// four instruction slots each (an m16n8k8 TF32 mma.sync holds its SM
// quarter's tensor core, which four warps share, for several cycles).
// Plain weights of widths that are no multiple of 4 (value heads) take
// mm_narrow.
template <int NWS = NW>
__device__ __noinline__ void mm(const float* A, int lda, int M, WSrc ws,
                                int Kd, int Nc, const float* bias, float* out,
                                int ldo, bool accumulate, float* ring) {
  if (Nc & 3) {
    mm_narrow(A, lda, M, ws.W, ws.ldw, Kd, Nc, bias, out, ldo);
    return;
  }
  int TM, TN, LWM;
  mm_shape<NWS>(M, Nc, TM, TN, LWM);
#define MM_TC(T, N)                                                         \
  mm_tc<T, N, NWS>(A, lda, M, ws, Kd, Nc, bias, out, ldo, accumulate, ring, \
                   LWM)
  switch (TN * 8 + TM) {
    case 9: MM_TC(1, 1); break;
    case 10: MM_TC(2, 1); break;
    case 11: MM_TC(3, 1); break;
    case 12: MM_TC(4, 1); break;
    case 13: MM_TC(5, 1); break;
    case 17: MM_TC(1, 2); break;
    case 18: MM_TC(2, 2); break;
    case 19: MM_TC(3, 2); break;
    case 20: MM_TC(4, 2); break;
    default: MM_TC(5, 2);
  }
#undef MM_TC
}

// out[m*ldo + c] = sum_k A'[m*lda + k] * W[k*pitch + c] for m < M, c < Nc
// (Nc % 4 == 0), A' = A for c < nsplit and A + aoff from there on: the
// folded key layer (and stage C's value layer) in one product on the
// weight W that load_fold copied into shared memory (see mm_tc_sh). 16
// warps; W and A must be complete before the call, and a barrier ends it.
__device__ __noinline__ void mm_fold(const float* A, int lda, int M,
                                     const float* W, int pitch, int Kd,
                                     int Nc, float* out, int ldo, int nsplit,
                                     int aoff) {
  int TM, TN, LWM;
  mm_shape<NW>(M, Nc, TM, TN, LWM);
#define MM_TC(T, N) \
  mm_tc_sh<T, N>(A, lda, M, W, pitch, Kd, Nc, out, ldo, LWM, nsplit, aoff)
  switch (TN * 8 + TM) {
    case 9: MM_TC(1, 1); break;
    case 10: MM_TC(2, 1); break;
    case 11: MM_TC(3, 1); break;
    case 12: MM_TC(4, 1); break;
    case 13: MM_TC(5, 1); break;
    case 17: MM_TC(1, 2); break;
    case 18: MM_TC(2, 2); break;
    case 19: MM_TC(3, 2); break;
    case 20: MM_TC(4, 2); break;
    default: MM_TC(5, 2);
  }
#undef MM_TC
}

// out[c] = bias[c] + sum_k v[k] * W[k*ldw + c] for c < Nc (Nc % 4 == 0,
// Nc <= 4 * blockDim): a thread takes 4 columns and one of blockDim / (Nc/4)
// parts of the sum over k, with all its 16-byte weight loads in flight
// together; the parts are reduced through `scr` (4 * blockDim floats; the
// idle weight ring). v must be complete before; a barrier ends it.
__device__ void vec_mat(const float* v, const float* __restrict__ W, int ldw,
                        int Kd, int Nc, const float* __restrict__ bias,
                        float* out, float* scr) {
  const int tid = threadIdx.x, ng = Nc >> 2, parts = blockDim.x / ng;
  const int kp = (Kd + parts - 1) / parts;
  if (tid < parts * ng) {
    const int c = (tid % ng) * 4, p = tid / ng;
    const int k1 = imin(Kd, (p + 1) * kp);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int k = p * kp; k < k1; ++k) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(
          W + (size_t)k * ldw + c));
      const float vk = v[k];
      acc.x = fmaf(vk, w.x, acc.x); acc.y = fmaf(vk, w.y, acc.y);
      acc.z = fmaf(vk, w.z, acc.z); acc.w = fmaf(vk, w.w, acc.w);
    }
    st4(scr + p * Nc + c, acc);
  }
  __syncthreads();
  if (tid < Nc) {
    float s = bias[tid];
    for (int p = 0; p < parts; ++p) s += scr[p * Nc + tid];
    out[tid] = s;
  }
  __syncthreads();
}

// out[c] (= or +=) sum_k al[k*ldal + c/dh] * V[k*ldv + c] for c < H, k < n:
// the attention pool of one destination, split over blockDim / H threads a
// column and reduced through `scr` (blockDim floats; the idle weight ring).
__device__ void pool_cols(const float* al, int ldal, const float* V, int ldv,
                          int n, int H, int dh, float* out, bool accumulate,
                          float* scr) {
  const int tid = threadIdx.x, parts = blockDim.x / H;
  if (tid < parts * H) {
    const int c = tid % H, p = tid / H;
    float acc = 0.f;
    for (int k = p; k < n; k += parts)
      acc = fmaf(al[k * ldal + c / dh], V[(size_t)k * ldv + c], acc);
    scr[tid] = acc;
  }
  __syncthreads();
  if (tid < H) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += scr[p * H + tid];
    out[tid] = accumulate ? out[tid] + s : s;
  }
  __syncthreads();
}

// 1 + the last ligand slot of the graph that holds an atom (0: none), through
// the shared-memory word `slot`. Sources from there on are padding: their
// softmax weights are exactly 0 and their triplets all masked, so the bond
// grid's attention and B2 run on the sources before it only. Every thread of
// the block must call it.
__device__ int valid_sources(const float* ml, int NL, int* slot) {
  if (threadIdx.x == 0) *slot = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < NL; j += blockDim.x)
    if (ml[j] != 0.f) atomicMax(slot, j + 1);
  __syncthreads();
  return *slot;
}

// Masked softmax over n sources for each head, in place on sc[n][NH]: a
// warp per head, lanes over sources. mask(k) gives the 0/1 mask of source k.
template <class Mask>
__device__ void softmax_heads(float* sc, int n, int NH, const Mask& mask) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int hh = warp; hh < NH; hh += nw) {
    float m = -INFINITY;
    for (int k = lane; k < n; k += 32)
      m = fmaxf(m, sc[k * NH + hh] + (1.f - mask(k)) * NEG_INF_F);
    m = warp_max(m);
    float sum = 0.f;
    for (int k = lane; k < n; k += 32) {
      const float mk = mask(k);
      const float e = expf(sc[k * NH + hh] + (1.f - mk) * NEG_INF_F - m) * mk;
      sc[k * NH + hh] = e;
      sum += e;
    }
    const float den = fmaxf(warp_sum(sum), 1.f);
    for (int k = lane; k < n; k += 32) sc[k * NH + hh] /= den;
  }
}

// Y[r, c] = sum_k X[row(r), k] * W[k, c] with rows grouped per graph:
// row(r) = (r / rpb) * bstride + roff + r % rpb. Grid-wide phase for the
// per-node projections that neighbours gather: a block takes RMAX rows and
// NCMAX columns through `mm`.
__global__ void __launch_bounds__(NT)
rows_gemm(const float* __restrict__ X, int ldx, int rows, int rpb,
          int bstride, int roff, int Kd, const float* __restrict__ W, int Nc,
          float* __restrict__ Y) {
  extern __shared__ float sm[];  // [RMAX][Kd + PD] | ring
  const int lda = Kd + PD, K4 = Kd >> 2;
  const int r0 = blockIdx.x * RMAX, nr = imin(RMAX, rows - r0);
  const int c0 = blockIdx.y * NCMAX, nc = imin(NCMAX, Nc - c0);
  for (int idx = threadIdx.x; idx < nr * K4; idx += blockDim.x) {
    const int rr = idx / K4, k = (idx % K4) * 4, r = r0 + rr;
    const size_t row = (size_t)(r / rpb) * bstride + roff + r % rpb;
    st4(sm + rr * lda + k, ld4(X + row * ldx + k));
  }
  __syncthreads();
  mm(sm, lda, nr, wmat(W + c0, Nc), Kd, nc, nullptr,
     Y + (size_t)r0 * Nc + c0, Nc, false, sm + RMAX * lda);
}

// ------------------------------------------------ kNN edge attention (A, C)

// Table argument slots shared by stages A and C.
enum {
  T_NBR_IDX = 5, T_NBR_MASK, T_EDGE_TYPE, T_EW, T_PHORE_NORM, T_LIG3_IDX,
  T_LIG3_MASK, T_MASK_L
};

// comb[m]: phore unit norm for phore nodes, neighbour-centroid offset
// (mean of the 3 frozen nearest ligand atoms minus own position) for
// ligand nodes.
__device__ void node_comb(const Dims& d, const Args& a, const float* xb,
                          int b, int m, float out[3]) {
  if (m < d.NP) {
    const float* pn = FP(T_PHORE_NORM) + ((size_t)b * d.NP + m) * 3;
    out[0] = pn[0]; out[1] = pn[1]; out[2] = pn[2];
    return;
  }
  const int l = m - d.NP;
  const int* li = IP(T_LIG3_IDX) + ((size_t)b * d.NL + l) * 3;
  const float* lm = FP(T_LIG3_MASK) + ((size_t)b * d.NL + l) * 3;
  const float cnt = fmaxf(lm[0] + lm[1] + lm[2], 1.f);
  float c[3] = {0.f, 0.f, 0.f};
  for (int q = 0; q < 3; ++q) {
    const float* p = xb + (size_t)(d.NP + li[q]) * 3;
    for (int e = 0; e < 3; ++e) c[e] += lm[q] * p[e];
  }
  const float* pl = xb + (size_t)m * 3;
  for (int e = 0; e < 3; ++e) out[e] = c[e] / cnt - pl[e];
}

// Heads per group in B2 + C: as many as fill 2 * NCMAX columns of q_h (8 at
// the flagship). Each group is one more pass over the pre_t tiles. B2 alone
// takes all heads in one group (trip_att_heads).
__host__ __device__ inline int att_head_group(const Dims& d) {
  return imax(1, imin(d.heads, 2 * NCMAX / d.Wt));
}

// Edge rows a pass of the kNN edge tiles: all of a block's KE = G * K edges
// up to ECMAX (the flagship's 2 x 32), else evened-out chunks of at most
// ECMAX. A hybrid neighbour table (NL + k sources a ligand row, 112 at
// NL = 80) takes two passes of 56.
#define ECMAX 64
__host__ __device__ inline int edge_chunk(int KE) {
  const int nc = (KE + ECMAX - 1) / ECMAX;
  return nc > 1 ? (KE + nc - 1) / nc : KE;
}

// The folded second layer of one attention (see load_fold): one product of
// nc columns on the LayerNorm'd first-layer tile, score columns
// [g * heads, (g + 1) * heads) for each of its G destinations (the query
// folded into the key layer) and, where the value layer is heads wide
// (stage C: `values`), value columns [voff, voff + heads), voff a multiple
// of 16 so that no warp's tiles straddle the two inputs. The weight lies
// in shared memory [up8(H)][pitch] (pitch 8 or 24 mod 32, past nc rounded
// up to 16), its bias row [up4(nc)] after it.
struct Fold {
  int voff, nc, pitch, floats;
};

__host__ __device__ inline Fold fold_geom(const Dims& d, int G, bool values) {
  Fold f;
  f.voff = (G * d.heads + 15) & ~15;
  f.nc = f.voff + (values ? up4(d.heads) : 0);
  f.pitch = ((f.nc + 15) & ~15) + 8;
  f.floats = ((d.H + 7) & ~7) * f.pitch + up4(f.nc);
  return f;
}

// Shared memory of stages A, C and B2 (+ C), in floats from the block's
// base. Regions that are never live together lie over one another:
//   rows: the R source rows of the bond grid (B2's output tile) | the kNN
//         edge features [KC][FEP] of one pass over the edges (KC of the
//         KE edges of the block's G nodes, see edge_chunk)
//   u1:   first-layer tile [R or KC][2H+PD] | B2's q_h / pooled
//         [R][hg*Wt+PD] (hg heads a group; 0: no B2)
//   u2:   the folded product's tile [R or KC][nc] and its weight (stage A
//         in one pass over the edges: after the edge values [KC][H+PD]) |
//         B2's q_z [R][H+PD] while a head group's queries are made, then
//         its per-warp pre_t tiles [K8*Wt]
// then the weight ring (between B2's two products of a head group it holds
// the warps' softmax weights [32][4]) and what lives through the whole
// block. The value layer is vcols wide: H in stage A, heads in stage C.
// Stage A's bond values [NL][H] lie in `rows` (free once the first layer
// has read them) when one pass takes all NL sources, else in vall. When
// the edges take more than one pass, their values [KE][H] are kept in vall
// until the edge attention's pool has read them (the bond grid's attention
// comes after it); in one pass they stay in u2. Stage C keeps the edge
// values [KE][heads] in vall, then the bond grid's.
struct Lay {
  int R, KC, vsep, ldv, ef, rows, u1, u2, ring, vall, scb, sc, qt, outv,
      rel, emask, ew, dist, d3, src, wp, misc, total;
};

__host__ __device__ inline Lay stage_layout(const Dims& d, int vcols, int R,
                                            bool edge, int hg, int G = 1,
                                            bool vfold = false) {
  // K: the edge rows of the block's G destination nodes, KC a pass of them;
  // vfold: the values ride in the folded product (stage C)
  const int H = d.H, K = edge ? G * d.K : 0, PH = H + PD, PP = 2 * H + PD;
  const int KC = edge_chunk(K);
  const int nw = NT / 32;
  Lay L;
  int o = 0;
  L.R = R;
  L.KC = KC;
  L.vsep = vfold || K > KC;
  L.ldv = vfold ? d.heads : L.vsep ? up4(vcols) : PH;
  L.ef = L.vsep ? 0 : KC * PH;  // the edge fold's tile within u2
  const int u0 = imax(R * PH, KC * FEP);
  int u1 = edge ? imax(R, KC) * PP : 0, u2 = 0;
  if (edge) {
    const Fold fe = fold_geom(d, G, vfold), fb = fold_geom(d, 1, vfold);
    u2 = imax(L.ef + KC * fe.nc + fe.floats, R * fb.nc + fb.floats);
  }
  if (hg) {
    u1 = imax(u1, R * (hg * d.Wt + PD));
    u2 = imax(u2, imax(R * PH, nw * d.K8 * d.Wt));
  }
  L.rows = o; o += u0;
  L.u1 = o; o += u1;
  L.u2 = o; o += u2;
  L.ring = o; o += RING_FLOATS;
  L.vall = o;
  o += imax(edge && !(vcols == H && R >= d.NL) ? up4(d.NL * vcols) : 0,
            L.vsep ? up4(K * L.ldv) : 0);
  L.scb = o; o += edge ? up4(d.NL * d.heads) : 0;
  L.sc = o; o += up4(K * d.heads);
  const int hk = up4(imax(G * H, K));
  L.qt = o; o += hk;
  L.outv = o; o += hk;
  L.rel = o; o += up4(3 * K);
  L.emask = o; o += up4(K);
  L.ew = o; o += up4(K);
  L.dist = o; o += up4(K);
  L.d3 = o; o += up4(3 * K);
  L.src = o; o += up4(K);
  L.wp = o; o += edge ? up4(d.NL) : 0;
  L.misc = o; o += 8;  // [0, 3G): stage C's edge moves; [7]: int slot
  L.total = o;
  return L;
}

// v: the edge values [KE][ldv]; fold: the edge fold's tile, its weight
// after it; kv: the bond grid's fold tile; KC: edge rows a pass.
struct EdgeSmem {
  float *feat, *pre, *kv, *fold, *v, *sc, *qt, *rel, *emask, *ew, *dist,
      *d3, *ring;
  int* src;
  int KC, ldv;
};

__device__ EdgeSmem edge_smem(float* sm, const Lay& L) {
  EdgeSmem s;
  s.feat = sm + L.rows; s.pre = sm + L.u1; s.kv = sm + L.u2;
  s.fold = s.kv + L.ef;
  s.v = L.vsep ? sm + L.vall : s.kv;
  s.KC = L.KC; s.ldv = L.ldv;
  s.sc = sm + L.sc; s.qt = sm + L.qt; s.rel = sm + L.rel;
  s.emask = sm + L.emask; s.ew = sm + L.ew; s.dist = sm + L.dist;
  s.d3 = sm + L.d3; s.ring = sm + L.ring;
  s.src = reinterpret_cast<int*>(sm + L.src);
  return s;
}

struct EdgeMask {
  const float* m;
  __device__ float operator()(int k) const { return m[k]; }
};

// The query fold: the scores of an attention are
//   (LN(pre_k) @ k2W + k2b) . q / sqrt(dh) summed over a head's dh columns
//   = LN(pre_k) @ W_kq + b_kq,  W_kq[c][h] = k2W[c][h-slice] . q[h-slice]
//   / sqrt(dh), b_kq[h] = k2b[h-slice] . q[h-slice] / sqrt(dh),
// exact algebra (the JAX stages' `qk @ hm`, `qkb @ hm`, `xqk @ hm`, `pqk
// @ hm`). So the key layer, an H x H product whose only use is that dot,
// becomes an H x heads one; in stage C the value layer's heads columns go
// beside it, one product of f.nc columns (fold_geom) for the two.
// node_pos_query_kernel forms W_kq and b_kq once for every destination of
// both attentions, F [H+1][heads] a destination (row H: b_kq). load_fold
// issues the cp.async copies of the product's weight into wf: the score
// columns of the G destinations from Fq (the first one's F; stage A's
// destinations (H+1) heads floats apart, stage C's ([row][attention]) twice
// that), with VF (stage C) the value columns from v2W, the bias row (b_kq
// | v2b) after the matrix, and zeros in the rows from H to the next
// multiple of 8. It does not wait: the copies are complete after
// the thread's next cp_async_wait and a barrier (the next mm's first
// slice).
template <bool VF>
__device__ void load_fold(int H, int NH, const Fold& f, const float* Fq,
                          int G, const float* __restrict__ v2W,
                          const float* __restrict__ v2b, float* wf) {
  const int tid = threadIdx.x, nt = blockDim.x, Hp = (H + 7) & ~7;
  const int H1 = H + 1, gs = (VF ? 2 : 1) * H1 * NH;
  float* bf = wf + Hp * f.pitch;
  if ((NH & 3) == 0) {
    const int N4 = NH >> 2;
    for (int idx = tid; idx < G * H1 * N4; idx += nt) {
      const int g = idx / (H1 * N4), r = idx - g * H1 * N4, c = r / N4;
      const int h = (r - c * N4) * 4;
      cp_async16((c < H ? wf + c * f.pitch : bf) + g * NH + h,
                 Fq + (size_t)g * gs + c * NH + h);
    }
    if (VF) {
      for (int idx = tid; idx < H * N4; idx += nt) {
        const int c = idx / N4, h = (idx - c * N4) * 4;
        cp_async16(wf + c * f.pitch + f.voff + h, v2W + c * NH + h);
      }
    }
  } else {
    for (int idx = tid; idx < G * H1 * NH; idx += nt) {
      const int g = idx / (H1 * NH), r = idx - g * H1 * NH, c = r / NH;
      (c < H ? wf + c * f.pitch : bf)[g * NH + r - c * NH] =
          Fq[(size_t)g * gs + r];
    }
    if (VF) {
      for (int idx = tid; idx < H * NH; idx += nt)
        wf[(idx / NH) * f.pitch + f.voff + idx % NH] = __ldg(v2W + idx);
    }
  }
  if (VF)
    for (int h = tid; h < NH; h += nt) bf[f.voff + h] = __ldg(v2b + h);
  for (int idx = tid; idx < (Hp - H) * f.pitch; idx += nt)
    wf[H * f.pitch + idx] = 0.f;
}

// Shared first half of stages A and C for the G destination nodes n0,
// n0 + 1, ... of graph b (their K edges each are consecutive rows of the
// tables and of every tile here, KE = G * K rows in all, so that one pass
// over the weights serves G nodes): edge features, the fused first layer
// (columns [lo, lo+2H) of e_W plus the gathered node terms), LN+ReLU, the
// second layers and the masked per-head softmax over each node's K edges.
// The queries come folded into the key layer (Fq, gs: see load_fold): the
// scores are one product on the folded weight of the G destinations, each
// row's copied out of its tile by its own destination. The value layer
// has Nv columns, scaled by e_w: with VF (stage C, Nv = heads) they ride in
// the same product, else (stage A, Nv = H) they take their own `mm`. The
// tiles take KC edge rows a pass (all KE in one pass up to ECMAX). Leaves
// alpha in sc[KE][heads] and v in s.v[KE][s.ldv].
template <bool VF>
__device__ void edge_attention(
    const Dims& d, const Args& a, const EdgeSmem& s, int b, int n0, int G,
    const float* xb, const float* P, int PW, int lo, int ln_row,
    const float* e_W, const float* e_b, const float* dire_W,
    const float* dire_b, const float* e_ln_s, const float* e_ln_b,
    const float* v2W, const float* v2b, int Nv, const float* Fq) {
  const int N = d.NP + d.NL, K = d.K, H = d.H, NH = d.heads;
  const int KE = G * K, PP = 2 * H + PD;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* Pn = P + ((size_t)b * N + n0) * PW;
  const size_t e0 = ((size_t)b * N + n0) * K;
  for (int r = tid; r < KE; r += nt) {
    const size_t e = e0 + r;
    const int n = n0 + r / K;
    const int sidx = IP(T_NBR_IDX)[e];
    const float mk = FP(T_NBR_MASK)[e];
    s.src[r] = sidx;
    s.emask[r] = mk;
    s.ew[r] = FP(T_EW)[e];
    float rl[3];
    for (int c = 0; c < 3; ++c) rl[c] = xb[n * 3 + c] - xb[sidx * 3 + c] * mk;
    for (int c = 0; c < 3; ++c) s.rel[r * 3 + c] = rl[c];
    s.dist[r] = sqrtf(rl[0] * rl[0] + rl[1] * rl[1] + rl[2] * rl[2] + 1e-12f);
    float cs[3], cn[3];
    node_comb(d, a, xb, b, sidx, cs);
    node_comb(d, a, xb, b, n, cn);
    float d3[3] = {0.f, 0.f, 0.f};
    for (int c = 0; c < 3; ++c) {
      const float v1 = cs[c] * mk, v2 = cn[c], v3 = -rl[c];
      d3[0] += v1 * v2;
      d3[1] += v1 * v3;
      d3[2] += v2 * v3;
    }
    for (int c = 0; c < 3; ++c) s.d3[r * 3 + c] = d3[c];
  }
  const Fold f = fold_geom(d, G, VF);
  // the folded weight, after its tile
  float* wf = s.fold + s.KC * f.nc;
  load_fold<VF>(H, NH, f, Fq, G, v2W, v2b, wf);
  __syncthreads();
  for (int c0 = 0; c0 < KE; c0 += s.KC) {
    const int kc = imin(s.KC, KE - c0);
    // features over (edge, rbf) pairs, then the 16 closing columns of a
    // row: edge type (4), dire (9), zero pad (3)
    for (int idx = tid; idx < kc * NRBF; idx += nt) {
      const int k = idx / NRBF, q = idx % NRBF;
      const float df = s.dist[c0 + k] - c_rbf_off[q];
      const float g = expf(RBF_COEFF * (df * df));
      const float* et = FP(T_EDGE_TYPE) + (e0 + c0 + k) * 4;
      float* f = s.feat + k * FEP;
      for (int t4 = 0; t4 < 4; ++t4) f[t4 * NRBF + q] = et[t4] * g;
    }
    for (int idx = tid; idx < kc * 16; idx += nt) {
      const int k = idx / 16, o = idx % 16;
      float v = 0.f;
      if (o < 4) {
        v = FP(T_EDGE_TYPE)[(e0 + c0 + k) * 4 + o];
      } else if (o < 13) {
        const float* d3 = s.d3 + (c0 + k) * 3;
        v = d3[0] * dire_W[o - 4] + d3[1] * dire_W[9 + o - 4] +
            d3[2] * dire_W[18 + o - 4] + dire_b[o - 4];
      }
      s.feat[k * FEP + 80 + o] = v;
    }
    __syncthreads();
    mm(s.feat, FEP, kc, wmat(e_W + lo, 4 * H), FE, 2 * H, e_b + lo, s.pre,
       PP, false, s.ring);
    for (int idx = tid; idx < kc * (H >> 1); idx += nt) {
      const int k = idx / (H >> 1), c = (idx % (H >> 1)) * 4, ke = c0 + k;
      const float mk = s.emask[ke];
      const float4 sv = ld4(P + ((size_t)b * N + s.src[ke]) * PW + 2 * H + c);
      const float4 dv = ld4(Pn + (ke / K) * PW + c);
      float* o = s.pre + k * PP + c;
      const float4 v = ld4(o);
      st4(o, make_float4(v.x + (mk * sv.x + dv.x), v.y + (mk * sv.y + dv.y),
                         v.z + (mk * sv.z + dv.z), v.w + (mk * sv.w + dv.w)));
    }
    __syncthreads();
    ln_rows(s.pre, PP, kc, H, e_ln_s + ln_row * H, e_ln_b + ln_row * H, true);
    ln_rows(s.pre + H, PP, kc, H, e_ln_s + (ln_row + 1) * H,
            e_ln_b + (ln_row + 1) * H, true);
    __syncthreads();
    mm_fold(s.pre, PP, kc, wf, f.pitch, H, f.nc, s.fold, f.nc, f.voff, H);
    const float* bf = wf + ((H + 7) & ~7) * f.pitch;
    for (int idx = tid; idx < kc * NH; idx += nt) {
      const int k = idx / NH, hh = idx - k * NH, ke = c0 + k;
      const int col = (ke / K) * NH + hh;
      const float* t = s.fold + k * f.nc;
      s.sc[ke * NH + hh] = t[col] + bf[col];
      if (VF)
        s.v[ke * s.ldv + hh] = (t[f.voff + hh] + bf[f.voff + hh]) * s.ew[ke];
    }
    if (!VF)
      mm(s.pre + H, PP, kc, wmat(v2W, Nv), H, Nv, v2b, s.v + c0 * s.ldv,
         s.ldv, false, s.ring);
    __syncthreads();
  }
  if (!VF) {
    for (int idx = tid; idx < KE * Nv; idx += nt) {
      const int k = idx / Nv, c = idx % Nv;
      s.v[k * s.ldv + c] *= s.ew[k];
    }
    __syncthreads();
  }
  for (int g = 0; g < G; ++g)
    softmax_heads(s.sc + g * K * NH, K, NH, EdgeMask{s.emask + g * K});
  __syncthreads();
}

// Row source of bond_attention that reads the bond grid from device
// memory: rows[sr] = hbg[b, s0 + sr, dl, :] (pitch H+PD).
struct HbColumnRows {
  // reads device memory into `rows` only: a fold copied before the passes
  // stays intact
  static constexpr bool kFoldKept = true;
  const float* hbg;
  __device__ void operator()(const Dims& d, int b, int dl, int s0, int ns,
                             float* rows) const {
    const int H4 = d.H >> 2;
    for (int idx = threadIdx.x; idx < ns * H4; idx += blockDim.x) {
      const int sr = idx / H4, c = (idx % H4) * 4;
      st4(rows + sr * (d.H + PD) + c,
          ld4(hbg + (((size_t)b * d.NL + s0 + sr) * d.NL + dl) * d.H + c));
    }
    __syncthreads();
  }
};

struct PairMask {
  const float* ml;
  float md;
  int dl;
  __device__ float operator()(int sr) const {
    return ml[sr] * md * (sr != dl ? 1.f : 0.f);
  }
};

// Dense bond-grid attention over the first nsrc sources (see valid_sources)
// of ligand destination dl, R sources a pass: `load_rows` leaves the bond
// features of sources [s0, s0+ns) towards dl in rows[ns][H+PD] (and ends
// with a block barrier); then the first layer (columns of W1 [H, 2H]) plus
// the node terms P[dst][dcol:dcol+2H] and P[NP+s][scol:scol+2H], LN+ReLU,
// the second layers and scores into scb[s][heads]; then the masked softmax
// over s. The destination's query comes folded into the key layer (Fq, see
// load_fold; the copies complete at the first-layer product's first
// wait), copied once before the passes, or after each pass's rows where
// the row loader's scratch lies over it (Rows::kFoldKept false: B2's
// AttRows). The scores are one product on it, and the Nv value columns
// (into vall[s][ldv], which may be `rows` itself when one pass takes all
// sources) ride in it with VF (stage C, Nv = heads), else take their own
// `mm` (stage A, Nv = H).
template <bool VF, class Rows>
__device__ void bond_attention(
    const Dims& d, const Args& a, const EdgeSmem& s, int R, int nsrc,
    float* rows, float* vall, int ldv, float* scb, int b, int dl,
    const Rows& load_rows, const float* P, int PW, int dcol, int scol,
    const float* W1, const float* b1, const float* ln_s, const float* ln_b,
    const float* v2W, const float* v2b, int Nv, const float* Fq) {
  const int NL = d.NL;
  const int tid = threadIdx.x, nt = blockDim.x;
  if (Rows::kFoldKept) {
    const Fold f = fold_geom(d, 1, VF);
    load_fold<VF>(d.H, d.heads, f, Fq, 1, v2W, v2b, s.kv + R * f.nc);
  }
  for (int s0 = 0; s0 < nsrc; s0 += R) {
    const int ns = imin(R, nsrc - s0);
    load_rows(d, b, dl, s0, ns, rows);
    // After a row loader whose scratch lies over the fold (B2's AttRows),
    // the pass's sizes and coordinates go through an empty asm, so that
    // nothing computed from them is hoisted above the loader, where it
    // would hold registers through B2's loops and their product calls:
    // hoisted so, att_pos_kernel ran 5-10% slower on an H100.
    Dims w = d;
    int bw = b, dlw = dl, PWw = PW, dcw = dcol, scw = scol;
    if (!Rows::kFoldKept)
      asm volatile("" : "+r"(w.H), "+r"(w.heads), "+r"(w.NP), "+r"(w.NL),
                   "+r"(bw), "+r"(dlw), "+r"(PWw), "+r"(dcw), "+r"(scw));
    const int H = w.H, NH = w.heads, PH = H + PD, PP = 2 * H + PD;
    const int N = w.NP + w.NL;
    const float* Pn = P + ((size_t)bw * N + w.NP + dlw) * PWw;
    const Fold f = fold_geom(w, 1, VF);
    // the folded weight, after its tile
    float* wf = s.kv + R * f.nc;
    if (!Rows::kFoldKept) load_fold<VF>(H, NH, f, Fq, 1, v2W, v2b, wf);
    mm(rows, PH, ns, wmat(W1, 2 * H), H, 2 * H, b1, s.pre, PP, false, s.ring);
    for (int idx = tid; idx < ns * (H >> 1); idx += nt) {
      const int sr = idx / (H >> 1), c = (idx % (H >> 1)) * 4;
      const float4 dv = ld4(Pn + dcw + c);
      const float4 sv =
          ld4(P + ((size_t)bw * N + w.NP + s0 + sr) * PWw + scw + c);
      float* o = s.pre + sr * PP + c;
      const float4 v = ld4(o);
      st4(o, make_float4(v.x + (dv.x + sv.x), v.y + (dv.y + sv.y),
                         v.z + (dv.z + sv.z), v.w + (dv.w + sv.w)));
    }
    __syncthreads();
    ln_rows(s.pre, PP, ns, H, ln_s, ln_b, true);
    ln_rows(s.pre + H, PP, ns, H, ln_s + H, ln_b + H, true);
    __syncthreads();
    mm_fold(s.pre, PP, ns, wf, f.pitch, H, f.nc, s.kv, f.nc, f.voff, H);
    const float* bf = wf + ((H + 7) & ~7) * f.pitch;
    for (int idx = tid; idx < ns * NH; idx += nt) {
      const int sr = idx / NH, hh = idx - sr * NH;
      const float* t = s.kv + sr * f.nc;
      scb[(s0 + sr) * NH + hh] = t[hh] + bf[hh];
      if (VF)
        vall[(s0 + sr) * ldv + hh] = t[f.voff + hh] + bf[f.voff + hh];
    }
    if (!VF)
      mm(s.pre + H, PP, ns, wmat(v2W, Nv), H, Nv, v2b, vall + s0 * ldv, ldv,
         false, s.ring);
    __syncthreads();
  }
  int bw = b, dlw = dl, NLw = NL, NHw = d.heads;
  if (!Rows::kFoldKept)
    asm volatile("" : "+r"(bw), "+r"(dlw), "+r"(NLw), "+r"(NHw));
  const float* ml = FP(T_MASK_L) + (size_t)bw * NLw;
  softmax_heads(scb, nsrc, NHw, PairMask{ml, ml[dlw], dlw});
  __syncthreads();
}

// ------------------------------------------------------ stage A: node update

enum {
  NA_H = 0, NA_X, NA_HB, NA_OUT, NA_P,
  NA_W = 13, NA_E_W, NA_E_B, NA_DIRE_W, NA_DIRE_B, NA_E_LN_S, NA_E_LN_B,
  NA_E_K2, NA_E_B2, NA_Q_B0, NA_Q_LN_S, NA_Q_LN_B, NA_Q_W1, NA_Q_B1, NA_B_W,
  NA_B_B, NA_B_LN_S, NA_B_LN_B, NA_B_K2, NA_B_B2, NA_LIN_W, NA_LIN_B,
  NA_COUNT
};

// Floats of one destination's fold F [H+1][heads].
__host__ __device__ inline size_t fold_floats(const Dims& d) {
  return (size_t)(d.H + 1) * d.heads;
}

// Stage A's scratch NA_P holds the node projections [B*N][PW], then the
// folded queries of node_pos_query_kernel: the kNN edges' [B*N][H+1][heads]
// (every node), then the bond grid's [B*NL][H+1][heads] (the ligand rows;
// none for a padded one).
__host__ __device__ inline float* node_folds(const Dims& d, const Args& a,
                                             int PW) {
  return OUTP(NA_P) + (size_t)d.B * (d.NP + d.NL) * PW;
}

// Stage A for nodes n0 .. n0 + G - 1 of graph b: the kNN edge attention of
// all G at once (G * K rows a weight pass), then the bond-grid attention of
// each ligand node that holds an atom, and the output layer. Both take
// their queries folded into the key layer (load_fold,
// node_pos_query_kernel). A padded ligand slot skips its bond grid: every
// weight of its pool is exactly 0 (PairMask), so the pool would add exact
// zeros to its kNN attention; it has no bond-grid fold. P holds the node
// projections h @ nodeA_W in columns [0, 10H) of rows of pitch PW.
__device__ void node_body(const Dims& d, const Args& a, float* sm, int R,
                          int b, int n0, int G, int PW) {
  const int tid = threadIdx.x;
  const int N = d.NP + d.NL, H = d.H, NH = d.heads, dh = H / NH;
  const Lay L = stage_layout(d, H, R, true, 0, G);
  const EdgeSmem s = edge_smem(sm, L);
  const bool one_pass = R >= d.NL;
  float *rows = sm + L.rows, *scb = sm + L.scb;
  float* vall = one_pass ? rows : sm + L.vall;
  const int ldv = one_pass ? H + PD : H;
  float* outv = sm + L.outv;
  const float* xb = FP(NA_X) + (size_t)b * N * 3;
  const float* P = FP(NA_P);
  // the folds (node_folds) are addressed where they are passed: a pointer
  // kept across the edge attention costs the products registers
  G = imin(G, N - n0);
  edge_attention<false>(d, a, s, b, n0, G, xb, P, PW, 0, 0, FP(NA_E_W),
                        FP(NA_E_B), FP(NA_DIRE_W), FP(NA_DIRE_B),
                        FP(NA_E_LN_S), FP(NA_E_LN_B), FP(NA_E_K2) + H * H,
                        FP(NA_E_B2) + H, H,
                        node_folds(d, a, PW) +
                            ((size_t)b * N + n0) * fold_floats(d));
  for (int g = 0; g < G; ++g)
    pool_cols(s.sc + g * d.K * NH, NH, s.v + g * d.K * s.ldv, s.ldv, d.K, H,
              dh, outv + g * H, false, s.ring);
  const float* ml = FP(T_MASK_L) + (size_t)b * d.NL;
  int nsrc = -1;
  for (int g = 0; g < G; ++g) {
    const int n = n0 + g;
    if (n >= d.NP && ml[n - d.NP] != 0.f) {
      const int dl = n - d.NP;
      if (nsrc < 0)
        nsrc = valid_sources(ml, d.NL,
                             reinterpret_cast<int*>(sm + L.misc + 7));
      bond_attention<false>(
          d, a, s, R, nsrc, rows, vall, ldv, scb, b, dl,
          HbColumnRows{FP(NA_HB)}, P, PW, 6 * H, 8 * H, FP(NA_B_W),
          FP(NA_B_B), FP(NA_B_LN_S), FP(NA_B_LN_B), FP(NA_B_K2) + H * H,
          FP(NA_B_B2) + H, H,
          node_folds(d, a, PW) +
              ((size_t)d.B * N + (size_t)b * d.NL + dl) * fold_floats(d));
      pool_cols(scb, NH, vall, ldv, nsrc, H, dh, outv + g * H, true, s.ring);
    }
  }
  for (int g = 0; g < G; ++g) {
    vec_mat(outv + g * H, FP(NA_LIN_W), H, H, H, FP(NA_LIN_B), s.qt, s.ring);
    if (tid < H) {
      const size_t o = ((size_t)b * N + n0 + g) * H + tid;
      OUTP(NA_OUT)[o] = FP(NA_H)[o] + s.qt[tid];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT, 1)
node_kernel(Dims d, Args a, int R, int G, int PW) {
  extern __shared__ float sm[];
  node_body(d, a, sm, R, blockIdx.y, blockIdx.x * G, G, PW);
}

// ------------------------------------------------- stage C: position update

enum {
  PA_NEW_H = 0, PA_X, PA_HB, PA_OUT, PA_P,
  PA_W = 13, PA_E_W, PA_E_B, PA_DIRE_W, PA_DIRE_B, PA_E_LN_S, PA_E_LN_B,
  PA_E_XK2, PA_E_XK2B, PA_E_XV2, PA_E_XV2B, PA_Q_B0, PA_Q_LN_S, PA_Q_LN_B,
  PA_Q_W1, PA_Q_B1, PA_P_W, PA_P_B, PA_P_LN_S, PA_P_LN_B, PA_P_XK2,
  PA_P_XK2B, PA_P_XV2, PA_P_XV2B, PA_COUNT
};

// Stage C's scratch PA_P holds the node projections [B*N][10H], then the
// folded queries of node_pos_query_kernel F [B*NL][2][H+1][heads].
__host__ __device__ inline float* pos_folds(const Dims& d, const Args& a) {
  return OUTP(PA_P) + (size_t)d.B * (d.NP + d.NL) * 10 * d.H;
}

// Stage C for the G ligand destinations dl0, dl0 + 1, ... of graph b, all
// holding an atom (phore rows are copied by the host entry, padded
// destinations by pos_padded). `load_rows` gives the new bond features
// towards a destination of the first nsrc sources (see bond_attention,
// valid_sources). The kNN edge attention of all G runs at once (G * K rows
// a weight pass), then the bond-grid attention of each. Both take their
// queries folded into the key layer (load_fold, node_pos_query_kernel).
template <class Rows>
__device__ void pos_body(const Dims& d, const Args& a, float* sm,
                         const Lay& L, int b, int dl0, int G, int nsrc,
                         const Rows& load_rows) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int NP = d.NP, N = NP + d.NL, H = d.H, NH = d.heads, K = d.K;
  const int PW = 10 * H;
  const EdgeSmem s = edge_smem(sm, L);
  float *rows = sm + L.rows, *vall = sm + L.vall, *scb = sm + L.scb;
  float *outv = sm + L.outv, *wp = sm + L.wp, *dxe = sm + L.misc;  // [3G]
  const float* xb = FP(PA_X) + (size_t)b * N * 3;
  // F of destination dl, attention 0 (kNN edges) or 1 (bond grid): see
  // node_body for why it is addressed where it is passed
  const float* P = FP(PA_P);
  edge_attention<true>(d, a, s, b, NP + dl0, G, xb, P, PW, 2 * H, 2,
                       FP(PA_E_W), FP(PA_E_B), FP(PA_DIRE_W), FP(PA_DIRE_B),
                       FP(PA_E_LN_S), FP(PA_E_LN_B), FP(PA_E_XV2),
                       FP(PA_E_XV2B), NH,
                       pos_folds(d, a) +
                           ((size_t)b * d.NL + dl0) * 2 * fold_floats(d));
  // w_e[k] = mean over heads of alpha * xv; dx_edge = sum_k w_e[k] rel[k]
  for (int k = tid; k < G * K; k += nt) {
    float we = 0.f;
    for (int hh = 0; hh < NH; ++hh)
      we += s.sc[k * NH + hh] * s.v[k * s.ldv + hh];
    outv[k] = we / NH;
  }
  __syncthreads();
  if (warp < 3 * G) {
    const int g = warp / 3, c = warp - 3 * g;
    float acc = 0.f;
    for (int k = lane; k < K; k += 32)
      acc += outv[g * K + k] * s.rel[(g * K + k) * 3 + c];
    acc = warp_sum(acc);
    if (lane == 0) dxe[warp] = acc;
  }
  for (int g = 0; g < G; ++g) {
    const int dl = dl0 + g;
    bond_attention<true>(d, a, s, L.R, nsrc, rows, vall, NH, scb, b, dl,
                         load_rows, P, PW, 6 * H, 8 * H, FP(PA_P_W),
                         FP(PA_P_B), FP(PA_P_LN_S), FP(PA_P_LN_B),
                         FP(PA_P_XV2), FP(PA_P_XV2B), NH,
                         pos_folds(d, a) +
                             (((size_t)b * d.NL + dl) * 2 + 1) *
                                 fold_floats(d));
    // after B2's rows, addressed from opaque values as in bond_attention
    Dims dw = d;
    int bw = b, dlw = dl;
    if (!Rows::kFoldKept)
      asm volatile("" : "+r"(dw.heads), "+r"(dw.NP), "+r"(dw.NL), "+r"(bw),
                   "+r"(dlw));
    const int NHw = dw.heads, NPw = dw.NP, Nw = dw.NP + dw.NL;
    for (int sr = tid; sr < nsrc; sr += nt) {
      float w = 0.f;
      for (int hh = 0; hh < NHw; ++hh)
        w += scb[sr * NHw + hh] * vall[sr * NHw + hh];
      wp[sr] = w / NHw;
    }
    __syncthreads();
    if (warp < 3) {
      const float* pl = FP(PA_X) + ((size_t)bw * Nw + NPw) * 3;
      float acc = 0.f;
      for (int sr = lane; sr < nsrc; sr += 32)
        acc += wp[sr] * (pl[dlw * 3 + warp] - pl[sr * 3 + warp]);
      acc = warp_sum(acc);
      if (lane == 0) {
        const float md = FP(T_MASK_L)[(size_t)bw * dw.NL + dlw];
        const size_t o = ((size_t)bw * Nw + NPw + dlw) * 3 + warp;
        OUTP(PA_OUT)[o] = FP(PA_X)[o] + (dxe[3 * g + warp] + acc) * md;
      }
    }
  }
}

// A padded destination keeps its position (its update is masked to zero).
__device__ bool pos_padded(const Dims& d, const Args& a, int b, int dl) {
  if (FP(T_MASK_L)[(size_t)b * d.NL + dl] != 0.f) return false;
  if (threadIdx.x < 3) {
    const size_t o = ((size_t)b * (d.NP + d.NL) + d.NP + dl) * 3 + threadIdx.x;
    OUTP(PA_OUT)[o] = FP(PA_X)[o];
  }
  return true;
}

// Stage C, G ligand destinations a block (plan_nodes): pos_body runs on
// both of two when both hold an atom, else on the one that does; a padded
// destination only keeps its position.
__global__ void __launch_bounds__(NT, 1)
pos_kernel(Dims d, Args a, int R, int G) {
  extern __shared__ float sm[];
  const int b = blockIdx.y, dl0 = blockIdx.x * G;
  const int ng = imin(G, d.NL - dl0);
  int first = 0, filled = 0;
  for (int g = ng - 1; g >= 0; --g)
    if (!pos_padded(d, a, b, dl0 + g)) {
      first = dl0 + g;
      ++filled;
    }
  if (!filled) return;
  const Lay L = stage_layout(d, d.heads, R, true, 0, G, true);
  const int nsrc = valid_sources(FP(T_MASK_L) + (size_t)b * d.NL, d.NL,
                                 reinterpret_cast<int*>(sm + L.misc + 7));
  pos_body(d, a, sm, L, b, first, filled, nsrc, HbColumnRows{FP(PA_HB)});
}

// Queries and their folds (load_fold), a grid-wide phase between a stage's
// rows_gemm and its main kernel, for stages A and C: block (x, y) takes
// QROWS rows of job y, one attention's destinations: q = relu(LN(P[row]
// [col..col+H) + q_b0)) @ q_W1 + q_b1 for all of them in one product, then
// F[c][h] = k2W[c][h-slice] . q[h-slice] / sqrt(dh) and F[H][h] =
// k2b[h-slice] . q[h-slice] / sqrt(dh) with each thread's dh weights of
// (c, h) read once for the block's rows. This replaces single-row products
// and reads of k2W a destination in the stages' blocks, where each was a
// chain of L2 round trips. A row whose mask is 0 gets no fold: its stage
// reads none of its.
#define QROWS 16
template <int DH>
__device__ void fold_rows(int H, int NH, const float* q, int ldq, int nr,
                          const float* ml, const float* __restrict__ k2W,
                          const float* __restrict__ k2b, float* F,
                          size_t fstride) {
  constexpr int DL = DH ? DH : 1;
  const int dh = H / NH, H1 = H + 1;
  const float inv = 1.f / sqrtf((float)dh);
  for (int idx = threadIdx.x; idx < H1 * NH; idx += blockDim.x) {
    const int c = idx / NH, h = idx - c * NH;
    const float* kr = (c < H ? k2W + (size_t)c * H : k2b) + h * dh;
    float kv[DL];
    if (DH) {
#pragma unroll
      for (int e = 0; e < DL; e += 4) {
        const float4 k4 = __ldg(reinterpret_cast<const float4*>(kr + e));
        kv[e] = k4.x; kv[e + 1] = k4.y; kv[e + 2] = k4.z; kv[e + 3] = k4.w;
      }
    }
    for (int r = 0; r < nr; ++r) {
      if (ml && ml[r] == 0.f) continue;
      const float* qh = q + r * ldq + h * dh;
      float acc = 0.f;
      if (DH) {
#pragma unroll
        for (int e = 0; e < DL; ++e) acc += kv[e] * qh[e];
      } else {
        for (int e = 0; e < dh; ++e) acc += __ldg(kr + e) * qh[e];
      }
      F[r * fstride + idx] = acc * inv;
    }
  }
}

// One attention's query phase: its `rows` destinations, row r at row
// (r / rpb) * bstride + roff + r % rpb of the node projections P (pitch
// PW), whose columns [col, col + H) are the query's first layer; its query
// MLP (q_b0 .. q_b1 of one slot) and the key layer it folds into; row r's
// F at F + r * fs. ml: row r's mask (null: every row gets a fold).
struct QueryJob {
  const float *P, *qb0, *ln_s, *ln_b, *W1, *b1, *k2W, *k2b, *ml;
  float* F;
  int PW, col, rows, rpb, bstride, roff, fs;
};
struct QueryJobs {
  QueryJob j[2];
};

__global__ void __launch_bounds__(NT, 1)
node_pos_query_kernel(Dims d, QueryJobs jobs) {
  extern __shared__ float sm[];  // z [QROWS][H+PD] | q [QROWS][H+PD] | ring
  const QueryJob& j = jobs.j[blockIdx.y];
  const int H = d.H, NH = d.heads, PH = H + PD;
  const int r0 = blockIdx.x * QROWS;
  if (r0 >= j.rows) return;
  const int nr = imin(QROWS, j.rows - r0);
  float *z = sm, *q = sm + QROWS * PH, *ring = sm + 2 * QROWS * PH;
  for (int idx = threadIdx.x; idx < nr * H; idx += blockDim.x) {
    const int r = idx / H, c = idx - r * H, row = r0 + r;
    const size_t src =
        (size_t)(row / j.rpb) * j.bstride + j.roff + row % j.rpb;
    z[r * PH + c] = j.P[src * j.PW + j.col + c] + j.qb0[c];
  }
  __syncthreads();
  ln_rows(z, PH, nr, H, j.ln_s, j.ln_b, true);
  __syncthreads();
  mm(z, PH, nr, wmat(j.W1, H), H, H, j.b1, q, PH, false, ring);
  float* F = j.F + (size_t)r0 * j.fs;
  const float* ml = j.ml ? j.ml + r0 : nullptr;
  // dh == 8: the flagship's (and every release config's) head width, its
  // weights and queries in 16-byte loads. The one generic loop (dh a
  // runtime bound) made stage C 1.8-2.6% slower on the H100 (PERF.md).
  if (H / NH == 8)
    fold_rows<8>(H, NH, q, PH, nr, ml, j.k2W, j.k2b, F, j.fs);
  else
    fold_rows<0>(H, NH, q, PH, nr, ml, j.k2W, j.k2b, F, j.fs);
}

// --------------------------------------- stage B1: triplet pre-features

enum {
  TP_H = 0, TP_X, TP_HB, TP_PRE_T, TP_QZ, TP_PB, TP_TRIP_IDX, TP_W,
  TP_T_WHB, TP_T_WR, TP_T_B, TP_T_WJI, TP_T_WANG, TP_T_LN_S, TP_T_LN_B,
  TP_TQ_WHB, TP_TQ_B0, TP_TQ_LN_S, TP_TQ_LN_B, TP_COUNT
};

// The reference's angle encodings are [a, sin(f a), cos(f a)] over the bands
// f = [1, 2, 3, 1, 1/2, 1/3] (num_ang = 3): band 1 twice, so the 13 take 11
// distinct values. B1 computes those 11 from three sincosf (a, a/2, a/3;
// 2a and 3a by the double- and triple-angle identities) and multiplies
// them by t_Wang with the two rows of each duplicate summed: c_enc_rows
// holds the rows of t_Wang behind each of the 11 (-1: none).
#define NENC 11
__constant__ int c_enc_rows[NENC][2] = {{0, -1}, {1, 4},  {2, -1}, {3, -1},
                                        {5, -1}, {6, -1}, {7, 10}, {8, -1},
                                        {9, -1}, {11, -1}, {12, -1}};
#define ELD 20  // row pitch of a warp's encoding tile [32][16] (ldmatrix)

// Row pitch of B1's a_kj tile: 16 mod 32 floats, so that the pre_t phase's
// 16-byte reads of 8 consecutive sources (4 lanes a source) fall on 32
// banks.
__host__ __device__ inline int akj_pitch(int Wt) { return Wt <= 16 ? 16 : 48; }

// Shared memory of stage B1 (floats). `x` holds the gathered bond rows
// [max(K8, R)][H+PD] and the q_z tile [R][H+PD], and afterwards the
// warps' encoding tiles [32][ELD] of the pre_t phase; wang: the merged
// t_Wang [NENC][Wt]; lnsb: LayerNorm scale [32] | bias [32].
struct PreLay {
  int R, AP, posl, rf, aji, akj, x, qp, wang, lnsb, ring, tidx, total;
};

__host__ __device__ inline PreLay pre_layout(const Dims& d, int R) {
  const int PH = d.H + PD, RB = imax(d.K8, R);
  PreLay L;
  int o = 0;
  L.R = R;
  L.AP = akj_pitch(d.Wt);
  L.posl = o; o += up4(d.NL * 3);
  L.rf = o; o += d.NL * NRBF;
  L.aji = o; o += d.NL * d.Wt;
  L.akj = o; o += d.K8 * L.AP;
  L.x = o; L.qp = o + RB * PH;
  o += imax(RB * PH + R * PH, NW1 * 32 * ELD);
  L.wang = o; o += up4(NENC * d.Wt);
  L.lnsb = o; o += 64;
  L.ring = o; o += RING_FLOATS;
  L.tidx = o; o += up4(d.K8);
  L.total = o;
  return L;
}

// Stage B1 for ligand atom j of graph b, NT1 threads. PB points at the
// graph's first ligand row of the node projections h @ nodeB_W (columns
// [0, 2Wt+H) of rows of pitch PBW). BT: element type of pre_t and q_z (see
// Blk).
template <class BT>
__device__ void trip_pre_body(const Dims& d, const Args& a, float* sm, int R,
                              int b, int j, const float* PB, int PBW) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int NL = d.NL, NP = d.NP, N = NP + NL, H = d.H, K8 = d.K8, Wt = d.Wt;
  const int PH = H + PD, H4 = H >> 2;
  const PreLay L = pre_layout(d, R);
  const int AP = L.AP;
  float* posl = sm + L.posl;
  float* rf = sm + L.rf;      // [NL][20] rbf of |pos_j - pos_i|
  float* aji = sm + L.aji;    // [NL][Wt]
  float* akj = sm + L.akj;    // [K8][AP]
  float* rows = sm + L.x;     // [max(K8, R)][H+PD]
  float* qp = sm + L.qp;      // [R][H+PD]
  float* wang = sm + L.wang;  // [NENC][Wt]
  float* lnsb = sm + L.lnsb;  // LayerNorm scale [32] | bias [32]
  float* ring = sm + L.ring;
  int* tidx = reinterpret_cast<int*>(sm + L.tidx);
  const float* hb = FP(TP_HB);

  for (int idx = tid; idx < NL * 3; idx += nt)
    posl[idx] = FP(TP_X)[((size_t)b * N + NP) * 3 + idx];
  for (int idx = tid; idx < 2 * Wt; idx += nt)
    lnsb[idx < Wt ? idx : 32 + idx - Wt] =
        idx < Wt ? FP(TP_T_LN_S)[idx] : FP(TP_T_LN_B)[idx - Wt];
  for (int idx = tid; idx < NENC * Wt; idx += nt) {
    const int e = idx / Wt, f = idx - e * Wt, r1 = c_enc_rows[e][1];
    wang[idx] = FP(TP_T_WANG)[c_enc_rows[e][0] * Wt + f] +
                (r1 >= 0 ? FP(TP_T_WANG)[r1 * Wt + f] : 0.f);
  }
  if (tid < K8) tidx[tid] = IP(TP_TRIP_IDX)[((size_t)b * NL + j) * K8 + tid];
  __syncthreads();
  for (int idx = tid; idx < K8 * H4; idx += nt) {
    const int k8 = idx / H4, c = (idx % H4) * 4;
    cp_async16(rows + k8 * PH + c,
               hb + (((size_t)b * NL + tidx[k8]) * NL + j) * H + c);
  }
  for (int idx = tid; idx < NL * NRBF; idx += nt) {
    const int i = idx / NRBF, q = idx % NRBF;
    float r2 = 0.f;
    for (int c = 0; c < 3; ++c) {
      const float r = posl[j * 3 + c] - posl[i * 3 + c];
      r2 += r * r;
    }
    const float df = sqrtf(r2 + 1e-12f) - c_rbf_off[q];
    rf[idx] = expf(RBF_COEFF * (df * df));
  }
  cp_async_wait();
  __syncthreads();
  mm<NW1>(rf, NRBF, NL, wmat(FP(TP_T_WJI), Wt), NRBF, Wt, nullptr, aji, Wt,
          false, ring);
  mm<NW1>(rows, PH, K8, wmat(FP(TP_T_WHB), Wt), H, Wt, nullptr, akj, AP,
          false, ring);
  // a_kj[m, j] for the K8 frozen sources m of j: + rbf(|pos_m - pos_j|) @
  // t_Wr + t_b + (h_m @ t_Wn[:, :Wt]) + (h_j @ t_Wn[:, Wt:]); the rbf row
  // of (m, j) is rf[m], the distance being symmetric
  for (int idx = tid; idx < K8 * Wt; idx += nt) {
    const int k8 = idx / Wt, w = idx % Wt, m = tidx[k8];
    float acc = 0.f;
    for (int q = 0; q < NRBF; ++q)
      acc += rf[m * NRBF + q] * FP(TP_T_WR)[q * Wt + w];
    akj[k8 * AP + w] +=
        acc + FP(TP_T_B)[w] + PB[m * PBW + w] + PB[j * PBW + Wt + w];
  }
  // q_z[j, i] = relu(LN(hb[j, i] @ tq_Whb + h_i @ tq_Wi + tq_b0)): the rows
  // of hb and of the node term h_i @ tq_Wi come in by cp.async, the node
  // term is the product's starting sum
  for (int i0 = 0; i0 < NL; i0 += R) {
    const int ni = imin(R, NL - i0);
    __syncthreads();
    for (int idx = tid; idx < ni * H4; idx += nt) {
      const int i = idx / H4, c = (idx % H4) * 4;
      cp_async16(rows + i * PH + c,
                 hb + (((size_t)b * NL + j) * NL + i0 + i) * H + c);
      cp_async16(qp + i * PH + c, PB + (size_t)(i0 + i) * PBW + 2 * Wt + c);
    }
    cp_async_wait();
    __syncthreads();
    mm<NW1>(rows, PH, ni, wmat(FP(TP_TQ_WHB), H), H, H, FP(TP_TQ_B0), qp, PH,
            true, ring);
    ln_rows(qp, PH, ni, H, FP(TP_TQ_LN_S), FP(TP_TQ_LN_B), true);
    __syncthreads();
    for (int idx = tid; idx < ni * H4; idx += nt) {
      const int i = idx / H4, c = (idx % H4) * 4;
      Blk<BT>::st(reinterpret_cast<BT*>(const_cast<void*>(a.p[TP_QZ])) +
                      (((size_t)b * NL + j) * NL + i0 + i) * H + c,
                  ld4(qp + i * PH + c));
    }
  }
  __syncthreads();
  // pre_t[j, i, k8, :] = relu(LN(a_kj[m, j] + a_ji[j, i] + enc(angle) @
  // t_Wang)), on the tensor cores: a warp takes 32 consecutive triplets
  // (i, k8) of pre_t, each lane computes one triplet's angle and its 11
  // encodings into row `lane` of the warp's tile [32][16] (5 zero columns),
  // and the tile goes through mma.sync m16n8k8 in 3xTF32 (as mm_tc) against
  // the merged t_Wang, split once into registers. The sums start from
  // a_kj + a_ji. The weight's columns are permuted so that in the
  // accumulators lane (gr, tq) holds features 16 q + 4 tq .. + 3 (q = 0, 1)
  // of rows gr, gr + 8, gr + 16 and gr + 24: a quad holds a row's Wt
  // features, its LayerNorm needs two shuffles, and every lane stores 16
  // bytes at a time. Features from Wt on (Wt < 32) have zero weights and
  // start from 0, so they add nothing to the LayerNorm sums; they are not
  // stored.
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int ntask = NL * K8;
  // i = t / K8 as one multiply-high (exact for t < 2^32 / K8^2)
  const uint32_t magic = K8 > 1 ? 0xffffffffu / (uint32_t)K8 + 1u : 0u;
#define TRIP_I(t) (K8 > 1 ? (int)__umulhi((uint32_t)(t), magic) : (t))
  uint32_t bh[2][4][2], bl[2][4][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int n8 = 0; n8 < 4; ++n8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 8 * ks + tq + 4 * h;
        const int f = 16 * (n8 >> 1) + 4 * (gr >> 1) + 2 * (n8 & 1) + (gr & 1);
        const float w = e < NENC && f < Wt ? wang[e * Wt + f] : 0.f;
        split_tf32(__float_as_uint(w), bh[ks][n8][h], bl[ks][n8][h]);
      }
    }
  }
  float* et = rows + warp * 32 * ELD;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 4;
  const uint32_t et_sh =
      (uint32_t)__cvta_generic_to_shared(et + lrow * ELD + lcol);
  BT* outp = reinterpret_cast<BT*>(const_cast<void*>(a.p[TP_PRE_T])) +
             ((size_t)b * NL + j) * NL * K8 * Wt;
  for (int t0 = warp * 32; t0 < ntask; t0 += nw * 32) {
    {
      const int t = t0 + lane;
      float e[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) e[q] = 0.f;
      if (t < ntask) {
        const int i = TRIP_I(t), k8 = t - i * K8, m = tidx[k8];
        float dot = 0.f, njsq = 0.f, nksq = 0.f;
        for (int c = 0; c < 3; ++c) {
          const float rj = posl[j * 3 + c] - posl[i * 3 + c];
          const float rk = posl[m * 3 + c] - posl[i * 3 + c];
          dot += rj * rk;
          njsq += rj * rj;
          nksq += rk * rk;
        }
        const float cross =
            sqrtf(fmaxf(njsq * nksq - dot * dot, CROSS_SQ_EPS_F));
        const float ang = atan2f(cross, dot);
        float s1, c1, s2, c2, s3, c3;
        sincosf(ang, &s1, &c1);
        sincosf(ang * 0.5f, &s2, &c2);
        sincosf(ang * 0.33333334f, &s3, &c3);
        e[0] = ang;
        e[1] = s1;
        e[2] = 2.f * s1 * c1;                 // sin 2a
        e[3] = s1 * (3.f - 4.f * s1 * s1);    // sin 3a
        e[4] = s2;
        e[5] = s3;
        e[6] = c1;
        e[7] = 1.f - 2.f * s1 * s1;           // cos 2a
        e[8] = c1 * (4.f * c1 * c1 - 3.f);    // cos 3a
        e[9] = c2;
        e[10] = c3;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        st4(et + lane * ELD + 4 * q,
            make_float4(e[4 * q], e[4 * q + 1], e[4 * q + 2], e[4 * q + 3]));
    }
    __syncwarp();
    float acc[2][4][4];
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = t0 + rt * 16 + hr * 8 + gr;
        const int i = TRIP_I(t), k8 = t - i * K8;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int f = 16 * q + 4 * tq;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (t < ntask && f < Wt) {
            const float4 kv = ld4(akj + k8 * AP + f);
            const float4 jv = ld4(aji + i * Wt + f);
            v = make_float4(kv.x + jv.x, kv.y + jv.y, kv.z + jv.z,
                            kv.w + jv.w);
          }
          acc[rt][2 * q][2 * hr] = v.x;
          acc[rt][2 * q][2 * hr + 1] = v.y;
          acc[rt][2 * q + 1][2 * hr] = v.z;
          acc[rt][2 * q + 1][2 * hr + 1] = v.w;
        }
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t af[4];
        ldmatrix_x4(af, et_sh + (uint32_t)(rt * 16 * ELD + ks * 8) * 4u);
        tile_step<4>(af, bh[ks], bl[ks], acc[rt]);
      }
    }
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float s = 0.f, s2 = 0.f;
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) {
          const float v0 = acc[rt][n8][2 * hr], v1 = acc[rt][n8][2 * hr + 1];
          s += v0 + v1;
          s2 += v0 * v0 + v1 * v1;
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
        const float mu = s / Wt;
        const float rs = rsqrtf(s2 / Wt - mu * mu + LN_EPS_F);
        const int t = t0 + rt * 16 + hr * 8 + gr;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int f = 16 * q + 4 * tq;
          if (t >= ntask || f >= Wt) continue;
          const float4 ls = ld4(lnsb + f), lb = ld4(lnsb + 32 + f);
          float4 y;
          y.x = fmaxf((acc[rt][2 * q][2 * hr] - mu) * rs * ls.x + lb.x, 0.f);
          y.y = fmaxf((acc[rt][2 * q][2 * hr + 1] - mu) * rs * ls.y + lb.y,
                      0.f);
          y.z = fmaxf((acc[rt][2 * q + 1][2 * hr] - mu) * rs * ls.z + lb.z,
                      0.f);
          y.w = fmaxf((acc[rt][2 * q + 1][2 * hr + 1] - mu) * rs * ls.w + lb.w,
                      0.f);
          Blk<BT>::st(outp + (size_t)t * Wt + f, y);
        }
      }
    }
    __syncwarp();  // the tile is free for the warp's next triplets
  }
#undef TRIP_I
}

template <class BT>
__global__ void __launch_bounds__(NT1, 2)
trip_pre_kernel(Dims d, Args a, int R, const float* P0, int gstride, int PW) {
  extern __shared__ float sm[];
  const int b = blockIdx.y;
  trip_pre_body<BT>(d, a, sm, R, b, blockIdx.x, P0 + (size_t)b * gstride,
                    PW);
}

// --------------------------------------- stage B2: triplet head attention

enum {
  TA_HB = 0, TA_PRE_T, TA_QZ, TA_OUT, TA_TRIP_IDX, TA_TRIP_MASK, TA_MASK_L,
  TA_TQ_W1, TA_TQ_B1, TA_T_OUT_W, TA_T_OUT_B, TA_COUNT
};

struct AttSmem {
  float *qz, *qh, *pt, *alw, *ring;
};

__device__ AttSmem att_smem(const Dims& d, float* sm, const Lay& L) {
  AttSmem s;
  s.qh = sm + L.u1;
  s.qz = sm + L.u2;
  s.pt = sm + L.u2;  // q_z is reloaded for each head group
  s.ring = sm + L.ring;
  s.alw = s.ring;  // the ring is idle between the two products of a group
  return s;
}

// Stage B2 for np <= R pairs: per-head queries, masked softmax over the K8
// sources of j, pool, t_out_W; heads in groups of HG, each group one pass
// over the pairs' pre_t tiles. ROW:
// the pairs are (j0, i0 + p), one row of the bond grid; else (j0 + p, i0),
// one column. The new bond features go to TA_OUT and stay in out[p][ldo]
// (shared memory); a block barrier ends it. BT: element type of pre_t and
// q_z (see Blk); the warps' pre_t tiles hold it as it is stored.
template <bool ROW, class BT>
__device__ void trip_att_pairs(const Dims& d, const Args& a, const AttSmem& s,
                               int b, int j0, int i0, int np, int HG,
                               float* out, int ldo) {
  constexpr int dj = ROW ? 0 : 1, di = ROW ? 1 : 0;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int NL = d.NL, H = d.H, K8 = d.K8, Wt = d.Wt, NH = d.heads;
  const int PH = H + PD, H4 = H >> 2, W4 = Wt >> 2;
  const int QP = HG * Wt + PD;
#define PAIR(p) (((size_t)b * NL + j0 + (p) * dj) * NL + i0 + (p) * di)
  const float* ml = FP(TA_MASK_L) + (size_t)b * NL;
  const float inv_sw = (float)(1.0 / sqrt((double)Wt));
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const BT* qz = reinterpret_cast<const BT*>(a.p[TA_QZ]);
  const BT* pt = reinterpret_cast<const BT*>(a.p[TA_PRE_T]);
  // the warp's tile [K8][Wt], rotated
  BT* ptw = reinterpret_cast<BT*>(s.pt) + warp * K8 * Wt;
  float* alw = s.alw + warp * 128;     // softmax weights [k][4 heads]
  for (int hg0 = 0; hg0 < NH; hg0 += HG) {
    const int nhg = imin(HG, NH - hg0), gw = nhg * Wt;
    for (int idx = tid; idx < np * H4; idx += nt) {
      const int p = idx / H4, c = (idx % H4) * 4;
      st4(s.qz + p * PH + c, Blk<BT>::ld(qz + PAIR(p) * H + c));
    }
    __syncthreads();
    // q_h = q_z @ tq_W1[h] + tq_b1[h]; column h*Wt + w of the group
    WSrc w1;
    w1.W = FP(TA_TQ_W1) + (size_t)hg0 * H * Wt;
    w1.ldw = Wt; w1.cbw = Wt; w1.cbs = H * Wt;
    mm(s.qz, PH, np, w1, H, gw, FP(TA_TQ_B1) + hg0 * Wt, s.qh, QP, false,
       s.ring);
    for (int p = warp; p < np; p += nw) {
      const int j = j0 + p * dj, i = i0 + p * di;
      float* qrow = s.qh + p * QP;
      const float pv = ml[i] * ml[j] * (i != j ? 1.f : 0.f);
      if (pv == 0.f) {  // every triplet of the pair is masked: pooled = 0
        for (int c = lane; c < gw; c += 32) qrow[c] = 0.f;
        continue;
      }
      const BT* src = pt + PAIR(p) * K8 * Wt;
      for (int q = lane; q < K8 * W4; q += 32) {
        const int k = q / W4, c4 = q % W4;
        Blk<BT>::cp(ptw + k * Wt + rot4(c4, k, W4) * 4, src + q * 4);
      }
      float vf = 0.f;
      if (lane < K8) {
        const size_t o = ((size_t)b * NL + j) * K8 + lane;
        vf = FP(TA_TRIP_MASK)[o] * pv *
             (IP(TA_TRIP_IDX)[o] != i ? 1.f : 0.f);
      }
      cp_async_wait();
      __syncwarp();
      // the lane's row of the tile (source k8 = lane), all loads in flight
      float4 trow[8];
#pragma unroll
      for (int c4 = 0; c4 < 8; ++c4)
        trow[c4] = lane < K8 && c4 < W4
                       ? Blk<BT>::ld(ptw + lane * Wt + rot4(c4, lane, W4) * 4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      for (int h0 = 0; h0 < nhg; h0 += 4) {
        const int hc = imin(4, nhg - h0);
        float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c4 = 0; c4 < 8; ++c4) {
          if (c4 < W4) {
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              if (h < hc) {
                const float4 q4 = ld4(qrow + (h0 + h) * Wt + c4 * 4);
                sc[h] = fmaf(trow[c4].x, q4.x, sc[h]);
                sc[h] = fmaf(trow[c4].y, q4.y, sc[h]);
                sc[h] = fmaf(trow[c4].z, q4.z, sc[h]);
                sc[h] = fmaf(trow[c4].w, q4.w, sc[h]);
              }
            }
          }
        }
        // masked softmax over the sources (lanes), the 4 heads' shuffle
        // chains side by side
        float sv[4], mx[4], ex[4], sm4[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          sv[h] = lane < K8 && h < hc
                      ? sc[h] * inv_sw + (1.f - vf) * NEG_INF_F
                      : -INFINITY;
          mx[h] = sv[h];
        }
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int h = 0; h < 4; ++h)
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], o));
        }
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          ex[h] = lane < K8 && h < hc ? expf(sv[h] - mx[h]) * vf : 0.f;
          sm4[h] = ex[h];
        }
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int h = 0; h < 4; ++h)
            sm4[h] += __shfl_xor_sync(0xffffffffu, sm4[h], o);
        }
        __syncwarp();  // the heads' q_h is consumed, alw is free
        st4(alw + lane * 4, make_float4(ex[0] / fmaxf(sm4[0], 1.f),
                                        ex[1] / fmaxf(sm4[1], 1.f),
                                        ex[2] / fmaxf(sm4[2], 1.f),
                                        ex[3] / fmaxf(sm4[3], 1.f)));
        __syncwarp();
        if (lane < Wt) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
          for (int k = 0; k < K8; ++k) {
            const float4 a4 = ld4(alw + k * 4);
            const float tv = Blk<BT>::at(
                ptw + k * Wt + rot4(lane >> 2, k, W4) * 4 + (lane & 3));
            acc[0] = fmaf(a4.x, tv, acc[0]);
            acc[1] = fmaf(a4.y, tv, acc[1]);
            acc[2] = fmaf(a4.z, tv, acc[2]);
            acc[3] = fmaf(a4.w, tv, acc[3]);
          }
#pragma unroll
          for (int h = 0; h < 4; ++h)
            if (h < hc) qrow[(h0 + h) * Wt + lane] = acc[h];
        }
      }
      __syncwarp();  // tile and alw are free for the warp's next pair
    }
    __syncthreads();
    mm(s.qh, QP, np, wmat(FP(TA_T_OUT_W) + (size_t)hg0 * Wt * H, H), gw, H,
       nullptr, out, ldo, hg0 > 0, s.ring);
  }
  for (int idx = tid; idx < np * H4; idx += nt) {
    const int p = idx / H4, c = (idx % H4) * 4;
    const size_t o = PAIR(p) * H + c;
    const float4 hv = ld4(FP(TA_HB) + o), ov = ld4(out + p * ldo + c);
    const float4 bv = ld4(FP(TA_T_OUT_B) + c);
    const float4 v = make_float4(hv.x + (ov.x + bv.x), hv.y + (ov.y + bv.y),
                                 hv.z + (ov.z + bv.z), hv.w + (ov.w + bv.w));
    st4(OUTP(TA_OUT) + o, v);
    st4(out + p * ldo + c, v);
  }
  __syncthreads();
#undef PAIR
}

// What stage B2 gives pairs [p0, p1) of a row or column whose triplets are
// all masked: hb_new = hb + (0 @ t_out_W + t_out_b).
template <bool ROW>
__device__ void trip_att_void_pairs(const Dims& d, const Args& a, int b,
                                    int j0, int i0, int p0, int p1) {
  constexpr int dj = ROW ? 0 : 1, di = ROW ? 1 : 0;
  const int H4 = d.H >> 2;
  for (int idx = threadIdx.x; idx < (p1 - p0) * H4; idx += blockDim.x) {
    const int p = p0 + idx / H4, c = (idx % H4) * 4;
    const size_t o =
        (((size_t)b * d.NL + j0 + p * dj) * d.NL + i0 + p * di) * d.H + c;
    const float4 hv = ld4(FP(TA_HB) + o), bv = ld4(FP(TA_T_OUT_B) + c);
    st4(OUTP(TA_OUT) + o,
        make_float4(hv.x + (0.f + bv.x), hv.y + (0.f + bv.y),
                    hv.z + (0.f + bv.z), hv.w + (0.f + bv.w)));
  }
}

template <class BT>
__global__ void __launch_bounds__(NT, 1)
trip_att_kernel(Dims d, Args a, int R, int HG) {
  extern __shared__ float sm[];
  const Lay L = stage_layout(d, 0, R, false, HG);
  const int b = blockIdx.z, j = blockIdx.y, i0 = blockIdx.x * R;
  const int np = imin(R, d.NL - i0);
  const float* ml = FP(TA_MASK_L) + (size_t)b * d.NL;
  // the pairs (j, i) with an atom in slot i; none if j itself is padding
  const int nsrc =
      valid_sources(ml, d.NL, reinterpret_cast<int*>(sm + L.misc + 7));
  const int nv = ml[j] != 0.f ? imax(0, imin(np, nsrc - i0)) : 0;
  if (nv > 0)
    trip_att_pairs<true, BT>(d, a, att_smem(d, sm, L), b, j, i0, nv, HG,
                             sm + L.rows, d.H + PD);
  trip_att_void_pairs<true>(d, a, b, j, i0, nv, np);
}

// ------------------------------- merged stage B2 + C (one main grid)
//
// Counterpart of _att_pos_pallas. Stage C's bond-grid attention for
// destination dl softmaxes over ALL sources j of hb_new[b, j, dl, :], so one
// block per (graph, dl) finishes that column itself: it runs B2 on the
// column's pairs (j, dl), R sources a pass (all of them up to NL = 80), for
// all heads, writes hb_new once, and B2's output tile is the `rows` tile of
// C's first layer. hb_new is never read back, and no block waits for
// another. B2's scratch lies over C's first- and second-layer tiles (they
// are idle while the rows are made).
template <class BT>
struct AttRows {
  // B2's tiles lie over the fold: it is copied again after each pass's rows
  static constexpr bool kFoldKept = false;
  const Args* ta;
  AttSmem s;
  __device__ void operator()(const Dims& d, int b, int dl, int s0, int ns,
                             float* rows) const {
    trip_att_pairs<false, BT>(d, *ta, s, b, s0, dl, ns, att_head_group(d),
                              rows, d.H + PD);
  }
};

template <class BT>
__global__ void __launch_bounds__(NT, 1)
att_pos_kernel(Dims d, Args ap, Args ta, int R) {
  extern __shared__ float sm[];
  const int b = blockIdx.y, dl = blockIdx.x;
  if (pos_padded(d, ap, b, dl)) {
    trip_att_void_pairs<false>(d, ta, b, 0, dl, 0, d.NL);
    return;
  }
  const Lay L =
      stage_layout(d, d.heads, R, true, att_head_group(d), 1, true);
  const Args& a = ap;
  const int nsrc = valid_sources(FP(T_MASK_L) + (size_t)b * d.NL, d.NL,
                                 reinterpret_cast<int*>(sm + L.misc + 7));
  trip_att_void_pairs<false>(d, ta, b, 0, dl, nsrc, d.NL);
  pos_body(d, ap, sm, L, b, dl, 1, nsrc,
           AttRows<BT>{&ta, att_smem(d, sm, L)});
}

// ------------------------------------------------------------ host entries

static Dims read_dims(const int* v) {
  Dims d;
  d.B = v[0]; d.NP = v[1]; d.NL = v[2]; d.K = v[3];
  d.K8 = v[4]; d.H = v[5]; d.heads = v[6]; d.Wt = v[7];
  return d;
}

static Args read_args(const void* const* p, int n) {
  Args a;
  for (int i = 0; i < MAXARGS; ++i) a.p[i] = i < n ? p[i] : nullptr;
  return a;
}

static const size_t kMaxSmem = 232448;
// the most a block may take for two blocks an SM (228 KB, 1 KB reserved a
// block): stage B1's plan
static const size_t kTwoBlockSmem = 233472 / 2 - 1024;

static bool dims_ok(const Dims& d) {
  return d.H % d.heads == 0 && d.H % 4 == 0 && d.Wt % 4 == 0 && d.H <= NT &&
         d.Wt <= 32 && d.Wt >= 4 && d.K8 <= 32 && d.K8 >= 1 && d.K >= 1 &&
         d.K <= d.H && d.heads <= 32 && d.NL >= 1 && d.NL <= NT;
}

static int launch_rows_gemm(const float* X, int ldx, int rows, int rpb,
                            int bstride, int roff, int Kd, const float* W,
                            int Nc, float* Y, cudaStream_t st) {
  const size_t bytes =
      ((size_t)RMAX * (Kd + PD) + RING_FLOATS) * sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(rows_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  dim3 grid((rows + RMAX - 1) / RMAX, (Nc + NCMAX - 1) / NCMAX);
  rows_gemm<<<grid, NT, bytes, st>>>(X, ldx, rows, rpb, bstride, roff, Kd, W,
                                     Nc, Y);
  return (int)cudaGetLastError();
}

// The main kernels, as ls_launch_plan numbers them.
enum { PLAN_NODE, PLAN_TRIP_PRE, PLAN_TRIP_ATT, PLAN_POS, PLAN_ATT_POS,
       PLAN_COUNT };

// Destination nodes a block of stage A (PLAN_NODE) or stage C (PLAN_POS):
// two, so that the kNN edge products run on 2 * K rows a weight pass, where
// the bond grid's rows a pass do not shrink beside them; else one.
static int plan_nodes(const Dims& d, int which = 0);

// Heads a group of B2 alone: all of them where q_h of all heads fits beside
// a whole column of pairs (R = NL up to RMAX; the flagship at NL <= 48), so
// that one pass reads each pair's pre_t tile once; else B2 + C's groups
// over a column of R = 80 pairs (NL = 80: two passes over pre_t). Measured
// on the H100 at NL = 80: one pass over 48 + 32 pairs a block took 6%
// longer than two over 80, its products on fewer rows a weight pass costing
// more than the second read of pre_t saves.
static int trip_att_heads(const Dims& d) {
  const int R = imin(d.NL, RMAX);
  return stage_layout(d, 0, R, false, d.heads).total * sizeof(float) <=
                 kMaxSmem
             ? d.heads
             : att_head_group(d);
}

// Dynamic shared memory of a block of kernel `which` with R source rows a
// pass (stages A and C: with G destination nodes a block).
static size_t plan_bytes(int which, const Dims& d, int R, int G = 1) {
  int floats = 0;
  switch (which) {
    case PLAN_NODE:
      floats = stage_layout(d, d.H, R, true, 0, G).total; break;
    case PLAN_TRIP_PRE: floats = pre_layout(d, R).total; break;
    case PLAN_TRIP_ATT:
      floats = stage_layout(d, 0, R, false, trip_att_heads(d)).total; break;
    case PLAN_POS:
      floats = stage_layout(d, d.heads, R, true, 0, G, true).total; break;
    default:
      floats = stage_layout(d, d.heads, R, true, att_head_group(d), 1,
                            true).total;
      break;
  }
  return (size_t)floats * sizeof(float);
}

// Source rows a pass within `cap` bytes a block: all NL up to RMAX if they
// fit, else the largest count that fits, evened out over the passes and
// rounded up to whole 16-row tensor-core tiles where that still fits (80
// as 48 + 32, not 40 + 40). 0 if nothing fits.
static int plan_rows_in(int which, const Dims& d, int G, size_t cap) {
  int R = d.NL < RMAX ? d.NL : RMAX;
  while (R > 1 && plan_bytes(which, d, R, G) > cap) R -= R > 8 ? 8 : 1;
  if (plan_bytes(which, d, R, G) > cap) return 0;
  const int np = (d.NL + R - 1) / R, even = (d.NL + np - 1) / np;
  return np > 1 && ((even + 15) & ~15) <= R ? (even + 15) & ~15 : even;
}

// Source rows a pass of kernel `which`. Stage B1 takes its q_z rows in
// passes small enough for two blocks an SM (NT1 threads each), so that one
// block's stores overlap another's products; where nothing fits that, one.
static int plan_rows(int which, const Dims& d, int G = 1) {
  if (which == PLAN_TRIP_PRE) {
    const int R = plan_rows_in(which, d, G, kTwoBlockSmem);
    if (R) return R;
  }
  return plan_rows_in(which, d, G, kMaxSmem);
}

static int plan_nodes(const Dims& d, int which) {
  return plan_rows(which, d, 2) == plan_rows(which, d, 1) ? 2 : 1;
}

// One attention's query job (QueryJob) of MLP slot `slot` (the packed
// q_b0 .. q_b1 in a.p[q0 .. q0 + 4]), the query's first layer in columns
// [col, col + H) of the node projections a.p[P] of pitch PW: for every
// ligand row (lig; a padded one gets no fold) or every row.
static QueryJob query_job(const Dims& d, const Args& a, int P, int PW,
                          int q0, int slot, int col, bool lig,
                          const float* k2W, const float* k2b, float* F,
                          size_t fs) {
  const int H = d.H, N = d.NP + d.NL;
  QueryJob j;
  j.P = FP(P); j.PW = PW; j.col = col;
  j.qb0 = FP(q0) + slot * H;
  j.ln_s = FP(q0 + 1) + slot * H;
  j.ln_b = FP(q0 + 2) + slot * H;
  j.W1 = FP(q0 + 3) + (size_t)slot * H * H;
  j.b1 = FP(q0 + 4) + slot * H;
  j.k2W = k2W; j.k2b = k2b;
  j.rows = d.B * (lig ? d.NL : N);
  j.rpb = lig ? d.NL : j.rows;
  j.bstride = lig ? N : 0;
  j.roff = lig ? d.NP : 0;
  j.ml = lig ? FP(T_MASK_L) : nullptr;
  j.F = F; j.fs = (int)fs;
  return j;
}

static int launch_queries(const Dims& d, const QueryJobs& q,
                          cudaStream_t st) {
  const size_t bytes =
      ((size_t)2 * QROWS * (d.H + PD) + RING_FLOATS) * sizeof(float);
  cudaFuncSetAttribute(node_pos_query_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  const int rows = imax(q.j[0].rows, q.j[1].rows);
  node_pos_query_kernel<<<dim3((rows + QROWS - 1) / QROWS, 2), NT, bytes,
                          st>>>(d, q);
  return (int)cudaGetLastError();
}

// Stage A: its queries and folds (node_pos_query_kernel: the kNN edges'
// of every row, slot 0 into e_k2[0]; the bond grid's of every ligand row,
// slot 1 into b_k2[0]), then node_kernel. P (slot NA_P) holds the node
// projections at pitch PW, made before.
static int launch_node(const Dims& d, const Args& a, int PW,
                       cudaStream_t st) {
  const int H = d.H;
  const size_t fs = fold_floats(d);
  float* Fe = node_folds(d, a, PW);
  QueryJobs q;
  q.j[0] = query_job(d, a, NA_P, PW, NA_Q_B0, 0, 4 * H, false, FP(NA_E_K2),
                     FP(NA_E_B2), Fe, fs);
  q.j[1] = query_job(d, a, NA_P, PW, NA_Q_B0, 1, 5 * H, true, FP(NA_B_K2),
                     FP(NA_B_B2), Fe + (size_t)d.B * (d.NP + d.NL) * fs, fs);
  int rc = launch_queries(d, q, st);
  if (rc) return rc;
  const int G = plan_nodes(d), R = plan_rows(PLAN_NODE, d, G);
  if (!R) return (int)cudaErrorInvalidValue;
  const size_t bytes = plan_bytes(PLAN_NODE, d, R, G);
  cudaFuncSetAttribute(node_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  node_kernel<<<dim3((d.NP + d.NL + G - 1) / G, d.B), NT, bytes, st>>>(
      d, a, R, G, PW);
  return (int)cudaGetLastError();
}

// P0: graph 0's first ligand row of the B1 node projections; gstride:
// floats from one graph's rows to the next's; PW: row pitch.
template <class BT>
static int launch_trip_pre(const Dims& d, const Args& a, const float* P0,
                           int gstride, int PW, cudaStream_t st) {
  const int R = plan_rows(PLAN_TRIP_PRE, d);
  if (!R) return (int)cudaErrorInvalidValue;
  const size_t bytes = plan_bytes(PLAN_TRIP_PRE, d, R);
  cudaFuncSetAttribute(trip_pre_kernel<BT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  trip_pre_kernel<BT><<<dim3(d.NL, d.B), NT1, bytes, st>>>(d, a, R, P0,
                                                            gstride, PW);
  return (int)cudaGetLastError();
}

// Stage C's queries and folds for every ligand row (node_pos_query_kernel:
// the kNN edges' slot 2 into e_xk2, the bond grid's slot 3 into p_xk2),
// after rows_gemm has made the node projections P.
static int launch_pos_query(const Dims& d, const Args& a, cudaStream_t st) {
  const size_t fs = fold_floats(d);
  QueryJobs q;
  for (int at = 0; at < 2; ++at)
    q.j[at] = query_job(d, a, PA_P, 10 * d.H, PA_Q_B0, 2 + at, (4 + at) * d.H,
                        true, FP(at ? PA_P_XK2 : PA_E_XK2),
                        FP(at ? PA_P_XK2B : PA_E_XK2B),
                        pos_folds(d, a) + at * fs, 2 * fs);
  return launch_queries(d, q, st);
}

// Phore rows of x pass through stage C unchanged (their update is masked to
// zero), so its kernels run on ligand rows only.
static int copy_phore_rows(const Dims& d, const float* x, float* out,
                           cudaStream_t st) {
  const size_t pitch = (size_t)(d.NP + d.NL) * 3 * sizeof(float);
  return (int)cudaMemcpy2DAsync(out, pitch, x, pitch,
                                (size_t)d.NP * 3 * sizeof(float), d.B,
                                cudaMemcpyDeviceToDevice, st);
}

// The stage entries whose blocks pre_t and q_z have element type BT. Each
// has an entry for float blocks and one for bf16 blocks (`_bf16`), with the
// same pointer slots and dims.

// Stage B1. Pointer slots: see the TP_* enum.
template <class BT>
static int stage_trip_pre(const void* const* p, int np, const int* dims,
                          void* stream) {
  if (np != TP_COUNT) return (int)cudaErrorInvalidValue;
  const Dims d = read_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const Args a = read_args(p, np);
  cudaStream_t st = (cudaStream_t)stream;
  const int N = d.NP + d.NL, PBW = 2 * d.Wt + d.H;
  int rc = launch_rows_gemm(FP(TP_H), d.H, d.B * d.NL, d.NL, N, d.NP, d.H,
                            FP(TP_W), PBW, OUTP(TP_PB), st);
  if (rc) return rc;
  return launch_trip_pre<BT>(d, a, FP(TP_PB), d.NL * PBW, PBW, st);
}

// Stage B2. Pointer slots: see the TA_* enum.
template <class BT>
static int stage_trip_att(const void* const* p, int np, const int* dims,
                          void* stream) {
  if (np != TA_COUNT) return (int)cudaErrorInvalidValue;
  const Dims d = read_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const Args a = read_args(p, np);
  cudaStream_t st = (cudaStream_t)stream;
  const int R = plan_rows(PLAN_TRIP_ATT, d);
  if (!R) return (int)cudaErrorInvalidValue;
  const size_t bytes = plan_bytes(PLAN_TRIP_ATT, d, R);
  cudaFuncSetAttribute(trip_att_kernel<BT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  trip_att_kernel<BT><<<dim3((d.NL + R - 1) / R, d.NL, d.B), NT, bytes, st>>>(
      d, a, R, trip_att_heads(d));
  return (int)cudaGetLastError();
}

// Merged stage A + B1. Pointer slots: stage A's (NA_*, T_*; slot NA_W holds
// [nodeA_W | nodeB_W]), then pre_t, q_z, trip_idx and stage B1's weights
// from TP_T_WHB on. One rows_gemm gives h @ [nodeA_W | nodeB_W] for both
// roles; then A's grid and B1's grid, each with its own shared memory (B1's
// blocks do not run under A's footprint), reading h, x and hb a second time
// from L2 at most.
template <class BT>
static int stage_node_pre(const void* const* p, int np, const int* dims,
                          void* stream) {
  const int extra = TP_COUNT - TP_T_WHB;
  if (np != NA_COUNT + 3 + extra) return (int)cudaErrorInvalidValue;
  const Dims d = read_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const Args an = read_args(p, NA_COUNT);
  Args at = read_args(p, 0);
  at.p[TP_H] = p[NA_H];
  at.p[TP_X] = p[NA_X];
  at.p[TP_HB] = p[NA_HB];
  at.p[TP_PRE_T] = p[NA_COUNT];
  at.p[TP_QZ] = p[NA_COUNT + 1];
  at.p[TP_TRIP_IDX] = p[NA_COUNT + 2];
  for (int i = 0; i < extra; ++i) at.p[TP_T_WHB + i] = p[NA_COUNT + 3 + i];
  cudaStream_t st = (cudaStream_t)stream;
  const int N = d.NP + d.NL, PW = 10 * d.H + 2 * d.Wt + d.H;
  const Args& a = an;
  int rc = launch_rows_gemm(FP(NA_H), d.H, d.B * N, d.B * N, 0, 0, d.H,
                            FP(NA_W), PW, OUTP(NA_P), st);
  if (rc) return rc;
  // B1 reads columns [10H, PW) of the ligand rows
  rc = launch_trip_pre<BT>(d, at, FP(NA_P) + (size_t)d.NP * PW + 10 * d.H,
                           N * PW, PW, st);
  if (rc) return rc;
  return launch_node(d, an, PW, st);
}

// Merged stage B2 + C. Pointer slots: stage C's (PA_*, T_*; PA_HB is the
// OLD bond grid, B2's input), then pre_t, q_z, hb_new (output), trip_idx,
// trip_mask and stage B2's weights from TA_TQ_W1 on. Phore rows of x are
// copied as in ls_stage_pos.
template <class BT>
static int stage_att_pos(const void* const* p, int np, const int* dims,
                         void* stream) {
  const int extra = TA_COUNT - TA_TQ_W1;
  if (np != PA_COUNT + 5 + extra) return (int)cudaErrorInvalidValue;
  const Dims d = read_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const Args ap = read_args(p, PA_COUNT);
  Args ta = read_args(p, 0);
  ta.p[TA_HB] = p[PA_HB];
  ta.p[TA_PRE_T] = p[PA_COUNT];
  ta.p[TA_QZ] = p[PA_COUNT + 1];
  ta.p[TA_OUT] = p[PA_COUNT + 2];
  ta.p[TA_TRIP_IDX] = p[PA_COUNT + 3];
  ta.p[TA_TRIP_MASK] = p[PA_COUNT + 4];
  ta.p[TA_MASK_L] = p[T_MASK_L];
  for (int i = 0; i < extra; ++i) ta.p[TA_TQ_W1 + i] = p[PA_COUNT + 5 + i];
  cudaStream_t st = (cudaStream_t)stream;
  const int N = d.NP + d.NL;
  const Args& a = ap;
  int rc = copy_phore_rows(d, FP(PA_X), OUTP(PA_OUT), st);
  if (rc) return rc;
  rc = launch_rows_gemm(FP(PA_NEW_H), d.H, d.B * N, d.B * N, 0, 0, d.H,
                        FP(PA_W), 10 * d.H, OUTP(PA_P), st);
  if (rc) return rc;
  rc = launch_pos_query(d, a, st);
  if (rc) return rc;
  const int R = plan_rows(PLAN_ATT_POS, d);
  if (!R) return (int)cudaErrorInvalidValue;
  const size_t bytes = plan_bytes(PLAN_ATT_POS, d, R);
  cudaFuncSetAttribute(att_pos_kernel<BT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  att_pos_kernel<BT><<<dim3(d.NL, d.B), NT, bytes, st>>>(d, ap, ta, R);
  return (int)cudaGetLastError();
}

extern "C" {

// For `dims`: of node_kernel, trip_pre_kernel, trip_att_kernel, pos_kernel
// and att_pos_kernel (i = 0 .. 4), source rows a pass out[4 i] (0: does not
// fit), dynamic shared memory a block in bytes out[4 i + 1], destination
// nodes a block out[4 i + 2] (stages A and C; 1 for the others) and the
// blocks an SM holds at once out[4 i + 3] (the occupancy API: registers,
// threads and shared memory; 0 where nothing fits).
int ls_launch_plan(const int* dims, int* out) {
  const Dims d = read_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const void* kern[PLAN_COUNT] = {
      (const void*)node_kernel, (const void*)trip_pre_kernel<float>,
      (const void*)trip_att_kernel<float>, (const void*)pos_kernel,
      (const void*)att_pos_kernel<float>};
  for (int i = 0; i < PLAN_COUNT; ++i) {
    const int G = i == PLAN_NODE || i == PLAN_POS ? plan_nodes(d, i) : 1;
    const int R = plan_rows(i, d, G);
    const size_t bytes = R ? plan_bytes(i, d, R, G) : 0;
    int blocks = 0;
    if (R) {
      cudaFuncSetAttribute(kern[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern[i], i == PLAN_TRIP_PRE ? NT1 : NT, bytes);
      if (e != cudaSuccess) return (int)e;
    }
    out[4 * i] = R;
    out[4 * i + 1] = (int)bytes;
    out[4 * i + 2] = G;
    out[4 * i + 3] = blocks;
  }
  return 0;
}

// Stage A. Pointer slots: see the NA_* and T_* enums.
int ls_stage_node(const void* const* p, int np, const int* dims, void* stream) {
  if (np != NA_COUNT) return (int)cudaErrorInvalidValue;
  const Dims d = read_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const Args a = read_args(p, np);
  cudaStream_t st = (cudaStream_t)stream;
  const int N = d.NP + d.NL;
  int rc = launch_rows_gemm(FP(NA_H), d.H, d.B * N, d.B * N, 0, 0, d.H,
                            FP(NA_W), 10 * d.H, OUTP(NA_P), st);
  if (rc) return rc;
  return launch_node(d, a, 10 * d.H, st);
}

// Stage C.
int ls_stage_pos(const void* const* p, int np, const int* dims, void* stream) {
  if (np != PA_COUNT) return (int)cudaErrorInvalidValue;
  const Dims d = read_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const Args a = read_args(p, np);
  cudaStream_t st = (cudaStream_t)stream;
  const int N = d.NP + d.NL;
  int rc = copy_phore_rows(d, FP(PA_X), OUTP(PA_OUT), st);
  if (rc) return rc;
  rc = launch_rows_gemm(FP(PA_NEW_H), d.H, d.B * N, d.B * N, 0, 0, d.H,
                        FP(PA_W), 10 * d.H, OUTP(PA_P), st);
  if (rc) return rc;
  rc = launch_pos_query(d, a, st);
  if (rc) return rc;
  const int G = plan_nodes(d, PLAN_POS), R = plan_rows(PLAN_POS, d, G);
  if (!R) return (int)cudaErrorInvalidValue;
  const size_t bytes = plan_bytes(PLAN_POS, d, R, G);
  cudaFuncSetAttribute(pos_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  pos_kernel<<<dim3((d.NL + G - 1) / G, d.B), NT, bytes, st>>>(d, a, R, G);
  return (int)cudaGetLastError();
}

// Stages B1, B2, A + B1 and B2 + C (see the templates above), with float
// blocks and with bf16 blocks.
int ls_stage_trip_pre(const void* const* p, int np, const int* dims,
                      void* stream) {
  return stage_trip_pre<float>(p, np, dims, stream);
}

int ls_stage_trip_pre_bf16(const void* const* p, int np, const int* dims,
                           void* stream) {
  return stage_trip_pre<bf16>(p, np, dims, stream);
}

int ls_stage_trip_att(const void* const* p, int np, const int* dims,
                      void* stream) {
  return stage_trip_att<float>(p, np, dims, stream);
}

int ls_stage_trip_att_bf16(const void* const* p, int np, const int* dims,
                           void* stream) {
  return stage_trip_att<bf16>(p, np, dims, stream);
}

int ls_stage_node_pre(const void* const* p, int np, const int* dims,
                      void* stream) {
  return stage_node_pre<float>(p, np, dims, stream);
}

int ls_stage_node_pre_bf16(const void* const* p, int np, const int* dims,
                           void* stream) {
  return stage_node_pre<bf16>(p, np, dims, stream);
}

int ls_stage_att_pos(const void* const* p, int np, const int* dims,
                     void* stream) {
  return stage_att_pos<float>(p, np, dims, stream);
}

int ls_stage_att_pos_bf16(const void* const* p, int np, const int* dims,
                          void* stream) {
  return stage_att_pos<bf16>(p, np, dims, stream);
}

}  // extern "C"
