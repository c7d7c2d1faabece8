// Fused CIM matmul and implicit-GEMM conv for Hopper (sm_90a) on float32
// digit planes (cell variation), with per-column partial-sum (ADC)
// quantization or ADC-free, the MACs on the FP64 tensor cores. Plain C
// interface, loaded with ctypes by repro_torch/kernels/_build.py.
//
// Replaces, on planes that carry cell variation (float32 digits):
//   repro/kernels/cim_matmul.py::cim_matmul_pallas (:160) on float32
//     digits (:177-185): its dense body `_kernel` and occupancy-skip body
//     `_kernel_sparse`; entry point cim_matmul_launch;
//   repro/kernels/cim_adc_free.py::cim_matmul_adc_free_pallas (:98) on
//     float32 planes: the same tile loop with the ADC-free epilogue and no
//     s_p operand; entry point cim_matmul_adc_free_launch;
//   repro/kernels/cim_conv.py::cim_conv_pallas (:60) and
//     repro/kernels/cim_adc_free.py::cim_conv_adc_free_pallas (:180) on
//     float32 planes, which take stretched-kernel patches outside their
//     Pallas kernels: here the kernel gathers the patch rows itself from
//     the NHWC codes (implicit GEMM, the index map of cim_mma.cuh's
//     slot_pixel, mirrored by repro_torch.kernels.ref.implicit_conv_rows),
//     and no patch tensor exists; entry point cim_conv_float_implicit_launch
//     (ADC or ADC-free).
// Integer planes (int8, or int4 nibbles) run on the int8 tensor cores
// (cim_mma.cuh, in cim_matmul_mma.cu and cim_adc_free_mma.cu); this file
// serves no integer plane, and the MoE experts kernel takes none of its
// planes (as in the reference).
//
//   p[m,s,t,n] = sum_r a[m,t,r] * d[s,t,r,n]
//   ADC:       out[m,n] = sum_t sum_s deq[s,t,n] * ADC(rint(p))
//              ADC(p) = sign(p) * s_p                     psum_bits == 1
//                     = clip(rint(p / s_p), -2^(b-1), 2^(b-1)-1) * s_p
//              s_p clamped to >= 1e-9; psum_quant == 0 skips rint and ADC.
//   ADC-free:  out[m,n] = sum_t sum_s deq[s,t,n] * rint(p)
//
// Numerics. The MACs run on mma.sync m16n8k16 f64 (DMMA): each product code
// x digit is exact in float64 (a code has at most 8 significant bits, a
// float32 digit 24, so a product at most 32), and a tile's float64 sum is
// the plain version's float64 einsum bit for bit wherever every partial
// sum on the way is exact, whatever order the MMA adds its products in.
// The wrappers show that before each launch, from the planes, for any
// tile height (repro_torch/kernels/cim_matmul.py::float_sums_exact): in a
// tile column whose least nonzero digit magnitude is lo, every digit is a
// multiple of lo's last bit u > lo * 2^-24, so each partial sum is an
// integer multiple of u below rows * A * hi / u (A the codes' bound, 255
// or 128; hi the largest magnitude), exact in float64 when rows * A * hi
// <= 2^29 * lo. Cell variation and drift (d * exp(field), a few units of
// sigma apart within a column; the column drift is one factor a column)
// leave hi / lo far inside the 2^29 / (196 * 255) = 10,741 of llava's
// 196-row patch-embed tiles; a launch on planes that fail it raises
// instead of running (tests/test_torch_float_digits.py proves the bound
// and sums such tiles in row order, in the MMA's k16-chunked order and
// exactly, on the grids of chip_smoke.py and tests/test_torch_cuda.py,
// 126- and 196-row tiles and drifted planes among them). The float64 sum
// is rounded once to float32 (__double2float_rn)
// -- what the plain version's einsum does -- then, but with psum_quant
// off, rounded to the integer grid with rintf. The ADC divide is the IEEE
// quotient: from the column's correctly rounded reciprocal by Markstein's
// correction where the tile's scales lie in [2^-100, 2^100], b <= 22 and
// |p| < 2^24 (the integer kernels' branch-free kRecip, cim_mma.cuh),
// else __fdiv_rn; rint half to even; one rounded multiply by s_p. The
// accumulate uses one rounded multiply and one rounded add (__fmul_rn,
// __fadd_rn: no FMA contraction) in the order t outer, s inner -- the
// order of repro_torch.kernels.ref.shift_add, so the kernel and its plain
// version agree bit for bit. Build without --use_fast_math.
//
// Sparse planes. With an occupancy map, a block skips the staging and the
// MACs of a (t, s) plane whose columns in the block are all unoccupied;
// the partial sum is then exactly 0 and goes through the same epilogue,
// so a dead plane adds ADC(0) * deq (+s_p * deq under the sign ADC, +0
// else; +0 ADC-free) and the sparse path is bit-exact with the dense one.
// Cell variation multiplies, so dead cells stay dead and the clean map
// holds.
//
// Bound at the main path's shapes (ResNet-20 at batch 256 under the
// variation sweep): by operations, about 2 G float64 MACs a conv on the
// FP64 tensor cores (67 TFLOP/s on an H100 SXM; scalar DFMA peaks at half
// that). The design, against it:
//   - each warp computes 16 rows x 16 columns as two m16n8k16 tiles for up
//     to three splits at once, so one A fragment feeds up to 6 MMAs;
//   - each operand element is converted to float64 once: the digits by a
//     small pass per launch into a float64 workspace (K-compacted, columns
//     padded to the column tile; the planes are drawn fresh for each
//     Monte-Carlo sample, so nothing is kept across calls), the codes when
//     they are staged into shared memory (once per tile and split group,
//     by the exact 2^52 trick on the FP64 adder, not the slower
//     int-to-double conversion); never inside the MAC loop;
//   - a tile's K is compacted to its real rows: taps x the channels below
//     C_in (a first-stage conv's second tile holds 2 of 14), padded to the
//     MMA's 16;
//   - a pipeline over the K chunks of every (tile, split group): the next
//     chunk's digits arrive by cp.async into the other of two buffers
//     while this chunk's MMAs run;
//   - window mode for the conv on 16-byte aligned pixels (as the integer
//     kernels' loader, cim_mma.cuh): a row block's input window is copied
//     once into shared memory and the codes are read from there;
//   - fragment reads from shared memory are conflict-free (row strides of
//     4 mod 16 doubles);
//   - the conv reads its codes through the pixel table of its row block
//     (built once per block), not from a patch tensor.

#include "cim_mma.cuh"

namespace {

constexpr int kFThreads = 256;   // 8 warps of 16 x 16 outputs
constexpr int kG = 3;            // splits that share one A fragment

// A block's tile: BM rows x BN columns (16 or 32); K chunks of KC rows,
// two MMA k-steps; row strides of 4 mod 16 doubles; APT codes per thread
// per chunk.
template <int BN>
struct FTile {
  static constexpr int BM = 2048 / BN;
  static constexpr int KC = 32;
  static constexpr int LDA = KC + 4;
  static constexpr int LDB = BN + 4;
  static constexpr int APT = BM * KC / kFThreads;
};

// The epilogue, chosen per block and tile: the rounded partial sum
// (ADC-free), the partial sum itself (psum_quant off), the sign ADC, the
// ADC with the divide from the reciprocal, the ADC with __fdiv_rn.
enum { kFRound = 0, kFPlain = 1, kFSign = 2, kFRecip = 3, kFDivide = 4 };

// A code byte as a float64, exactly: 2^52 + u has u in its low bits.
template <bool kUnsignedA>
__device__ __forceinline__ double code_double(unsigned byte) {
  return kUnsignedA
             ? __hiloint2double(0x43300000, (int)byte) - 4503599627370496.0
             : __hiloint2double(0x43300000, (int)(byte ^ 0x80u)) -
                   4503599627370624.0;   // 2^52 + 128
}

// D (16x8) = A (16x16, row) * B (16x8, col) + D on the FP64 tensor cores
// (Hopper's m16n8k16 shape; g = lane / 4, q = lane % 4): a[i] is A[g +
// 8 (i % 2)][q + 4 (i / 2)], b[i] is B[q + 4 i][g], d[i] is D[g + 8 (i /
// 2)][2 q + i % 2].
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[8],
                                     const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// The term value v of one float64 partial sum (before the dequant): the
// ADC of the rounded partial sum p is cim_mma.cuh's adc_value, guarded:
// a float partial sum may exceed 2^24.
template <int kMode>
__device__ __forceinline__ float term_value(double pd, float s, float r,
                                            const AdcRange& rg) {
  const float pf = __double2float_rn(pd);
  if (kMode == kFPlain) return pf;
  // rint(pf) >= 0 (-0 included) exactly when pf >= -0.5
  if (kMode == kFSign) return pf >= -0.5f ? s : -s;
  const float p = rintf(pf);
  if (kMode == kFRound) return p;
  return adc_value<kMode == kFRecip ? kRecip : kDivide, true>(p, s, r, rg);
}

// One split's terms v * deq added to the warp's sums, in place: p its two
// D fragments, c0 the split's first scale index of the warp's columns.
template <int kMode>
__device__ __forceinline__ void add_terms(const double (&p)[2][4],
                                          const float* spv, const float* rcp,
                                          const float* dq, int c0,
                                          const AdcRange& rg,
                                          float (&acc)[2][2][2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 8 * j + e;
      const float s = spv[c], r = rcp[c], d = dq[c];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        acc[i][j][e] = __fadd_rn(
            acc[i][j][e], __fmul_rn(term_value<kMode>(p[j][2 * i + e], s, r,
                                                      rg), d));
    }
}

// Real (compacted) K rows of tile t: taps x its channels below C.
__host__ __device__ inline int tile_rows(const Geo& g, int t) {
  const int len = tile_len(g, t);
  return len > 0 ? g.taps * len : 0;
}

// The digits' float64 workspace: (S, kt, kpad, npad), tile t's compacted
// K rows first, zero rows and columns after them.
__host__ __device__ inline int digit_kpad(const Geo& g) {
  return (int)round_up(g.rows, 32);
}

// The float32 planes as float64 into the workspace, each tile's K rows
// compacted: K row k of tile t (segments of len codes) is plane row
// tap * seg + c with (tap, c) = divmod(k, len) (the matmul: row k).
__global__ void float_digits_kernel(const float* __restrict__ digits,
                                    double* __restrict__ bd, Geo g,
                                    int npad) {
  const int kpad = digit_kpad(g);
  const long long total = (long long)g.S * g.kt * kpad * npad;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int n = (int)(idx % npad);
  const long long rest = idx / npad;
  const int k = (int)(rest % kpad);
  const long long st = rest / kpad;           // s * kt + t
  const int t = (int)(st % g.kt);
  const int len = tile_len(g, t);
  float v = 0.f;
  if (n < g.N && k < tile_rows(g, t)) {
    const int tap = k / len;
    v = digits[(st * g.rows + tap * g.seg + (k - tap * len)) * g.N + n];
  }
  bd[idx] = (double)v;
}

// Shared memory of one block, in bytes: the A chunk (BM x LDA doubles),
// two digit buffers of a split group (kG x KC x LDB doubles each), the
// pixel table (conv: BM x taps), the K maps of a full and of a partial
// tile (conv), the scales of a tile (deq, s_p, 1 / s_p: S x BN each), the
// live (t, s) planes of the block's columns, and the conv's input window
// (window_cap bytes, or none).
struct FLayout {
  long long b, pix, kmap, dq, sp, rcp, live, win, total;
};

template <int BN, bool kImplicit>
__host__ __device__ inline FLayout flayout(const Geo& g) {
  using T = FTile<BN>;
  FLayout L;
  long long o = 8LL * T::BM * T::LDA;
  L.b = o; o += 2 * 8LL * kG * T::KC * T::LDB;
  L.pix = o; if (kImplicit) o += round_up(4LL * T::BM * g.taps, 16);
  L.kmap = o; if (kImplicit) o += round_up(8LL * g.rows, 16);
  L.dq = o; o += 4LL * g.S * BN;
  L.sp = o; o += 4LL * g.S * BN;
  L.rcp = o; o += 4LL * g.S * BN;
  L.live = o; o += round_up((long long)g.kt * g.S, 16);
  L.win = o; o += g.window_cap;
  L.total = o;
  return L;
}

// Any live split in the group of kG from s0 of tile t.
__device__ __forceinline__ bool group_live(const Geo& g, const uint8_t* live,
                                           int t, int s0) {
  bool any = false;
  for (int q = 0; q < kG && s0 + q < g.S; ++q)
    any = any || live[t * g.S + s0 + q];
  return any;
}

// The first (tile, split group) at or after (t, s0) with MACs to do: rows,
// and a live split; t = kt past the last.
__device__ void seek_group(const Geo& g, const uint8_t* live, int& t,
                           int& s0) {
  while (t < g.kt) {
    if (s0 >= g.S) {
      s0 = 0;
      ++t;
    } else if (tile_rows(g, t) > 0 && group_live(g, live, t, s0)) {
      return;
    } else {
      s0 += kG;
    }
  }
}

// The A chunk of K rows kc.. of tile t as float64, into shared memory:
// thread tid takes K row kc + tid % KC of rows tid / KC + i * (256 / KC),
// zero where no code sits. The conv reads pixel px's codes at codes + off
// + px * C: the NHWC codes, or the row block's input window in shared
// memory.
template <int BN, bool kUnsignedA, bool kImplicit>
__device__ __forceinline__ void form_codes(
    const uint8_t* a, long long off, const Geo& g, const int* pix,
    const int* kmap, long long m0, int t, int kc, double* as) {
  using T = FTile<BN>;
  constexpr int kStep = kFThreads / T::KC;   // rows between a thread's codes
  const int kl = threadIdx.x % T::KC, k = kc + kl;
  const int mm0 = threadIdx.x / T::KC;
  double* dst = as + mm0 * T::LDA + kl;
  if (k >= tile_rows(g, t)) {
#pragma unroll
    for (int i = 0; i < T::APT; ++i) dst[i * kStep * T::LDA] = 0.0;
    return;
  }
  unsigned v[T::APT];
  if (kImplicit) {
    const int km = kmap[(tile_len(g, t) == g.seg ? 0 : g.rows) + k];
    const int* prow = pix + mm0 * g.taps + (km >> 16);
    const uint8_t* src = a + off + t * g.seg + (km & 0xFFFF);
#pragma unroll
    for (int i = 0; i < T::APT; ++i) {
      const int px = prow[i * kStep * g.taps];
      v[i] = px >= 0 ? src[(long long)px * g.C] : 0u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < T::APT; ++i) {
      const long long m = m0 + mm0 + i * kStep;
      v[i] = m < g.M ? a[(m * g.kt + t) * (long long)g.rows + k] : 0u;
    }
  }
#pragma unroll
  for (int i = 0; i < T::APT; ++i)
    dst[i * kStep * T::LDA] = code_double<kUnsignedA>(v[i]);
}

// Issue the cp.async copies of one K chunk's float64 digits (rows kc..,
// tile t) of the live splits of the group from s0 into the digit buffer
// bs.
template <int BN>
__device__ __forceinline__ void issue_digits(
    const double* __restrict__ bd, const Geo& g, const uint8_t* live,
    double* bs, int npad, int n0, int t, int s0, int kc) {
  using T = FTile<BN>;
  constexpr int kPer = T::KC * BN / 2;        // 16-byte copies per split
  const int kpad = digit_kpad(g);
  for (int q = 0; q < kG; ++q) {
    if (s0 + q >= g.S || !live[t * g.S + s0 + q]) continue;
    const double* src =
        bd + (((long long)(s0 + q) * g.kt + t) * kpad + kc) * npad + n0;
    double* dst = bs + q * T::KC * T::LDB;
    for (int i = threadIdx.x; i < kPer; i += kFThreads) {
      const int kl = i / (BN / 2), j = 2 * (i - kl * (BN / 2));
      cp_async16<true>(dst + kl * T::LDB + j, src + (long long)kl * npad + j);
    }
  }
}

// One block: BM rows from blockIdx.x * BM, BN columns from blockIdx.y *
// BN; warp w the 16 x 16 outputs at row block w % (BM / 16), column block
// w / (BM / 16). For each tile t (its scales staged) and each group of up
// to kG splits: the K chunks in a pipeline (the MMAs of one chunk under
// the digit copies of the next, which may belong to the next group or
// tile; the chunk's codes formed from the window or the pixel table at
// its start), then the epilogue in split order into the float32 sums.
// The output is written once.
template <int BN, bool kUnsignedA, bool kImplicit>
__global__ void __launch_bounds__(kFThreads, 2) cim_float_kernel(
    const uint8_t* __restrict__ a,       // (M, kt, rows) codes, or NHWC
    const double* __restrict__ bd,       // float64 digits (S, kt, kpad, npad)
    const uint8_t* __restrict__ occ,     // (S, kt, N) or nullptr
    const float* __restrict__ s_p,       // (S, kt, N); ADC only
    const float* __restrict__ deq,       // (S, kt, N)
    float* __restrict__ out,             // (M, N)
    Geo g, int npad) {
  using T = FTile<BN>;
  constexpr int kWarpsM = T::BM / 16;
  extern __shared__ __align__(16) uint8_t smem[];
  const FLayout L = flayout<BN, kImplicit>(g);
  double* as = reinterpret_cast<double*>(smem);
  double* bs = reinterpret_cast<double*>(smem + L.b);
  int* pix = reinterpret_cast<int*>(smem + L.pix);
  int* kmap = reinterpret_cast<int*>(smem + L.kmap);
  float* dq = reinterpret_cast<float*>(smem + L.dq);
  float* spv = reinterpret_cast<float*>(smem + L.sp);
  float* rcp = reinterpret_cast<float*>(smem + L.rcp);
  uint8_t* live = smem + L.live;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const long long m0 = (long long)blockIdx.x * T::BM;
  const int n0 = blockIdx.y * BN;
  const int ncols = imin(BN, g.N - n0);
  const AdcRange range(g.adc && g.psum_quant ? g.psum_bits : 2);

  // window mode (the conv on 16-byte aligned pixels): the row block's
  // input rows r_lo.. are one contiguous range of the NHWC codes, copied
  // once into shared memory; its codes are then read from there
  const uint8_t* codes = a;
  long long coff = 0;
  if (kImplicit && g.window_cap > 0) {
    issue_window(a, g, T::BM, smem + L.win, m0);
    cp_async_commit();
    codes = smem + L.win;
    coff = -(long long)window_first_row(g, m0) * g.W * g.C;
  }

  if (kImplicit) {
    // the row block's pixel of each (row, tap)
    SlotWalk sw(g.taps);
    for (int slot = tid; slot < T::BM * g.taps;
         slot += kFThreads, sw.next())
      pix[slot] = slot_pixel<true>(g, m0, sw.mm, sw.tap, g.M);
    // K row -> (tap, code) of a full tile and of the partial one (C_in
    // mod cpa channels), if any
    const int part = g.C % g.seg;
    for (int k = tid; k < 2 * g.rows; k += kFThreads) {
      const int len = k < g.rows ? g.seg : part, kk = k % g.rows;
      const int tap = len > 0 ? kk / len : 0;
      kmap[k] = (tap << 16) | (kk - tap * len);
    }
  }
  // the live (t, s) planes: any occupied column of the block
  for (int i = tid; i < g.kt * g.S; i += kFThreads) live[i] = occ == nullptr;
  cp_async_wait_all();    // the window, if any
  __syncthreads();
  if (occ != nullptr)
    for (int i = tid; i < g.kt * g.S * BN; i += kFThreads) {
      const int pl = i / BN, nn = i - pl * BN;   // pl = t * S + s
      const int t = pl / g.S, s = pl - t * g.S;
      if (nn < ncols && occ[((long long)s * g.kt + t) * g.N + n0 + nn])
        live[pl] = 1;
    }
  __syncthreads();

  // the digits' cursor: the next chunk to copy
  int ft = 0, fs0 = 0, fkc = 0;
  seek_group(g, live, ft, fs0);
  if (ft < g.kt) issue_digits<BN>(bd, g, live, bs, npad, n0, ft, fs0, fkc);
  cp_async_commit();
  int buf = 0;

  float acc[2][2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j][0] = acc[i][j][1] = 0.f;

  for (int t = 0; t < g.kt; ++t) {
    const int rows_t = tile_rows(g, t);
    __syncthreads();      // the previous tile's epilogue read its scales
    int safe = 1;
    for (int i = tid; i < g.S * BN; i += kFThreads) {
      const int s = i / BN, nn = i - s * BN;
      const long long src = ((long long)s * g.kt + t) * g.N + n0 + nn;
      dq[i] = nn < ncols ? deq[src] : 0.f;
      const float v = fmaxf(g.adc && nn < ncols ? s_p[src] : 1.f, 1e-9f);
      spv[i] = v;
      rcp[i] = __frcp_rn(v);
      safe &= v >= 0x1p-100f && v <= 0x1p100f;
    }
    safe = __syncthreads_and(safe);
    const int mode = !g.adc               ? kFRound
                     : !g.psum_quant      ? kFPlain
                     : g.psum_bits == 1   ? kFSign
                     : safe && range.small ? kFRecip : kFDivide;

    for (int s0 = 0; s0 < g.S; s0 += kG) {
      bool lv[kG];
#pragma unroll
      for (int q = 0; q < kG; ++q)
        lv[q] = s0 + q < g.S && live[t * g.S + s0 + q];
      double p[kG][2][4];     // split, column tile of 8, D fragment
#pragma unroll
      for (int q = 0; q < kG; ++q)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[q][j][e] = 0.0;
      const bool steps = rows_t > 0 && group_live(g, live, t, s0);
      for (int kc = 0; steps && kc < rows_t; kc += T::KC) {
        __syncthreads();  // the last chunk's MMAs are done: A, other buffer
        form_codes<BN, kUnsignedA, kImplicit>(codes, coff, g, pix, kmap, m0,
                                              t, kc, as);
        cp_async_wait_all();
        __syncthreads();  // this chunk's codes and digits are in
        // the next chunk: this group's, or the next group's with MACs
        fkc += T::KC;
        if (fkc >= tile_rows(g, ft)) {
          fkc = 0;
          fs0 += kG;
          seek_group(g, live, ft, fs0);
        }
        if (ft < g.kt)
          issue_digits<BN>(bd, g, live, bs + (buf ^ 1) * kG * T::KC * T::LDB,
                           npad, n0, ft, fs0, fkc);
        cp_async_commit();
        const double* bb = bs + buf * kG * T::KC * T::LDB;
        const int ksteps = (imin(T::KC, rows_t - kc) + 15) / 16;
        const double* arow = as + (wm * 16 + gr) * T::LDA + tq;
        const double* bcol = bb + tq * T::LDB + wn * 16 + gr;
        for (int kk = 0; kk < ksteps; ++kk) {
          double af[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            af[i] = arow[(i & 1) * 8 * T::LDA + 16 * kk + 4 * (i >> 1)];
#pragma unroll
          for (int q = 0; q < kG; ++q) {
            if (!lv[q]) continue;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              double bf[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                bf[i] = bcol[(q * T::KC + 16 * kk + 4 * i) * T::LDB + 8 * j];
              dmma(p[q][j], af, bf);
            }
          }
        }
        buf ^= 1;
      }
      // epilogue: the term of each split in order, dequant, shift-and-add
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        if (s0 + q >= g.S) break;
        const int c0 = (s0 + q) * BN + wn * 16 + 2 * tq;
        switch (mode) {
          case kFRound:
            add_terms<kFRound>(p[q], spv, rcp, dq, c0, range, acc);
            break;
          case kFPlain:
            add_terms<kFPlain>(p[q], spv, rcp, dq, c0, range, acc);
            break;
          case kFSign:
            add_terms<kFSign>(p[q], spv, rcp, dq, c0, range, acc);
            break;
          case kFRecip:
            add_terms<kFRecip>(p[q], spv, rcp, dq, c0, range, acc);
            break;
          default:
            add_terms<kFDivide>(p[q], spv, rcp, dq, c0, range, acc);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + wm * 16 + 8 * i + gr;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + wn * 16 + 8 * j + 2 * tq + e;
        if (n < g.N) out[m * g.N + n] = acc[i][j][e];
      }
  }
}

struct FOps {
  const uint8_t* a;
  const float* digits;
  const uint8_t* occ;
  const float* s_p;   // nullptr ADC-free
  const float* deq;
  float* out;
  void* work;         // the float64 digits
  long long work_bytes;
};

// The column tile: 16 where it holds N, so that a 16-wide layer does not
// idle half a wide tile, else 32 (64 columns were slower on H100: their
// two digit buffers of three splits leave room for one-k-step chunks
// only, or for one block per SM).
int float_column_tile(int n) { return n <= 16 ? 16 : 32; }

long long float_workspace(const Geo& g) {
  return 8LL * g.S * g.kt * digit_kpad(g) *
         round_up(g.N, float_column_tile(g.N));
}

template <int BN, bool kUnsignedA, bool kImplicit>
cudaError_t launch(const FOps& o, Geo g, cudaStream_t stream) {
  using T = FTile<BN>;
  // window mode where the pixels are 16-byte aligned and a row block's
  // input window is at most kWindowMax bytes (every ResNet-20 conv but the
  // 3-channel stem); else the codes are read from device memory
  g.window_cap = 0;
  if (kImplicit && g.C % 16 == 0 && (uintptr_t)o.a % 16 == 0 &&
      window_bytes(g, T::BM) <= kWindowMax)
    g.window_cap = (int)round_up(window_bytes(g, T::BM), 16);
  const long long smem = flayout<BN, kImplicit>(g).total;
  const long long nblk_m = (g.M + T::BM - 1) / T::BM;
  const int npad = (int)round_up(g.N, BN);
  if (smem > kMaxSmem || nblk_m > 0x7FFFFFFFLL ||
      float_workspace(g) > o.work_bytes)
    return cudaErrorInvalidValue;
  double* bd = static_cast<double*>(o.work);
  const long long words = (long long)g.S * g.kt * digit_kpad(g) * npad;
  float_digits_kernel<<<(unsigned)((words + 255) / 256), 256, 0, stream>>>(
      o.digits, bd, g, npad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto kern = cim_float_kernel<BN, kUnsignedA, kImplicit>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)nblk_m, (unsigned)((g.N + BN - 1) / BN));
  kern<<<grid, kFThreads, (size_t)smem, stream>>>(o.a, bd, o.occ, o.s_p,
                                                  o.deq, o.out, g, npad);
  return cudaGetLastError();
}

bool float_geo_ok(const Geo& g) {
  return g.M > 0 && g.M <= 0x7FFFFFFFLL && g.kt > 0 && g.rows > 0 &&
         g.S > 0 && g.N > 0 && g.seg > 0 && g.seg <= 0xFFFF && g.taps > 0 &&
         g.taps < 0x8000 && (g.N + 15) / 16 <= 65535 &&
         !(g.adc && g.psum_quant && (g.psum_bits < 1 || g.psum_bits > 24));
}

template <bool kImplicit>
int dispatch(const FOps& o, const Geo& g, int a_unsigned, void* stream) {
  if (!float_geo_ok(g)) return (int)cudaErrorInvalidValue;
  auto* st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (float_column_tile(g.N) == 16)
    e = a_unsigned ? launch<16, true, kImplicit>(o, g, st)
                   : launch<16, false, kImplicit>(o, g, st);
  else
    e = a_unsigned ? launch<32, true, kImplicit>(o, g, st)
                   : launch<32, false, kImplicit>(o, g, st);
  return (int)e;
}

Geo float_matmul_geo(long long m, int kt, int rows, int S, int n, int adc,
                     int psum_bits, int psum_quant) {
  Geo g{};
  g.M = m; g.kt = kt; g.rows = rows; g.S = S; g.N = n;
  g.taps = 1; g.seg = rows; g.C = kt * rows; g.kh = 1; g.kw = 1;
  g.stride = 1; g.experts = 1; g.tc = kt; g.nsplit = 1;
  g.adc = adc; g.psum_bits = psum_bits; g.psum_quant = psum_quant;
  return g;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code: 0 on a successful launch. `occ` may be
// null. Digits float32; s_p, deq (S, kt, n) float32. `work`: a device
// buffer of `work_bytes` >= the matching *_workspace(...) bytes, where a
// small pass writes the digits as float64 before the kernel runs (both on
// `stream`); it holds nothing the next launch reads.

// Workspace bytes of the matmul (taps 1, seg rows) or of the conv (kh*kw,
// cpa) at kt tiles, S splits, n columns.
long long cim_float_workspace(int kt, int S, int n, int taps, int seg) {
  if (kt <= 0 || S <= 0 || n <= 0 || taps <= 0 || seg <= 0) return 0;
  Geo g{};
  g.kt = kt; g.S = S; g.N = n; g.rows = taps * seg;
  return float_workspace(g);
}

// Codes (m, kt, rows) int8 (a_unsigned = 0) or uint8; digits (S, kt, rows,
// n); out (m, n).
int cim_matmul_launch(const void* a, const void* digits, const void* occ,
                      const void* s_p, const void* deq, void* out, void* work,
                      long long work_bytes, long long m, int kt, int rows,
                      int S, int n, int a_unsigned, int psum_bits,
                      int psum_quant, void* stream) {
  const FOps o{static_cast<const uint8_t*>(a),
               static_cast<const float*>(digits),
               static_cast<const uint8_t*>(occ),
               static_cast<const float*>(s_p), static_cast<const float*>(deq),
               static_cast<float*>(out), work, work_bytes};
  return dispatch<false>(
      o, float_matmul_geo(m, kt, rows, S, n, 1, psum_bits, psum_quant),
      a_unsigned, stream);
}

// The ADC-free matmul: no s_p operand, no psum_bits.
int cim_matmul_adc_free_launch(const void* a, const void* digits,
                               const void* occ, const void* deq, void* out,
                               void* work, long long work_bytes, long long m,
                               int kt, int rows, int S, int n, int a_unsigned,
                               void* stream) {
  const FOps o{static_cast<const uint8_t*>(a),
               static_cast<const float*>(digits),
               static_cast<const uint8_t*>(occ), nullptr,
               static_cast<const float*>(deq), static_cast<float*>(out), work,
               work_bytes};
  return dispatch<false>(o, float_matmul_geo(m, kt, rows, S, n, 0, 2, 0),
                         a_unsigned, stream);
}

// The conv as an implicit GEMM, with the ADC (adc = 1: s_p, psum_bits,
// psum_quant) or ADC-free (adc = 0, s_p null). Codes (batch, h, w, c)
// NHWC; digits (S, kt, kh*kw*cpa, n); out (batch, ho, wo, n). The pads
// before (ph, pw) and ho, wo come from the caller (XLA's SAME/VALID
// rule).
int cim_conv_float_implicit_launch(const void* a, const void* digits,
                                   const void* occ, const void* s_p,
                                   const void* deq, void* out, void* work,
                                   long long work_bytes, int batch, int h,
                                   int w, int c, int kh, int kw, int stride,
                                   int ph, int pw, int ho, int wo, int cpa,
                                   int kt, int S, int n, int a_unsigned,
                                   int adc, int psum_bits, int psum_quant,
                                   void* stream) {
  Geo g;
  if (!conv_geo(g, batch, h, w, c, kh, kw, stride, ph, pw, ho, wo, cpa, kt, S,
                n, 0, adc, psum_bits, psum_quant) ||
      (adc && s_p == nullptr))
    return (int)cudaErrorInvalidValue;
  const FOps o{static_cast<const uint8_t*>(a),
               static_cast<const float*>(digits),
               static_cast<const uint8_t*>(occ),
               static_cast<const float*>(s_p), static_cast<const float*>(deq),
               static_cast<float*>(out), work, work_bytes};
  return dispatch<true>(o, g, a_unsigned, stream);
}

const char* cim_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
