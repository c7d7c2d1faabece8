// Fused CIM matmul with per-column partial-sum (ADC) quantization for
// Hopper (sm_90a) on the int8 tensor cores (the core, its numerics and its
// design: cim_mma.cuh). Plain C interface, loaded with ctypes by
// repro_torch/kernels/_build.py.
//
// Replaces, for integer digit planes (int8, or int4 nibble pairs):
//   repro/kernels/cim_matmul.py::cim_matmul_pallas (:160): its dense body
//     `_kernel` (:80), the occupancy-skip body `_kernel_sparse` (:101) and
//     the nibble decode `decode_digit_block` (:59; here the relayout decodes
//     the nibbles once per plane tensor); entry point
//     cim_matmul_mma_launch;
//   repro/kernels/cim_conv.py::cim_conv_pallas (:60), which takes
//     stretched-kernel patches outside its Pallas kernel and runs the ADC
//     matmul on them with M = B*H'*W'; here the same kernel gathers the
//     patch rows itself from the NHWC codes (implicit GEMM, the ADC-free
//     conv's loader: window mode or the staged path, cim_mma.cuh), and no
//     patch tensor exists; entry point cim_conv_mma_implicit_launch, its
//     relaid planes in K5's layout (an int8 pack is relaid once for both);
//   repro/kernels/cim_matmul.py::cim_matmul_experts_pallas (:269), body
//     `_experts_kernel` (:237): the same kernel over every expert of an MoE
//     bank in one launch, the expert on blockIdx.z, the bank relaid once as
//     one tensor, and the empty capacity slots skipped (`counts`); entry
//     point cim_matmul_experts_mma_launch.
// Float32 planes (cell variation) run on the FP64 tensor cores
// (cim_matmul.cu).
//
//   out[m,n] = sum_t sum_s deq[s,t,n] * ADC(p[m,s,t,n]),
//   p[m,s,t,n] = sum_r a[m,t,r] * d[s,t,r,n]
//
// What bounds it on this card, and the launch shapes. The MoE transformer's
// linears read 8-46 MB of planes for 8 (decode) to 512 (prefill) rows, and
// an expert bank 369 MB (int8) for 48-61 capacity rows an expert: bound by
// the plane bytes. So, beside the core's resident or double-buffered digit
// tiles:
//   - at M <= 16 (decode) a row block is one warp of 16 rows, and the
//     columns go 16 to a block, so a 2048-column linear has 128 blocks;
//   - where even so a launch has fewer than two blocks per SM, the tile
//     loop is split over blockIdx.z (chunks whose digit tiles stay
//     resident), each block writes its per-(t, s) terms, and
//     cim_ordered_sum_kernel adds them in the kernel's own order;
//   - a bank's experts run on blockIdx.z, each expert's filled slots
//     (`counts`, a prefix of its capacity buffer) only: at decode 48
//     token-expert pairs fill about 35 of 64 experts, and the others read
//     no plane.
// ResNet-20's convs (rows 126, M up to 262,144) are bound by the codes
// read once and the float32 output written once: the conv reads its input
// window, not a patch tensor nine times the codes.

#include "cim_mma.cuh"

namespace {

// out[i] = sum over q of terms[q, i], in q order from 0.0 (q = t * S + s:
// t outer, s inner): the kernel's shift-and-add, after a split tile loop.
__global__ void cim_ordered_sum_kernel(const float* __restrict__ terms,
                                       float* __restrict__ out, long long mn,
                                       int q) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = 0.f;
  for (int k = 0; k < q; ++k) acc = __fadd_rn(acc, terms[k * mn + i]);
  out[i] = acc;
}

// The column tile: 16 at M <= 16 (one warp of rows: narrow tiles give the
// launch blocks); else all of N up to 64, but 32 where 64-column blocks
// would put fewer than two blocks on each SM.
int column_tile(const Geo& g) {
  if (g.M <= 16 || g.N <= 16) return 16;
  if (g.N <= 32) return 32;
  return (g.M + 127) / 128 * ((g.N + 63) / 64) * g.experts >=
                 2LL * sm_count()
             ? 64 : 32;
}

// The split of the tile loop (the single-matrix entry at M <= 16 only):
// chunks of tc tiles on blockIdx.z, so that the launch has about two
// blocks per SM, and no chunk's digit tiles take more than about 97 KB
// (the dense layer's down projection, kt 88, splits 6 ways, not 3). Sets
// g.tc and g.nsplit.
void split_plan(Geo& g, int bn) {
  g.tc = g.kt;
  g.nsplit = 1;
  const long long blocks = (g.N + bn - 1) / bn;
  const long long want = 2LL * sm_count();
  if (g.M > 16 || g.kt < 2 || blocks >= want) return;
  const long long ns = (want + blocks - 1) / blocks;
  int tc = (int)((g.kt + (ns < g.kt ? ns : g.kt) - 1) /
                 (ns < g.kt ? ns : g.kt));
  const long long tile = (long long)g.S * bn * (g.kq + 16);
  while (tc > 1 && tc * tile > kTwoBlocks - 16 * 1024) tc = (tc + 1) / 2;
  g.nsplit = (g.kt + tc - 1) / tc;
  g.tc = g.nsplit > 1 ? tc : g.kt;
}

// The matmul's row blocks: one warp per 16 rows up to 64 rows; above,
// 128-row blocks unless they would leave half the SMs idle. A block that
// walks several row blocks keeps its digit tiles resident where they fit
// (on any SM when the launch has no more blocks than SMs): they are read
// once. A block of one row block double-buffers them (resident tiles
// would all arrive before its first MAC); else one buffer. The conv's:
// streaming_buffers (cim_mma.cuh), as the ADC-free conv's.
template <int BN, bool kUnsignedA, bool kImplicit, bool kDirect,
          bool kPacked>
cudaError_t launch(const Ops& o, Geo g, cudaStream_t stream) {
  long long smem;
  if (kImplicit) {
    smem = streaming_buffers<BN, kImplicit, kDirect>(g);
  } else {
    const long long nblk_n = (g.N + BN - 1) / BN;
    const long long nz = g.nsplit > 1 ? g.nsplit : g.experts;
    const int bm0 = g.M <= 64 ? (int)round_up(g.M, 16)
                    : ((g.M + 127) / 128) * nblk_n * nz * 2 >= sm_count()
                        ? 128 : 64;
    const int bm1 = bm0 < 64 ? bm0 : 64;
    const long long blocks = (g.M + bm0 - 1) / bm0 * nblk_n * nz;
    const long long res = blocks <= sm_count() ? kMaxSmem
                          : bm0 <= 32          ? kTwoBlocks
                                               : kThreeBlocks;
    const bool one = g.M <= bm0;           // one row block per block
    const long long cand[7][3] = {
        {bm0, one ? 2 : 0, one ? kTwoBlocks : res},
        {bm0, 2, kTwoBlocks}, {bm0, 1, kTwoBlocks}, {bm0, 0, res},
        {bm1, 0, kThreeBlocks}, {bm1, 2, kTwoBlocks}, {bm1, 1, kTwoBlocks}};
    smem = choose_buffers<BN, kImplicit, kDirect>(g, cand, 7);
  }
  if (smem < 0) return cudaErrorInvalidValue;
  cudaError_t e = run<BN, kUnsignedA, kImplicit, kDirect, true, kPacked>(
      o, g, smem, stream);
  if (e != cudaSuccess || g.nsplit <= 1) return e;
  const long long mn = g.M * g.N;
  cim_ordered_sum_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      o.terms, o.out, mn, g.kt * g.S);
  return cudaGetLastError();
}

Geo matmul_geo(long long m, int kt, int rows, int S, int n, int nibble,
               int psum_bits, int psum_quant, int experts) {
  Geo g{};
  g.M = m; g.kt = kt; g.rows = rows; g.S = S; g.N = n;
  g.nibble = nibble; g.groups = 1;
  g.taps = 1; g.seg = rows; g.C = kt * rows; g.kh = 1; g.kw = 1;
  g.stride = 1; g.adc = 1; g.psum_bits = psum_bits;
  g.psum_quant = psum_quant; g.experts = experts;
  g.tc = kt; g.nsplit = 1;
  return g;
}

template <bool kImplicit>
int dispatch(const Ops& o, Geo g, int a_unsigned, bool split, void* stream) {
  if (!prepare<kImplicit>(g, o.a)) return (int)cudaErrorInvalidValue;
  const int bn = column_tile(g);
  if (split) split_plan(g, bn);
  auto* st = static_cast<cudaStream_t>(stream);
#define CIM_LAUNCH(BN, U)                                              \
  (g.direct   ? launch<BN, U, kImplicit, true, false>(o, g, st)      \
   : g.packed ? launch<BN, U, kImplicit, false, kImplicit>(o, g, st) \
              : launch<BN, U, kImplicit, false, false>(o, g, st))
  cudaError_t e;
  if (bn == 16)
    e = a_unsigned ? CIM_LAUNCH(16, true) : CIM_LAUNCH(16, false);
  else if (bn == 32)
    e = a_unsigned ? CIM_LAUNCH(32, true) : CIM_LAUNCH(32, false);
  else
    e = a_unsigned ? CIM_LAUNCH(64, true) : CIM_LAUNCH(64, false);
#undef CIM_LAUNCH
  return (int)e;
}

}  // namespace

extern "C" {

// Each launch returns a cudaError_t code: 0 on a successful launch. `occ`
// may be null. `rows` is the logical row count; nibble planes (nibble = 1)
// store rows / 2 rows, half-split (the conv's: in kh*kw blocks).
// `work` is a device buffer of `work_bytes` >=
// cim_matmul_mma_workspace(...) bytes for the relaid digit operand, and
// `*held` the id of the layout it holds (0: none): a launch relays the
// planes into `work` only if its layout id differs, then stores its id
// there (as cim_adc_free_mma.cu's launches, with the same layout ids: the
// two libraries can share a kept copy).
// Every kernel runs on `stream`.

// Workspace bytes for `experts` matrices of kt tiles, S splits, n
// columns, taps segments of seg codes (the matmul: taps 1, seg rows; the
// conv: kh*kw, cpa; as cim_adc_free_mma_workspace).
long long cim_matmul_mma_workspace(int kt, int S, int n, int taps, int seg,
                                   int experts) {
  if (kt <= 0 || S <= 0 || n <= 0 || taps <= 0 || seg <= 0 || experts <= 0)
    return 0;
  return experts * workspace_bytes(kt, S, n, taps, seg);
}

// Bytes of the terms workspace cim_matmul_mma_launch needs at these
// shapes: 4 * kt * S * m * n where it splits the tile loop, else 0.
long long cim_matmul_mma_terms_bytes(long long m, int kt, int rows, int S,
                                     int n) {
  Geo g = matmul_geo(m, kt, rows, S, n, 0, 4, 1, 1);
  if (!prepare<false>(g, reinterpret_cast<const void*>(16))) return 0;
  split_plan(g, column_tile(g));
  return g.nsplit > 1 ? 4LL * kt * S * m * n : 0;
}

// K1/K2: codes (m, kt, rows) int8 (a_unsigned = 0) or uint8; s_p, deq
// (S, kt, n) float32; out (m, n). `terms`: a float32 buffer of
// cim_matmul_mma_terms_bytes(...) bytes, or null where that is 0.
int cim_matmul_mma_launch(const void* a, const void* digits, const void* occ,
                          const void* s_p, const void* deq, void* out,
                          void* work, long long work_bytes, long long* held,
                          void* terms, long long terms_bytes, long long m,
                          int kt, int rows, int S, int n, int a_unsigned,
                          int nibble, int psum_bits,
                          int psum_quant, void* stream) {
  const Ops o{static_cast<const uint8_t*>(a),
              static_cast<const uint8_t*>(digits),
              static_cast<const uint8_t*>(occ),
              static_cast<const float*>(s_p), static_cast<const float*>(deq),
              static_cast<float*>(out), nullptr,
              static_cast<uint8_t*>(work), work_bytes, held,
              static_cast<float*>(terms), terms_bytes};
  return dispatch<false>(o, matmul_geo(m, kt, rows, S, n, nibble,
                                       psum_bits, psum_quant, 1),
                         a_unsigned, true, stream);
}

// K6: the ADC matmul over an MoE bank, each operand stacked on a leading
// expert axis (codes (E, C, kt, rows), digits (E, S, kt, rows or rows/2,
// N), occ/s_p/deq (E, S, kt, N), out (E, C, N)); `m` is C. `counts`: null,
// or (E,) int32 on the device, expert e's filled slots (rows 0 ..
// counts[e] - 1 of its buffer); every row at or past them is computed as
// an all-zero code row.
int cim_matmul_experts_mma_launch(const void* a, const void* digits,
                                  const void* occ, const void* s_p,
                                  const void* deq, void* out,
                                  const void* counts, void* work,
                                  long long work_bytes, long long* held,
                                  long long m, int kt, int rows, int S, int n,
                                  int a_unsigned, int nibble, int psum_bits,
                                  int psum_quant, int experts, void* stream) {
  const Ops o{static_cast<const uint8_t*>(a),
              static_cast<const uint8_t*>(digits),
              static_cast<const uint8_t*>(occ),
              static_cast<const float*>(s_p), static_cast<const float*>(deq),
              static_cast<float*>(out), static_cast<const int*>(counts),
              static_cast<uint8_t*>(work), work_bytes, held, nullptr, 0};
  return dispatch<false>(o, matmul_geo(m, kt, rows, S, n, nibble,
                                       psum_bits, psum_quant, experts),
                         a_unsigned, false, stream);
}

// K3: the ADC conv as an implicit GEMM. Codes (batch, h, w, c) NHWC int8
// (a_unsigned = 0) or uint8; planes (S, kt, kh*kw*cpa or half, n) with
// nibble groups kh*kw; occ, s_p, deq (S, kt, n); out (batch, ho, wo, n).
// The pads before (ph, pw) and ho, wo come from the caller (XLA's
// SAME/VALID rule). `work`: as K1, sized by cim_matmul_mma_workspace(kt,
// S, n, kh*kw, cpa, 1); the layout is K5's.
int cim_conv_mma_implicit_launch(const void* a, const void* digits,
                                 const void* occ, const void* s_p,
                                 const void* deq, void* out, void* work,
                                 long long work_bytes, long long* held,
                                 int batch, int h, int w, int c, int kh,
                                 int kw, int stride, int ph, int pw, int ho,
                                 int wo, int cpa, int kt, int S, int n,
                                 int a_unsigned, int nibble, int psum_bits,
                                 int psum_quant, void* stream) {
  Geo g;
  if (!conv_geo(g, batch, h, w, c, kh, kw, stride, ph, pw, ho, wo, cpa, kt,
                S, n, nibble, 1, psum_bits, psum_quant))
    return (int)cudaErrorInvalidValue;
  const Ops o{static_cast<const uint8_t*>(a),
              static_cast<const uint8_t*>(digits),
              static_cast<const uint8_t*>(occ),
              static_cast<const float*>(s_p), static_cast<const float*>(deq),
              static_cast<float*>(out), nullptr,
              static_cast<uint8_t*>(work), work_bytes, held, nullptr, 0};
  return dispatch<true>(o, g, a_unsigned, false, stream);
}

// Whether K3 (and K5) at these sizes runs in window mode (1: its row
// blocks copy their input windows; 0: the staged path of the same kernel,
// e.g. a window over kWindowMax bytes; -1: sizes out of range), for codes
// at a 16-byte aligned address.
int cim_conv_mma_window_mode(int batch, int h, int w, int c, int kh, int kw,
                             int stride, int ph, int pw, int ho, int wo,
                             int cpa, int kt, int S, int n) {
  Geo g;
  if (!conv_geo(g, batch, h, w, c, kh, kw, stride, ph, pw, ho, wo, cpa, kt,
                S, n, 0, 1, 4, 1) ||
      !prepare<true>(g, reinterpret_cast<const void*>(16)))
    return -1;
  return g.direct;
}

const char* cim_matmul_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
