// ADC-free CIM matmul and implicit-GEMM conv for Hopper (sm_90a) on the
// int8 tensor cores (the core, its numerics and its design: cim_mma.cuh).
// Plain C interface, loaded with ctypes by repro_torch/kernels/_build.py.
//
// Replaces, for integer digit planes (int8, or int4 nibble pairs):
//   repro/kernels/cim_adc_free.py::cim_matmul_adc_free_pallas (:98), bodies
//     `_kernel` (:46) and `_kernel_sparse` (:66); entry point
//     cim_matmul_adc_free_mma_launch;
//   repro/kernels/cim_adc_free.py::cim_conv_adc_free_pallas (:180), which
//     takes stretched-kernel patches outside its Pallas kernel and lowers
//     them onto the matmul; here the kernel gathers the patch rows itself
//     from the NHWC codes (implicit GEMM), and no patch tensor exists;
//     entry point cim_conv_adc_free_implicit_launch.
// Float32 planes (cell variation) run on the FP64 tensor cores
// (cim_matmul.cu).
//
//   out[m,n] = sum_t sum_s deq[s,t,n] * rint(p[m,s,t,n]),
//   p[m,s,t,n] = sum_r a[m,t,r] * d[s,t,r,n]
//
// Measured on H100 while this design took shape: forming tiles byte by
// byte in shared memory cost more than the MACs; then the number of
// 16-byte requests through L1 (a granule per row, tap and tile: 18 per
// output pixel of a first-stage conv) set the pace, and after that the MMA
// chains. Hence the conv's input window, the persistent blocks and the
// resident digit tiles of the core.

#include "cim_mma.cuh"

namespace {

// The column tile: all of N up to 64, so a block reads each code once;
// but 32 where 64-column blocks would put fewer than two blocks of 128
// rows on each SM (the extra blocks keep more warps in flight).
int column_tile(int n, long long m) {
  if (n <= 16) return 16;
  if (n <= 32) return 32;
  return (m + 127) / 128 * ((n + 63) / 64) >= 2LL * sm_count() ? 64 : 32;
}

// Row blocks and digit buffers: streaming_buffers (cim_mma.cuh).
template <int BN, bool kUnsignedA, bool kImplicit, bool kDirect,
          bool kPacked>
cudaError_t launch(const Ops& o, Geo g, cudaStream_t stream) {
  const long long smem = streaming_buffers<BN, kImplicit, kDirect>(g);
  if (smem < 0) return cudaErrorInvalidValue;
  return run<BN, kUnsignedA, kImplicit, kDirect, false, kPacked>(o, g, smem,
                                                                 stream);
}

template <bool kImplicit>
int dispatch(const Ops& o, Geo g, int a_unsigned, void* stream) {
  if (!prepare<kImplicit>(g, o.a)) return (int)cudaErrorInvalidValue;
  auto* st = static_cast<cudaStream_t>(stream);
#define CIM_LAUNCH(BN, U)                                              \
  (g.direct   ? launch<BN, U, kImplicit, true, false>(o, g, st)      \
   : g.packed ? launch<BN, U, kImplicit, false, kImplicit>(o, g, st) \
              : launch<BN, U, kImplicit, false, false>(o, g, st))
  const int bn = column_tile(g.N, g.M);
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

Ops ops(const void* a, const void* digits, const void* occ, const void* deq,
        void* out, void* work, long long work_bytes, long long* held) {
  return Ops{static_cast<const uint8_t*>(a),
             static_cast<const uint8_t*>(digits),
             static_cast<const uint8_t*>(occ), nullptr,
             static_cast<const float*>(deq), static_cast<float*>(out),
             nullptr, static_cast<uint8_t*>(work), work_bytes, held,
             nullptr, 0};
}

}  // namespace

extern "C" {

// Each launch returns a cudaError_t code: 0 on a successful launch. `occ`
// may be null. `rows` is the logical row count; nibble planes (nibble = 1)
// store rows / 2 rows, half-split (the conv's: in kh*kw blocks).
// `work` is a device buffer of `work_bytes` >=
// cim_adc_free_mma_workspace(...) bytes for the relaid digit operand, and
// `*held` the id of the layout it holds (0: none). A launch relays the
// planes into `work` (a small kernel, first on the stream) only if its
// layout id differs from `*held`, then stores its id there: a caller that
// keeps `work` and `*held` beside constant planes relays them once. Both
// kernels run on `stream`.

// Workspace bytes for kt tiles, S splits, n columns, taps segments of seg
// codes (the matmul: taps 1, seg rows; the conv: kh*kw, cpa).
long long cim_adc_free_mma_workspace(int kt, int S, int n, int taps,
                                     int seg) {
  if (kt <= 0 || S <= 0 || n <= 0 || taps <= 0 || seg <= 0) return 0;
  return workspace_bytes(kt, S, n, taps, seg);
}

// K4: codes (m, kt, rows) int8 (a_unsigned = 0) or uint8; out (m, n).
int cim_matmul_adc_free_mma_launch(const void* a, const void* digits,
                                   const void* occ, const void* deq, void* out,
                                   void* work, long long work_bytes,
                                   long long* held, long long m, int kt,
                                   int rows, int S, int n, int a_unsigned,
                                   int nibble, void* stream) {
  Geo g{};
  g.M = m; g.kt = kt; g.rows = rows; g.S = S; g.N = n;
  g.nibble = nibble; g.groups = 1;
  g.taps = 1; g.seg = rows; g.C = kt * rows; g.kh = 1; g.kw = 1;
  g.stride = 1; g.experts = 1;
  return dispatch<false>(ops(a, digits, occ, deq, out, work, work_bytes, held),
                         g, a_unsigned, stream);
}

// K5: codes (batch, h, w, c) NHWC; planes (S, kt, kh*kw*cpa or half, n)
// with nibble groups kh*kw; out (batch, ho, wo, n). The pads before
// (ph, pw) and ho, wo come from the caller (XLA's SAME/VALID rule).
int cim_conv_adc_free_implicit_launch(const void* a, const void* digits,
                                      const void* occ, const void* deq,
                                      void* out, void* work,
                                      long long work_bytes, long long* held,
                                      int batch, int h, int w, int c, int kh,
                                      int kw, int stride, int ph, int pw,
                                      int ho, int wo, int cpa, int kt, int S,
                                      int n, int a_unsigned, int nibble,
                                      void* stream) {
  Geo g;
  if (!conv_geo(g, batch, h, w, c, kh, kw, stride, ph, pw, ho, wo, cpa, kt,
                S, n, nibble, 0, 0, 0))
    return (int)cudaErrorInvalidValue;
  return dispatch<true>(ops(a, digits, occ, deq, out, work, work_bytes, held),
                        g, a_unsigned, stream);
}

const char* cim_adc_free_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
