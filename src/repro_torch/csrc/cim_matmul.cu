// Fused CIM matmul for Hopper (sm_90a) on float32 digit planes (cell
// variation), with per-column partial-sum (ADC) quantization or ADC-free.
// Plain C interface, loaded with ctypes by repro_torch/kernels/_build.py.
//
// Replaces, on planes that carry cell variation (float32 digits):
//   repro/kernels/cim_matmul.py::cim_matmul_pallas (:160) on float32
//     digits (:177-185): its dense body `_kernel` and occupancy-skip body
//     `_kernel_sparse`; entry point cim_matmul_launch;
//   repro/kernels/cim_adc_free.py::cim_matmul_adc_free_pallas (:98) on
//     float32 planes: the same tile loop with the ADC-free epilogue and no
//     s_p operand; entry point cim_matmul_adc_free_launch.
// The conv paths (repro/kernels/cim_conv.py::cim_conv_pallas, :60, and
// repro/kernels/cim_adc_free.py::cim_conv_adc_free_pallas, :180) lower
// their float-plane patches onto these with M = B*H'*W'. Integer planes
// (int8, or int4 nibbles) run on the int8 tensor cores: the ADC kernels
// K1/K2 and the MoE experts kernel K6 in cim_matmul_mma.cu (which also
// skips a bank's empty capacity slots), the ADC-free ones in
// cim_adc_free_mma.cu; this file serves no integer plane.
//
//   p[m,s,t,n] = sum_r a[m,t,r] * d[s,t,r,n]
//   ADC:       out[m,n] = sum_t sum_s deq[s,t,n] * ADC(round(p))
//              ADC(p) = sign(p) * s_p                     psum_bits == 1
//                     = clip(rint(p / s_p), -2^(b-1), 2^(b-1)-1) * s_p
//              s_p clamped to >= 1e-9; psum_quant == 0 skips round and ADC.
//   ADC-free:  out[m,n] = sum_t sum_s deq[s,t,n] * round(p)
//
// Numerics. Each product code x digit is exact in float64 and, for the
// code and digit ranges of a CIM array, so is their float64 sum; it is
// rounded once to float32 (__double2float_rn) -- what the plain version's
// float64 einsum does -- then rounded to the integer grid with rintf. The
// ADC uses an IEEE divide (__fdiv_rn) and rintf (half to even, like
// torch.round / jnp.round); the accumulate uses one rounded multiply and
// one rounded add (__fmul_rn, __fadd_rn: no FMA contraction) in the order
// t outer, s inner -- the order of repro_torch.kernels.ref.shift_add, so
// the kernel and its plain version agree bit for bit. (The TPU's ADC-free
// grid runs s outer, t inner; within the port one order keeps adc_free
// equal to emulate with psum_quant off, and keeps the patch tile in shared
// memory across all S splits.) Build without --use_fast_math.
//
// Sparse planes. With an occupancy map, a block skips the load and the MACs
// of a (t, s) plane whose columns in the block are all unoccupied; the
// partial sum is then exactly 0 and goes through the same epilogue, so a
// dead plane adds ADC(0) * deq (+s_p * deq under the sign ADC, +0 else;
// +0 ADC-free) and the sparse path is bit-exact with the dense one. Cell
// variation multiplies, so dead cells stay dead and the clean map holds.
//
// Bound at the main path's shapes (ResNet-20, batch 256, under the
// variation sweep): the MACs run in float64 (~3.2 G FMAs for a first-stage
// conv), which makes the kernel bound by operations (FP64). This version
// keeps one patch tile per array tile in shared memory and reuses it
// across all S splits (the patches are read once per t, not once per
// (t, s)), picks the N tile from {16, 32, 64} so a 16-wide layer does not
// idle 7/8 of a 128-wide tile, and writes the output once. Its conv
// callers gather the patches in plain torch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 4;  // outputs per thread along m
constexpr int kTN = 4;  // outputs per thread along n
constexpr size_t kMaxSmem = 232448;  // 227 KB per block on H100

// 32-bit words per shared-memory row of a byte tile; odd, so that threads
// reading different rows hit different banks.
__host__ __device__ inline int stride_words(int rows) {
  return ((rows + 3) / 4) | 1;
}

// floats per shared-memory row of a float plane: whole float4s, an odd
// count of them, so the float4 reads of different rows spread over banks.
__host__ __device__ inline int stride_floats(int rows) {
  return 4 * (((rows + 3) / 4) | 1);
}

// byte k of a word of four activation codes, as an integer
template <bool kUnsignedA>
__device__ __forceinline__ int code(int word, int k) {
  return kUnsignedA ? (int)(((unsigned)word >> (8 * k)) & 0xFFu)
                    : (int)(signed char)(word >> (8 * k));
}

__device__ __forceinline__ float adc(float p, float sp, int psum_bits,
                                     int psum_quant) {
  if (!psum_quant) return p;
  p = rintf(p);  // the integer snap of a float-digit partial sum
  sp = fmaxf(sp, 1e-9f);
  if (psum_bits == 1) return __fmul_rn(p >= 0.f ? 1.f : -1.f, sp);
  const float qn = -(float)(1 << (psum_bits - 1));
  const float qp = (float)((1 << (psum_bits - 1)) - 1);
  const float q = fminf(fmaxf(rintf(__fdiv_rn(p, sp)), qn), qp);
  return __fmul_rn(q, sp);
}

// One block computes a BM x BN output tile; 256 threads, 4 x 4 outputs
// each. Shared memory: the block's patch rows of array tile t (BM x rows
// bytes) and the float32 digit plane (t, s) transposed (BN x rows floats).
template <int BN, bool kUnsignedA, bool kAdcFree>
__global__ void __launch_bounds__(kThreads) cim_matmul_kernel(
    const int8_t* __restrict__ a,        // (M, kt, rows) int8 or uint8 bytes
    const float* __restrict__ digits,    // (S, kt, rows, N) float32
    const uint8_t* __restrict__ occ,     // (S, kt, N) or nullptr
    const float* __restrict__ s_p,       // (S, kt, N); unused ADC-free
    const float* __restrict__ deq,       // (S, kt, N)
    float* __restrict__ out,             // (M, N)
    long long M, int kt, int rows, int S, int N, int psum_bits,
    int psum_quant) {
  constexpr int TX = BN / kTN;        // threads along n
  constexpr int TY = kThreads / TX;   // threads along m
  constexpr int BM = TY * kTM;
  extern __shared__ int smem[];
  const int sw = stride_words(rows);
  const int sf = stride_floats(rows);
  const int rb = sw * 4;              // bytes per shared row
  const int rw = (rows + 3) / 4;      // words holding data
  int* a_s = smem;                    // BM rows
  int8_t* a_b = reinterpret_cast<int8_t*>(a_s);
  float* d_f = reinterpret_cast<float*>(smem + BM * sw);  // BN rows

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int warp = tid / 32, lane = tid % 32;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < kt; ++t) {
    __syncthreads();  // the previous tile's readers are done
    // patch tile: one warp per row, lanes along the row (coalesced)
    for (int mm = warp; mm < BM; mm += kThreads / 32) {
      const long long m = m0 + mm;
      const int8_t* src = a + (m * kt + t) * (long long)rows;
      for (int r = lane; r < rb; r += 32)
        a_b[mm * rb + r] = (m < M && r < rows) ? src[r] : (int8_t)0;
    }
    for (int s = 0; s < S; ++s) {
      const long long col = ((long long)s * kt + t) * N;
      // barrier; also decides, block-wide, whether the plane is live here
      const int live = occ == nullptr
          ? (__syncthreads(), 1)
          : __syncthreads_or(tid < BN && n0 + tid < N &&
                             occ[col + n0 + tid] != 0);
      double p[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) p[i][j] = 0;
      if (live) {
        const int nn = tid % BN;
        const int n = n0 + nn;
        const float* dsrc = digits + col * rows;
        for (int r = tid / BN; r < sf; r += kThreads / BN)
          d_f[nn * sf + r] = (n < N && r < rows)
              ? dsrc[(long long)r * N + n] : 0.f;
        __syncthreads();
        for (int w = 0; w < rw; ++w) {
          int av[kTM];
#pragma unroll
          for (int i = 0; i < kTM; ++i) av[i] = a_s[(ty + i * TY) * sw + w];
          float4 dv[kTN];
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            dv[j] = *reinterpret_cast<const float4*>(
                d_f + (tx + j * TX) * sf + 4 * w);
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const double c0 = code<kUnsignedA>(av[i], 0);
            const double c1 = code<kUnsignedA>(av[i], 1);
            const double c2 = code<kUnsignedA>(av[i], 2);
            const double c3 = code<kUnsignedA>(av[i], 3);
#pragma unroll
            for (int j = 0; j < kTN; ++j) {
              // exact products; the float64 sum of a tile is exact too
              double q = p[i][j];
              q = fma(c0, (double)dv[j].x, q);
              q = fma(c1, (double)dv[j].y, q);
              q = fma(c2, (double)dv[j].z, q);
              q = fma(c3, (double)dv[j].w, q);
              p[i][j] = q;
            }
          }
        }
      }
      // epilogue: (ADC or round), dequant, shift-and-add into the f32 sum
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = n0 + tx + j * TX;
        if (n >= N) continue;
        const float sp = kAdcFree ? 0.f : s_p[col + n];
        const float dq = deq[col + n];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float pf = __double2float_rn(p[i][j]);
          const float v = kAdcFree ? rintf(pf)
                                   : adc(pf, sp, psum_bits, psum_quant);
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(v, dq));
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + ty + i * TY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n < N) out[m * N + n] = acc[i][j];
    }
  }
}

struct Args {
  const void* a;
  const void* digits;
  const void* occ;
  const void* s_p;  // nullptr ADC-free
  const void* deq;
  void* out;
  long long m;
  int kt, rows, S, n, a_unsigned, psum_bits, psum_quant;
  cudaStream_t stream;
};

template <int BN, bool kUnsignedA, bool kAdcFree>
cudaError_t launch(const Args& x) {
  constexpr int BM = (kThreads / (BN / kTN)) * kTM;
  const size_t smem = ((size_t)BM * stride_words(x.rows) +
                       (size_t)BN * stride_floats(x.rows)) * 4;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = cim_matmul_kernel<BN, kUnsignedA, kAdcFree>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)((x.m + BM - 1) / BM),
                  (unsigned)((x.n + BN - 1) / BN));
  kern<<<grid, kThreads, smem, x.stream>>>(
      static_cast<const int8_t*>(x.a), static_cast<const float*>(x.digits),
      static_cast<const uint8_t*>(x.occ), static_cast<const float*>(x.s_p),
      static_cast<const float*>(x.deq), static_cast<float*>(x.out), x.m, x.kt,
      x.rows, x.S, x.n, x.psum_bits, x.psum_quant);
  return cudaGetLastError();
}

template <bool kAdcFree>
int dispatch(const Args& x) {
  if (x.m <= 0 || x.kt <= 0 || x.rows <= 0 || x.S <= 0 || x.n <= 0 ||
      (x.n + 15) / 16 > 65535 ||
      (!kAdcFree && (x.psum_bits < 1 || x.psum_bits > 24)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (x.n <= 16)
    e = x.a_unsigned ? launch<16, true, kAdcFree>(x)
                     : launch<16, false, kAdcFree>(x);
  else if (x.n <= 32)
    e = x.a_unsigned ? launch<32, true, kAdcFree>(x)
                     : launch<32, false, kAdcFree>(x);
  else
    e = x.a_unsigned ? launch<64, true, kAdcFree>(x)
                     : launch<64, false, kAdcFree>(x);
  return (int)e;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code: 0 on a successful launch. `occ` may be
// null. Codes (m, kt, rows) int8 (a_unsigned = 0) or uint8; digits (S, kt,
// rows, n) float32; s_p, deq (S, kt, n); out (m, n).
int cim_matmul_launch(const void* a, const void* digits, const void* occ,
                      const void* s_p, const void* deq, void* out,
                      long long m, int kt, int rows, int S, int n,
                      int a_unsigned, int psum_bits, int psum_quant,
                      void* stream) {
  const Args x{a, digits, occ, s_p, deq, out, m, kt, rows, S, n,
               a_unsigned, psum_bits, psum_quant,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(x);
}

// The ADC-free kernel: no s_p operand, no psum_bits.
int cim_matmul_adc_free_launch(const void* a, const void* digits,
                               const void* occ, const void* deq, void* out,
                               long long m, int kt, int rows, int S, int n,
                               int a_unsigned, void* stream) {
  const Args x{a, digits, occ, nullptr, deq, out, m, kt, rows, S, n,
               a_unsigned, 0, 0, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(x);
}

const char* cim_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
