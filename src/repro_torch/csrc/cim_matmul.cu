// Fused CIM matmul for Hopper (sm_90a), with per-column partial-sum (ADC)
// quantization or ADC-free. Plain C interface, loaded with ctypes by
// repro_torch/kernels/_build.py.
//
// Replaces, as one kernel family:
//   repro/kernels/cim_matmul.py::cim_matmul_pallas (:160): its dense body
//     `_kernel`, the occupancy-skip body `_kernel_sparse` and the nibble
//     decode `decode_digit_block`; entry point cim_matmul_launch;
//   repro/kernels/cim_adc_free.py::cim_matmul_adc_free_pallas (:98) on
//     float32 planes: the ADC-free bodies `_kernel` and `_kernel_sparse`,
//     the same tile loop with the ADC-free epilogue and no s_p operand;
//     entry point cim_matmul_adc_free_launch (integer planes run
//     cim_adc_free_mma.cu);
//   repro/kernels/cim_matmul.py::cim_matmul_experts_pallas (:269), body
//     `_experts_kernel` (:237): the ADC kernel over every expert of an MoE
//     bank in one launch, the expert on blockIdx.z; entry point
//     cim_matmul_experts_launch.
// The conv deploy paths (repro/kernels/cim_conv.py::cim_conv_pallas, and
// repro/kernels/cim_adc_free.py::cim_conv_adc_free_pallas, :180, on float32
// planes) lower onto these with M = B*H'*W' and nibble groups = kh*kw.
//
//   p[m,s,t,n] = sum_r a[m,t,r] * d[s,t,r,n]
//   ADC:       out[m,n] = sum_t sum_s deq[s,t,n] * ADC(round(p))
//              ADC(p) = sign(p) * s_p                     psum_bits == 1
//                     = clip(rint(p / s_p), -2^(b-1), 2^(b-1)-1) * s_p
//              s_p clamped to >= 1e-9; psum_quant == 0 skips round and ADC.
//   ADC-free:  out[m,n] = sum_t sum_s deq[s,t,n] * round(p)
//
// Numerics. Integer digit planes (int8, or int4 nibbles): each (t, s)
// partial sum is an exact int32 sum of int8 x int8 (or uint8 x int8)
// products (dp4a), so round() is the identity. Float32 digit planes (cell
// variation): each product code x digit is exact in float64 and, for the
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
// MoE expert banks. blockIdx.z is the expert e; each operand's base pointer
// moves by e times its per-expert size (codes M*kt*rows, digits
// S*kt*rows_stored*N, occ/s_p/deq S*kt*N, out M*N, with M the expert's
// capacity C), and the block then runs K1's loop unchanged. So each
// expert's output is bit-exact with a K1 launch on that expert's slice,
// dense, sparse and nibble alike; nibble banks and their occupancy maps are
// read in place. With one expert (gridDim.z == 1) the offsets are 0: the
// single-matrix entry points launch the same instances. At the MoE path's
// shapes (64 experts, d_model 2048, expert d_ff 1408, S = 2: 369 MB of int8
// planes per bank) the planes bound a launch by bytes, about 0.11 ms per
// bank at 3.35 TB/s. The launch runs every slot of every expert's capacity
// buffer, filled or not, as the reference's dispatch defines it; a block
// whose rows are all empty slots could exit early (later work).
//
// Nibble planes (uint8, half-split per group): packed row g*gh + w holds
// logical row g*2gh + w in its low nibble and g*2gh + gh + w in its high
// nibble; each nibble decodes as ((x ^ 8) - 8). Decoding happens while the
// tile is copied into shared memory. Float planes are never nibbles: the
// variation path unpacks them before it perturbs.
//
// Bound at the main path's shapes (ResNet-20, batch 256, 3-bit weights on
// 1-bit cells -> S = 3, 128-row arrays -> rows = 126 for 3x3 convs): the
// first stage's convs have M = 262,144, kt = 2, N = 16, so one layer moves
// ~66 MB of patches + 17 MB of output (25 us at 3.35 TB/s) against
// ~6.3 G int8 ops (3 us at 1,979 TOPS): with integer digits the kernel is
// bound by bytes, with and without the ADC. With float digits the MACs run
// in float64 (~3.2 G FMAs a layer), which makes it bound by operations.
// This first version keeps one patch tile per array tile in shared memory
// and reuses it across all S splits (the patches are read once per t, not
// once per (t, s)), picks the N tile from {16, 32, 64} so a 16-wide layer
// does not idle 7/8 of a 128-wide tile, and writes the output once. It
// runs its MACs on dp4a (float64 FMAs for float digits) rather than on the
// tensor cores, and its conv callers gather the patches in plain torch.
// The ADC-free path on integer planes has moved to cim_adc_free_mma.cu
// (int8 tensor cores; the conv gathers its patch rows inside the kernel);
// cim_matmul_adc_free_launch here serves float32 (cell-variation) planes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 4;  // outputs per thread along m
constexpr int kTN = 4;  // outputs per thread along n
constexpr size_t kMaxSmem = 232448;  // 227 KB per block on H100

// digit-plane storage, as the wrappers pass it
constexpr int kInt8 = 0;     // (S, kt, rows, N) int8
constexpr int kNibble = 1;   // (S, kt, rows / 2, N) uint8, half-split
constexpr int kFloat32 = 2;  // (S, kt, rows, N) float32

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

template <bool kUnsignedA>
__device__ __forceinline__ int dot4(int a, int d, int c) {
  int r;
  if (kUnsignedA) {
    asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(d), "r"(c));
  } else {
    asm("dp4a.s32.s32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(d), "r"(c));
  }
  return r;
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
  p = rintf(p);  // the integer snap; the identity on integer digits
  sp = fmaxf(sp, 1e-9f);
  if (psum_bits == 1) return __fmul_rn(p >= 0.f ? 1.f : -1.f, sp);
  const float qn = -(float)(1 << (psum_bits - 1));
  const float qp = (float)((1 << (psum_bits - 1)) - 1);
  const float q = fminf(fmaxf(rintf(__fdiv_rn(p, sp)), qn), qp);
  return __fmul_rn(q, sp);
}

// One block computes a BM x BN output tile; 256 threads, 4 x 4 outputs
// each. Shared memory: the block's patch rows of array tile t (BM x rows
// bytes) and the digit plane (t, s) transposed (BN x rows bytes, decoded
// from nibbles, or BN x rows floats).
template <int BN, bool kUnsignedA, int kKind, bool kAdcFree>
__global__ void __launch_bounds__(kThreads) cim_matmul_kernel(
    const int8_t* __restrict__ a,        // (M, kt, rows) int8 or uint8 bytes
    const void* __restrict__ digits,     // (S, kt, rows or rows/2, N)
    const uint8_t* __restrict__ occ,     // (S, kt, N) or nullptr
    const float* __restrict__ s_p,       // (S, kt, N); unused ADC-free
    const float* __restrict__ deq,       // (S, kt, N)
    float* __restrict__ out,             // (M, N)
    long long M, int kt, int rows, int S, int N, int groups, int psum_bits,
    int psum_quant) {
  constexpr int TX = BN / kTN;        // threads along n
  constexpr int TY = kThreads / TX;   // threads along m
  constexpr int BM = TY * kTM;
  constexpr bool kFloat = kKind == kFloat32;
  using Acc = typename std::conditional<kFloat, double, int>::type;
  extern __shared__ int smem[];
  const int sw = stride_words(rows);
  const int sf = stride_floats(rows);
  const int rb = sw * 4;              // bytes per shared row
  const int rw = (rows + 3) / 4;      // words holding data
  int* a_s = smem;                    // BM rows
  int* d_s = smem + BM * sw;          // BN rows (transposed plane)
  int8_t* a_b = reinterpret_cast<int8_t*>(a_s);
  int8_t* d_b = reinterpret_cast<int8_t*>(d_s);
  float* d_f = reinterpret_cast<float*>(d_s);

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int warp = tid / 32, lane = tid % 32;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int rows_st = kKind == kNibble ? rows / 2 : rows;

  // this block's expert: every operand moves by the expert's own size
  const long long ex = blockIdx.z;
  const long long plane = (long long)S * kt * N;
  a += ex * M * kt * rows;
  out += ex * M * N;
  digits = static_cast<const char*>(digits) +
           ex * plane * rows_st * (kFloat ? (long long)sizeof(float) : 1LL);
  if (occ != nullptr) occ += ex * plane;
  if (!kAdcFree) s_p += ex * plane;
  deq += ex * plane;

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
      Acc p[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) p[i][j] = 0;
      if (live) {
        const int nn = tid % BN;
        const int n = n0 + nn;
        if constexpr (kKind == kFloat32) {
          const float* dsrc = static_cast<const float*>(digits) + col * rows;
          for (int r = tid / BN; r < sf; r += kThreads / BN)
            d_f[nn * sf + r] = (n < N && r < rows)
                ? dsrc[(long long)r * N + n] : 0.f;
        } else if constexpr (kKind == kNibble) {
          const uint8_t* dsrc = static_cast<const uint8_t*>(digits)
              + col * rows_st;
          const int gh = rows_st / groups;
          for (int rp = tid / BN; rp < rows_st; rp += kThreads / BN) {
            const int b = n < N ? (int)dsrc[(long long)rp * N + n] : 0;
            const int g = rp / gh, w = rp % gh;
            const int r = g * 2 * gh + w;
            d_b[nn * rb + r] = (int8_t)(((b & 0xF) ^ 8) - 8);
            d_b[nn * rb + r + gh] = (int8_t)(((b >> 4) ^ 8) - 8);
          }
          for (int r = rows + tid / BN; r < rb; r += kThreads / BN)
            d_b[nn * rb + r] = 0;
        } else {
          const int8_t* dsrc = static_cast<const int8_t*>(digits)
              + col * rows_st;
          for (int r = tid / BN; r < rb; r += kThreads / BN)
            d_b[nn * rb + r] = (n < N && r < rows)
                ? dsrc[(long long)r * N + n] : (int8_t)0;
        }
        __syncthreads();
        for (int w = 0; w < rw; ++w) {
          int av[kTM];
#pragma unroll
          for (int i = 0; i < kTM; ++i) av[i] = a_s[(ty + i * TY) * sw + w];
          if constexpr (kFloat) {
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
          } else {
            int dv[kTN];
#pragma unroll
            for (int j = 0; j < kTN; ++j) dv[j] = d_s[(tx + j * TX) * sw + w];
#pragma unroll
            for (int i = 0; i < kTM; ++i)
#pragma unroll
              for (int j = 0; j < kTN; ++j)
                p[i][j] = dot4<kUnsignedA>(av[i], dv[j], p[i][j]);
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
          const float pf = kFloat ? __double2float_rn((double)p[i][j])
                                  : (float)p[i][j];
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
  long long m;      // rows of one matrix (an expert's capacity C)
  int kt, rows, S, n, groups, a_unsigned, kind, psum_bits, psum_quant;
  int experts;      // 1 for a single matrix
  cudaStream_t stream;
};

template <int BN, bool kUnsignedA, int kKind, bool kAdcFree>
cudaError_t launch(const Args& x) {
  constexpr int BM = (kThreads / (BN / kTN)) * kTM;
  const int d_words = kKind == kFloat32 ? stride_floats(x.rows)
                                        : stride_words(x.rows);
  const size_t smem =
      ((size_t)BM * stride_words(x.rows) + (size_t)BN * d_words) * 4;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = cim_matmul_kernel<BN, kUnsignedA, kKind, kAdcFree>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)((x.m + BM - 1) / BM),
                  (unsigned)((x.n + BN - 1) / BN), (unsigned)x.experts);
  kern<<<grid, kThreads, smem, x.stream>>>(
      static_cast<const int8_t*>(x.a), x.digits,
      static_cast<const uint8_t*>(x.occ), static_cast<const float*>(x.s_p),
      static_cast<const float*>(x.deq), static_cast<float*>(x.out), x.m, x.kt,
      x.rows, x.S, x.n, x.groups, x.psum_bits, x.psum_quant);
  return cudaGetLastError();
}

template <int BN, bool kAdcFree, bool kUnsignedA>
cudaError_t dispatch_kind(const Args& x) {
  if (x.kind == kNibble) return launch<BN, kUnsignedA, kNibble, kAdcFree>(x);
  if (x.kind == kFloat32) return launch<BN, kUnsignedA, kFloat32, kAdcFree>(x);
  return launch<BN, kUnsignedA, kInt8, kAdcFree>(x);
}

template <bool kAdcFree>
int dispatch(const Args& x) {
  if (x.m <= 0 || x.kt <= 0 || x.rows <= 0 || x.S <= 0 || x.n <= 0 ||
      x.groups <= 0 || x.kind < kInt8 || x.kind > kFloat32 ||
      x.experts <= 0 || x.experts > 65535 || (x.n + 15) / 16 > 65535 ||
      (!kAdcFree && (x.psum_bits < 1 || x.psum_bits > 24)) ||
      (x.kind == kNibble && ((x.rows % 2) || ((x.rows / 2) % x.groups))))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (x.n <= 16)
    e = x.a_unsigned ? dispatch_kind<16, kAdcFree, true>(x)
                     : dispatch_kind<16, kAdcFree, false>(x);
  else if (x.n <= 32)
    e = x.a_unsigned ? dispatch_kind<32, kAdcFree, true>(x)
                     : dispatch_kind<32, kAdcFree, false>(x);
  else
    e = x.a_unsigned ? dispatch_kind<64, kAdcFree, true>(x)
                     : dispatch_kind<64, kAdcFree, false>(x);
  return (int)e;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code: 0 on a successful launch. `occ` may be
// null. `rows` is the logical row count; nibble planes store rows / 2 rows
// in `groups` half-split blocks. `digit_kind`: 0 int8, 1 nibble uint8,
// 2 float32.
int cim_matmul_launch(const void* a, const void* digits, const void* occ,
                      const void* s_p, const void* deq, void* out,
                      long long m, int kt, int rows, int S, int n, int groups,
                      int a_unsigned, int digit_kind, int psum_bits,
                      int psum_quant, void* stream) {
  const Args x{a, digits, occ, s_p, deq, out, m, kt, rows, S, n, groups,
               a_unsigned, digit_kind, psum_bits, psum_quant, 1,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(x);
}

// The ADC kernel over an MoE bank: `experts` matrices of the shapes above,
// each operand stacked on a leading expert axis (codes (E, C, kt, rows),
// digits (E, S, kt, rows or rows/2, N), occ/s_p/deq (E, S, kt, N), out
// (E, C, N)); `m` is C.
int cim_matmul_experts_launch(const void* a, const void* digits,
                              const void* occ, const void* s_p,
                              const void* deq, void* out, long long m, int kt,
                              int rows, int S, int n, int groups,
                              int a_unsigned, int digit_kind, int psum_bits,
                              int psum_quant, int experts, void* stream) {
  const Args x{a, digits, occ, s_p, deq, out, m, kt, rows, S, n, groups,
               a_unsigned, digit_kind, psum_bits, psum_quant, experts,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(x);
}

// The ADC-free kernel: no s_p operand, no psum_bits.
int cim_matmul_adc_free_launch(const void* a, const void* digits,
                               const void* occ, const void* deq, void* out,
                               long long m, int kt, int rows, int S, int n,
                               int groups, int a_unsigned, int digit_kind,
                               void* stream) {
  const Args x{a, digits, occ, nullptr, deq, out, m, kt, rows, S, n, groups,
               a_unsigned, digit_kind, 0, 0, 1,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(x);
}

const char* cim_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
