// Fused CIM matmul with per-column partial-sum (ADC) quantization, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// repro_torch/kernels/_build.py.
//
// Replaces repro/kernels/cim_matmul.py::cim_matmul_pallas: its dense body
// `_kernel`, the occupancy-skip body `_kernel_sparse` and the nibble decode
// `decode_digit_block`. The conv deploy path (repro/kernels/cim_conv.py::
// cim_conv_pallas) lowers onto this same kernel with M = B*H'*W' and
// nibble groups = kh*kw.
//
//   out[m, n] = sum_t sum_s deq[s,t,n] * ADC(sum_r a[m,t,r] * d[s,t,r,n])
//   ADC(p) = sign(p) * s_p                             psum_bits == 1
//          = clip(rint(p / s_p), -2^(b-1), 2^(b-1)-1) * s_p   otherwise
//   s_p clamped to >= 1e-9; psum_quant == 0 skips the ADC.
//
// Numerics. Each (t, s) partial sum is an exact int32 sum of int8 x int8
// (or uint8 x int8) products (dp4a). It is converted to float, quantized
// with an IEEE divide (__fdiv_rn) and rintf (half to even, like
// torch.round / jnp.round), and accumulated with one rounded multiply and
// one rounded add (__fmul_rn, __fadd_rn: no FMA contraction) in the order
// t outer, s inner -- the order of the TPU grid and of
// repro_torch.kernels.ref.shift_add, so the kernel and its plain version
// agree bit for bit. Build without --use_fast_math.
//
// Sparse planes. With an occupancy map, a block skips the load and the MACs
// of a (t, s) plane whose columns in the block are all unoccupied; the
// partial sum is then exactly 0 and goes through the same epilogue, so a
// dead plane adds ADC(0) * deq (+s_p * deq under the sign ADC, +0 else) and
// the sparse path is bit-exact with the dense one at every psum_bits.
//
// Nibble planes (uint8, half-split per group): packed row g*gh + w holds
// logical row g*2gh + w in its low nibble and g*2gh + gh + w in its high
// nibble; each nibble decodes as ((x ^ 8) - 8). Decoding happens while the
// tile is copied into shared memory.
//
// Bound at the main path's shapes (ResNet-20, batch 256, 3-bit weights on
// 1-bit cells -> S = 3, 128-row arrays -> rows = 126 for 3x3 convs): the
// first stage's convs have M = 262,144, kt = 2, N = 16, so one layer moves
// ~66 MB of patches + 17 MB of output (25 us at 3.35 TB/s) against
// ~6.3 G int8 ops (3 us at 1,979 TOPS): the kernel is bound by bytes.
// This first version keeps one patch tile per array tile in shared memory
// and reuses it across all S splits (the patches are read once per t, not
// once per (t, s)), picks the N tile from {16, 32, 64} so a 16-wide layer
// does not idle 7/8 of a 128-wide tile, and writes the output once. It
// runs its MACs on dp4a rather than on the tensor cores (wgmma) and does
// not gather the patches itself (implicit GEMM); both are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 4;  // outputs per thread along m
constexpr int kTN = 4;  // outputs per thread along n
constexpr size_t kMaxSmem = 232448;  // 227 KB per block on H100

// 32-bit words per shared-memory row of a tile; odd, so that threads
// reading different rows hit different banks.
__host__ __device__ inline int stride_words(int rows) {
  return ((rows + 3) / 4) | 1;
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

__device__ __forceinline__ float adc(float p, float sp, int psum_bits,
                                     int psum_quant) {
  if (!psum_quant) return p;
  sp = fmaxf(sp, 1e-9f);
  if (psum_bits == 1) return __fmul_rn(p >= 0.f ? 1.f : -1.f, sp);
  const float qn = -(float)(1 << (psum_bits - 1));
  const float qp = (float)((1 << (psum_bits - 1)) - 1);
  const float q = fminf(fmaxf(rintf(__fdiv_rn(p, sp)), qn), qp);
  return __fmul_rn(q, sp);
}

// One block computes a BM x BN output tile; 256 threads, 4 x 4 outputs
// each. Shared memory: the block's patch rows of array tile t (BM x rows
// bytes) and the decoded digit plane (t, s) transposed (BN x rows bytes).
template <int BN, bool kUnsignedA, bool kNibble>
__global__ void __launch_bounds__(kThreads) cim_matmul_kernel(
    const int8_t* __restrict__ a,        // (M, kt, rows) int8 or uint8 bytes
    const uint8_t* __restrict__ digits,  // (S, kt, rows or rows/2, N)
    const uint8_t* __restrict__ occ,     // (S, kt, N) or nullptr
    const float* __restrict__ s_p,       // (S, kt, N)
    const float* __restrict__ deq,       // (S, kt, N)
    float* __restrict__ out,             // (M, N)
    long long M, int kt, int rows, int S, int N, int groups, int psum_bits,
    int psum_quant) {
  constexpr int TX = BN / kTN;        // threads along n
  constexpr int TY = kThreads / TX;   // threads along m
  constexpr int BM = TY * kTM;
  extern __shared__ int smem[];
  const int sw = stride_words(rows);
  const int rb = sw * 4;              // bytes per shared row
  const int rw = (rows + 3) / 4;      // words holding data
  int* a_s = smem;                    // BM rows
  int* d_s = smem + BM * sw;          // BN rows (transposed plane)
  int8_t* a_b = reinterpret_cast<int8_t*>(a_s);
  int8_t* d_b = reinterpret_cast<int8_t*>(d_s);

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int warp = tid / 32, lane = tid % 32;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int rows_st = kNibble ? rows / 2 : rows;

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
      int p[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) p[i][j] = 0;
      if (live) {
        const uint8_t* dsrc = digits + col * rows_st;
        const int nn = tid % BN;
        const int n = n0 + nn;
        if (kNibble) {
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
          for (int r = tid / BN; r < rb; r += kThreads / BN)
            d_b[nn * rb + r] = (n < N && r < rows)
                ? (int8_t)dsrc[(long long)r * N + n] : (int8_t)0;
        }
        __syncthreads();
        for (int w = 0; w < rw; ++w) {
          int av[kTM], dv[kTN];
#pragma unroll
          for (int i = 0; i < kTM; ++i) av[i] = a_s[(ty + i * TY) * sw + w];
#pragma unroll
          for (int j = 0; j < kTN; ++j) dv[j] = d_s[(tx + j * TX) * sw + w];
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j)
              p[i][j] = dot4<kUnsignedA>(av[i], dv[j], p[i][j]);
        }
      }
      // epilogue: ADC, dequant, shift-and-add into the f32 accumulator
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = n0 + tx + j * TX;
        if (n >= N) continue;
        const float sp = s_p[col + n];
        const float dq = deq[col + n];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float v = adc((float)p[i][j], sp, psum_bits, psum_quant);
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

template <int BN, bool kUnsignedA, bool kNibble>
cudaError_t launch(const void* a, const void* digits, const void* occ,
                   const void* s_p, const void* deq, void* out, long long m,
                   int kt, int rows, int S, int n, int groups, int psum_bits,
                   int psum_quant, cudaStream_t stream) {
  constexpr int BM = (kThreads / (BN / kTN)) * kTM;
  const size_t smem = (size_t)(BM + BN) * stride_words(rows) * 4;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = cim_matmul_kernel<BN, kUnsignedA, kNibble>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((n + BN - 1) / BN));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const uint8_t*>(digits),
      static_cast<const uint8_t*>(occ), static_cast<const float*>(s_p),
      static_cast<const float*>(deq), static_cast<float*>(out), m, kt, rows,
      S, n, groups, psum_bits, psum_quant);
  return cudaGetLastError();
}

template <int BN>
cudaError_t dispatch(int a_unsigned, int nibble, const void* a,
                     const void* digits, const void* occ, const void* s_p,
                     const void* deq, void* out, long long m, int kt, int rows,
                     int S, int n, int groups, int psum_bits, int psum_quant,
                     cudaStream_t st) {
  if (a_unsigned && nibble)
    return launch<BN, true, true>(a, digits, occ, s_p, deq, out, m, kt, rows,
                                  S, n, groups, psum_bits, psum_quant, st);
  if (a_unsigned)
    return launch<BN, true, false>(a, digits, occ, s_p, deq, out, m, kt, rows,
                                   S, n, groups, psum_bits, psum_quant, st);
  if (nibble)
    return launch<BN, false, true>(a, digits, occ, s_p, deq, out, m, kt, rows,
                                   S, n, groups, psum_bits, psum_quant, st);
  return launch<BN, false, false>(a, digits, occ, s_p, deq, out, m, kt, rows,
                                  S, n, groups, psum_bits, psum_quant, st);
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a successful launch. `occ` may be null.
// `rows` is the logical row count; nibble planes store rows / 2 rows in
// `groups` half-split blocks.
int cim_matmul_launch(const void* a, const void* digits, const void* occ,
                      const void* s_p, const void* deq, void* out,
                      long long m, int kt, int rows, int S, int n, int groups,
                      int a_unsigned, int nibble, int psum_bits,
                      int psum_quant, void* stream) {
  if (m <= 0 || kt <= 0 || rows <= 0 || S <= 0 || n <= 0 || groups <= 0 ||
      psum_bits < 1 || psum_bits > 24 ||
      (nibble && ((rows % 2) || ((rows / 2) % groups))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 16)
    return (int)dispatch<16>(a_unsigned, nibble, a, digits, occ, s_p, deq,
                             out, m, kt, rows, S, n, groups, psum_bits,
                             psum_quant, st);
  if (n <= 32)
    return (int)dispatch<32>(a_unsigned, nibble, a, digits, occ, s_p, deq,
                             out, m, kt, rows, S, n, groups, psum_bits,
                             psum_quant, st);
  return (int)dispatch<64>(a_unsigned, nibble, a, digits, occ, s_p, deq, out,
                           m, kt, rows, S, n, groups, psum_bits, psum_quant,
                           st);
}

const char* cim_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
