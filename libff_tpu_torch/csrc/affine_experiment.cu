// affine_experiment.cu -- kernel K7e, the batched-affine bucket-add
// experiment.
//
// Replaces profile/affine_experiment.py:72 _run_kernel (its pallas_call at
// :80) with the three bodies of its main (:91-208).  The TPU kernel runs a
// sequential grid of T steps over (n16, Ls, 128) tiles and keeps one output
// tile resident across the grid; here a loop over the T steps inside the
// kernel takes the place of the grid, and I independent instances run side
// by side, each with its own inputs and its own o, because one instance is
// 512 lanes, under 1% of the card.  Inputs are (I, T, 8, L) limb-major
// words, L = Ls * 128; instance i starts at i * inst_stride.
//
// madd (:101-111), one thread a lane: o <- X3 ^ Y3 ^ Z3 of formulas.cuh's
//   rcb_madd of the projective (o, a_t, b_t) and the affine (a_t, b_t),
//   b3 = 9 by fp.cuh's addition chain; 11 products a step.
// affine (:116-135), one thread a lane: the affine add body with the
//   stand-in inverse b_t, the doubling numerator 3 x1^2 where x1 == x2;
//   o <- x3 ^ y3; 3 products a step (4 where x1 == x2).
// lane_inv (:149-187), one block of L threads an instance: per step the
//   2-D inclusive prefix pre[r][j] = prod over r' <= r, j' <= j of
//   d[r'][j'] (d = a_t), the suffix of each 128-lane row, acc = pre^(p-2)
//   by the left-to-right ladder over p - 2's bits (253 squarings and 109
//   products for alt_bn128's Fq), o = (pre * suf) * acc.  The lane scans
//   run within each warp by shuffles (strides 1..16); each warp's total
//   goes through shared memory, and a leader thread of each warp forms the
//   product of the row's warps before (prefix) or after (suffix) it, which
//   every lane of the warp then multiplies in (strides 32 and 64); the
//   scan over the Ls rows goes through shared memory (strides 1, 2, ..).
//   Every input is a canonical nonzero residue and a Montgomery product of
//   canonical residues is canonical, so this schedule gives the bits of
//   the reference's roll butterflies.  Each step's o is independent of
//   the others, and only the last reaches o: `chk`, the XOR of every
//   step's o, is a second output, so no step's work can be dropped.
//
// madd's and affine's o are fed back by XOR and so are not canonical from
// the second step on; fp.cuh's add, sub and CIOS product give the JAX
// package's bits on any 256-bit operands.
//
// Bound on an H100: integer multiply issue in all three (a product is
// 136 mad.lo and 128 mad.hi against 64 or 32 bytes read a step).  madd and
// affine keep the chain in registers and read a_t, b_t once, each limb
// load of a warp one 128-byte transaction; lane_inv keeps its 16 warps'
// serial ladders in registers, one block of 512 threads an SM.
#include "formulas.cuh"

using namespace lff;

namespace {

constexpr int kThreads = 128;  // madd, affine: threads a block, one a lane
constexpr int kRow = 128;      // lanes of a row
constexpr int kWarpsRow = kRow / 32;
constexpr int kMaxRows = 4;    // lane_inv: at most 4 rows, 512 threads
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = kMaxRows * kWarpsRow;

// the Fermat exponent p - 2 of alt_bn128's Fq, the one field the Python
// wrappers pass here, 32-bit limbs little-endian; it has 254 bits, 110 of
// them set
__constant__ uint32_t kExp[8] = {0xd87cfd45u, 0x3c208c16u, 0x6871ca8du,
                                 0x97816a91u, 0x8181585du, 0xb85045b6u,
                                 0xe131a029u, 0x30644e72u};
constexpr int kExpTop = 253;  // the index of p - 2's leading bit

__device__ __forceinline__ Fe<8> xor8(const Fe<8>& a, const Fe<8>& b) {
  Fe<8> r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = a.v[k] ^ b.v[k];
  return r;
}

__global__ void __launch_bounds__(kThreads)
    madd_kernel(uint32_t* out, const uint32_t* a, const uint32_t* b, int T,
                int L, long long inst_stride, FieldParams<8> P) {
  using F = FpField<9>;
  const F f{P};
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const long long i = blockIdx.y;
  const uint32_t* ai = a + i * inst_stride + l;
  const uint32_t* bi = b + i * inst_stride + l;
  const long long step = 8LL * L;
  Fe<8> o = zero<8>();
#pragma unroll 1
  for (int t = 0; t < T; t++) {
    const Fe<8> x = load<8>(ai + t * step, L, 0);
    const Fe<8> y = load<8>(bi + t * step, L, 0);
    const Pt<F> r = rcb_madd(f, Pt<F>{o, x, y}, x, y);
    o = xor8(xor8(r.x, r.y), r.z);
  }
  store<8>(out + i * 8LL * L + l, L, 0, o);
}

__global__ void __launch_bounds__(kThreads)
    affine_kernel(uint32_t* out, const uint32_t* a, const uint32_t* b, int T,
                  int L, long long inst_stride, FieldParams<8> P) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const long long i = blockIdx.y;
  const uint32_t* ai = a + i * inst_stride + l;
  const uint32_t* bi = b + i * inst_stride + l;
  const long long step = 8LL * L;
  Fe<8> o = zero<8>();
#pragma unroll 1
  for (int t = 0; t < T; t++) {
    // bucket (x1, y1) = (o, a_t), incoming point (x2, y2) = (a_t, b_t),
    // the inverse's stand-in dinv = b_t
    const Fe<8> x2 = load<8>(ai + t * step, L, 0);
    const Fe<8> y2 = load<8>(bi + t * step, L, 0);
    const Fe<8> x1 = o, y1 = x2;
    uint32_t diff = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) diff |= x1.v[k] ^ x2.v[k];
    Fe<8> num;
    if (diff == 0) {  // x1 == x2: the doubling numerator 3 x1^2
      const Fe<8> sq = mul(x1, x1, P);
      num = add(add(sq, sq, P), sq, P);
    } else {
      num = sub(y2, y1, P);
    }
    const Fe<8> lam = mul(num, y2, P);
    const Fe<8> x3 = sub(sub(mul(lam, lam, P), x1, P), x2, P);
    const Fe<8> y3 = sub(mul(lam, sub(x1, x3, P), P), y1, P);
    o = xor8(x3, y3);
  }
  store<8>(out + i * 8LL * L + l, L, 0, o);
}

__device__ __forceinline__ Fe<8> shfl_up(const Fe<8>& a, int s) {
  Fe<8> r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = __shfl_up_sync(kFull, a.v[k], s);
  return r;
}

__device__ __forceinline__ Fe<8> shfl_down(const Fe<8>& a, int s) {
  Fe<8> r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = __shfl_down_sync(kFull, a.v[k], s);
  return r;
}

// element q of a limb-major (8, W) shared array
template <int W>
__device__ __forceinline__ Fe<8> sload(uint32_t (*s)[W], int q) {
  Fe<8> r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = s[k][q];
  return r;
}

template <int W>
__device__ __forceinline__ void sstore(uint32_t (*s)[W], int q,
                                       const Fe<8>& a) {
#pragma unroll
  for (int k = 0; k < 8; k++) s[k][q] = a.v[k];
}

__global__ void __launch_bounds__(kMaxRows * kRow, 1)
    lane_inv_kernel(uint32_t* out, uint32_t* chk_out, const uint32_t* a,
                    int T, int Ls, long long inst_stride, FieldParams<8> P) {
  // each warp's totals and the products of its row's other warps, and
  // pre of every lane for the scan over rows
  __shared__ uint32_t tot_pre[8][kWarps], tot_suf[8][kWarps];
  __shared__ uint32_t ex_pre[8][kWarps], ex_suf[8][kWarps];
  __shared__ uint32_t rows[8][kMaxRows * kRow];
  const int tid = threadIdx.x, L = Ls * kRow;
  const int r = tid / kRow, lane = tid & 31, w = tid >> 5;
  const int wr = (tid % kRow) >> 5;  // the warp's place in its row
  const int w0 = r * kWarpsRow;      // the row's first warp
  const long long i = blockIdx.x;
  const uint32_t* ai = a + i * inst_stride + tid;
  const long long step = 8LL * L;
  Fe<8> o = zero<8>(), chk = zero<8>();
#pragma unroll 1
  for (int t = 0; t < T; t++) {
    const Fe<8> d = load<8>(ai + t * step, L, 0);
    Fe<8> pre = d, suf = d;
#pragma unroll 1
    for (int s = 1; s < 32; s <<= 1) {
      const Fe<8> up = shfl_up(pre, s), dn = shfl_down(suf, s);
      if (lane >= s) pre = mul(pre, up, P);
      if (lane + s < 32) suf = mul(suf, dn, P);
    }
    if (lane == 31) sstore(tot_pre, w, pre);
    if (lane == 0) sstore(tot_suf, w, suf);
    __syncthreads();
    if (lane == 0) {
      if (wr > 0) {
        Fe<8> e = sload(tot_pre, w0);
        for (int q = 1; q < wr; q++) e = mul(e, sload(tot_pre, w0 + q), P);
        sstore(ex_pre, w, e);
      }
      if (wr < kWarpsRow - 1) {
        Fe<8> e = sload(tot_suf, w0 + kWarpsRow - 1);
        for (int q = kWarpsRow - 2; q > wr; q--)
          e = mul(e, sload(tot_suf, w0 + q), P);
        sstore(ex_suf, w, e);
      }
    }
    __syncthreads();
    if (wr > 0) pre = mul(pre, sload(ex_pre, w), P);
    if (wr < kWarpsRow - 1) suf = mul(suf, sload(ex_suf, w), P);
    // the scan over rows: pre[r] *= pre[r - s] for r >= s
#pragma unroll 1
    for (int s = 1; s < Ls; s <<= 1) {
      sstore(rows, tid, pre);
      __syncthreads();
      Fe<8> v = pre;
      if (r >= s) v = sload(rows, tid - s * kRow);
      __syncthreads();
      if (r >= s) pre = mul(pre, v, P);
    }
    // x^(p-2) by fp.cuh's ladder (affine_experiment.py:183-186)
    const Fe<8> acc = pow_ladder(pre, kExp, kExpTop, P);
    o = mul(mul(pre, suf, P), acc, P);
    chk = xor8(chk, o);
  }
  store<8>(out + i * 8LL * L + tid, L, 0, o);
  store<8>(chk_out + i * 8LL * L + tid, L, 0, chk);
}

}  // namespace

extern "C" {

// body 0 madd, 1 affine: out (I, 8, L); a, b (I, T, 8, L) limb-major,
// instance i at i * inst_stride words; 2 lane_inv: out and chk (I, 8, L),
// a as above (b unused), L = Ls * 128 with Ls in 1..4.  p is alt_bn128's
// Fq (lane_inv's exponent is built in; affine_experiment.py checks p).
int affine_body(int body, void* out, void* chk, const void* a, const void* b,
                int I, int T, int L, long long inst_stride, const uint32_t* p,
                uint32_t inv, int device, void* stream) {
  if (I < 0 || T < 0 || L <= 0 || L % kRow || I > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (I == 0) return 0;
  const FieldParams<8> P = field_params(p, nullptr, inv);
  const cudaStream_t s = (cudaStream_t)stream;
  auto* o = (uint32_t*)out;
  auto* x = (const uint32_t*)a;
  auto* y = (const uint32_t*)b;
  const dim3 grid(L / kThreads, I);
  switch (body) {
    case 0:
      madd_kernel<<<grid, kThreads, 0, s>>>(o, x, y, T, L, inst_stride, P);
      break;
    case 1:
      affine_kernel<<<grid, kThreads, 0, s>>>(o, x, y, T, L, inst_stride, P);
      break;
    case 2:
      if (L > kMaxRows * kRow) return (int)cudaErrorInvalidValue;
      lane_inv_kernel<<<I, L, 0, s>>>(o, (uint32_t*)chk, x, T, L / kRow,
                                      inst_stride, P);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// What the card makes of body's kernel at `threads` a block: out[0]
// registers a thread, out[1] local (spill) bytes a thread, out[2] blocks
// resident an SM, out[3] the SM count.
int affine_body_info(int body, int threads, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* fn = body == 0   ? (const void*)madd_kernel
                   : body == 1 ? (const void*)affine_kernel
                   : body == 2 ? (const void*)lane_inv_kernel
                               : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, 0);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = sms;
  return 0;
}

}  // extern "C"
